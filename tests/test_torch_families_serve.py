"""The serving engine for the ``moe``, ``ssm`` and ``hybrid`` families:
``repro_torch.launch.serve.ContinuousBatchingEngine`` vs the reference's,
on the reduced configs with the reference's parameters carried across, and
C9 (ROADMAP.md, queue C): the reference's engine keeps a finished
request's recurrent state in its slot and the next request admitted there
starts from it; the port's zeroes the slot's ``ssm`` and ``conv`` rows on
admission.  The port runs on ``device="cpu"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import ContinuousBatchingEngine as RefEngine
from repro.launch.serve import Request as RefRequest
from repro.models import LM as RefLM

from repro_torch import convert
from repro_torch.launch.serve import ContinuousBatchingEngine, Request

BF16 = dict(rtol=4e-2, atol=4e-2)     # the reference's bf16 tolerance


FIRST = np.array([5, 9, 13, 17, 21, 25], np.int32)    # request 1 (C9)
SECOND = np.array([7, 3, 11], np.int32)                # request 2


def _record(fn, rows):
    def recording(*args):
        logits, cache = fn(*args)
        rows.append(np.asarray(logits[0], np.float32) if not isinstance(
            logits, torch.Tensor) else logits[0].float().numpy())
        return logits, cache
    return recording


def _ref_second_request_logits(cfg, params, after_first):
    eng = RefEngine(cfg, params, batch_slots=1, max_seq=32)
    rows = []
    eng._decode = _record(eng._decode, rows)
    if after_first:
        eng.submit(RefRequest(rid=0, prompt=FIRST, max_new_tokens=6))
        eng.run_until_drained()
        rows.clear()
    eng.submit(RefRequest(rid=1, prompt=SECOND, max_new_tokens=4))
    out = eng.run_until_drained()[1].output
    return rows, out


def _port_second_request_logits(cfg, params, after_first):
    eng = ContinuousBatchingEngine(cfg, params, 1, 32, device="cpu")
    rows = []
    eng.model.decode_step = _record(eng.model.decode_step, rows)
    if after_first:
        eng.submit(Request(rid=0, prompt=FIRST, max_new_tokens=6))
        eng.run_until_drained()
        rows.clear()
    eng.submit(Request(rid=1, prompt=SECOND, max_new_tokens=4))
    out = eng.run_until_drained()[1].output
    return rows, out


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_c9_slot_state_is_zeroed_on_admission(arch):
    """C9.  In the reference's one-slot engine, request 2 served after
    request 1 starts from request 1's recurrent state: its first decode
    logits differ from request 2 served alone.  In the port's engine they
    are equal, and equal the reference's served alone."""
    cfg = ref_get_config(arch, reduced=True)
    params = RefLM(cfg).init_params(jax.random.PRNGKey(0))
    ref_after, _ = _ref_second_request_logits(cfg, params, True)
    ref_alone, ref_out = _ref_second_request_logits(cfg, params, False)
    assert np.abs(ref_after[0] - ref_alone[0]).max() > 1e-2

    tcfg = convert.model_config_from_reference(cfg)
    tparams = convert.params_from_reference(params, device="cpu")
    after, out_after = _port_second_request_logits(tcfg, tparams, True)
    alone, out_alone = _port_second_request_logits(tcfg, tparams, False)
    assert len(after) == len(alone) == len(SECOND) + 3
    for a, b in zip(after, alone):
        np.testing.assert_array_equal(a, b)
    assert out_after == out_alone
    np.testing.assert_allclose(alone[0], ref_alone[0], **BF16)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_engine_tokens_equal_the_reference_and_batching_changes_none(arch):
    """float32 parameters: each request served alone gets the reference's
    greedy tokens (alone there too — the reference's shared slots carry
    C9), and the port serving them 2 at a time in a 2-slot engine, slots
    reused, gives every request the same tokens."""
    cfg = ref_get_config(arch, reduced=True)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          RefLM(cfg).init_params(jax.random.PRNGKey(3)))
    tcfg = convert.model_config_from_reference(cfg)
    tparams = convert.params_from_reference(params, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 5, 4, 6)]
    engine = ContinuousBatchingEngine(tcfg, tparams, 2, 24, device="cpu")
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    done = engine.run_until_drained()
    for i, p in enumerate(prompts):
        ref_alone = RefEngine(cfg, params, batch_slots=1, max_seq=24)
        ref_alone.submit(RefRequest(rid=0, prompt=p, max_new_tokens=4))
        alone = ContinuousBatchingEngine(tcfg, tparams, 1, 24, device="cpu")
        alone.submit(Request(rid=0, prompt=p, max_new_tokens=4))
        got = alone.run_until_drained()[0].output
        assert got == ref_alone.run_until_drained()[0].output, i
        assert done[i].output == got, i
