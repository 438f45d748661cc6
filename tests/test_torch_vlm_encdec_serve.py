"""The serving engine for the ``vlm`` and ``encdec`` families:
``repro_torch.launch.serve.ContinuousBatchingEngine`` vs the reference's,
on the reduced configs with the reference's parameters carried across
(float32; the vlm's gates set non-zero on both sides).

The reference's engine never fills the cross caches: it allocates the
whole cache as zeros from ``cache_defs`` and a ``Request`` carries no image
and no audio, so ``cross_k`` / ``cross_v`` stay zero and the cross layers
add nothing (attention over zero values).  The port copies that
(ROADMAP.md, C10): both engines serve the decoder text-only, and the tests
here pin it.  The real cross path is held with prefill -> ``decode_step``
in ``tests/test_torch_vlm_encdec.py``.  The port runs on ``device="cpu"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.launch.serve import ContinuousBatchingEngine as RefEngine
from repro.launch.serve import Request as RefRequest
from repro.models import LM as RefLM

from repro_torch import convert
from repro_torch.launch.serve import ContinuousBatchingEngine, Request

ARCHS = ("llama-3.2-vision-11b", "whisper-base")
MAX_SEQ, NEW = 24, 4


def _models(arch, gate=0.5):
    cfg = ref_get_config(arch, reduced=True)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          RefLM(cfg).init_params(jax.random.PRNGKey(3)))
    if "cross" in params:
        params["cross"]["gate"] = jnp.full_like(params["cross"]["gate"],
                                                gate)
    return (cfg, params, convert.model_config_from_reference(cfg),
            convert.params_from_reference(params, device="cpu"))


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in (3, 5, 4, 6)]


def _serve_port(tcfg, tparams, prompts, slots):
    engine = ContinuousBatchingEngine(tcfg, tparams, slots, MAX_SEQ,
                                      device="cpu")
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    done = engine.run_until_drained()
    return [done[i].output for i in range(len(prompts))], engine


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_reference_engine(arch):
    """Both engines, 2 slots (reused), the same 4 requests: the same
    greedy tokens for every request, and each request served alone in a
    one-slot engine gets them too."""
    cfg, params, tcfg, tparams = _models(arch)
    prompts = _prompts(cfg)
    ref = RefEngine(cfg, params, batch_slots=2, max_seq=MAX_SEQ)
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p, max_new_tokens=NEW))
    ref_done = ref.run_until_drained()
    got, _ = _serve_port(tcfg, tparams, prompts, 2)
    assert got == [ref_done[i].output for i in range(len(prompts))]
    for i, p in enumerate(prompts):
        alone, _ = _serve_port(tcfg, tparams, [p], 1)
        assert alone[0] == got[i], i


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_cross_caches_stay_zero_as_in_the_reference(arch):
    """C10, copied: after serving, both engines' cross caches are all
    zero, and the tokens do not depend on the cross layers' weights (the
    vlm's gate at 0.5 or 0; whisper's cross output projection zeroed)."""
    cfg, params, tcfg, tparams = _models(arch)
    prompts = _prompts(cfg)
    ref = RefEngine(cfg, params, batch_slots=2, max_seq=MAX_SEQ)
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p, max_new_tokens=NEW))
    ref.run_until_drained()
    got, engine = _serve_port(tcfg, tparams, prompts, 2)
    for name in ("cross_k", "cross_v"):
        assert not np.asarray(ref.cache[name]).any(), name
        assert engine.cache[name].shape == ref.cache[name].shape
        assert not engine.cache[name].any(), name
    if "cross" in tparams:
        off = {**tparams, "cross": {**tparams["cross"],
                                    "gate": tparams["cross"]["gate"] * 0}}
    else:
        blocks = tparams["blocks"]
        off = {**tparams, "blocks": {**blocks, "cross": {
            **blocks["cross"], "wo": blocks["cross"]["wo"] * 0}}}
    assert _serve_port(tcfg, off, prompts, 2)[0] == got
