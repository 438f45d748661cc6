"""``repro_torch.launch.serve`` vs ``repro.launch.serve``: the
continuous-batching engine answers the same requests with the same greedy
tokens, on the same float32 parameters; its slot bookkeeping (the MVE
dimension-level mask) behaves as the reference's; and the lane-packing
helpers it is built on are equal to the reference's.

Token equality is asked for with float32 parameters only: in bf16 the two
frameworks round at other points and a greedy pick between two nearly
equal logits may flip (the note in ``tests/test_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core.packing import LaneGrid as RefLaneGrid
from repro.core.packing import pack_documents as ref_pack_documents
from repro.launch.serve import ContinuousBatchingEngine as RefEngine
from repro.launch.serve import Request as RefRequest
from repro.models import LM as RefLM

from repro_torch import convert
from repro_torch.core.packing import LaneGrid, pack_documents
from repro_torch.launch.serve import ContinuousBatchingEngine, Request

PROMPT_LENS = (3, 5, 4, 6, 3)          # tests/test_serve.py


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(ref_get_config("qwen2-0.5b", reduced=True),
                              num_layers=1)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          RefLM(cfg).init_params(jax.random.PRNGKey(3)))
    return (cfg, params, convert.model_config_from_reference(cfg),
            convert.params_from_reference(params, device="cpu"))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _engine(small_model, slots, max_seq):
    _, _, cfg, tparams = small_model
    return ContinuousBatchingEngine(cfg, tparams, batch_slots=slots,
                                    max_seq=max_seq, device="cpu")


def test_tokens_equal_the_reference_engine(small_model):
    ref_cfg, params, cfg, _ = small_model
    prompts = _prompts(cfg.vocab_size)
    ref_engine = RefEngine(ref_cfg, params, batch_slots=2, max_seq=32)
    engine = _engine(small_model, 2, 32)
    for i, p in enumerate(prompts):
        ref_engine.submit(RefRequest(rid=i, prompt=p, max_new_tokens=4))
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    want = ref_engine.run_until_drained()
    got = engine.run_until_drained()
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for i in range(len(prompts)):
        assert got[i].output == want[i].output, (i, got[i].output,
                                                 want[i].output)


def test_batching_never_changes_a_requests_output(small_model):
    """The reference's invariant: a request served beside others gets the
    tokens it gets alone in a one-slot engine."""
    prompts = _prompts(small_model[2].vocab_size)
    engine = _engine(small_model, 2, 32)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    done = engine.run_until_drained()
    for i, p in enumerate(prompts):
        alone = _engine(small_model, 1, 32)
        alone.submit(Request(rid=0, prompt=p, max_new_tokens=4))
        assert done[i].output == alone.run_until_drained()[0].output


def test_dimension_level_masking_occupancy(small_model):
    engine = _engine(small_model, 4, 16)
    assert engine.occupancy == 0.0
    engine.submit(Request(rid=0, prompt=np.asarray([5, 6], np.int32),
                          max_new_tokens=2))
    engine.step()
    assert engine.occupancy == pytest.approx(0.25)
    assert engine.grid.mask.sum() == 1
    engine.run_until_drained()
    assert engine.occupancy == 0.0


def test_queueing_beyond_slots(small_model):
    engine = _engine(small_model, 2, 16)
    for i in range(4):
        engine.submit(Request(rid=i, prompt=np.asarray([2 + i], np.int32),
                              max_new_tokens=2))
    engine.step()
    assert len(engine.grid.active_slots()) == 2
    assert len(engine._queue) == 2
    assert len(engine.run_until_drained()) == 4


def test_request_ends_at_eos_and_at_the_cache_end(small_model):
    engine = _engine(small_model, 1, 6)
    engine.submit(Request(rid=0, prompt=np.asarray([3, 4], np.int32),
                          max_new_tokens=50))
    out = engine.run_until_drained()[0].output
    assert len(out) == 4                         # length reached max_seq - 1
    engine = _engine(small_model, 1, 32)
    engine.submit(Request(rid=1, prompt=np.asarray([3, 4], np.int32),
                          max_new_tokens=50, eos_id=out[1]))
    assert engine.run_until_drained()[1].output == out[:2]


def test_lane_grid_matches_the_reference():
    ref, port = RefLaneGrid((4, 3, 5)), LaneGrid((4, 3, 5))
    for op, arg in [("allocate", "a"), ("allocate", "b"), ("allocate", "c"),
                    ("release", 1), ("allocate", "d"), ("release", 0)]:
        assert getattr(port, op)(arg) == getattr(ref, op)(arg)
        np.testing.assert_array_equal(port.mask, ref.mask)
        np.testing.assert_array_equal(port.lane_mask(), ref.lane_mask())
        assert port.occupancy() == ref.occupancy()
    assert port.lanes == ref.lanes and port.top == ref.top
    with pytest.raises(ValueError):
        LaneGrid((2, 300))
    with pytest.raises(KeyError):
        port.release(4)


def test_pack_documents_matches_the_reference():
    rng = np.random.default_rng(1)
    docs = [rng.integers(1, 100, n) for n in (5, 17, 3, 9, 30, 1, 12)]
    for got, want in zip(pack_documents(docs, 16),
                         ref_pack_documents(docs, 16)):
        np.testing.assert_array_equal(got, want)
