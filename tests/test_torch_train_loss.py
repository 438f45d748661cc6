"""``repro_torch`` ``LM.loss`` vs ``repro`` ``jax.value_and_grad(LM.loss)``:
the loss, its metrics and every gradient leaf, for the reduced config of
each architecture (all six families; the MoE's load-balance aux is
non-zero), on a packed batch from the reference's data pipeline (segment
ids, a document-level loss mask).  The reference runs on the CPU through
its training path (plain chunked attention under ``jax.checkpoint``); the
port on ``device="cpu"``.

Parameters are the reference's ``jax.random.PRNGKey(0)`` draw cast to
float32 and carried across by ``convert.params_from_reference``; the vlm's
gates are set to ``GATE`` on both sides (declared zero, its cross layers
would add nothing and get no gradient but the gate's).

Tolerances (float32): the loss within ``1e-5`` relative; each gradient
leaf within ``GRAD_TOL`` of its largest entry.  The two frameworks sum the
same products in other orders; the worst leaf measured is ``a_log`` of the
SSM families at 1.1e-5 of its largest entry, every other leaf under 2e-6.
A slip of semantics (a mask, a scale, a missed aux term) moves a leaf by
far more.

``S`` is a multiple of the reduced configs' ``attn_chunk``: the
reference's chunked attention cannot take segment ids with a padded last
chunk (ROADMAP.md, C11); the port can
(``test_segment_ids_with_a_ragged_last_chunk``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM

from repro_torch.models import attention

from _torch_train import (check_against_reference, port_loss,
                          reference_params, train_batch)

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_the_reference(arch):
    cfg = ref_get_config(arch, reduced=True)
    _, metrics = check_against_reference(cfg, train_batch(cfg))
    if cfg.family == "moe":                  # the load-balance term counts
        assert float(metrics["aux"]) > 0.5


def test_a_padded_ce_chunk_and_the_mask_match_the_reference():
    """``ce_chunk`` 48 over 64 tokens: the second chunk is padded, the pad
    masked out; the document-level mask hides the packing's tail."""
    cfg = dataclasses.replace(ref_get_config("qwen2-0.5b", reduced=True),
                              ce_chunk=48)
    batch = train_batch(cfg, seed=3)
    assert batch["loss_mask"].min() == 0.0
    check_against_reference(cfg, batch)


def test_remat_changes_memory_never_values():
    """remat "full", "dots" and "none" give the same loss and gradients bit
    for bit (the recompute repeats the same operations)."""
    cfg = ref_get_config("llama4-scout-17b-a16e", reduced=True)
    params, batch = reference_params(cfg), train_batch(cfg, seed=1)
    runs = {r: port_loss(dataclasses.replace(cfg, remat=r), params, batch)
            for r in ("full", "dots", "none")}
    loss, _, grads = runs["none"]
    for r in ("full", "dots"):
        assert torch.equal(runs[r][0], loss), r
        for path, g in runs[r][2].items():
            assert torch.equal(g, grads[path]), (r, path)


def test_segment_ids_with_a_ragged_last_chunk():
    """The port's chunked attention takes segment ids with a last chunk
    shorter than ``attn_chunk`` (40 tokens in chunks of 32); the reference
    raises there (C11).  Its output equals the same attention with the
    chunk as long as the sequence (one chunk, nothing ragged), within
    float32 rounding."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 4, 8))
                                .astype(np.float32)) for _ in range(3))
    seg = torch.from_numpy(np.repeat([[1, 2, 3, 0]], 10, axis=1)
                           .repeat(2, axis=0).astype(np.int32))
    got = attention.chunked_attention(q, k, v, segment_ids=seg, chunk=32)
    want = attention.chunked_attention(q, k, v, segment_ids=seg, chunk=40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    ref_cfg = ref_get_config("qwen2-0.5b", reduced=True)
    with pytest.raises(TypeError, match="incompatible shapes"):
        RefLM(ref_cfg).loss(reference_params(ref_cfg),
                            {k: jnp.asarray(x) for k, x in
                             train_batch(ref_cfg, seq=40).items()})
