"""A float8 KV cache (``kv_cache_dtype="float8"``) on the CPU: the port's
``update_cache`` against the reference's (ROADMAP.md, C12).

``float8_e4m3fn`` has no infinity.  The reference's ``astype`` rounds to
nearest even and gives NaN for what rounds past 448 (every |x| > 464, and
+-inf), with x's sign (bytes 0x7f / 0xff); torch's own ``.to`` saturates
those to +-448 on the CPU.  The port writes the reference's rule out
(``models.attention._to_cache_type``), so:

* the cache bytes after ``update_cache`` equal the reference's bit for bit
  at the edge values, through the int-index and the ``(B,)``-index
  branches;
* ROADMAP C12's own input (one 500.0 in ``k_new``) gives the reference's
  NaN attention row;
* six decode steps of reduced qwen2 (float32 weights) from a zero float8
  cache leave bit-equal caches, with the logits within ``LOGIT_TOL``:
  float32 sums in another order, a few ulps of logits near 1 (1.5e-7
  measured when C12 was found, 1.8e-7 at this test's seed; the limit,
  5e-7, sits just above that reading).

``chip_smoke.py``'s ``lm`` phase writes the same edge values through
``update_cache`` on the card and holds the bytes equal to the CPU's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.models import attention as ref_attention

from repro_torch import convert
from repro_torch.models import LM, attention

from _torch_parity import assert_bits_equal

EDGES = np.array([464.0, -464.0, 464.01, -464.01, 479.9, -479.9, 480.0,
                  -480.0, 1e4, -1e4, np.inf, -np.inf, np.nan, -np.nan,
                  448.0, -0.0, 1e-9], np.float32)
LOGIT_TOL = dict(rtol=0, atol=5e-7)
DECODE_STEPS = 6


def _bytes(cache) -> np.ndarray:
    if isinstance(cache, torch.Tensor):
        return cache.view(torch.uint8).numpy()
    return np.asarray(cache).view(np.uint8)


def _edge_rows(b, kh, d):
    """``(B, 1, K, D)`` float32 with every edge value in every row, the
    rest standard normal."""
    rng = np.random.default_rng(b * 100 + d)
    x = rng.standard_normal((b, 1, kh, d)).astype(np.float32)
    flat = x.reshape(b, -1)
    for r in range(b):
        flat[r, r:r + len(EDGES)] = EDGES
    return x


@pytest.mark.parametrize("index", ["scalar", "rows"])
def test_update_cache_bytes_equal_the_reference(index):
    b, s, kh, d = 3, 6, 2, 16
    kn, vn = _edge_rows(b, kh, d), -_edge_rows(b, kh, d)
    ck = np.zeros((b, s, kh, d), np.float32)
    ci = 4 if index == "scalar" else np.array([1, 5, 3], np.int32)
    jci = jnp.int32(ci) if index == "scalar" else jnp.asarray(ci)
    tci = ci if index == "scalar" else torch.from_numpy(ci)
    f8 = jnp.float8_e4m3fn
    want_k, want_v = ref_attention.update_cache(
        jnp.asarray(ck).astype(f8), jnp.asarray(ck).astype(f8),
        jnp.asarray(kn), jnp.asarray(vn), jci)
    got_k, got_v = attention.update_cache(
        torch.zeros(ck.shape, dtype=torch.float8_e4m3fn),
        torch.zeros(ck.shape, dtype=torch.float8_e4m3fn),
        torch.from_numpy(kn), torch.from_numpy(vn), tci)
    assert_bits_equal(_bytes(want_k), _bytes(got_k), "k")
    assert_bits_equal(_bytes(want_v), _bytes(got_v), "v")
    # the edges reached the cache: NaN bytes of both signs, and 448
    written = _bytes(got_k)[np.arange(b), np.broadcast_to(ci, (b,))]
    assert {0x7F, 0xFF, 0x7E} <= set(written.ravel().tolist())


def test_bf16_values_round_before_the_rule():
    """A bf16 ``k_new`` (the models' type) widens exactly, so 464.01 is
    464 in bf16 and stores 448 on both sides."""
    x = torch.from_numpy(EDGES).bfloat16()
    want = np.asarray(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16).astype(jnp.float8_e4m3fn))
    got = attention._to_cache_type(x, torch.float8_e4m3fn)
    assert_bits_equal(want.view(np.uint8), _bytes(got))


def test_other_cache_types_convert_as_they_are():
    x = torch.from_numpy(EDGES)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        assert torch.equal(attention._to_cache_type(x, dtype).view(
            torch.uint8), x.to(dtype).view(torch.uint8))


def test_c12_overflow_gives_the_reference_nan_row():
    """ROADMAP C12: a zero float8 cache (B 1, S 4, K 1, D 8), ``k_new``
    0.5 with one 500.0, ``v_new`` 0.25 at index 0, then decode attention
    with q = 0.01: NaN in the cache and in the row, on both sides."""
    kn = np.full((1, 1, 1, 8), 0.5, np.float32)
    kn[0, 0, 0, 3] = 500.0
    vn = np.full((1, 1, 1, 8), 0.25, np.float32)
    q = np.full((1, 1, 1, 8), 0.01, np.float32)
    f8 = jnp.float8_e4m3fn
    zero = jnp.zeros((1, 4, 1, 8), f8)
    wk, wv = ref_attention.update_cache(zero, zero, jnp.asarray(kn),
                                        jnp.asarray(vn), jnp.int32(0))
    want = np.asarray(ref_attention.decode_attention(jnp.asarray(q), wk, wv,
                                                     jnp.int32(0)))
    gk, gv = attention.update_cache(
        torch.zeros(1, 4, 1, 8, dtype=torch.float8_e4m3fn),
        torch.zeros(1, 4, 1, 8, dtype=torch.float8_e4m3fn),
        torch.from_numpy(kn), torch.from_numpy(vn), 0)
    got = attention.decode_attention(torch.from_numpy(q), gk, gv, 0).numpy()
    assert_bits_equal(_bytes(wk), _bytes(gk), "k")
    assert np.isnan(want).all() and np.isnan(got).all()
    assert np.isnan(gk.float().numpy()[0, 0, 0, 3])


def test_float8_cache_decode_matches_the_reference():
    """Reduced qwen2 with a float8 cache, float32 weights: six decode
    steps from a zero cache, one token per row."""
    cfg_ref = dataclasses.replace(ref_get_config("qwen2-0.5b", reduced=True),
                                  kv_cache_dtype="float8")
    ref_model = RefLM(cfg_ref)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_model.init_params(jax.random.PRNGKey(3)))
    model = LM(convert.model_config_from_reference(cfg_ref))
    tparams = convert.params_from_reference(params, device="cpu")
    b, s = 2, 8
    cache = model.init_cache(b, s, device="cpu")
    assert cache["k"].dtype == torch.float8_e4m3fn
    ref_cache = {name: jnp.zeros(t.shape, jnp.float8_e4m3fn)
                 for name, t in cache.items()}
    tokens = np.random.default_rng(5).integers(
        1, cfg_ref.vocab_size, (b, DECODE_STEPS)).astype(np.int32)
    for t in range(DECODE_STEPS):
        want, ref_cache = ref_model.decode_step(
            params, ref_cache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        got, cache = model.decode_step(
            tparams, cache, torch.from_numpy(tokens[:, t:t + 1]).long(), t)
        for name in ("k", "v"):
            assert_bits_equal(_bytes(ref_cache[name]), _bytes(cache[name]),
                              f"{name} after step {t}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
