"""The float32 flash kernels' 3xTF32 arithmetic, emulated on the CPU.

``csrc/flash_attention.cu::flash_fwd_tf32_kernel`` and
``csrc/flash_attention_bwd.cu::flash_bwd_{dkdv,dq}_tf32_kernel`` run every
float32 product on the tensor cores as three TF32 products: each operand
``x`` is split into ``hi = rna(x)`` and ``lo = rna(x - hi)``, where ``rna``
is ``cvt.rna.tf32.f32`` (10 mantissa bits, to nearest, ties away from
zero), and each ``mma.sync`` m16n8k8 k step of 8 adds ``lo*hi``, then
``hi*lo``, then ``hi*hi`` to the fp32 accumulator.  The kernels run only on
the card; here that arithmetic is emulated in NumPy in the kernels' order
(the k steps of 8 in order, the accumulator rounded to fp32 after each
product; the 8 products of one step summed exactly, which the tensor core
does not promise, so the tolerance has room for that):

* the forward, key tile by key tile (64 keys at D = 64, 32 at D = 128),
  q scaled in fp32 before its split, the online softmax's max and rescale
  per tile, P split from fp32, against the reference's Pallas kernel in
  interpret mode within ``tests/_torch_card.py``'s ``FLASH_FP32_TOL`` (3e-5);
* the same with one TF32 product (``hi*hi``) misses 3e-5: the reason for
  three;
* the backward (dK/dV over 64-row q tiles from the causal diagonal on,
  the q heads of a kv head in order or split into fp32 partials summed in
  head order; dQ over key tiles up to the diagonal; P and dS split from
  fp32) against ``jax.vjp`` of the reference's plain attention within
  ``FLASH_BWD_FP32_TOL`` (rtol 1e-4, 1e-4 of the largest entry).

``tests/test_torch_flash_card.py`` holds the kernels themselves against
the plain versions on the card at the same limits.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash

from _torch_card import (FLASH_BWD_FP32_TOL, FLASH_FP32_PATH_TOL,
                         FLASH_FP32_TOL)

NEG_INF = np.float32(-1e30)
ROWS = 64                        # q rows a forward / dQ block, K rows a dK/dV
MMA_K = 8                        # the k depth of one m16n8k8


def kv_rows(d: int) -> int:
    """Keys a staged tile of the forward and dQ kernels (ft_kv_rows)."""
    return 64 if d == 64 else 32


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: the top 10 mantissa bits, rounded to nearest
    with ties away from zero (half a unit added to the magnitude, then the
    low 13 bits cut)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32((np.asarray(x, np.float32) - hi).astype(np.float32))


def mma(a: np.ndarray, b: np.ndarray, c: np.ndarray, terms: int = 3
        ) -> np.ndarray:
    """``c + a @ b`` as the kernels add it: per k step of 8, ``lo*hi``,
    ``hi*lo``, ``hi*hi`` (``terms=1``: ``hi*hi`` alone), each step's 8
    products summed in float64 and the accumulator rounded to fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    c = np.array(c, np.float32)
    for k0 in range(0, a.shape[-1], MMA_K):
        ks = slice(k0, k0 + MMA_K)
        for x, y in pairs:
            c = (c + x[..., ks].astype(np.float64)
                 @ y[ks].astype(np.float64)).astype(np.float32)
    return c


def emulate_forward(q, k, v, causal, terms=3):
    """The forward kernel on float32 ``(Sq, D)`` and ``(Sk, D)`` arrays of
    one head: ``(out, lse)``."""
    sq, d = q.shape
    sk = k.shape[0]
    scale = np.float32(1.0 / math.sqrt(d))
    qs = (q * scale).astype(np.float32)
    pos = np.arange(sq) + (sk - sq)
    m = np.full(sq, NEG_INF, np.float32)
    l = np.zeros(sq, np.float32)
    o = np.zeros((sq, d), np.float32)
    bk = kv_rows(d)
    for k0 in range(0, sk, bk):
        keys = np.arange(k0, min(k0 + bk, sk))
        s = mma(qs, k[keys].T, np.zeros((sq, len(keys))), terms)
        if causal:
            s = np.where(pos[:, None] >= keys[None, :], s, NEG_INF)
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - m_new).astype(np.float32)
        with np.errstate(over="ignore"):
            p = np.where(s > NEG_INF / 2, np.exp(s - m_new[:, None]),
                         0).astype(np.float32)
        l = (l * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        o = mma(p, v[keys], o * alpha[:, None], terms)
        m = m_new
    with np.errstate(divide="ignore"):
        lse = np.where(l > 0, m + np.log(l), -np.inf).astype(np.float32)
    return (o / np.where(l == 0, 1, l)[:, None]).astype(np.float32), lse


def _forward_all(q, k, v, causal, terms=3):
    """``emulate_forward`` over (B, H) with kv head ``h // (H / Hkv)``."""
    b, h = q.shape[:2]
    group = h // k.shape[1]
    out = np.zeros(q.shape, np.float32)
    lse = np.zeros(q.shape[:3], np.float32)
    for bb in range(b):
        for hh in range(h):
            out[bb, hh], lse[bb, hh] = emulate_forward(
                q[bb, hh], k[bb, hh // group], v[bb, hh // group], causal,
                terms)
    return out, lse


def _pallas(q, k, v, causal):
    group = q.shape[1] // k.shape[1]
    return np.asarray(pallas_flash(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, axis=1),
        jnp.repeat(jnp.asarray(v), group, axis=1), causal=causal,
        interpret=True), np.float32)


def _inputs(seed, b, h, hk, sq, sk, d, spread=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, n, s, d)) * spread).astype(
        np.float32) for n, s in ((h, sq), (hk, sk), (hk, sk)))


FWD_CASES = [  # (B, H, Hkv, Sq, Sk, D, causal)
    (1, 4, 2, 256, 256, 64, True), (1, 4, 2, 256, 256, 64, False),
    (1, 2, 1, 128, 128, 128, True), (1, 2, 2, 64, 160, 128, False),
    (1, 2, 1, 77, 200, 64, True), (1, 2, 2, 33, 95, 64, False),
    (1, 2, 1, 1, 128, 64, True), (1, 2, 2, 24, 16, 64, True),
]


@pytest.mark.parametrize("b,h,hk,sq,sk,d,causal", FWD_CASES)
def test_3xtf32_forward_holds_the_fp32_limit(b, h, hk, sq, sk, d, causal):
    """Against the Pallas kernel in interpret mode; a row that sees no key
    (causal, Sq > Sk) comes out 0 in both."""
    q, k, v = _inputs(sq * 7 + sk + d, b, h, hk, sq, sk, d)
    got, _ = _forward_all(q, k, v, causal)
    want = _pallas(q, k, v, causal)
    np.testing.assert_allclose(got, want, **FLASH_FP32_TOL)
    if causal and sq > sk:
        assert not got[:, :, :sq - sk].any()
        assert not want[:, :, :sq - sk].any()


def test_3xtf32_forward_at_a_1024_long_sum():
    """qwen2-0.5b's 1024 keys at one head, inputs scaled by 3 (wider
    logits): within ``FLASH_FP32_PATH_TOL``, the limit of the card's
    1024-long sums."""
    q, k, v = _inputs(5, 1, 2, 1, 1024, 1024, 64, spread=3.0)
    got, _ = _forward_all(q, k, v, True)
    np.testing.assert_allclose(got, _pallas(q, k, v, True),
                               **FLASH_FP32_PATH_TOL)


def test_one_tf32_product_misses_the_fp32_limit():
    """Why three products: with ``hi*hi`` alone (q and P rounded to 10
    mantissa bits) the forward leaves 3e-5 of the reference, at a shape
    where three products stay inside it."""
    q, k, v = _inputs(3, 1, 4, 2, 256, 256, 64)
    want = _pallas(q, k, v, True)
    three, _ = _forward_all(q, k, v, True)
    one, _ = _forward_all(q, k, v, True, terms=1)
    tol = FLASH_FP32_TOL
    np.testing.assert_allclose(three, want, **tol)
    assert not np.allclose(one, want, **tol)
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                  1 + 2.0 ** -11 - 2.0 ** -23], np.float32)
    assert list(tf32(x)) == [one + ulp, one + 2 * ulp, -(one + ulp), one]
    hi, lo = split(np.float32(np.pi))
    assert abs(float(hi) + float(lo) - float(np.float32(np.pi))) <= \
        2.0 ** -22 * np.pi


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of ``x``, zero past its end."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    part = x[r0:r0 + n]
    out[:len(part)] = part
    return out


def emulate_backward(q, k, v, o, lse, do, causal, split_heads):
    """The float32 backward kernels: ``(dq, dk, dv)``."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group, offset = h // hk, sk - sq
    scale = np.float32(1.0 / math.sqrt(d))
    delta = (do * o).sum(-1, dtype=np.float32)
    lse = np.where(np.isfinite(lse), lse, np.float32(np.inf))   # p = 0

    def p_of(s, lse_r, valid):
        with np.errstate(over="ignore", invalid="ignore"):
            p = np.exp((s * scale).astype(np.float32) - lse_r)
        return np.where(valid, p, 0).astype(np.float32)

    def dkdv(bb, heads, kh, k0):
        keys = k0 + np.arange(ROWS)
        kt, vt = _rows(k[bb, kh], k0, ROWS), _rows(v[bb, kh], k0, ROWS)
        first = 0
        if causal and k0 - offset > 0:
            first = (k0 - offset) // ROWS * ROWS
        dk_, dv_ = np.zeros_like(kt), np.zeros_like(vt)
        for hh in heads:
            for i0 in range(first, sq, ROWS):
                rows = i0 + np.arange(ROWS)
                qt, dot = _rows(q[bb, hh], i0, ROWS), _rows(do[bb, hh], i0,
                                                             ROWS)
                valid = ((keys[:, None] < sk) & (rows[None, :] < sq)
                         & ((not causal)
                            | (rows[None, :] + offset >= keys[:, None])))
                zero = np.zeros((ROWS, ROWS), np.float32)
                st = mma(kt, qt.T, zero)
                dpt = mma(vt, dot.T, zero)
                pt = p_of(st, _rows(lse[bb, hh], i0, ROWS)[None, :], valid)
                dst = (pt * (dpt - _rows(delta[bb, hh], i0, ROWS)[None, :])
                       ).astype(np.float32)
                dv_ = mma(pt, dot, dv_)
                dk_ = mma(dst, qt, dk_)
        return (dk_ * scale).astype(np.float32), dv_

    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bb in range(b):
        for kh in range(hk):
            heads = range(kh * group, (kh + 1) * group)
            for k0 in range(0, sk, ROWS):
                n = min(ROWS, sk - k0)
                if split_heads:              # fp32 partials, head order
                    parts = [dkdv(bb, [hh], kh, k0) for hh in heads]
                    bk, bv = parts[0]
                    for pk, pv in parts[1:]:
                        bk = (bk + pk).astype(np.float32)
                        bv = (bv + pv).astype(np.float32)
                else:
                    bk, bv = dkdv(bb, heads, kh, k0)
                dk[bb, kh, k0:k0 + n], dv[bb, kh, k0:k0 + n] = bk[:n], bv[:n]
    dq = np.zeros_like(q)
    bk = kv_rows(d)
    for bb in range(b):
        for hh in range(h):
            kh = hh // group
            for q0 in range(0, sq, ROWS):
                rows = q0 + np.arange(ROWS)
                qt, dot = _rows(q[bb, hh], q0, ROWS), _rows(do[bb, hh], q0,
                                                             ROWS)
                lse_r = _rows(lse[bb, hh], q0, ROWS)[:, None]
                dl_r = _rows(delta[bb, hh], q0, ROWS)[:, None]
                acc = np.zeros_like(qt)
                for k0 in range(0, sk, bk):
                    keys = k0 + np.arange(bk)
                    if causal and k0 > min(q0 + ROWS, sq) - 1 + offset:
                        break                     # past the block's diagonal
                    kt, vt = _rows(k[bb, kh], k0, bk), _rows(v[bb, kh], k0,
                                                             bk)
                    valid = ((keys[None, :] < sk) & (rows[:, None] < sq)
                             & ((not causal)
                                | (rows[:, None] + offset >= keys[None, :])))
                    zero = np.zeros((ROWS, bk), np.float32)
                    p = p_of(mma(qt, kt.T, zero), lse_r, valid)
                    ds = (p * (mma(dot, vt.T, zero) - dl_r)).astype(
                        np.float32)
                    acc = mma(ds, kt, acc)
                n = min(ROWS, sq - q0)
                dq[bb, hh, q0:q0 + n] = (acc * scale)[:n]
    return dq, dk, dv


def _reference_grads(q, k, v, do, causal):
    """``jax.vjp`` of the reference's plain attention (kv heads repeated,
    so their gradient sums over the q heads that share them)."""
    group = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jref.flash_attention_ref(
            q, jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1),
            causal=causal)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


BWD_CASES = [  # (B, H, Hkv, Sq, Sk, D, causal)
    (1, 2, 2, 150, 150, 64, False),         # whisper's encoder, reduced
    (1, 2, 2, 40, 150, 64, False),          # whisper's cross attention
    (1, 4, 1, 100, 96, 128, False),         # the vision cross attention
    (1, 7, 1, 130, 130, 64, True),          # qwen2's causal self attention
    (1, 4, 2, 70, 33, 64, True),
    (1, 2, 1, 65, 129, 128, True),
]


# both ways of the GQA sum where q heads share a kv head
BWD_PARAMS = [(s, False) for s in BWD_CASES] + [
    (s, True) for s in BWD_CASES if s[1] != s[2]]


@pytest.mark.parametrize("shape,split_heads", BWD_PARAMS)
def test_3xtf32_backward_holds_the_fp32_limit(shape, split_heads):
    """Rows that see no key (causal, Sq > Sk: NaN in the reference) get no
    gradient from the kernels; the reference is taken on the rows that see
    one (the causal diagonal stays where it was)."""
    b, h, hk, sq, sk, d, causal = shape
    q, k, v = _inputs(sum(shape[:6]), b, h, hk, sq, sk, d)
    do = np.random.default_rng(sq).standard_normal(q.shape).astype(
        np.float32)
    o, lse = _forward_all(q, k, v, causal)
    got = list(emulate_backward(q, k, v, o, lse, do, causal, split_heads))
    first = max(sq - sk, 0) if causal else 0
    assert not got[0][:, :, :first].any()
    got[0] = got[0][:, :, first:]
    _, want = _reference_grads(q[:, :, first:], k, v, do[:, :, first:],
                               causal)
    rtol, step = FLASH_BWD_FP32_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=step * np.abs(w).max(),
                                   err_msg=f"{name} at {shape}")
