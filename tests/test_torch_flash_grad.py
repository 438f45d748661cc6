"""The flash route's gradient on the CPU.

* ``kernels.ref.flash_attention_bwd_ref`` (the plain backward: what the
  backward kernels compute, and what ``FlashAttentionFn`` runs on a CPU
  tensor) against ``jax.vjp`` of the reference's oracle
  ``repro.kernels.ref.flash_attention_ref`` and of its model attention
  ``repro.models.attention.chunked_attention``: causal and not, GQA, ragged
  ``Sq != Sk`` both ways, D 64 and 128.  float32, ``rtol = atol = 2e-5``
  (the same products summed in other orders; the forward's own tolerance
  is 3e-5).  A row that sees no key (causal, ``Sq > Sk``: NaN in the
  reference) has no gradient in the port; the reference is compared on the
  rows that see a key.
* ``torch.autograd.gradcheck`` of ``FlashAttentionFn``'s CPU path in
  float64 (its saved tensors, the GQA sum, the scale).
* The float32 backward kernels' loops (``csrc/flash_attention_bwd.cu``,
  ``flash_bwd_{dkdv,dq}_tf32_kernel``: 64-row K blocks over 64-row q
  tiles from the causal diagonal on, the q heads of a kv head in order;
  64-row q blocks over K tiles of 64 rows, 32 at D = 128, up to it)
  emulated in NumPy against the plain backward, products in fp32; their
  3xTF32 products are emulated in ``tests/test_torch_tf32_numerics.py``,
  the bf16 tensor-core kernels in ``tests/test_torch_flash_bwd_mma.py``.
* ``LM.loss`` through the flash route: the reduced dense, vlm and encdec
  configs at ``head_dim=64``, with and without ``segment_ids``, against
  ``jax.value_and_grad`` of the reference's loss (its plain attention, its
  training path; with ids the reference's attention is plain, the port's
  the flash route with the ids), with the flash calls of the forward, of
  the remat recompute and of the backward counted exactly.

The kernels themselves run only on the card:
``tests/test_torch_flash_card.py`` and
``tests/test_torch_flash_segments_card.py`` hold them against the same
plain versions there.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as jref
from repro.models import attention as ref_attention

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import attention

from _torch_train import (check_against_reference, port_loss,
                          reference_params, train_batch)

TOL = dict(rtol=2e-5, atol=2e-5)
# (B, H, Hkv, Sq, Sk, D, causal)
SHAPES = [(2, 4, 2, 40, 40, 64, True), (2, 4, 4, 40, 40, 64, False),
          (1, 6, 2, 17, 70, 64, True), (1, 6, 3, 33, 95, 128, False),
          (2, 2, 1, 70, 33, 64, True), (1, 4, 1, 65, 129, 128, True),
          (2, 3, 1, 50, 21, 128, False)]


def _inputs(shape, seed=0):
    b, h, hk, sq, sk, d, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d),
                      (b, h, sq, d))]


def _port_grads(q, k, v, do, causal):
    o, lse = ref.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
    return [g.numpy() for g in ref.flash_attention_bwd_ref(
        *map(torch.from_numpy, (q, k, v)), o, lse, torch.from_numpy(do),
        causal=causal)], lse.numpy()


def _seen(sq, sk, causal):
    """The first q row that sees a key."""
    return max(sq - sk, 0) if causal else 0


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp_of_the_oracle(shape):
    _, h, hk, sq, sk, _, causal = shape
    q, k, v, do = _inputs(shape)
    (dq, dk, dv), lse = _port_grads(q, k, v, do, causal)
    first = _seen(sq, sk, causal)
    g = h // hk

    def oracle(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, g, axis=1),
                                        jnp.repeat(v, g, axis=1),
                                        causal=causal)

    # the rows that see a key, as their own problem (the causal diagonal
    # of the cut problem sits where it sat)
    _, vjp = jax.vjp(oracle, jnp.asarray(q[:, :, first:]), jnp.asarray(k),
                     jnp.asarray(v))
    wq, wk, wv = vjp(jnp.asarray(do[:, :, first:]))
    np.testing.assert_allclose(dq[:, :, first:], wq, **TOL)
    np.testing.assert_allclose(dk, wk, **TOL)
    np.testing.assert_allclose(dv, wv, **TOL)
    # the rows that see no key: lse -inf, no gradient
    assert np.all(np.isneginf(lse[:, :, :first]))
    assert not np.any(dq[:, :, :first])


@pytest.mark.parametrize("shape", [s for s in SHAPES
                                   if not (s[6] and s[3] > s[4])])
def test_plain_backward_matches_jax_vjp_of_chunked_attention(shape):
    """The reference model's attention, (B, S, H, D) with GQA grouped and
    the query chunks checkpointed, differentiated by JAX."""
    _, _, _, sq, _, _, causal = shape
    q, k, v, do = _inputs(shape, seed=1)
    (dq, dk, dv), _ = _port_grads(q, k, v, do, causal)
    t = (lambda x: jnp.asarray(x.transpose(0, 2, 1, 3)))
    _, vjp = jax.vjp(lambda q, k, v: ref_attention.chunked_attention(
        q, k, v, causal=causal, chunk=32), t(q), t(k), t(v))
    for got, want in zip((dq, dk, dv), vjp(t(do))):
        np.testing.assert_allclose(got, np.asarray(want).transpose(
            0, 2, 1, 3), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,h,hk", [(5, 7, 4, 2), (6, 6, 3, 3),
                                        (7, 5, 2, 1)])
def test_function_gradcheck_float64(causal, sq, sk, h, hk):
    if causal and sq > sk:        # rows with no key: NaN in the forward
        sq = sk
    gen = torch.Generator().manual_seed(sq * 10 + sk)
    q, k, v = (torch.randn(1, n, s, 64, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for n, s in ((h, sq), (hk, sk), (hk, sk)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttentionFn.apply(q, k, v, causal, 0.3),
        (q, k, v), fast_mode=True)


def test_the_function_runs_where_autograd_records():
    """With an input that requires a gradient the wrapper goes through
    ``FlashAttentionFn`` (whose backward is ``flash_attention_bwd``), and
    equals autograd through the plain forward; without one it builds no
    graph.  A row that sees no key gets no gradient."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 9, 64, generator=gen, requires_grad=True)
    k, v = (torch.randn(2, 2, 6, 64, generator=gen, requires_grad=True)
            for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    do = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out[:, :, 3:], (q, k, v), do[:, :, 3:],
                              retain_graph=True)
    # the plain forward's NaN rows (3 of them: 9 over 6 keys) make autograd
    # through it NaN: the rows that see a key, as their own problem
    qs = q.detach()[:, :, 3:].requires_grad_()
    plain = ref.flash_attention_ref(qs, k, v, causal=True)
    want = torch.autograd.grad(plain, (qs, k, v), do[:, :, 3:])
    np.testing.assert_allclose(got[0][:, :, 3:].numpy(), want[0].numpy(),
                               **TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    (dq,) = torch.autograd.grad(out, (q,), torch.where(
        torch.isnan(out), 0.0, do))
    assert not dq[:, :, :3].any() and dq[:, :, 3:].abs().sum() > 0
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# the backward kernels' loops, emulated
# ---------------------------------------------------------------------------

KROWS, QTILE, QROWS = 64, 64, 64


def _ktile(d):
    """K rows a staged tile of the dQ kernel (``ftb_kv_rows``)."""
    return 64 if d == 64 else 32


def emulate_backward(q, k, v, o, lse, do, causal, scale):
    """The float32 ``flash_bwd_{delta,dkdv,dq}`` kernels block by block: the
    same tiles, loop bounds, masks and GQA order."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group, offset = h // hk, sk - sq
    ktile = _ktile(d)
    delta = (do * o).sum(-1)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bb in range(b):
        for kh in range(hk):
            for k0 in range(0, sk, KROWS):
                keys = np.arange(k0, min(k0 + KROWS, sk))
                kr, vr = k[bb, kh, keys], v[bb, kh, keys]
                dkr, dvr = np.zeros_like(kr), np.zeros_like(vr)
                first = 0
                if causal and k0 - offset > 0:
                    first = (k0 - offset) // QTILE * QTILE
                for gi in range(group):
                    hh = kh * group + gi
                    for i0 in range(first, sq, QTILE):
                        rows = np.arange(i0, min(i0 + QTILE, sq))
                        qt, dt = q[bb, hh, rows], do[bb, hh, rows]
                        s = qt @ kr.T
                        dp = dt @ vr.T
                        valid = np.ones(s.shape, bool)
                        if causal:
                            valid = rows[:, None] + offset >= keys[None, :]
                        p = np.where(valid, np.exp(
                            s * scale - lse[bb, hh, rows][:, None]), 0.0)
                        ds = p * (dp - delta[bb, hh, rows][:, None])
                        dvr += p.T @ dt
                        dkr += ds.T @ qt
                dk[bb, kh, keys] = dkr * scale
                dv[bb, kh, keys] = dvr
    dq = np.zeros_like(q)
    for bb in range(b):
        for hh in range(h):
            kh = hh // group
            for q0 in range(0, sq, QROWS):
                rows = np.arange(q0, min(q0 + QROWS, sq))
                nk = -(-sk // ktile)
                upper = nk
                if causal:
                    last = rows[-1] + offset
                    upper = 0 if last < 0 else min(last // ktile + 1, nk)
                qr, dr = q[bb, hh, rows], do[bb, hh, rows]
                acc = np.zeros_like(qr)
                for j in range(upper):
                    keys = np.arange(j * ktile, min((j + 1) * ktile, sk))
                    kt, vt = k[bb, kh, keys], v[bb, kh, keys]
                    valid = np.ones((len(rows), len(keys)), bool)
                    if causal:
                        valid = rows[:, None] + offset >= keys[None, :]
                    p = np.where(valid, np.exp(qr @ kt.T * scale -
                                               lse[bb, hh, rows][:, None]),
                                 0.0)
                    acc += (p * (dr @ vt.T - delta[bb, hh, rows][:, None])
                            ) @ kt
                dq[bb, hh, rows] = acc * scale
    return dq, dk, dv


@pytest.mark.parametrize("shape", SHAPES + [(1, 2, 1, 130, 200, 64, True),
                                            (1, 2, 2, 200, 130, 128, True)])
def test_backward_kernel_loops_emulated(shape):
    _, _, _, sq, sk, d, causal = shape
    q, k, v, do = _inputs(shape, seed=2)
    o, lse = ref.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
    # the kernel's forward gives 0 where the plain version gives NaN
    o = torch.nan_to_num(o, nan=0.0).numpy()
    want = ref.flash_attention_bwd_ref(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(o), lse,
        torch.from_numpy(do), causal=causal)
    with np.errstate(invalid="ignore", over="ignore"):
        got = emulate_backward(q, k, v, o, lse.numpy(), do, causal,
                               1.0 / math.sqrt(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL)


# ---------------------------------------------------------------------------
# LM.loss through the flash route
# ---------------------------------------------------------------------------

FLASH_ARCHS = ("qwen2-0.5b", "llama-3.2-vision-11b", "whisper-base")


def flash_calls(cfg, segments):
    """Flash calls of one loss: (forward, remat recompute, backward).  Self
    attention takes the route with and without segment ids (whisper's
    decoder never passes them), cross attention and whisper's encoder
    always; with remat the checkpointed layers (every decoder layer; not
    whisper's encoder) run their attention again in the backward."""
    L = cfg.num_layers
    self_attn = L
    cross = {"vlm": L // max(cfg.cross_attn_every, 1),
             "encdec": L}.get(cfg.family, 0)
    enc = cfg.encoder_layers if cfg.family == "encdec" else 0
    forward = self_attn + cross + enc
    recompute = (self_attn + cross) if cfg.remat != "none" else 0
    return forward, recompute, forward


@pytest.mark.parametrize("segments", [True, False])
@pytest.mark.parametrize("arch", FLASH_ARCHS)
def test_loss_through_the_flash_route_matches_the_reference(
        arch, segments, monkeypatch):
    cfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                              head_dim=64)
    counts = {"fwd": 0, "bwd": 0, "fwd_ids": 0, "bwd_ids": 0}
    fwd, bwd = kops.flash_attention, fa.flash_attention_bwd

    def counting_fwd(*args, **kwargs):
        counts["fwd"] += 1
        counts["fwd_ids"] += kwargs.get("segment_ids") is not None
        return fwd(*args, **kwargs)

    def counting_bwd(*args, **kwargs):
        counts["bwd"] += 1
        counts["bwd_ids"] += kwargs.get("segment_ids") is not None
        return bwd(*args, **kwargs)

    monkeypatch.setattr(kops, "flash_attention", counting_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", counting_bwd)
    plain = attention.chunked_attention.plain_chunks
    batch = train_batch(cfg, seed=4, segments=segments)
    check_against_reference(cfg, batch)
    forward, recompute, backward = flash_calls(cfg, segments)
    # packed batches take the flash route with their ids in every self
    # attention but whisper's (its decoder passes none), and no plain chunk
    with_ids = segments and cfg.family != "encdec"
    L = cfg.num_layers
    assert counts == {"fwd": forward + recompute, "bwd": backward,
                      "fwd_ids": L * (1 + (cfg.remat != "none"))
                      if with_ids else 0,
                      "bwd_ids": L if with_ids else 0}, counts
    assert attention.chunked_attention.plain_chunks == plain


def test_flash_route_counts_without_remat(monkeypatch):
    """remat "none": no recompute, the same loss bit for bit."""
    cfg = dataclasses.replace(ref_get_config("whisper-base", reduced=True),
                              head_dim=64)
    params, batch = reference_params(cfg), train_batch(cfg, seed=5)
    full = port_loss(cfg, params, batch)
    calls = []
    fwd = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    none = port_loss(dataclasses.replace(cfg, remat="none"), params, batch)
    # 2 encoder layers, 2 decoder layers' self and cross attention
    assert len(calls) == flash_calls(dataclasses.replace(
        cfg, remat="none"), True)[0] == 6
    assert torch.equal(full[0], none[0])
    for path, g in full[2].items():
        assert torch.equal(g, none[2][path]), path
