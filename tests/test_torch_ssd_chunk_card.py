"""The SSD kernels on the card (skipped without one).

``csrc/ssd_chunk.cu`` (``kernels/ssd_chunk.py``) held against the plain
versions ``ref.ssd_chunk_ref`` / ``ssd_chunk_bwd_ref`` (which the CPU tests
hold equal to the einsum route in float64), in float32 on the card with
TF32 off:

* at Zamba2-7B's training shape, ``(4, 4096)``, chunk 256, 2 groups of 56
  heads of 64, state 64, runs of ``pack_documents`` rows of Poisson-512
  documents;
* at a ragged small shape: 3 tiles a chunk, 11 heads a group (a block of 8
  and one of 3), state 128, one group, short documents whose ids come back
  and pads; and the same without runs;
* ``ssd_chunked`` on the card on the kernels' route, with S not a
  multiple of the chunk, against the same scan in float64;
* the state kernels (gather, apply, cross) against their plain versions;
* a call whose runs are all equal is bit-equal to the call without runs,
  forward and backward;
* ``mamba_mixer`` at Zamba2-7B's widths counts every call in
  ``ssd_chunked.kernel``, remat's recompute again.

The limit, ``(rtol, share of the largest entry)`` = ``(1e-4, 1e-5)``: the
kernels sum in float32 (up to 256 terms a product, and dS over 56 heads)
with each product as three TF32 ones, whose left-out ``lo * lo`` term is
2^-22 of a product; the plain versions sum the same terms in float32 in
another order.  ``chip_smoke.py`` (``check_ssd_chunk``) holds the same
limit.

Run on a machine with the card, from the root of the checkout::

    PYTHONPATH=src python -m pytest -q -m card \\
        tests/test_torch_ssd_chunk_card.py
"""
import math

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import zamba2_7b
from repro_torch.core.packing import pack_documents
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as sk
from repro_torch.models import ssm

pytestmark = pytest.mark.card

TOL = (1e-4, 1e-5)
CELL = (4, 4096, 256, 2, 56, 64, 64)      # B, S, chunk, G, heads a group, P, N
SMALL = (3, 384, 192, 1, 11, 64, 128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the SSD kernels run only on one")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _ids(b: int, s: int, seed: int) -> np.ndarray:
    """Packed rows of Poisson-512 documents at the cell's length; short
    documents with ids that come back and pads (0) below it."""
    rng = np.random.default_rng(seed)
    if s >= 4096:
        docs = [np.zeros(max(16, int(rng.poisson(512))), np.int32)
                for _ in range(4 * b * s // 512)]
        return pack_documents(docs, s)[1][:b]
    return np.stack([np.repeat(np.arange(s) % 5,
                               rng.integers(5, 80, size=s))[:s]
                     for _ in range(b)])


def _inputs(shape, device, seed, runs=True):
    b, s, cs, g, hg, p, n = shape
    nc = s // cs
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*size):
        return torch.randn(*size, generator=gen, device=device)

    cc, bc = (draw(b, nc, cs, g, n) * 0.5 for _ in range(2))
    dt = torch.nn.functional.softplus(draw(b, nc, cs, g, hg) - 2)
    xf = draw(b, nc, cs, g, hg, p) * dt[..., None]
    da_cum = torch.cumsum(dt * -math.e, 2)
    rc = None
    if runs:
        ids = torch.from_numpy(_ids(b, s, seed).astype(np.int32)).to(device)
        rc = ssm.document_runs(ids).view(b, nc, cs)
    return cc, bc, xf, da_cum, rc, draw(*xf.shape)


def _close(got, want, what):
    rtol, step = TOL
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=step * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


def _by_row(fn, *tensors):
    """``fn`` one batch row at a time (the plain versions' decay blocks of
    the whole cell take several GB each)."""
    outs = [fn(*(t[i:i + 1] for t in tensors))
            for i in range(tensors[0].shape[0])]
    return [torch.cat(parts) for parts in zip(*outs)]


@pytest.mark.parametrize("shape,runs", [(CELL, True), (SMALL, True),
                                        (SMALL, False)])
def test_kernels_are_the_plain_versions(card, shape, runs):
    cc, bc, xf, da_cum, rc, dy = _inputs(shape, card, seed=1, runs=runs)
    extra = () if rc is None else (rc,)
    y = sk.ssd_chunk_fwd(cc, bc, xf, da_cum, rc)
    want = _by_row(lambda *t: (ref.ssd_chunk_ref(*t),), cc, bc, xf, da_cum,
                   *extra)[0]
    _close(y, want, "y")
    del want
    got = sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy, rc)
    want = _by_row(ref.ssd_chunk_bwd_ref, cc, bc, xf, da_cum, dy, *extra)
    for what, g, w in zip(("dC", "dB", "dX", "dA"), got, want):
        _close(g, w, what)


@pytest.mark.parametrize("shape", [CELL, SMALL])
def test_state_kernels_are_the_plain_versions(card, shape):
    """gather, apply (with and without a base) and cross against
    ``ref.ssd_gather_ref`` / ``ssd_apply_ref`` / ``ssd_cross_ref``, with
    weights in (0, 1] and a random entering state."""
    cc, bc, xf, da_cum, _, dy = _inputs(shape, card, seed=7, runs=False)
    w = torch.exp(da_cum[:, :, -1:] - da_cum)
    gen = torch.Generator(device=card).manual_seed(8)
    wm = torch.randn(xf.shape[:2] + xf.shape[3:] + cc.shape[-1:],
                     generator=gen, device=card) * 0.1
    _close(sk.ssd_gather(xf, bc, w), ref.ssd_gather_ref(xf, bc, w), "gather")
    for base in (None, dy):
        _close(sk.ssd_apply(cc, wm, w, base),
               ref.ssd_apply_ref(cc, wm, w, base), "apply")
    for what, got, want in zip(("dV", "dw"), sk.ssd_cross(dy, wm, cc, w),
                               ref.ssd_cross_ref(dy, wm, cc, w)):
        _close(got, want, what)


@pytest.mark.parametrize("shape", [CELL, SMALL])
def test_all_equal_runs_are_bit_equal_to_no_runs(card, shape):
    cc, bc, xf, da_cum, rc, dy = _inputs(shape, card, seed=2)
    same = torch.full_like(rc, 3)
    plain = (sk.ssd_chunk_fwd(cc, bc, xf, da_cum),
             *sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy))
    seg = (sk.ssd_chunk_fwd(cc, bc, xf, da_cum, same),
           *sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy, same))
    assert all(torch.equal(a, b) for a, b in zip(plain, seg))


@pytest.mark.parametrize("with_ids", [False, True])
def test_ssd_chunked_takes_the_kernel_on_the_card(card, with_ids):
    """The whole scan, S = 1000 (not a multiple of 256), on the kernels'
    route: output, state and every gradient against the same scan in
    float64 (the einsum route on the CPU with its float32 casts made
    float64), within 1e-4 of the largest entry.  Both float32 routes sit
    1e-6 to 7e-5 of the largest entry from float64 here (the gradients
    sum through the decay and the recurrence); the einsum route on the
    card read up to 7.1e-5 (the gradient of dt), the kernels' route up to
    3.3e-5, so the two are not held to each other."""
    gen = torch.Generator(device=card).manual_seed(3)
    b, s, h, g, n = 2, 1000, 6, 2, 64
    args = [torch.randn(b, s, h, 64, generator=gen, device=card),
            torch.nn.functional.softplus(
                torch.randn(b, s, h, generator=gen, device=card) - 1),
            torch.randn(h, generator=gen, device=card) * 0.3,
            torch.randn(b, s, g, n, generator=gen, device=card) * 0.5,
            torch.randn(b, s, g, n, generator=gen, device=card) * 0.5]
    ids = (torch.from_numpy(_ids(b, s, 4).astype(np.int32))
           if with_ids else None)

    def scan(tensors, segment_ids):
        leaves = [t.detach().clone().requires_grad_() for t in tensors]
        y, state = ssm.ssd_chunked(*leaves, 256, segment_ids=segment_ids)
        loss = (y * torch.cos(y)).sum() + state.sum()
        return [y, state, *torch.autograd.grad(loss, leaves)]

    before = ssm.ssd_chunked.kernel
    got = scan(args, None if ids is None else ids.to(card))
    assert ssm.ssd_chunked.kernel - before == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda t: t.double())
        want = scan([t.cpu().double() for t in args], ids)
    for what, k, w in zip(("y", "state", "dx", "ddt", "da_log", "db", "dc"),
                          got, want):
        w = w.detach()
        top = float(w.abs().max())
        torch.testing.assert_close(k.detach().cpu().double(), w, rtol=1e-4,
                                   atol=1e-4 * top,
                                   msg=lambda m, what=what: f"{what}: {m}")


def test_mamba_mixer_at_zamba2_widths_counts_every_call(card):
    """One Zamba2-7B Mamba2 mixer (d 3584, 112 heads of 64, ngroups 2,
    state 64, chunk 256) on 2 x 4096 packed tokens, checkpointed as the
    model's remat does: the forward and its recompute both take the
    kernels."""
    cfg = zamba2_7b.CONFIG
    gen = torch.Generator(device=card).manual_seed(5)
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_ngroups * cfg.ssm_state

    def w(*size):
        return (torch.randn(*size, generator=gen, device=card) * 0.02
                ).bfloat16().requires_grad_()

    params = dict(w_zx=w(d, 2 * din), w_bc=w(d, 2 * gn), w_dt=w(d, h),
                  dt_bias=w(h), conv_w=w(cfg.ssm_conv, din + 2 * gn),
                  conv_b=w(din + 2 * gn), a_log=w(h), d_skip=w(h),
                  gate_norm=w(din), w_out=w(din, d))
    hidden = w(2, 4096, d)
    ids = torch.from_numpy(_ids(2, 4096, 6).astype(np.int32)).to(card)
    before = ssm.ssd_chunked.kernel
    out = checkpoint(lambda x: ssm.mamba_mixer(params, x, cfg,
                                               segment_ids=ids)[0],
                     hidden, use_reentrant=False)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert ssm.ssd_chunked.kernel - before == 2
    assert torch.isfinite(hidden.grad).all()
