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

The limit is ``SSD_TOL`` (``tests/_torch_card.py``), ``(rtol, share of
the largest entry)`` = ``(1e-4, 1e-5)``: the kernels sum in float32 (up
to 256 terms a product, and dS over 56 heads) with each product as three
TF32 ones, whose left-out ``lo * lo`` term is 2^-22 of a product; the
plain versions sum the same terms in float32 in another order.

Run on a machine with the card, from the root of the checkout::

    PYTHONPATH=src python -m pytest -q -m card \\
        tests/test_torch_ssd_chunk_card.py
"""
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from benchmarks.torch_kernel_ab import (SSD_SHAPE, packed_ids, returning_ids,
                                        ssd_inputs)
from repro_torch.configs import zamba2_7b
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as sk
from repro_torch.models import ssm

from _torch_card import SSD_TOL, assert_within, bits, by_row, card

pytestmark = pytest.mark.card

SMALL = (3, 384, 192, 1, 11, 64, 128)


def _inputs(shape, seed, runs=True):
    """``ssd_inputs`` and a dY of x's shape."""
    cc, bc, xf, da_cum, rc = ssd_inputs(shape, seed, runs)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cc, bc, xf, da_cum, rc, torch.randn(xf.shape, generator=gen,
                                               device="cuda")


@pytest.mark.parametrize("shape,runs", [(SSD_SHAPE, True),
                                        (SMALL, True), (SMALL, False)])
def test_kernels_are_the_plain_versions(card, shape, runs):
    cc, bc, xf, da_cum, rc, dy = _inputs(shape, seed=1, runs=runs)
    extra = () if rc is None else (rc,)
    y = sk.ssd_chunk_fwd(cc, bc, xf, da_cum, rc)
    want = by_row(lambda *t: (ref.ssd_chunk_ref(*t),), cc, bc, xf, da_cum,
                  *extra)[0]
    assert_within(y, want, SSD_TOL, "y")
    del want
    got = sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy, rc)
    want = by_row(ref.ssd_chunk_bwd_ref, cc, bc, xf, da_cum, dy, *extra)
    for what, g, w in zip(("dC", "dB", "dX", "dA"), got, want):
        assert_within(g, w, SSD_TOL, what)


@pytest.mark.parametrize("shape", [SSD_SHAPE, SMALL])
def test_state_kernels_are_the_plain_versions(card, shape):
    """gather, apply (with and without a base) and cross against
    ``ref.ssd_gather_ref`` / ``ssd_apply_ref`` / ``ssd_cross_ref``, with
    weights in (0, 1] and a random entering state."""
    cc, bc, xf, da_cum, _, dy = _inputs(shape, seed=7, runs=False)
    w = torch.exp(da_cum[:, :, -1:] - da_cum)
    gen = torch.Generator(device=card).manual_seed(8)
    wm = torch.randn(xf.shape[:2] + xf.shape[3:] + cc.shape[-1:],
                     generator=gen, device=card) * 0.1
    assert_within(sk.ssd_gather(xf, bc, w), ref.ssd_gather_ref(xf, bc, w),
                  SSD_TOL, "gather")
    for base in (None, dy):
        assert_within(sk.ssd_apply(cc, wm, w, base),
                      ref.ssd_apply_ref(cc, wm, w, base), SSD_TOL, "apply")
    for what, got, want in zip(("dV", "dw"), sk.ssd_cross(dy, wm, cc, w),
                               ref.ssd_cross_ref(dy, wm, cc, w)):
        assert_within(got, want, SSD_TOL, what)


@pytest.mark.parametrize("shape", [SSD_SHAPE, SMALL])
def test_all_equal_runs_are_bit_equal_to_no_runs(card, shape):
    cc, bc, xf, da_cum, rc, dy = _inputs(shape, seed=2)
    same = torch.full_like(rc, 3)
    plain = (sk.ssd_chunk_fwd(cc, bc, xf, da_cum),
             *sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy))
    seg = (sk.ssd_chunk_fwd(cc, bc, xf, da_cum, same),
           *sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy, same))
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(plain, seg))


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
    ids = returning_ids(b, s, 4, device="cpu") if with_ids else None

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
    ids = packed_ids(2, 4096, 6)
    before = ssm.ssd_chunked.kernel
    out = checkpoint(lambda x: ssm.mamba_mixer(params, x, cfg,
                                               segment_ids=ids)[0],
                     hidden, use_reentrant=False)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert ssm.ssd_chunked.kernel - before == 2
    assert torch.isfinite(hidden.grad).all()
