"""Mamba2's chunked scan (SSD) on Hopper: the intra-chunk term, forward
and backward, and the chunk states' products.

Replaces no TPU kernel: the reference computes Mamba2's chunked scan
(``repro/models/ssm.py::ssd_chunked``) as einsums over an ``(L, L)`` decay
matrix per head, and the port's plain route (``models/ssm.py``) keeps that
code for the CPU.  On the card those einsums write and read ``(B, C, G, H,
L, L)`` float32 blocks, 1.9 GB a call at Zamba2-7B's training shape, in a
dozen elementwise passes each way.  ``csrc/ssd_chunk.cu`` computes the
diagonal-block term without writing an ``L x L`` block: ``S = C B^T`` once
a group, the decay ``exp(A[l] - A[s])`` and the mask on chip, ``y = (S o
L_h) X_h`` on the tensor cores as three TF32 products each (float32
arithmetic, as the fp32 flash kernels); the backward recomputes ``S`` and
the decay and gives ``dX``, ``dS`` (then ``dC = dS B`` and ``dB = dS^T C``
here, two small products) and ``dA`` (the row sum less the column sum of
``dM o M``).  The source's header has the design and the bound.

Run ids ``(B, C, L)`` (``models.ssm.document_runs`` cut into chunks) mask
each pair of two runs; a call without them runs kernels with no run test
(a template flag), so all-equal runs give the call without runs bit for
bit.

:class:`SsdChunkFn` saves only its inputs (``cc``, ``bc``, ``xf``,
``da_cum``, the runs), never a decay block.  The operators
``repro_torch::ssd_chunk_fwd`` / ``ssd_chunk_bwd`` take the kernels for a
CUDA tensor and the plain versions
(:func:`~repro_torch.kernels.ref.ssd_chunk_ref`,
:func:`~repro_torch.kernels.ref.ssd_chunk_bwd_ref`) for a CPU one; their
fake versions give the shapes, and their flop formulas count whole chunks,
as ``portbench``'s count of the model does.

The rest of the chunked scan but the 16-step recurrence is two linear
forms over the same rows, and their gradients are the same forms and one
more: ``ssd_gather`` (the state a chunk leaves), ``ssd_apply`` (the
entering state's term, added to ``y_diag``) and ``ssd_cross``, each one
kernel of ``csrc/ssd_chunk.cu`` with a per-row weight folded in, where
einsums would write and read (B, C, L, G, H, N) products and scaled copies
of 470 MB each.  :func:`ssd_states` and :func:`ssd_add_entering` (autograd
Functions :class:`SsdStatesFn`, :class:`SsdEnteringFn`) are what
``models/ssm.py`` calls.  Launches are counted in ``ssd_chunk.launches``,
``ssd_chunk.launches_bwd`` and ``ssd_chunk.launches_state``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import (ssd_apply_ref, ssd_chunk_bwd_ref, ssd_chunk_ref,
                  ssd_cross_ref, ssd_gather_ref)

#: Chunk lengths, head dims and state sizes the kernels take.
CHUNKS = (64, 128, 192, 256)
HEAD_DIMS = (64,)
STATES = (64, 128)
#: Rows of a tile (``SC_TILE``): ``dda``'s row half comes in one slot per
#: tile of the chunk.
TILE = 64

_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_STATE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])


def supports(chunk: int, head_dim: int, d_state: int) -> bool:
    """Whether the kernels take a scan of these sizes."""
    return chunk in CHUNKS and head_dim in HEAD_DIMS and d_state in STATES


def _entry(symbol: str, argtypes):
    fn = getattr(_build.load("ssd_chunk"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(cc: torch.Tensor, bc: torch.Tensor, xf: torch.Tensor,
           da_cum: torch.Tensor, runs: Optional[torch.Tensor]) -> None:
    """Raise on operands that do not fit each other, or that the kernels do
    not take on the card."""
    if cc.dim() != 5 or xf.dim() != 6:
        raise ValueError("cc, bc must be (B, C, L, G, N) and xf (B, C, L, G, "
                         "H, P)")
    bsz, nc, cs, g, n = cc.shape
    h, p = xf.shape[4], xf.shape[5]
    if bc.shape != cc.shape or xf.shape[:4] != cc.shape[:4] or \
            da_cum.shape != xf.shape[:5]:
        raise ValueError(f"cc {tuple(cc.shape)}, bc {tuple(bc.shape)}, xf "
                         f"{tuple(xf.shape)}, da_cum {tuple(da_cum.shape)} "
                         "do not fit")
    if runs is not None and (tuple(runs.shape) != (bsz, nc, cs)
                             or runs.dtype != torch.int32):
        raise ValueError(f"runs {tuple(runs.shape)} {runs.dtype}: need "
                         f"({bsz}, {nc}, {cs}) int32")
    operands = (cc, bc, xf, da_cum) + (() if runs is None else (runs,))
    if any(t.device != cc.device for t in operands):
        raise ValueError("the SSD operands must lie on one device")
    if cc.is_cuda:
        if any(t.dtype != torch.float32 for t in (cc, bc, xf, da_cum)):
            raise TypeError("the SSD kernels take float32 operands")
        if not supports(cs, p, n):
            raise ValueError(f"chunk {cs}, head dim {p}, state {n}: the "
                             f"kernels take chunks {CHUNKS}, head dims "
                             f"{HEAD_DIMS}, states {STATES}")


def _forward(cc, bc, xf, da_cum, runs=None):
    """One launch of the forward kernel on CUDA tensors (contiguous)."""
    y = torch.empty_like(xf)
    if y.numel() == 0:
        return y
    bsz, nc, cs, g, n = cc.shape
    with torch.cuda.device(cc.device):
        code = _entry("ssd_chunk_fwd_launch", _FWD_ARGTYPES)(
            cc.data_ptr(), bc.data_ptr(), xf.data_ptr(), da_cum.data_ptr(),
            0 if runs is None else runs.data_ptr(), y.data_ptr(), bsz * nc,
            g, xf.shape[4], cs, n, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssd_chunk")
    ssd_chunk.launches += 1
    return y


def _backward(cc, bc, xf, da_cum, dy, runs=None):
    """One call of the backward kernels on CUDA tensors (contiguous), then
    ``dC = dS B`` and ``dB = dS^T C`` and the sum of ``dA``'s parts."""
    bsz, nc, cs, g, n = cc.shape
    h = xf.shape[4]
    dxf = torch.empty_like(xf)
    da_cols = torch.empty_like(da_cum)
    ds = torch.zeros(bsz, nc, g, cs, cs, dtype=torch.float32,
                     device=cc.device)
    da_rows = torch.zeros((cs // TILE,) + tuple(da_cum.shape),
                          dtype=torch.float32, device=cc.device)
    if dxf.numel() == 0:
        return (torch.zeros_like(cc), torch.zeros_like(bc), dxf,
                torch.zeros_like(da_cum))
    with torch.cuda.device(cc.device):
        code = _entry("ssd_chunk_bwd_launch", _BWD_ARGTYPES)(
            cc.data_ptr(), bc.data_ptr(), xf.data_ptr(), da_cum.data_ptr(),
            0 if runs is None else runs.data_ptr(), dy.data_ptr(),
            dxf.data_ptr(), da_cols.data_ptr(), ds.data_ptr(),
            da_rows.data_ptr(), bsz * nc, g, h, cs, n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssd_chunk_bwd")
    ssd_chunk.launches_bwd += 1
    # (B, C, G, L, L) @ (B, C, G, L, N): each chunk's dS against B and C
    dcc = torch.matmul(ds, bc.transpose(2, 3)).transpose(2, 3)
    dbc = torch.matmul(ds.transpose(-1, -2), cc.transpose(2, 3)
                       ).transpose(2, 3)
    return (dcc.contiguous(), dbc.contiguous(), dxf,
            da_rows.sum(0) + da_cols)


# The kernels as operators (see kernels/flash_attention.py): CUDA launches
# the kernels, CPU runs the plain versions, the fake versions give shapes.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_chunk_fwd(Tensor cc, Tensor bc, Tensor xf, Tensor da_cum, "
            "Tensor? runs=None) -> Tensor")
_LIB.define("ssd_chunk_bwd(Tensor cc, Tensor bc, Tensor xf, Tensor da_cum, "
            "Tensor dy, Tensor? runs=None) -> (Tensor, Tensor, Tensor, "
            "Tensor)")
#: ``y_diag`` of the forward kernel.
ssd_chunk_fwd = torch.ops.repro_torch.ssd_chunk_fwd.default
#: ``(dcc, dbc, dxf, dda_cum)`` of the backward kernels.
ssd_chunk_bwd = torch.ops.repro_torch.ssd_chunk_bwd.default


def _fwd_fake(cc, bc, xf, da_cum, runs=None):
    return xf.new_empty(xf.shape)


def _bwd_fake(cc, bc, xf, da_cum, dy, runs=None):
    return (cc.new_empty(cc.shape), bc.new_empty(bc.shape),
            xf.new_empty(xf.shape), da_cum.new_empty(da_cum.shape))


_LIB.impl("ssd_chunk_fwd", _forward, "CUDA")
_LIB.impl("ssd_chunk_fwd", ssd_chunk_ref, "CPU")
torch.library.register_fake("repro_torch::ssd_chunk_fwd", _fwd_fake,
                            lib=_LIB)
_LIB.impl("ssd_chunk_bwd", _backward, "CUDA")
_LIB.impl("ssd_chunk_bwd", ssd_chunk_bwd_ref, "CPU")
torch.library.register_fake("repro_torch::ssd_chunk_bwd", _bwd_fake,
                            lib=_LIB)


def _block_flops(cc_shape, xf_shape) -> Tuple[int, int, int]:
    """``(2 L^2, N, H P)`` summed over chunks and groups' blocks: every
    product of a block is ``2 L^2`` times a width."""
    bsz, nc, cs, g, n = cc_shape
    return 2 * bsz * nc * g * cs * cs, n, xf_shape[4] * xf_shape[5]


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_fwd)
def _fwd_flops(cc_shape, bc_shape, xf_shape, *args, out_shape=None,
               **kwargs) -> int:
    """``S = C B^T`` and ``y_h = M_h X_h`` over whole chunks."""
    unit, n, hp = _block_flops(cc_shape, xf_shape)
    return unit * (n + hp)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_bwd)
def _bwd_flops(cc_shape, bc_shape, xf_shape, *args, out_shape=None,
               **kwargs) -> int:
    """``S`` again, ``dM_h``, ``dX_h``, ``dC`` and ``dB`` over whole
    chunks."""
    unit, n, hp = _block_flops(cc_shape, xf_shape)
    return unit * (3 * n + 2 * hp)


class SsdChunkFn(torch.autograd.Function):
    """The intra-chunk term with its gradient: ``ssd_chunk_fwd`` forward,
    ``ssd_chunk_bwd`` backward.  Saves its inputs only; safe under
    non-reentrant ``torch.utils.checkpoint`` (its recompute saves
    afresh)."""

    @staticmethod
    def forward(ctx, cc, bc, xf, da_cum, runs):
        ctx.save_for_backward(cc, bc, xf, da_cum, runs)
        return ssd_chunk_fwd(cc, bc, xf, da_cum, runs)

    @staticmethod
    def backward(ctx, dy):
        cc, bc, xf, da_cum, runs = ctx.saved_tensors
        dcc, dbc, dxf, dda = ssd_chunk_bwd(cc, bc, xf, da_cum,
                                           dy.contiguous(), runs)
        return dcc, dbc, dxf, dda, None


def ssd_chunk(cc: torch.Tensor, bc: torch.Tensor, xf: torch.Tensor,
              da_cum: torch.Tensor,
              runs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SSD's intra-chunk term ``y_diag`` ``(B, C, L, G, H, P)``:
    ``cc``, ``bc`` ``(B, C, L, G, N)``, ``xf`` ``(B, C, L, G, H, P)``,
    ``da_cum`` ``(B, C, L, G, H)``, ``runs`` ``(B, C, L)`` int32 or None
    (:func:`~repro_torch.kernels.ref.ssd_chunk_ref` has the semantics).  A
    CUDA call takes the kernels (float32; chunk, head dim and state in
    :data:`CHUNKS`, :data:`HEAD_DIMS`, :data:`STATES`) or raises; a CPU
    call the plain versions.  Where autograd needs a gradient the call
    goes through :class:`SsdChunkFn`."""
    _check(cc, bc, xf, da_cum, runs)
    cc, bc, xf, da_cum = (t.contiguous() for t in (cc, bc, xf, da_cum))
    runs = None if runs is None else runs.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (cc, bc, xf, da_cum)):
        return SsdChunkFn.apply(cc, bc, xf, da_cum, runs)
    return ssd_chunk_fwd(cc, bc, xf, da_cum, runs)


# ---------------------------------------------------------------------------
# the chunk states and the entering states' term
# ---------------------------------------------------------------------------

def _state_launch(op: int, what: str, operands, out, out2, v: torch.Tensor,
                  heads: int, p: int) -> None:
    """One launch of ``ssd_chunk_state_launch`` (op 0 gather, 1 apply, 2
    cross) on CUDA operands; ``v`` is the (B, C, L, G, N) operand, which
    gives the sizes with ``heads`` and the head dim ``p``."""
    bsz, nc, cs, g, n = v.shape
    if not supports(cs, p, n) or any(
            t is not None and (t.dtype != torch.float32
                               or not t.is_contiguous()) for t in operands):
        raise ValueError(f"{what}: the kernel takes contiguous float32 "
                         f"operands at chunks {CHUNKS}, head dims "
                         f"{HEAD_DIMS}, states {STATES}")
    ptrs = [0 if t is None else t.data_ptr() for t in operands]
    with torch.cuda.device(v.device):
        code = _entry("ssd_chunk_state_launch", _STATE_ARGTYPES)(
            op, *ptrs, out.data_ptr(), 0 if out2 is None else out2.data_ptr(),
            bsz * nc, g, heads, cs, n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, what)
    ssd_chunk.launches_state += 1


def _gather(u, v, w):
    r = u.new_empty(u.shape[:2] + (u.shape[3], u.shape[4], u.shape[5],
                                   v.shape[4]))
    if r.numel():
        _state_launch(0, "ssd_gather", (u, v, w, None), r, None, v,
                      u.shape[4], u.shape[5])
    return r


def _apply(v, wm, w, base=None):
    out = v.new_empty(w.shape + (wm.shape[4],))
    if out.numel():
        _state_launch(1, "ssd_apply", (v, wm, w, base), out, None, v,
                      w.shape[4], wm.shape[4])
    return out


def _cross(u, wm, v, w):
    dv, dw = torch.empty_like(v), torch.empty_like(w)
    if dw.numel():
        _state_launch(2, "ssd_cross", (u, wm, v, w), dv, dw, v, w.shape[4],
                      u.shape[5])
    return dv, dw


_LIB.define("ssd_gather(Tensor u, Tensor v, Tensor w) -> Tensor")
_LIB.define("ssd_apply(Tensor v, Tensor wm, Tensor w, Tensor? base=None) "
            "-> Tensor")
_LIB.define("ssd_cross(Tensor u, Tensor wm, Tensor v, Tensor w) -> "
            "(Tensor, Tensor)")
#: ``R_h = sum_l w U_h^T V`` (``ref.ssd_gather_ref``).
ssd_gather = torch.ops.repro_torch.ssd_gather.default
#: ``base + w V W_h^T`` (``ref.ssd_apply_ref``).
ssd_apply = torch.ops.repro_torch.ssd_apply.default
#: ``(sum_h w Z_h, V . Z_h)`` of ``Z_h = U_h W_h`` (``ref.ssd_cross_ref``).
ssd_cross = torch.ops.repro_torch.ssd_cross.default
for _name, _cuda, _cpu in (("ssd_gather", _gather, ssd_gather_ref),
                           ("ssd_apply", _apply, ssd_apply_ref),
                           ("ssd_cross", _cross, ssd_cross_ref)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
torch.library.register_fake(
    "repro_torch::ssd_gather",
    lambda u, v, w: u.new_empty(u.shape[:2] + u.shape[3:] + v.shape[4:]),
    lib=_LIB)
torch.library.register_fake(
    "repro_torch::ssd_apply",
    lambda v, wm, w, base=None: v.new_empty(w.shape + wm.shape[4:5]),
    lib=_LIB)
torch.library.register_fake(
    "repro_torch::ssd_cross",
    lambda u, wm, v, w: (v.new_empty(v.shape), w.new_empty(w.shape)),
    lib=_LIB)


def _pairs(w_shape, p: int, n: int) -> int:
    """``2 P N`` for every (row, head) of every chunk-group: one (P x N)
    product a row."""
    return 2 * math.prod(w_shape) * p * n


@register_flop_formula(torch.ops.repro_torch.ssd_gather)
def _gather_flops(u_shape, v_shape, w_shape, *args, out_shape=None,
                  **kwargs) -> int:
    return _pairs(w_shape, u_shape[5], v_shape[4])


@register_flop_formula(torch.ops.repro_torch.ssd_apply)
def _apply_flops(v_shape, wm_shape, w_shape, *args, out_shape=None,
                 **kwargs) -> int:
    return _pairs(w_shape, wm_shape[4], v_shape[4])


@register_flop_formula(torch.ops.repro_torch.ssd_cross)
def _cross_flops(u_shape, wm_shape, v_shape, w_shape, *args,
                 out_shape=None, **kwargs) -> int:
    return _pairs(w_shape, u_shape[5], v_shape[4])


class SsdStatesFn(torch.autograd.Function):
    """The state each chunk leaves, ``ssd_gather(xf, bc, decay_states)``;
    backward: ``dxf = ssd_apply(bc, dR, w)`` and ``(dbc, dw) =
    ssd_cross(xf, dR, bc, w)``."""

    @staticmethod
    def forward(ctx, xf, bc, w):
        ctx.save_for_backward(xf, bc, w)
        return ssd_gather(xf, bc, w)

    @staticmethod
    def backward(ctx, dr):
        xf, bc, w = ctx.saved_tensors
        dr = dr.contiguous()
        dbc, dw = ssd_cross(xf, dr, bc, w)
        return ssd_apply(bc, dr, w), dbc, dw


class SsdEnteringFn(torch.autograd.Function):
    """``y_diag`` plus the entering states' term, ``ssd_apply(cc, prev, w,
    y_diag)``; backward: ``dy`` to ``y_diag``, ``(dcc, dw) = ssd_cross(dy,
    prev, cc, w)``, ``dprev = ssd_gather(dy, cc, w)``."""

    @staticmethod
    def forward(ctx, y_diag, cc, prev, w):
        ctx.save_for_backward(cc, prev, w)
        return ssd_apply(cc, prev, w, y_diag)

    @staticmethod
    def backward(ctx, dy):
        cc, prev, w = ctx.saved_tensors
        dy = dy.contiguous()
        dcc, dw = ssd_cross(dy, prev, cc, w)
        return dy, dcc, ssd_gather(dy, cc, w), dw


def ssd_states(xf: torch.Tensor, bc: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """The state each chunk leaves, ``(B, C, G, H, P, N)``: ``sum_l w[l, h]
    xf_h[l]^T bc[l]`` (``xf`` ``(B, C, L, G, H, P)``, ``bc`` ``(B, C, L, G,
    N)``, ``w`` the decay to the chunk's end, ``(B, C, L, G, H)``).  The
    kernel on a CUDA tensor, the plain version on a CPU one."""
    xf, bc, w = (t.contiguous() for t in (xf, bc, w))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xf, bc, w)):
        return SsdStatesFn.apply(xf, bc, w)
    return ssd_gather(xf, bc, w)


def ssd_add_entering(y_diag: torch.Tensor, cc: torch.Tensor,
                     prev: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y_diag`` plus ``w[l, h] cc[l] prev_h^T``, ``(B, C, L, G, H, P)``:
    the term of the state entering each chunk (``prev`` ``(B, C, G, H, P,
    N)``, ``w`` the decay from the chunk's start)."""
    y_diag, cc, prev, w = (t.contiguous() for t in (y_diag, cc, prev, w))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y_diag, cc, prev, w)):
        return SsdEnteringFn.apply(y_diag, cc, prev, w)
    return ssd_apply(cc, prev, w, y_diag)


#: Launches of the forward kernel, of the backward pair, and of the
#: state kernels (gather, apply, cross) (CUDA only).
ssd_chunk.launches = 0
ssd_chunk.launches_bwd = 0
ssd_chunk.launches_state = 0
