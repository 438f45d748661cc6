"""Attention on Hopper: the online-softmax (flash) kernels, forward and
backward.

The forward replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel`` (wrapper
``flash_attention``).  The CUDA source is ``csrc/flash_attention.cu``,
with one kernel per dtype:

* bfloat16 takes ``flash_fwd_mma_kernel``, on the tensor cores: one block
  per (batch*head, 64-row q tile), 4 warps of 16 q rows; K/V tiles of 64
  rows staged by ``cp.async`` in two stages; ``S = Q K^T`` and ``O += P V``
  with ``mma.sync`` m16n8k16 (bf16 in, fp32 accumulators); the softmax
  scale on the fp32 logits; ``p`` rounded to bf16 in registers for
  ``P V``, ``l`` summed from the fp32 ``p``.
* float32 takes ``flash_fwd_tf32_kernel``, on the tensor cores too, in the
  same shape: each product is three TF32 ones (``mma.sync`` m16n8k8,
  ``hi*hi + hi*lo + lo*hi`` with ``hi``, ``lo`` rounded by
  ``cvt.rna.tf32.f32``), which keep the fp32 comparison (3e-5) where one
  TF32 product (10 mantissa bits) would not; q is scaled in fp32 before
  its split.  It serves the float32 checks, not bf16 serving.

``cp.async`` copies 16-byte rows, so an operand whose base or strides are
not 16-byte aligned is made contiguous first (:func:`_kernel_operand`).

Both mask with ``-1e30`` and the ``logits > -1e30/2`` guard exactly as the
TPU kernel, so a row that sees no key comes out 0 (the plain version gives
NaN there, as the reference's oracle does).  Ragged ``Sq``/``Sk`` are masked
inside the kernel; nothing is padded in device memory.  Both are counted in
``flash_attention.launches``, the float32 launches also in
``flash_attention.launches_fp32``.

The backward has no TPU kernel behind it: the reference differentiates its
plain attention.  A call whose inputs require a gradient goes through
:class:`FlashAttentionFn`, whose forward also keeps each row's log-sum-exp
(``lse``) and whose backward, :func:`flash_attention_bwd`, launches the
kernels of ``csrc/flash_attention_bwd.cu`` (``D = rowsum(dO O)``, dK/dV,
dQ; fp32 sums, no atomics), counted once a call in
``flash_attention_bwd.launches``.  The dtype picks them as in the forward:

* bfloat16 takes ``flash_bwd_dkdv_mma_kernel`` and
  ``flash_bwd_dq_mma_kernel`` on the tensor cores (``mma.sync``, P and dS
  rounded to bf16 as A operands);
* float32 takes ``flash_bwd_dkdv_tf32_kernel`` and
  ``flash_bwd_dq_tf32_kernel``, the same design with each product three
  TF32 ones, as the forward's float32 (P and dS split, not rounded).

In both the GQA sum over a kv head's q heads stays inside its dK/dV block
unless those blocks are too few to fill the card (:func:`gqa_split`); then
each block takes one q head, writes fp32 partials to a scratch allocated
here, and ``flash_bwd_gqa_sum_kernel`` sums them in head order.

A call that needs no gradient (every serving call) launches the forward
alone and keeps no ``lse``.

Segment ids (packed documents): with ``segment_ids`` ``(B, Sq)`` and
``kv_segment_ids`` ``(B, Sk)`` (int32 on the card) a query sees only the
keys of its own id, and causal where asked; pads (id 0) see only pads.
Every kernel above then runs an instantiation of its own (a template flag,
so a call without ids runs the code it ran before), after one small
launch, ``flash_seg_tiles_kernel`` (``csrc/flash_attention.cu``), that
reads the ids once for the whole call: for each 64-row q tile and each
64-row K tile its least and largest id, up to three distinct ids, and the
range of rows of the other side whose tiles may share one of them (two
tiles of at most three ids each meet where two ids are equal, others where
their id intervals meet; under causal only tiles at or before the
diagonal).  The forward and dQ kernels loop over their q tile's range of
keys, the dK/dV kernel over its K tile's range of q rows, each inside the
causal bound; a warp skips a tile whose id interval misses its own rows';
the per-pair test of the ids runs only on a tile whose ids are not one
value on both sides (a segment boundary), beside the causal and Sq / Sk
edges as before.  The ranges over-approximate the pairs, so any ids are
right, in any order; on packed documents a tile visits the tiles of its own
documents.  The pre-pass's result (``tiles``, int32 ``(B, nq + nk, 8)``,
:func:`~repro_torch.kernels.ref.flash_segment_tiles_ref`) is computed once
in :class:`FlashAttentionFn`'s forward and handed to the backward (on
the card only: the CPU's plain versions take the ids alone).
Segmented forward launches are also counted in
``flash_attention.launches_segmented``.

Bound on this card at the qwen2-0.5b prefill shape: operations (the
kernels' source notes have the arithmetic).

On a ``model`` mesh axis the attention hands the kernels each rank's own
heads as plain tensors; a ``DTensor`` reaching a wrapper raises.

The plain PyTorch versions are
:func:`repro_torch.kernels.ref.flash_attention_ref`,
``flash_attention_lse_ref`` and ``flash_attention_bwd_ref``; the wrappers
take them only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from torch.utils.flop_counter import (register_flop_formula,
                                     sdpa_backward_flop_count,
                                     sdpa_flop_count)

from . import _build
from .ref import (SEG_TILE, flash_attention_bwd_ref,
                  flash_attention_lse_ref, flash_attention_ref)

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 14 + [ctypes.c_int, ctypes.c_float]
             + [ctypes.c_void_p] * 4)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_float]
                 + [ctypes.c_void_p] * 4)
_SEG_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                 + [ctypes.c_int, ctypes.c_void_p])


def _entry(source: str, symbol: str, argtypes):
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it (staged by 16-byte ``cp.async``): the
    head dimension dense, the base pointer and the strides of the first
    three dimensions 16-byte aligned; otherwise a contiguous copy."""
    per = 16 // t.element_size()
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s % per == 0 for s in t.stride()[:3])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: Optional[float], float64_on_cpu: bool = False) -> float:
    """Raise on what the kernels do not take; return the scale.  With
    ``float64_on_cpu`` a CPU call may also be float64 (the plain versions
    take it: the gradient checks run in float64)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("a DTensor reached the flash kernels: pass each "
                        "rank's local heads (models/attention.py, "
                        "_flash_on_local_heads)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, h, _, d = q.shape
    hk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k == v == (B, Hkv, Sk, D)")
    if hk == 0 or h % hk:
        raise ValueError(f"{h} q heads are not a multiple of {hk} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    types = set(_DTYPES)
    if float64_on_cpu and not q.is_cuda:
        types.add(torch.float64)
    if q.dtype not in types or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v types {q.dtype}/{k.dtype}/{v.dtype}: need "
                        "one of float32, bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.is_cuda and b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    return float(scale if scale is not None else 1.0 / math.sqrt(d))


def _segment_operands(q: torch.Tensor, k: torch.Tensor,
                      segment_ids: Optional[torch.Tensor],
                      kv_segment_ids: Optional[torch.Tensor]
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """The ids as the kernels take them: int32 and contiguous, ``(B, Sq)``
    and ``(B, Sk)`` (the kv ids default to the q ids); ``(None, None)``
    without ids.  Raises on a shape, type or device they do not fit."""
    if segment_ids is None:
        return None, None
    kv = segment_ids if kv_segment_ids is None else kv_segment_ids
    if isinstance(segment_ids, DTensor) or isinstance(kv, DTensor):
        raise TypeError("a DTensor reached the flash kernels as segment "
                        "ids: pass the whole ids")
    want = ((q.shape[0], q.shape[2]), (k.shape[0], k.shape[2]))
    for ids, shape in zip((segment_ids, kv), want):
        if tuple(ids.shape) != shape:
            raise ValueError(f"segment ids {tuple(ids.shape)}: need "
                             f"{shape} (B, Sq) and (B, Sk)")
        if ids.dtype.is_floating_point or ids.dtype.is_complex or \
                ids.dtype == torch.bool:
            raise TypeError(f"segment ids of type {ids.dtype}: need ints")
        if ids.device != q.device:
            raise ValueError("segment ids must lie on q's device")
    return tuple(ids.to(torch.int32).contiguous()
                 for ids in (segment_ids, kv))


def _tiles_shape(segment_ids: torch.Tensor,
                 kv_segment_ids: torch.Tensor) -> Tuple[int, int, int]:
    return (segment_ids.shape[0],
            -(-segment_ids.shape[1] // SEG_TILE)
            - (-kv_segment_ids.shape[1] // SEG_TILE), 8)


def _segment_tiles(segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """One launch of the segment pre-pass on CUDA ids: ``(B, nq + nk, 8)``
    int32, as :func:`~repro_torch.kernels.ref.flash_segment_tiles_ref`."""
    tiles = torch.empty(_tiles_shape(segment_ids, kv_segment_ids),
                        dtype=torch.int32, device=segment_ids.device)
    b, sq = segment_ids.shape
    sk = kv_segment_ids.shape[1]
    if tiles.numel() == 0:
        return tiles
    with torch.cuda.device(segment_ids.device):
        code = _entry("flash_attention", "flash_segment_tiles_launch",
                      _SEG_ARGTYPES)(
            segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            tiles.data_ptr(), b, sq, sk, int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_segment_tiles")
    return tiles


def _seg_pointers(segment_ids, kv_segment_ids, tiles) -> Tuple[int, ...]:
    """The C entries' three segment pointers (0, 0, 0 without ids)."""
    if segment_ids is None:
        return 0, 0, 0
    return (segment_ids.data_ptr(), kv_segment_ids.data_ptr(),
            tiles.data_ptr())


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, scale: float, with_lse: bool,
             segment_ids: Optional[torch.Tensor] = None,
             kv_segment_ids: Optional[torch.Tensor] = None,
             tiles: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on CUDA tensors: the output and,
    when ``with_lse``, each row's log-sum-exp (fp32, ``(B, H, Sq)``; else an
    empty tensor).  With segment ids (int32, contiguous) the segmented
    instantiation, over ``tiles`` (the pre-pass's result; launched here
    where not given)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if segment_ids is not None and tiles is None:
        tiles = _segment_tiles(segment_ids, kv_segment_ids, causal)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    out = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(_lse_shape(q, with_lse), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        code = _entry("flash_attention", "flash_attention_launch",
                      _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else 0, _DTYPES[q.dtype], d, b, h,
            hk, sq, sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), scale,
            *_seg_pointers(segment_ids, kv_segment_ids, tiles),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_fp32 += q.dtype == torch.float32
    flash_attention.launches_segmented += segment_ids is not None
    return out, lse


def _lse_shape(q: torch.Tensor, with_lse: bool) -> Tuple[int, ...]:
    return tuple(q.shape[:3]) if with_lse else (0,)


# The kernels as operators of their own, so that PyTorch's dispatch sees
# them (a cost counter prices them by their flop formulas below, and a
# ``meta`` tensor gets their outputs' shapes): the CUDA implementation
# launches the kernels, the CPU one is the plain version, the fake one
# (``meta`` and fake tensors) makes the outputs' shapes and types and
# nothing else.  Each returns new tensors; autograd stays with
# :class:`FlashAttentionFn`, so the operators have no autograd kernel of
# their own (``torch.library.custom_op`` would add a Python one, and its
# host time, to every call).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_seg_tiles(Tensor segment_ids, Tensor kv_segment_ids, "
            "bool causal) -> Tensor")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale, bool with_lse, Tensor? segment_ids=None, "
            "Tensor? kv_segment_ids=None, Tensor? tiles=None) -> (Tensor, "
            "Tensor)")
_LIB.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
            "Tensor dout, bool causal, float scale, "
            "Tensor? segment_ids=None, Tensor? kv_segment_ids=None, "
            "Tensor? tiles=None) -> (Tensor, Tensor, Tensor)")
#: The segment pre-pass's ``(B, nq + nk, 8)`` int32 tiles.
flash_seg_tiles = torch.ops.repro_torch.flash_seg_tiles.default
#: ``(out, lse)`` of the forward kernel (``lse`` empty unless
#: ``with_lse``).
flash_fwd = torch.ops.repro_torch.flash_fwd.default
#: ``(dq, dk, dv)`` of the backward kernels (the checks of
#: :func:`flash_attention_bwd` made).
flash_bwd = torch.ops.repro_torch.flash_bwd.default


def _flash_fwd_cpu(q, k, v, causal, scale, with_lse, segment_ids=None,
                   kv_segment_ids=None, tiles=None):
    ids = dict(segment_ids=segment_ids, kv_segment_ids=kv_segment_ids)
    if with_lse:
        return flash_attention_lse_ref(q, k, v, causal=causal, scale=scale,
                                       **ids)
    return (flash_attention_ref(q, k, v, causal=causal, scale=scale, **ids),
            q.new_empty((0,), dtype=_lse_type(q)))


def _flash_fwd_fake(q, k, v, causal, scale, with_lse, segment_ids=None,
                    kv_segment_ids=None, tiles=None):
    return (q.new_empty(q.shape),
            q.new_empty(_lse_shape(q, with_lse), dtype=_lse_type(q)))


def _flash_seg_tiles_fake(segment_ids, kv_segment_ids, causal):
    return segment_ids.new_empty(_tiles_shape(segment_ids, kv_segment_ids),
                                 dtype=torch.int32)


_LIB.impl("flash_seg_tiles", _segment_tiles, "CUDA")
torch.library.register_fake("repro_torch::flash_seg_tiles",
                            _flash_seg_tiles_fake, lib=_LIB)
_LIB.impl("flash_fwd", _forward, "CUDA")
_LIB.impl("flash_fwd", _flash_fwd_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_fwd", _flash_fwd_fake,
                            lib=_LIB)


def _lse_type(q: torch.Tensor) -> torch.dtype:
    """fp32 (float64 for float64 inputs, which only the plain version
    takes)."""
    return torch.promote_types(q.dtype, torch.float32)


def _kv_as_q_heads(q_shape, k_shape) -> Tuple[int, ...]:
    """A k/v shape at the q heads: torch's flop convention counts GQA
    there."""
    return (k_shape[0], q_shape[1], k_shape[2], k_shape[3])


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """``scaled_dot_product_attention``'s count: ``Q K^T`` and ``P V``, no
    discount for the causal mask."""
    kv = _kv_as_q_heads(q_shape, k_shape)
    return sdpa_flop_count(q_shape, kv, kv)


class FlashAttentionFn(torch.autograd.Function):
    """The flash route with its gradient.  Forward: the forward kernel with
    ``lse`` (``flash_fwd``; the plain ``flash_attention_lse_ref`` on a CPU
    tensor), after the segment pre-pass where ids are given to the card; it
    saves q, k, v, the output, ``lse``, the ids and the pre-pass's tiles.
    Backward: :func:`flash_attention_bwd` over the same tiles.  Safe under
    non-reentrant ``torch.utils.checkpoint``: its recompute runs the
    forward again and saves afresh."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, segment_ids=None,
                kv_segment_ids=None):
        tiles = (flash_seg_tiles(segment_ids, kv_segment_ids, causal)
                 if segment_ids is not None and q.is_cuda else None)
        out, lse = flash_fwd(q, k, v, causal, scale, True, segment_ids,
                             kv_segment_ids, tiles)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids,
                              kv_segment_ids, tiles)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg_q, seg_k, tiles = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale,
            segment_ids=seg_q, kv_segment_ids=seg_k, tiles=tiles)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``(B, H, Sq, D)`` attention over ``(B, Hkv, Sk, D)`` keys and values
    -> ``(B, H, Sq, D)`` in q's type.

    ``H`` must be a multiple of ``Hkv``: kv head ``h // (H / Hkv)`` serves q
    head ``h`` (the reference repeats the kv heads in memory first; with
    ``Hkv == H`` the two are the same call).  ``D`` is 64 or 128, the type
    float32 or bfloat16, all three on one device; ``scale`` defaults to
    ``1/sqrt(D)``; the causal diagonal sits at ``Sk - Sq``.  Strided views
    are taken as they are as long as the head dimension is dense and rows
    are 16-byte aligned (else they are copied).  A CUDA
    tensor always goes through the kernels; only a CPU tensor takes the
    plain versions.  With ``segment_ids`` ``(B, Sq)`` (and
    ``kv_segment_ids`` ``(B, Sk)``, default ``segment_ids``) a query sees
    only the keys of its own id: the segmented kernels over the segment
    pre-pass (module docstring).  Where autograd needs a gradient of q, k
    or v the call goes through :class:`FlashAttentionFn`.
    """
    scale = _check(q, k, v, scale)
    seg = _segment_operands(q, k, segment_ids, kv_segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), scale, *seg)
    return flash_fwd(q, k, v, bool(causal), scale, False, *seg)[0]


#: Number of times the forward kernel was launched (CUDA tensors only),
#: how many of those launches were float32, and how many took segment ids.
flash_attention.launches = 0
flash_attention.launches_fp32 = 0
flash_attention.launches_segmented = 0


#: Rows of a K tile of the dK/dV kernels (``FBM_ROWS``).
BWD_TILE = 64


def gqa_split(batch: int, kv_heads: int, sk: int, group: int,
              sms: int) -> bool:
    """Whether the dK/dV kernel splits each kv head's ``group`` q
    heads over blocks (fp32 partials, summed after in head order): where
    the blocks of the in-block sum, ``batch * kv_heads * ceil(sk / 64)``,
    are fewer than two for each of the card's ``sms`` SMs (qwen2-0.5b's
    training shape, 4 x 2 x 16 = 128 on 132 SMs, splits; whisper's and the
    vision cross attention's, 512 and more, do not)."""
    blocks = batch * kv_heads * -(-sk // BWD_TILE)
    return group > 1 and blocks < 2 * sms


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        tiles: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` for the
    output gradient ``dout``, given the forward's output ``o`` and its
    ``lse`` (fp32 ``(B, H, Sq)``).  dq is ``(B, H, Sq, D)``, dk and dv
    ``(B, Hkv, Sk, D)`` (each kv head's sum over its q heads), all in q's
    type.  On CUDA tensors: the backward kernels, on the tensor cores
    (float32 as three TF32 products), with the GQA split of
    :func:`gqa_split`, one count in
    ``flash_attention_bwd.launches`` per call; on CPU tensors the plain
    :func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`.  The segment
    ids are the forward's; ``tiles``, the forward's pre-pass, is launched
    anew where not given."""
    scale = _check(q, k, v, scale, float64_on_cpu=True)
    b, h, sq, d = q.shape
    if o.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, sq):
        raise ValueError(f"o {tuple(o.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    seg = _segment_operands(q, k, segment_ids, kv_segment_ids)
    return flash_bwd(q, k, v, o, lse, dout, bool(causal), scale, *seg,
                     tiles)


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              causal: bool, scale: float,
              segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None,
              tiles: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call of the backward kernels on CUDA tensors (the segmented
    instantiations over ``tiles`` where ids are given)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if segment_ids is not None and tiles is None:
        tiles = _segment_tiles(segment_ids, kv_segment_ids, causal)
    if o.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"o {o.dtype}, dout {dout.dtype}, lse {lse.dtype}: "
                        f"need {q.dtype}, {q.dtype}, float32")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("q, k, v, o, lse, dout must lie on one device")
    q, k, v, dout = (_kernel_operand(t) for t in (q, k, v, dout))
    o, lse = o.contiguous(), lse.contiguous()
    dq = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, hk, sk, d, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:     # nothing seen, no gradient
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    part = None
    if gqa_split(
            b, hk, sk, h // hk,
            torch.cuda.get_device_properties(q.device).multi_processor_count):
        part = torch.empty(2, b, h, sk, d, dtype=torch.float32,
                           device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *dout.stride()[:3])
    with torch.cuda.device(q.device):
        code = _entry("flash_attention_bwd", "flash_attention_bwd_launch",
                      _BWD_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            0 if part is None else part.data_ptr(), _DTYPES[q.dtype], d, b,
            h, hk, sq, sk, strides, int(bool(causal)), scale,
            *_seg_pointers(segment_ids, kv_segment_ids, tiles),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_fp32 += q.dtype == torch.float32
    return dq, dk, dv


def _flash_bwd_cpu(q, k, v, o, lse, dout, causal, scale, segment_ids=None,
                   kv_segment_ids=None, tiles=None):
    return flash_attention_bwd_ref(q, k, v, o, lse, dout, causal=causal,
                                   scale=scale, segment_ids=segment_ids,
                                   kv_segment_ids=kv_segment_ids)


def _flash_bwd_fake(q, k, v, o, lse, dout, causal, scale, segment_ids=None,
                    kv_segment_ids=None, tiles=None):
    return q.new_empty(q.shape), q.new_empty(k.shape), q.new_empty(k.shape)


_LIB.impl("flash_bwd", _backward, "CUDA")
_LIB.impl("flash_bwd", _flash_bwd_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_bwd", _flash_bwd_fake,
                            lib=_LIB)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape,
                     dout_shape, *args, out_shape=None, **kwargs) -> int:
    """``scaled_dot_product_attention``'s backward count (the recomputed
    ``Q K^T``, ``dO V^T``, ``P^T dO``, ``dS K``, ``dS^T Q``), no causal
    discount."""
    kv = _kv_as_q_heads(q_shape, k_shape)
    return sdpa_backward_flop_count(dout_shape, q_shape, kv, kv)


#: Number of calls that launched the backward kernels (CUDA tensors only;
#: each call launches three of them, four with the GQA split), and how
#: many of those calls were float32.
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_fp32 = 0
