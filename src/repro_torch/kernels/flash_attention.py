"""Forward attention on Hopper: the online-softmax (flash) kernels.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(wrapper ``flash_attention``).  The CUDA source is
``csrc/flash_attention.cu``, with one kernel per dtype:

* bfloat16 takes ``flash_fwd_mma_kernel``, on the tensor cores: one block
  per (batch*head, 64-row q tile), 4 warps of 16 q rows; K/V tiles of 64
  rows staged by ``cp.async`` in two stages; ``S = Q K^T`` and ``O += P V``
  with ``mma.sync`` m16n8k16 (bf16 in, fp32 accumulators); the softmax
  scale on the fp32 logits; ``p`` rounded to bf16 in registers for
  ``P V``, ``l`` summed from the fp32 ``p``.  ``cp.async`` copies 16-byte
  rows, so an operand whose base or strides are not 16-byte aligned is
  made contiguous first (:func:`_kernel_operand`).
* float32 takes ``flash_fwd_simt_kernel``, on the fp32 CUDA cores (one
  thread per q row): TF32 tensor cores keep about 10 mantissa bits, too few
  for the fp32 comparison (3e-5).  It serves the float32 checks, not bf16
  serving.

Both mask with ``-1e30`` and the ``logits > -1e30/2`` guard exactly as the
TPU kernel, so a row that sees no key comes out 0 (the plain version gives
NaN there, as the reference's oracle does).  Ragged ``Sq``/``Sk`` are masked
inside the kernel; nothing is padded in device memory.  Both are counted in
``flash_attention.launches``.

Bound on this card at the qwen2-0.5b prefill shape: operations (the
kernel's source note has the arithmetic).

The plain PyTorch version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
the wrapper takes it only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_longlong] * 14 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])


def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel takes it: the head dimension dense and, for
    bfloat16 (staged by 16-byte ``cp.async``), the base pointer and the
    strides of the first three dimensions 16-byte aligned; otherwise a
    contiguous copy."""
    ok = t.stride(-1) == 1
    if t.dtype == torch.bfloat16:
        ok = ok and t.data_ptr() % 16 == 0 and all(
            s % 8 == 0 for s in t.stride()[:3])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``(B, H, Sq, D)`` attention over ``(B, Hkv, Sk, D)`` keys and values
    -> ``(B, H, Sq, D)`` in q's type.

    ``H`` must be a multiple of ``Hkv``: kv head ``h // (H / Hkv)`` serves q
    head ``h`` (the reference repeats the kv heads in memory first; with
    ``Hkv == H`` the two are the same call).  ``D`` is 64 or 128, the type
    float32 or bfloat16, all three on one device; ``scale`` defaults to
    ``1/sqrt(D)``; the causal diagonal sits at ``Sk - Sq``.  Strided views
    are taken as they are as long as the head dimension is dense (and, in
    bfloat16, rows are 16-byte aligned; else they are copied).  A CUDA
    tensor always goes through the kernel; only a CPU tensor takes the
    plain version.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k == v == (B, Hkv, Sk, D)")
    if hk == 0 or h % hk:
        raise ValueError(f"{h} q heads are not a multiple of {hk} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v types {q.dtype}/{k.dtype}/{v.dtype}: need "
                        "one of float32, bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    out = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], d, b, h, hk, sq,
                        sk, *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], int(bool(causal)), scale,
                        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


#: Number of times :func:`flash_attention` launched its kernel (CUDA
#: tensors only).
flash_attention.launches = 0
