"""MVE ``vsst`` on Hopper: the multi-dimensional strided scatter.

Replaces the TPU kernel ``repro/kernels/mdscatter.py::_scatter_kernel``
(wrapper ``mdscatter``).  That kernel walks its lane tiles one after another
in a single grid step, which is what makes the highest lane win on equal
addresses.  GPU blocks run in no order, so ``csrc/mdscatter.cu`` resolves
the order explicitly: pass 1 ``atomicMax``-es every active lane's id into an
int32 owner table (one entry per destination element), pass 2 lets only the
owner store.  Strided addresses are the same for every image of a batch, so
one table serves all of it.  A per-lane mask (the dimension-level mask of
the executors) switches lanes off *before* they reach an address: a masked
lane writes nowhere, it is not blended back afterwards.

Bound on this card: bytes — ``B * lanes * elem`` read and as much written,
plus ``4 * N`` for setting and reading the owner table.

The plain PyTorch version is :func:`repro_torch.kernels.ref.mdscatter_ref`;
the wrappers take it only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build
from .mdgather import _ELEM_SIZES, check_walk
from .ref import mdscatter_ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
             + [ctypes.c_int, ctypes.c_int] + [ctypes.c_longlong] * 9
             + [ctypes.c_void_p])


def _entry():
    fn = _build.load("mdscatter").mdscatter_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def mdscatter_(dst: torch.Tensor, values: torch.Tensor, dims: Sequence[int],
               strides: Sequence[int], base: int = 0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter lane values into flat ``dst`` **in place**; returns ``dst``.

    ``dst`` is ``(N,)`` or ``(B, N)`` and contiguous; ``values`` is
    ``(lanes,)`` / ``(B, lanes)`` of the same type; ``mask`` is an optional
    per-lane ``bool``/``uint8`` vector of ``lanes`` entries.  Lane ``l``
    stores when ``l < prod(dims)``, its mask entry is set and its address
    lies inside the image once an address in ``[-N, 0)`` has wrapped to
    ``a + N``; on equal addresses the highest such lane wins.
    A CUDA tensor always goes through the kernel; only a CPU tensor takes
    the plain version.
    """
    if dst.dim() not in (1, 2) or values.dim() != dst.dim() or \
            values.shape[:-1] != dst.shape[:-1]:
        raise ValueError(
            f"dst {tuple(dst.shape)} / values {tuple(values.shape)}: need "
            "(N,) with (lanes,) or (B, N) with (B, lanes)")
    if values.dtype != dst.dtype or values.device != dst.device:
        raise TypeError(f"values ({values.dtype}, {values.device}) must "
                        f"match dst ({dst.dtype}, {dst.device})")
    if not dst.is_contiguous():
        raise ValueError("dst must be contiguous (it is updated in place)")
    lanes = values.shape[-1]
    if mask is not None:
        if mask.shape != (lanes,) or mask.device != dst.device or \
                mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(
                f"mask must be a bool/uint8 vector of {lanes} lanes on "
                f"{dst.device}, got {mask.dtype} {tuple(mask.shape)} on "
                f"{mask.device}")
    ndims = len(dims)
    dims4, strides4 = check_walk(dims, strides)
    if not dst.is_cuda:
        return dst.copy_(mdscatter_ref(dst, values, dims, strides, base,
                                       mask))
    if dst.element_size() not in _ELEM_SIZES:
        raise TypeError(f"unsupported element type {dst.dtype}")
    if dst.numel() == 0 or lanes == 0:
        return dst
    values = values.contiguous()
    mask = None if mask is None else mask.contiguous()
    batch = dst.shape[0] if dst.dim() == 2 else 1
    owner = torch.empty(dst.shape[-1], dtype=torch.int32, device=dst.device)
    with torch.cuda.device(dst.device):
        code = _entry()(dst.data_ptr(), values.data_ptr(), owner.data_ptr(),
                        None if mask is None else mask.data_ptr(), batch,
                        dst.shape[-1], lanes, dst.element_size(), ndims,
                        *dims4, *strides4, int(base),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "mdscatter")
    mdscatter_.launches += 1
    return dst


#: Number of times :func:`mdscatter_` launched its kernel pair (owner pass +
#: store pass count as one; CUDA tensors only).
mdscatter_.launches = 0


def mdscatter(dst: torch.Tensor, values: torch.Tensor, dims: Sequence[int],
              strides: Sequence[int], base: int = 0,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Functional form of :func:`mdscatter_`: scatters into a copy."""
    return mdscatter_(dst.contiguous().clone(), values, dims, strides, base,
                      mask)
