"""MVE ``vsld`` on Hopper: the multi-dimensional strided gather.

Replaces the TPU kernel ``repro/kernels/mdgather.py::_gather_kernel``
(wrapper ``mdgather``).  The CUDA source is ``csrc/mdgather.cu``: one thread
per lane walks its Algorithm-1 address in registers and moves one element as
bits, so one kernel serves every element type of 1, 2, 4 or 8 bytes and a
whole ``(B, lanes)`` register comes out of one launch.  The TPU version's
source-size limit was a VMEM matter and has no counterpart here.

Bound on this card: bytes — ``B * lanes * elem`` read and as much written,
no arithmetic on the data; at one image the launch itself dominates.

The plain PyTorch version is :func:`repro_torch.kernels.ref.mdgather_ref`;
:func:`mdgather` takes it only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from . import _build
from .ref import mdgather_ref

MAX_DIMS = 4
_ELEM_SIZES = (1, 2, 4, 8)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_int] + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


def _entry():
    fn = _build.load("mdgather").mdgather_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_walk(dims: Sequence[int], strides: Sequence[int]):
    """Validated ``(dims, strides)`` tuples padded to four dimensions."""
    dims = tuple(int(d) for d in dims)
    strides = tuple(int(s) for s in strides)
    if not 1 <= len(dims) <= MAX_DIMS or len(dims) != len(strides):
        raise ValueError(f"need 1..{MAX_DIMS} dims with one stride each, "
                         f"got dims={dims} strides={strides}")
    if any(d < 1 for d in dims):
        raise ValueError(f"dimension lengths must be >= 1, got {dims}")
    pad = MAX_DIMS - len(dims)
    return dims + (1,) * pad, strides + (0,) * pad


def mdgather(src: torch.Tensor, dims: Sequence[int], strides: Sequence[int],
             base: int = 0, lanes: Optional[int] = None) -> torch.Tensor:
    """Gather ``lanes`` (default ``prod(dims)``) elements of flat ``src``
    per Algorithm 1.

    ``src`` is one image ``(N,)`` or a batch ``(B, N)``; the result is
    ``(lanes,)`` / ``(B, lanes)`` of the same type.  Addresses are clamped
    into the image; lanes at or past ``prod(dims)`` yield 0.  A CUDA tensor
    always goes through the kernel (built at first use); only a CPU tensor
    takes the plain version.
    """
    if src.dim() not in (1, 2) or src.shape[-1] == 0:
        raise ValueError("src must be a non-empty (N,) or (B, N) tensor, "
                         f"got shape {tuple(src.shape)}")
    ndims = len(dims)
    dims4, strides4 = check_walk(dims, strides)
    lanes = math.prod(dims4) if lanes is None else int(lanes)
    if not src.is_cuda:
        return mdgather_ref(src, dims, strides, base, lanes)
    if src.element_size() not in _ELEM_SIZES:
        raise TypeError(f"unsupported element type {src.dtype}")
    src = src.contiguous()
    batch = src.shape[0] if src.dim() == 2 else 1
    out = torch.empty(src.shape[:-1] + (lanes,), dtype=src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        code = _entry()(src.data_ptr(), out.data_ptr(), batch,
                        src.shape[-1], lanes, src.element_size(), ndims,
                        *dims4, *strides4, int(base),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "mdgather")
    mdgather.launches += 1
    return out


#: Number of kernel launches made by :func:`mdgather` (CUDA tensors only).
mdgather.launches = 0
