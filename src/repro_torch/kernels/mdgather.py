"""MVE ``vsld`` on Hopper: the multi-dimensional strided gather.

Replaces the TPU kernel ``repro/kernels/mdgather.py::_gather_kernel``
(wrapper ``mdgather``), which fills one (8,128) lane tile per grid step
from a VMEM-resident source.  A load's walk is static (dims, strides, base,
image length and lane count are Python ints), so :func:`load_plan`
classifies each walk once on the host (cached) and :func:`mdgather` takes
one of three routes of ``csrc/mdgather.cu``, each one kernel:

* ``"contiguous"`` — lane ``l`` reads ``base + l`` and every such address
  lies in the image: a copy of that run of every image, 16 bytes per thread
  where alignment allows, several images' loads in flight, the lanes at or
  past ``prod(dims)`` zero-filled in the same kernel.  Every load of
  ``daxpy``, ``fir``, ``alpha_blend``, ``audio_mix``, ``reduction`` and
  ``memcpy`` takes it.
* ``"tiled"`` — dimension 0 strides over the image and another dimension
  has stride ±1 (the ``transpose`` pattern's loads): a block stages a
  1024-element tile of each image in shared memory (up to 32 columns along
  the unit-stride dimension), read along that dimension and written along
  the lanes, so both sides are coalesced.
* ``"walk"`` — any other walk: each thread peels one lane's address once,
  in 32-bit arithmetic, clamps it once and moves that lane of a slice of
  the batch.  The replicating walks (a stride-0 dimension) of ``gemm``,
  ``spmm``, ``intra_pred`` and ``xor_cipher`` read a few cached lines.

All three clamp addresses into the image, as the reference's executors
do, and give 0 for lanes at or past ``prod(dims)``, as the TPU kernel
does; elements move as bits, so one kernel serves every element type of 1,
2, 4 or 8 bytes.  A call validates nothing it validated before: the plan
and the packed launch arguments are cached per walk, and the C entry
takes one pointer to them.

Bound on this card: bytes — each needed distinct source element read once
and ``B * lanes * elem`` written, no arithmetic on the data; at one image
the launch and the host's call dominate.

The plain PyTorch version is :func:`repro_torch.kernels.ref.mdgather_ref`;
:func:`mdgather` takes it only for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from . import _build
from .ref import mdgather_ref

MAX_DIMS = 4
MAX_LANES = 2**31 - 1          # lane ids are peeled in 32-bit arithmetic
_ELEM_SIZES = (1, 2, 4, 8)
_ROUTE_IDS = {"contiguous": 0, "walk": 1, "tiled": 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _entry():
    fn = _build.load("mdgather").mdgather_launch
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


@dataclasses.dataclass(frozen=True)
class LoadPlan:
    """How :func:`mdgather` executes one walk.  ``route`` is
    ``"contiguous"``, ``"walk"`` or ``"tiled"``; ``active`` lanes read
    (``min(lanes, prod(dims))``), the rest are 0; a tiled walk reads its
    tiles along dimension ``unit``."""

    route: str
    active: int
    unit: int = 0


def load_addresses(dims: Tuple[int, ...], strides: Tuple[int, ...],
                   base: int, lanes: int) -> np.ndarray:
    """Unclamped int64 addresses of the lanes below ``min(lanes,
    prod(dims))``, the lanes that read."""
    active = min(int(lanes), math.prod(dims))
    addr = np.full(active, int(base), dtype=np.int64)
    rem = np.arange(active, dtype=np.int64)
    for length, stride in zip(dims, strides):
        addr += (rem % length) * stride
        rem = rem // length
    return addr


@functools.lru_cache(maxsize=4096)
def load_plan(dims: Tuple[int, ...], strides: Tuple[int, ...], base: int,
              n: int, lanes: int) -> LoadPlan:
    """Classify a load walk on the host, once per ``(dims, strides, base,
    n, lanes)``, over the lanes that read:

    * ``"contiguous"`` when lane ``l`` reads ``base + l`` and every such
      address lies in ``[0, n)``;
    * ``"tiled"`` when every walk tuple is a lane (``prod(dims) <=
      lanes``), dimension 0 (longer than 1) has a stride other than 0 and
      ±1, and another dimension longer than 1 has stride ±1 (the first
      such is the tile's ``unit``);
    * ``"walk"`` otherwise.
    """
    total = math.prod(dims)
    active = min(int(lanes), total)
    if base >= 0 and base + active <= n and np.array_equal(
            load_addresses(dims, strides, base, lanes),
            base + np.arange(active, dtype=np.int64)):
        return LoadPlan("contiguous", active)
    if total <= lanes and dims[0] > 1 and strides[0] not in (-1, 0, 1):
        for k in range(1, len(dims)):
            if dims[k] > 1 and strides[k] in (-1, 1):
                return LoadPlan("tiled", active, k)
    return LoadPlan("walk", active)


class _Plan(ctypes.Structure):
    """``MdgatherPlan`` of ``csrc/mdgather.cu``: one walk's launch
    arguments, packed once so that a call passes one pointer (a ``ctypes``
    call costs microseconds per dozen integer arguments)."""

    _fields_ = [("src_len", ctypes.c_longlong), ("lanes", ctypes.c_longlong),
                ("dims", ctypes.c_longlong * MAX_DIMS),
                ("strides", ctypes.c_longlong * MAX_DIMS),
                ("base", ctypes.c_longlong), ("route", ctypes.c_int),
                ("ndims", ctypes.c_int), ("unit", ctypes.c_int)]


@functools.lru_cache(maxsize=1024)
def _call(dims: tuple, strides: tuple, base: int, n: int,
          lanes: Optional[int]):
    """``(lanes, plan, packed _Plan)`` of a CUDA call, validated,
    classified and packed once per walk."""
    dims4, strides4 = check_walk(dims, strides)
    lanes = math.prod(dims4) if lanes is None else int(lanes)
    if not 0 <= lanes <= MAX_LANES:
        raise ValueError(f"{lanes} lanes: need 0..{MAX_LANES}")
    ndims = len(dims)
    plan = load_plan(dims4[:ndims], strides4[:ndims], base, n, lanes)
    packed = _Plan(n, lanes, dims4, strides4, base, _ROUTE_IDS[plan.route],
                   ndims, plan.unit)
    return lanes, plan, packed


def mdgather(src: torch.Tensor, dims: Sequence[int], strides: Sequence[int],
             base: int = 0, lanes: Optional[int] = None) -> torch.Tensor:
    """Gather ``lanes`` (default ``prod(dims)``) elements of flat ``src``
    per Algorithm 1.

    ``src`` is one image ``(N,)`` or a batch ``(B, N)``; the result is
    ``(lanes,)`` / ``(B, lanes)`` of the same type.  Addresses are clamped
    into the image; lanes at or past ``prod(dims)`` yield 0.  A CUDA tensor
    always goes through a kernel route of :func:`load_plan` (built at first
    use); only a CPU tensor takes the plain version.
    """
    if src.dim() not in (1, 2) or src.shape[-1] == 0:
        raise ValueError("src must be a non-empty (N,) or (B, N) tensor, "
                         f"got shape {tuple(src.shape)}")
    if not src.is_cuda:
        with obs.span("kernels.route"):
            check_walk(dims, strides)
        return mdgather_ref(src, dims, strides, base, lanes)
    if src.element_size() not in _ELEM_SIZES:
        raise TypeError(f"unsupported element type {src.dtype}")
    device = src.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return mdgather(src, dims, strides, base, lanes)
    with obs.span("kernels.route"):
        lanes, plan, packed = _call(tuple(dims), tuple(strides), int(base),
                                    src.shape[-1], lanes)
        src = src.contiguous()
        out = torch.empty(src.shape[:-1] + (lanes,), dtype=src.dtype,
                          device=src.device)
    if out.numel() == 0:
        return out
    batch = src.shape[0] if src.dim() == 2 else 1
    code = _entry()(src.data_ptr(), out.data_ptr(), batch,
                    src.element_size(), ctypes.addressof(packed),
                    torch._C._cuda_getCurrentRawStream(device))
    _build.check(code, f"mdgather ({plan.route})")
    mdgather.launches += 1
    mdgather.routes[plan.route] += 1
    return out


#: Number of kernel launches made by :func:`mdgather` (CUDA tensors only),
#: and the same count by route.
mdgather.launches = 0
mdgather.routes = {route: 0 for route in _ROUTE_IDS}
