"""MVE ``vsst`` on Hopper: the multi-dimensional strided scatter.

Replaces the TPU kernel ``repro/kernels/mdscatter.py::_scatter_kernel``
(wrapper ``mdscatter``).  That kernel walks its lane tiles one after another
in a single grid step, which is what makes the highest lane win on equal
addresses.  GPU blocks run in no order, but a strided store's walk is
static (dims, strides, base, image length and lane count are Python ints)
and a per-lane mask only removes writers, so :func:`store_plan` classifies
each walk once on the host (cached) and :func:`mdscatter_` takes one of
three routes of ``csrc/mdscatter.cu``:

* ``"contiguous"`` — every lane that lands in the image writes
  ``lane + shift`` (``shift >= 0``), and those lanes are one run: one
  kernel, a masked copy of that run of every image, 16 bytes per thread
  where alignment allows; no walk, no table, no atomics.  Every static store
  of the 14 Section-IV patterns takes it.
* ``"distinct"`` — no two lanes land on one address, whatever the mask: one
  kernel; each thread takes one lane of :func:`lane_order` (the lanes that
  land, sorted by address, uploaded at the walk's first call), walks its
  address once (32-bit peeling) and stores it in a slice of the batch.
* ``"colliding"`` — the winner of a shared address depends on the
  device-resident mask: a memset of an int32 owner table, an ``atomicMax``
  owner pass in lane order, and the distinct route's kernel storing owners
  only.

A walk on which no lane lands in the image (``"none"``) launches nothing.
A masked lane writes nowhere; it is not blended back afterwards.

Bound on this card: bytes — each stored element read once from the lanes
and written once into the image, plus the lane mask (and, colliding, the
``4 * N``-byte owner table).

The plain PyTorch version is :func:`repro_torch.kernels.ref.mdscatter_ref`;
the wrappers take it only for a CPU tensor.
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
from .mdgather import _ELEM_SIZES, check_walk
from .ref import mdscatter_ref, wrap_store_addresses

_WALK_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                  + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
                  + [ctypes.c_int, ctypes.c_int] + [ctypes.c_longlong] * 9
                  + [ctypes.c_void_p])
_CONTIG_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] + [ctypes.c_longlong] * 3
                    + [ctypes.c_void_p])
MAX_LANES = 2**31 - 1          # lane ids are peeled in 32-bit arithmetic


def _entry(name: str, argtypes):
    fn = getattr(_build.load("mdscatter"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class StorePlan:
    """How :func:`mdscatter_` executes one walk.  ``route`` is
    ``"contiguous"``, ``"distinct"``, ``"colliding"`` or ``"none"``; a
    contiguous walk stores lanes ``lo .. hi - 1`` to ``lane + shift``."""

    route: str
    lo: int = 0
    hi: int = 0
    shift: int = 0


def store_addresses(dims: Tuple[int, ...], strides: Tuple[int, ...],
                    base: int, n: int, lanes: int):
    """``(lane, addr)`` int64 arrays of the lanes below ``prod(dims)`` and
    ``lanes`` whose address, after ``[-n, 0)`` wraps to ``+n``, lies in
    ``[0, n)``: the lanes that store when the mask lets them."""
    active = min(int(lanes), math.prod(dims))
    lane = np.arange(active, dtype=np.int64)
    addr = np.full(active, int(base), dtype=np.int64)
    rem = lane
    for length, stride in zip(dims, strides):
        addr += (rem % length) * stride
        rem = rem // length
    addr = wrap_store_addresses(addr, n)
    inside = (addr >= 0) & (addr < n)
    return lane[inside], addr[inside]


@functools.lru_cache(maxsize=4096)
def store_plan(dims: Tuple[int, ...], strides: Tuple[int, ...], base: int,
               n: int, lanes: int) -> StorePlan:
    """Classify a store walk on the host, once per ``(dims, strides, base,
    n, lanes)``.  A mask only removes writers, so the route holds for every
    mask."""
    lane, addr = store_addresses(dims, strides, base, n, lanes)
    if lane.size == 0:
        return StorePlan("none")
    lo, hi, shift = int(lane[0]), int(lane[-1]) + 1, int(addr[0] - lane[0])
    if (shift >= 0 and hi - lo == lane.size
            and bool((addr - lane == shift).all())):
        return StorePlan("contiguous", lo, hi, shift)
    if np.unique(addr).size == addr.size:
        return StorePlan("distinct")
    return StorePlan("colliding")


def lane_order(dims: Tuple[int, ...], strides: Tuple[int, ...], base: int,
               n: int, lanes: int) -> np.ndarray:
    """The lanes that land in the image, sorted by address (equal addresses
    in lane order), int32: the order in which the distinct and colliding
    routes' threads take them, so that a warp stores to neighbouring
    addresses."""
    lane, addr = store_addresses(dims, strides, base, n, lanes)
    return lane[np.argsort(addr, kind="stable")].astype(np.int32)


@functools.lru_cache(maxsize=1024)
def _walk(dims: tuple, strides: tuple, base: int, n: int, lanes: int):
    """``(ndims, dims4, strides4, plan)`` of a CUDA call, validated and
    classified once per walk."""
    dims4, strides4 = check_walk(dims, strides)
    ndims = len(dims)
    return ndims, dims4, strides4, store_plan(dims4[:ndims],
                                              strides4[:ndims], base, n,
                                              lanes)


@functools.lru_cache(maxsize=1024)
def _device_lane_order(dims: tuple, strides: tuple, base: int, n: int,
                       lanes: int, device: torch.device) -> torch.Tensor:
    """:func:`lane_order` on ``device``, uploaded at a walk's first call."""
    return torch.from_numpy(lane_order(dims, strides, base, n, lanes)).to(
        device)


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
    A CUDA tensor always goes through a kernel route of :func:`store_plan`;
    only a CPU tensor takes the plain version.
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
    if not dst.is_cuda:
        with obs.span("kernels.route"):
            check_walk(dims, strides)
        return dst.copy_(mdscatter_ref(dst, values, dims, strides, base,
                                       mask))
    if dst.element_size() not in _ELEM_SIZES:
        raise TypeError(f"unsupported element type {dst.dtype}")
    if lanes > MAX_LANES:
        raise ValueError(f"{lanes} lanes: at most {MAX_LANES}")
    device = dst.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return mdscatter_(dst, values, dims, strides, base, mask)
    n = dst.shape[-1]
    with obs.span("kernels.route"):
        walk = (tuple(dims), tuple(strides), int(base), n, lanes)
        ndims, dims4, strides4, plan = _walk(*walk)
        if plan.route == "none":            # no lane lands in the image
            return dst
        values = values.contiguous()
        mask = None if mask is None else mask.contiguous()     # kept alive
        mask_ptr = None if mask is None else mask.data_ptr()
        batch = dst.shape[0] if dst.dim() == 2 else 1
        stream = torch._C._cuda_getCurrentRawStream(device)
        if plan.route != "contiguous":
            order = _device_lane_order(*walk, dst.device)
            owner = (torch.empty(n, dtype=torch.int32, device=dst.device)
                     if plan.route == "colliding" else None)
    if plan.route == "contiguous":
        code = _entry("mdscatter_contig_launch", _CONTIG_ARGTYPES)(
            dst.data_ptr(), values.data_ptr(), mask_ptr, batch, n, lanes,
            dst.element_size(), plan.lo, plan.hi - plan.lo, plan.shift,
            stream)
    else:
        code = _entry("mdscatter_launch", _WALK_ARGTYPES)(
            dst.data_ptr(), values.data_ptr(),
            None if owner is None else owner.data_ptr(), order.data_ptr(),
            order.numel(), mask_ptr, batch, n, lanes, dst.element_size(),
            ndims, *dims4, *strides4, int(base), stream)
    _build.check(code, f"mdscatter ({plan.route})")
    mdscatter_.launches += 1
    mdscatter_.routes[plan.route] += 1
    return dst


#: Number of calls in which :func:`mdscatter_` launched a kernel route (one
#: per call, whatever the route's device work; CUDA tensors only), and the
#: same count by route.
mdscatter_.launches = 0
mdscatter_.routes = {"contiguous": 0, "distinct": 0, "colliding": 0}


def mdscatter(dst: torch.Tensor, values: torch.Tensor, dims: Sequence[int],
              strides: Sequence[int], base: int = 0,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Functional form of :func:`mdscatter_`: scatters into a copy."""
    return mdscatter_(dst.contiguous().clone(), values, dims, strides, base,
                      mask)
