"""Plain PyTorch versions of the hand-written kernels in this package.

These are the semantics; the CUDA kernels must match them bit for bit
(they move elements, they do no arithmetic on them).  The wrappers in
:mod:`repro_torch.kernels.mdgather` / :mod:`~repro_torch.kernels.mdscatter`
take these versions for CPU tensors, and the on-card smoke run holds each
kernel against them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


# ---------------------------------------------------------------------------
# Multi-dimensional strided gather/scatter (the MVE vsld/vsst data path).
# ---------------------------------------------------------------------------

def mdv_lane_addresses(dims: Sequence[int], strides: Sequence[int],
                       base: int, lanes: int,
                       device=None) -> torch.Tensor:
    """Per-lane flat element addresses per Algorithm 1 (x fastest), int64."""
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    addr = torch.full((lanes,), int(base), dtype=torch.int64, device=device)
    rem = lane
    for length, stride in zip(dims, strides):
        idx = rem % int(length)
        rem = rem // int(length)
        addr = addr + idx * int(stride)
    return addr


def mdgather_ref(src: torch.Tensor, dims: Sequence[int],
                 strides: Sequence[int], base: int = 0,
                 lanes: Optional[int] = None) -> torch.Tensor:
    """Gather ``lanes`` (default ``prod(dims)``) lanes from flat ``src``.

    ``src`` is ``(N,)`` or a batch of images ``(B, N)``; the result is
    ``(lanes,)`` / ``(B, lanes)``.  Addresses are clamped into the image
    and lanes at or past ``prod(dims)`` read nothing and yield 0.
    """
    total = math.prod(int(d) for d in dims)
    lanes = total if lanes is None else int(lanes)
    addr = mdv_lane_addresses(dims, strides, base, lanes, src.device)
    out = src[..., addr.clamp(0, src.shape[-1] - 1)]
    if lanes > total:
        out[..., total:] = 0
    return out


def mdscatter_ref(dst: torch.Tensor, values: torch.Tensor,
                  dims: Sequence[int], strides: Sequence[int],
                  base: int = 0,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter lane values into a copy of flat ``dst`` (``(N,)`` or
    ``(B, N)``); returns the updated copy.

    Lane ``l`` is active when ``l < prod(dims)`` and ``mask[l]`` (when a
    per-lane mask is given).  On equal addresses the highest active lane
    wins; inactive lanes and out-of-range addresses write nowhere.  The
    same two steps as the kernel: resolve one owner lane per address,
    then let only owners store — so the result never depends on the order
    a parallel scatter applies duplicates in.
    """
    n = dst.shape[-1]
    lanes = values.shape[-1]
    total = math.prod(int(d) for d in dims)
    addr = mdv_lane_addresses(dims, strides, base, lanes, dst.device)
    lane = torch.arange(lanes, dtype=torch.int32, device=dst.device)
    active = (lane < total) & (addr >= 0) & (addr < n)
    if mask is not None:
        active = active & mask.to(torch.bool)
    owner = torch.full((n,), -1, dtype=torch.int32, device=dst.device)
    owner.scatter_reduce_(0, torch.where(active, addr, 0),
                          torch.where(active, lane, -1), "amax")
    picked = values[..., owner.clamp(min=0).long()]
    return torch.where(owner >= 0, picked, dst)
