"""The gather/scatter entry points the executors call.

``mdv_gather`` / ``mdv_scatter_`` are the MVE ``vsld`` / ``vsst`` data path
of both executors (:mod:`repro_torch.core.interp`,
:mod:`repro_torch.core.engine`).  There is no switch between kernel and
plain version: a CPU tensor takes the plain version, a CUDA tensor launches
the hand-written kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mdgather import mdgather
from .mdscatter import mdscatter, mdscatter_


def mdv_gather(src: torch.Tensor, dims: Sequence[int],
               strides: Sequence[int], base: int = 0,
               lanes: Optional[int] = None) -> torch.Tensor:
    """MVE vsld: multi-dimensional strided gather from a flat image (or a
    ``(B, N)`` batch of images) into ``lanes`` lanes."""
    return mdgather(src, dims, strides, base, lanes)


def mdv_scatter_(dst: torch.Tensor, values: torch.Tensor,
                 dims: Sequence[int], strides: Sequence[int], base: int = 0,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MVE vsst, in place: masked multi-dimensional strided scatter into a
    flat image (or a ``(B, N)`` batch); the highest lane wins collisions."""
    return mdscatter_(dst, values, dims, strides, base, mask)


def mdv_scatter(dst: torch.Tensor, values: torch.Tensor,
                dims: Sequence[int], strides: Sequence[int], base: int = 0,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MVE vsst into a copy of ``dst`` (the caller's image is untouched)."""
    return mdscatter(dst, values, dims, strides, base, mask)
