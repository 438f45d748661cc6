"""The kernel entry points the rest of the port calls.

``mdv_gather`` / ``mdv_scatter_`` are the MVE ``vsld`` / ``vsst`` data path
of both executors (:mod:`repro_torch.core.interp`,
:mod:`repro_torch.core.engine`); ``flash_attention`` is the attention of
the LM prefill (:mod:`repro_torch.models.attention`); ``quantized_matmul``
is the int8 serving-path product.  There is no switch between kernel and
plain version, and no ``force_pallas``: a CPU tensor takes the plain
version, a CUDA tensor launches the hand-written kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import ref
from .bitplane_gemm import bitplane_matmul, int8_matmul
from .flash_attention import flash_attention  # noqa: F401  (an entry point)
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


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                     bitserial: bool = False) -> torch.Tensor:
    """``x`` (float, ``(M, K)``) @ dequant(``wq`` int8 ``(K, N)``, per-column
    ``scale``) with int8 activations: ``x`` quantized per row, an exact
    int32 product (``bitplane_matmul`` when ``bitserial``, else
    ``int8_matmul``), then one float rescale — in the reference's order."""
    xq, xs = ref.quantize_rowwise_ref(x)
    acc = bitplane_matmul(xq, wq) if bitserial else int8_matmul(xq, wq)
    return acc.to(torch.float32) * xs * scale[None, :]

