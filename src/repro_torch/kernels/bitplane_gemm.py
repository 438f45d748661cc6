"""Exact int8 matrix products on Hopper, direct and bit-plane by bit-plane.

Replaces the TPU kernels ``repro/kernels/bitplane_gemm.py::_int8_kernel``
(wrapper ``int8_matmul``) and ``::_bitplane_kernel`` (wrapper
``bitplane_matmul``).  Both run one kernel of ``csrc/bitplane_gemm.cu``,
``bitplane_gemm_kernel<kFullBytes>``, on the int8 tensor cores: one block
of 8 warps per 128x128 int32 tile, K in steps of 64 bytes staged by
``cp.async`` in two stages, ``mma.sync`` m16n8k32 (s8 in, s32 accumulators
without ``.satfinite``).  w stays (K, N) row-major: its rows are staged in a
permuted order so that ``ldmatrix.trans`` and two byte permutes give the
column-major B fragments, with no transposed copy.  K or N not a multiple
of 16 is staged by guarded scalar loads.  The two instances differ only in
what each K step multiplies:

* ``int8_matmul`` (``kFullBytes``): the raw weight bytes, one tensor-core
  product per 32 bytes of K.
* ``bitplane_matmul``: the paper's bit-serial structure (Section VII-E)
  stays in the kernel: plane ``b`` is ``word & (0x01010101 << b)``, bytes
  0 or ``2**b`` (the top plane negative), and each plane is one
  tensor-core product into the same accumulators, so ``nbits=4`` costs
  half the products of ``nbits=8``.

Both are bit-exact: integer sums wrap mod 2**32 exactly as the reference's
int32 arithmetic does.  Ragged M/N/K are zeros while staging, not padded in
device memory.

Bound on this card at the qwen2-0.5b MLP shape: bytes, ``M*K + K*N`` read
and ``4*M*N`` written (the kernel's source note has the arithmetic); the
bit-plane kernel's own floor is ``nbits`` int8 products of tensor-core
time.

The plain PyTorch versions are :func:`repro_torch.kernels.ref.int8_matmul_ref`
and :func:`~repro_torch.kernels.ref.bitplane_matmul_ref`; the wrappers take
them only for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import bitplane_matmul_ref, int8_matmul_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
TILE = 128          # output tile edge of the kernel; M rides on gridDim.y


def _entry(name: str):
    fn = getattr(_build.load("bitplane_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + (
            [ctypes.c_int] if name == "bitplane_gemm_launch" else []) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: need "
                         "(M, K) @ (K, N)")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x {x.dtype}, w {w.dtype}: both must be int8")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.is_cuda and x.shape[0] > 65535 * TILE:
        raise ValueError(f"M = {x.shape[0]} exceeds the kernel's grid")


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, *extra):
    x, w = x.contiguous(), w.contiguous()
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty(m, n, dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        code = _entry(name)(x.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                            n, k, *extra,
                            torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    return out


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 ``(M, K)`` @ int8 ``(K, N)`` -> int32.  A CUDA tensor
    always goes through the kernel; only a CPU tensor takes the plain
    version."""
    _check(x, w)
    if not x.is_cuda:
        return int8_matmul_ref(x, w)
    out = _launch("int8_gemm_launch", x, w)
    int8_matmul.launches += 1
    return out


def bitplane_matmul(x: torch.Tensor, w: torch.Tensor,
                    nbits: int = 8) -> torch.Tensor:
    """The same product computed over the ``nbits`` low bit planes of
    ``w`` (two's complement, top plane negative): equal to
    :func:`int8_matmul` for ``nbits=8``, and for narrower weights (values in
    ``[-2**(nbits-1), 2**(nbits-1))``) with ``nbits`` planes."""
    _check(x, w)
    if not 1 <= int(nbits) <= 8:
        raise ValueError(f"nbits={nbits}: need 1..8")
    if not x.is_cuda:
        return bitplane_matmul_ref(x, w, int(nbits))
    out = _launch("bitplane_gemm_launch", x, w, int(nbits))
    bitplane_matmul.launches += 1
    return out


#: Launch counters (CUDA tensors only).
int8_matmul.launches = 0
bitplane_matmul.launches = 0
