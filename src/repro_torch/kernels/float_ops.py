"""MVE float arithmetic and float32 <-> float16 conversions on Hopper, with
the reference's bits.

No TPU kernel stands behind this module: the reference leaves float
``vadd``/``vsub``/``vmul`` and the float <-> half conversions to XLA on an
x86 host.  CUDA's arithmetic gives its canonical NaN (``0x7FFFFFFF``, half
``0x7FFF``) where x86 gives the first NaN operand quieted or the default
NaN ``0xFFC00000``, and keeps float32 denormals that XLA's CPU runtime
flushes to zero.  ``csrc/float_ops.cu`` computes both functions with x86's
rules, so a float instruction on the card costs the one launch the torch op
it replaces would have cost:

* :func:`float_binary` — ``add``/``sub``/``mul`` of two float32 or two
  float16 tensors of one shape, one rounding point each
  (``__fadd_rn``/``__fsub_rn``/``__fmul_rn``), float16 computed in float32
  and rounded once;
* :func:`float_convert` — float32 <-> float16, rounding to nearest even,
  NaN payloads kept as F16C keeps them.

Bound on this card: bytes (operands read once, the result written once).
The plain PyTorch versions are
:func:`repro_torch.kernels.ref.float_binary_ref` and
:func:`~repro_torch.kernels.ref.float_convert_ref`; the wrappers take them
only for CPU tensors.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import FLOAT_BINARY_OPS, float_binary_ref, float_convert_ref

_SIZES = {torch.float32: 4, torch.float16: 2}
_BINARY_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_CONVERT_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _entry(name: str, argtypes):
    fn = getattr(_build.load("float_ops"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _vec(*tensors: torch.Tensor) -> int:
    """4 when every pointer is aligned to four elements, else 1."""
    return 4 if all(t.data_ptr() % (4 * t.element_size()) == 0
                    for t in tensors) else 1


def float_binary(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b``, ``a - b`` or ``a * b`` (``op`` ``"add"``, ``"sub"``,
    ``"mul"``) of two float32 or two float16 tensors of one shape, with
    x86's NaN bits and float32 denormals flushed (see the module note).
    A CUDA tensor always goes through the kernel; only CPU tensors take
    the plain version."""
    if op not in FLOAT_BINARY_OPS:
        raise ValueError(f"op {op!r}: expected one of {FLOAT_BINARY_OPS}")
    if a.dtype != b.dtype or a.dtype not in _SIZES:
        raise TypeError(f"operands {a.dtype}, {b.dtype}: need two float32 "
                        "or two float16 tensors")
    if a.shape != b.shape:
        raise ValueError(f"operand shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if not (a.is_cuda or b.is_cuda):
        return float_binary_ref(op, a, b)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return float_binary(op, a, b)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    code = _entry("float_binary_launch", _BINARY_ARGTYPES)(
        FLOAT_BINARY_OPS.index(op), _SIZES[a.dtype], a.data_ptr(),
        b.data_ptr(), out.data_ptr(), a.numel(), _vec(a, b, out),
        torch._C._cuda_getCurrentRawStream(device))
    _build.check(code, f"float_binary ({op}, {a.dtype})")
    float_binary.launches += 1
    return out


def float_convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` converted float32 -> float16 or float16 -> float32 as x86's
    F16C converts (see the module note).  A CUDA tensor always goes
    through the kernel; only a CPU tensor takes the plain version."""
    if {x.dtype, dtype} != set(_SIZES):
        raise TypeError(f"{x.dtype} -> {dtype}: float_convert takes "
                        "float32 <-> float16")
    if not x.is_cuda:
        return float_convert_ref(x, dtype)
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return float_convert(x, dtype)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    code = _entry("float_convert_launch", _CONVERT_ARGTYPES)(
        _SIZES[x.dtype], x.data_ptr(), out.data_ptr(), x.numel(),
        _vec(x, out), torch._C._cuda_getCurrentRawStream(device))
    _build.check(code, f"float_convert ({x.dtype} -> {dtype})")
    float_convert.launches += 1
    return out


#: Launch counters (CUDA tensors only).
float_binary.launches = 0
float_convert.launches = 0
