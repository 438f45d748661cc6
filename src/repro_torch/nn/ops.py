"""Composite numeric ops for model blocks, built from Table-II MVE ops.

The MVE ISA has no divide, no transcendentals, and no cross-dimension
reduction — the three gaps real LM blocks hit immediately (softmax needs
``exp`` and ``1/sum``; attention scores and SSM outputs reduce over the
*fastest* dimension, while the Section-IV masked tree only halves the
top one).  This module closes each gap by composition, with the
oracle/conformance discipline of the rest of the stack:

* :func:`exp_approx` — ``exp(x)`` for ``x <= 0`` (the post-max-subtract
  domain): Tag-predicated product reduction strips the integer-ish part
  of ``x`` into a product of ``exp(-2**j)`` constants, then a degree-5
  Taylor polynomial covers the ``(-0.25, 0]`` residual — ~45 vector
  ops, relative error ~1e-6 over ``[-60, 0]`` (measured,
  ``tests/test_torch_nn.py``).
* :func:`recip_approx` — ``1/s`` for ``s in [1, max_val]``: predicated
  halving (compare writes the Tag latch; ``s *= 0.5`` where ``s >= 2``)
  range-reduces into ``[1, 2)`` while mirroring the factor into the
  result, then Newton–Raphson ``r <- r * (2 - s*r)`` converges
  quadratically from ``r0 = 2/3`` (error ``(1/3)**2**iters``).
* :func:`tree_reduce_dim0` — log-tree reduction over dimension 0 via a
  scratch region: each step loads two halves with a per-row CR stride
  and combines, leaving one value per top-dim row.

Every helper traces through the ordinary :class:`KernelBuilder` API, so
the emitted programs stay inside the existing ISA/executors/targets —
no new opcodes, and the whole equivalence class (interp == fused == VM
== scheduler == targets == opt prefixes) applies unchanged.
"""
from __future__ import annotations

import numpy as np

from ..core.isa import DType
from ..frontend import CR, SEQ
from ..frontend.builder import KernelBuilder, VectorHandle
from ..frontend.operands import Operand

#: Inputs below this are flushed toward exp(-60) ~ 8.8e-27 — zero at
#: fp32 softmax scale, and safely inside the reduction's range.
EXP_CLAMP_LO = -60.0

#: Greedy binary reduction steps: conditionally strip 2**j from |x| and
#: fold exp(-2**j) into the product.  Sums to 63.75, covering the clamp
#: domain; the residual lands in (-0.25, 0].
_EXP_STEPS = (32.0, 16.0, 8.0, 4.0, 2.0, 1.0, 0.5, 0.25)

#: Degree-5 Taylor coefficients of exp, Horner order after the 1/120
#: head: (c4, c3, c2, c1, c0).
_EXP_TAIL = (1.0 / 24.0, 1.0 / 6.0, 0.5, 1.0, 1.0)


def exp_approx(b: KernelBuilder, x: VectorHandle,
               clamp_lo: float = EXP_CLAMP_LO) -> VectorHandle:
    """``exp(x)`` for ``x <= 0`` via predicated product reduction.

    The classic reduce-then-square scheme amplifies both truncation and
    fp32 rounding ``2**s``-fold (a ~5e-5 floor at best); instead the
    integer-ish part of ``x`` is peeled *multiplicatively*: for each
    step ``v`` in 32, 16, ... 0.25, a compare writes the Tag latch and
    two Tag-predicated in-place ops strip ``v`` from ``x`` while
    folding the constant ``exp(-v)`` into the running product — no
    error amplification anywhere.  The residual lies in ``(-0.25, 0]``,
    where a degree-5 Taylor polynomial is accurate to ``r**6/720 ~
    3e-7``; total measured relative error is ~1e-6 over ``[-60, 0]``
    (``tests/test_torch_nn.py``), and ``exp_approx(0) == 1.0`` exactly.
    """
    x = x.max(b.const(DType.F, float(clamp_lo)))   # fresh reg: safe to
    p = b.const(DType.F, 1.0)                      # mutate in place
    for v in _EXP_STEPS:
        x.lte(b.const(DType.F, -v))                # Tag := x <= -v
        b.add(x, b.const(DType.F, v), predicated=True, in_place=True)
        b.mul(p, b.const(DType.F, float(np.exp(-v))),
              predicated=True, in_place=True)
    poly = b.const(DType.F, 1.0 / 120.0)
    for coef in _EXP_TAIL:
        poly *= x
        poly += coef
    return p * poly


def recip_approx(b: KernelBuilder, s: VectorHandle, max_val: float,
                 newton_iters: int = 4) -> VectorHandle:
    """``1/s`` for ``s in [1, max_val]`` without a divide instruction.

    The range reduction runs ``ceil(log2(max_val))`` predicated steps:
    each compares ``s >= 2`` into the Tag latch, then conditionally
    halves both ``s`` and the mirror factor ``r`` (Tag-predicated
    in-place multiplies — masked lanes keep their previous contents).
    Newton–Raphson then refines ``rn = 1/s_reduced`` from ``rn0 = 2/3``;
    with ``s_reduced in [1, 2)`` the initial error is at most 1/3, so
    4 iterations land below fp32 epsilon.  The result is ``rn * r``.
    """
    steps = max(1, int(np.ceil(np.log2(float(max_val)))))
    half = b.const(DType.F, 0.5)
    two = b.const(DType.F, 2.0)
    r = b.const(DType.F, 1.0)
    sr = s.copy()                       # keep the caller's register intact
    for _ in range(steps):
        sr.gte(two)                     # Tag := s_reduced >= 2
        b.mul(sr, half, predicated=True, in_place=True)
        b.mul(r, half, predicated=True, in_place=True)
    rn = b.const(DType.F, 2.0 / 3.0)
    for _ in range(newton_iters):
        t = sr * rn
        t = b.sub(two, t)               # 2 - s*r
        rn *= t
    return rn * r


def tree_reduce_dim0(b: KernelBuilder, src: Operand, dst: Operand,
                     n: int, rows: int, op: str = "add") -> None:
    """Reduce dimension 0 of a ``(rows, n)`` row-major region.

    ``src`` and ``dst`` are scratch operands of shape ``(rows, n)``.
    Each step halves the reduced length: two half-rows load with a CR
    row stride of ``n``, combine (``add``/``max``/``min``), and the
    result stores into ``dst``'s low half.  After ``log2(n)`` steps the
    per-row reductions sit at ``dst[r, 0]`` (element stride ``n`` —
    reload with a CR stride, or ``(BCAST, ...)`` to broadcast them).

    ``n`` must be a power of two and ``(n // 2) * rows`` must fit the
    lane grid; combination order is the pairwise tree that
    :func:`repro_torch.kernels.ref.tree_sum_ref` mirrors, which is what
    makes integer and fp32 blocks bit-exact against their oracles.
    """
    if n < 2 or n & (n - 1):
        raise ValueError(f"tree_reduce_dim0 needs a power-of-two length "
                         f">= 2, got {n}")
    cur, length = src, n
    while length > 1:
        halfn = length // 2
        b.dims(halfn, rows, ld_strides={1: n}, st_strides={1: n})
        va = cur.at(0, 0).load(SEQ, CR)
        vb = cur.at(0, halfn).load(SEQ, CR)
        if op == "add":
            va += vb
        elif op == "max":
            va = va.max(vb)
        elif op == "min":
            va = va.min(vb)
        else:
            raise ValueError(f"unknown reduce op {op!r}")
        dst.at(0, 0).store(va, SEQ, CR)
        cur, length = dst, halfn
