"""Named tensor operands and the flat-memory planner.

The MVE machine model addresses one flat element memory; every
hand-written program in this repo used to carve it up with magic base
offsets (``c_base = n_rows * k + k * m`` and friends).  The frontend
replaces that with *named operands*: a kernel declares the tensors it
reads and writes (``b.input("x", (n,), DType.F)``), and the
:class:`MemoryPlan` packs them into the flat buffer back to back in
declaration order.  Programs address memory exclusively through operand
handles — ``a.at(i, j).load(...)`` — so base addresses never appear in
user code, and results are read back by name
(:meth:`MemoryPlan.unpack`).

Packing is deterministic (declaration order), which keeps frontend-built
programs byte-compatible with the legacy hand-packed layouts: declaring
operands in the legacy base-address order reproduces the exact memory
image, which the equivalence suite (``tests/test_frontend.py``) relies
on.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..core.isa import DType
from ..core.machine import to_numpy

#: Stride-mode mnemonics (the paper's 2-bit encodings, Section III-C).
BCAST = 0      # stride 0: replicate along this dimension
SEQ = 1        # stride 1: sequential
DERIVED = 2    # S_i = S_{i-1} * L_{i-1}: dense row-major continuation
CR = 3         # stride taken from the per-dimension stride control register

_KINDS = ("input", "output", "inout", "scratch")


class OperandError(ValueError):
    """Bad operand declaration or binding (wrong name/shape/dtype)."""


@dataclasses.dataclass(frozen=True)
class Operand:
    """One named tensor in the kernel's flat memory image.

    ``base`` is assigned at declaration time (operands pack in
    declaration order), so pointer tables for random-base accesses can
    be computed with :meth:`addr` while the kernel is still being built.
    """

    name: str
    shape: Tuple[int, ...]
    dtype: DType
    kind: str
    base: int
    init: Optional[np.ndarray] = None
    _builder: object = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    # -- addressing --------------------------------------------------------
    def _flat(self, idx: Tuple) -> int:
        """Row-major flat element offset of a (possibly partial) index."""
        if len(idx) == 1 and not isinstance(idx[0], tuple):
            # single index: flat offset into the ravelled operand
            return idx[0]
        if len(idx) > len(self.shape):
            raise OperandError(
                f"operand {self.name!r} has {len(self.shape)} dims, "
                f"got index {idx}")
        full = tuple(idx) + (0,) * (len(self.shape) - len(idx))
        off = 0
        for i, n in zip(full, self.shape):
            off = off * n + i
        return off

    def at(self, *idx) -> "OperandRef":
        """An addressable reference: ``a.at(i, j)`` is element ``a[i, j]``
        (row-major; trailing indices default to 0, a single index is a
        flat offset into the ravelled tensor)."""
        return OperandRef(self, self._flat(idx) if idx else 0)

    def addr(self, idx=0):
        """Absolute element address(es) in the flat memory image.

        Accepts an int flat offset or a numpy array of offsets — the
        latter is how pointer tables for random-base accesses (Eq. 1)
        are built without ever spelling out a base address."""
        return self.base + np.asarray(idx) if isinstance(
            idx, np.ndarray) else self.base + int(idx)

    # -- sugar: load/store at offset 0 -------------------------------------
    def load(self, *modes, dtype: Optional[DType] = None):
        return self.at().load(*modes, dtype=dtype)

    def store(self, value, *modes, dtype: Optional[DType] = None) -> None:
        self.at().store(value, *modes, dtype=dtype)

    def rload(self, *modes, dtype: Optional[DType] = None):
        return self.at().rload(*modes, dtype=dtype)

    def rstore(self, value, *modes, dtype: Optional[DType] = None) -> None:
        self.at().rstore(value, *modes, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class OperandRef:
    """An operand at an element offset — the unit of addressing.

    ``load``/``store`` emit strided accesses whose base is the referenced
    element; ``rload``/``rstore`` treat the referenced slice as the
    pointer array of a random-base access (Eq. 1).  The per-dimension
    stride modes are the frontend mnemonics :data:`SEQ`, :data:`BCAST`,
    :data:`DERIVED`, :data:`CR` (or raw 2-bit mode ints).
    """

    operand: Operand
    offset: int

    @property
    def address(self) -> int:
        return self.operand.base + self.offset

    def _b(self):
        b = self.operand._builder
        if b is None:
            raise OperandError(
                f"operand {self.operand.name!r} is not bound to a builder")
        return b

    def load(self, *modes, dtype: Optional[DType] = None):
        return self._b()._load(self, modes,
                               dtype or self.operand.dtype, random=False)

    def rload(self, *modes, dtype: Optional[DType] = None):
        return self._b()._load(self, modes,
                               dtype or self.operand.dtype, random=True)

    def store(self, value, *modes, dtype: Optional[DType] = None) -> None:
        self._b()._store(self, value, modes, dtype, random=False)

    def rstore(self, value, *modes, dtype: Optional[DType] = None) -> None:
        self._b()._store(self, value, modes, dtype, random=True)


class MemoryPlan:
    """The packed flat-memory layout of a kernel's named operands.

    ``pack`` builds a memory image from named arrays (falling back to
    each operand's declared ``init``, or zeros); ``unpack`` slices a
    result image back into named, shaped views.  Round-trips by name:
    ``plan.unpack(plan.pack(d))[k] == d[k]`` for every operand ``k``.
    """

    def __init__(self, operands: Iterable[Operand]):
        self.operands: "OrderedDict[str, Operand]" = OrderedDict(
            (op.name, op) for op in operands)
        self.size = sum(op.size for op in self.operands.values())

    def __contains__(self, name: str) -> bool:
        return name in self.operands

    def base(self, name: str) -> int:
        return self.operands[name].base

    def region(self, name: str) -> slice:
        op = self.operands[name]
        return slice(op.base, op.base + op.size)

    def pack(self, values: Optional[Dict[str, np.ndarray]] = None
             ) -> np.ndarray:
        """Build the flat float64 memory image the executors consume."""
        if values is not None and not isinstance(values, dict):
            raise OperandError(
                f"pack() wants a dict of named operand arrays, got "
                f"{type(values).__name__} — a flat memory image does "
                "not need packing")
        values = dict(values) if values is not None else {}
        mem = np.zeros(self.size, dtype=np.float64)
        for name, op in self.operands.items():
            val = values.pop(name, op.init)
            if val is None:
                continue
            arr = np.asarray(val)
            if arr.size != op.size:
                raise OperandError(
                    f"operand {name!r}: expected shape {op.shape} "
                    f"({op.size} elements), got {arr.shape}")
            mem[op.base:op.base + op.size] = arr.ravel()
        if values:
            raise OperandError(
                f"unknown operand(s) {sorted(values)}; kernel declares "
                f"{list(self.operands)}")
        return mem

    def unpack(self, memory) -> Dict[str, np.ndarray]:
        """Named, shaped copies of every non-scratch operand region."""
        mem = to_numpy(memory)
        out: Dict[str, np.ndarray] = {}
        for name, op in self.operands.items():
            if op.kind == "scratch":
                continue
            out[name] = mem[..., op.base:op.base + op.size].reshape(
                mem.shape[:-1] + op.shape).copy()
        return out

    def __repr__(self) -> str:
        rows = ", ".join(
            f"{op.name}@{op.base}:{op.kind}{list(op.shape)}"
            for op in self.operands.values())
        return f"MemoryPlan({self.size} elements: {rows})"
