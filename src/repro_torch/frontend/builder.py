"""``KernelBuilder`` / ``@mve.kernel``: the tracing kernel frontend.

The paper's pitch for MVE is that it "abstracts cache geometry and data
layout" behind an intrinsics interface (Section V); this module is that
interface for the repo.  A kernel function receives a builder, declares
named tensor operands, opens dimension scopes, and computes with
operator-overloaded vector handles:

    import repro_torch.frontend as mve
    from repro_torch.frontend import SEQ
    from repro_torch.core.isa import DType

    @mve.kernel
    def daxpy(b, n=8192, alpha=1.5):
        x = b.input("x", (n,), DType.F)
        y = b.inout("y", (n,), DType.F)
        b.width(32)
        with b.dims(n):
            b.scalar(4)
            vx = x.load(SEQ)
            vy = y.load(SEQ)
            vy += alpha * vx          # vsetdup + vmul + vadd
            y.store(vy, SEQ)

    k = daxpy(n=4096)                 # -> Kernel
    out, state = k.run({"x": xs, "y": ys})
    out["y"]                          # results read back by name

What the user never sees:

* register numbers — every value is a fresh *virtual* register; a
  liveness-based linear-scan allocator (:mod:`repro_torch.frontend.regalloc`)
  maps them onto the physical file and errors only when no valid
  assignment exists.  Staying under ``vm.N_REGS`` keeps kernels on the
  signature-shared VM executor path;
* base addresses — operands are named tensors packed by the memory
  planner (:mod:`repro_torch.frontend.operands`); addressing goes through
  ``a.at(i, j)``;
* config-op sequencing — ``b.dims(...)`` emits ``vsetdimc`` /
  ``vsetdiml`` (+ stride CRs) in canonical order, ``b.masked_off(...)``
  brackets a scope with ``vunsetmask``/``vsetmask``.

Tracing is eager: Python control flow unrolls, so the emitted program is
straight-line — exactly what the compile walk of
:mod:`repro_torch.core.engine` resolves statically.  ``build()`` allocates
registers, then validates the program strictly
(:func:`repro_torch.core.isa.validate`): out-of-range dims, width/dtype
mismatches and out-of-image addressing fail at build time with one-line
diagnostics instead of deep inside the walk compiler.

Design note: docs/FRONTEND.md.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import isa
from ..core.isa import DType, Instr, Op
from ..core.machine import (ControlState, apply_config, config_cell,
                            read_config_cell)
from . import regalloc
from .operands import MemoryPlan, Operand, OperandError, OperandRef


class BuildError(ValueError):
    """Misuse of the builder API detected while tracing."""


class VectorHandle:
    """A traced vector value living in a virtual register.

    Arithmetic operators emit instructions; Python scalars on either
    side are broadcast via ``vsetdup`` into a fresh register first.
    Augmented assignment (``+=`` and friends) updates *in place* —
    masked lanes keep the destination's previous contents, which is how
    accumulators and read-modify-write idioms are expressed.
    """

    __slots__ = ("_b", "vreg", "dtype")

    def __init__(self, b: "KernelBuilder", vreg: int, dtype: DType):
        self._b = b
        self.vreg = vreg
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"VectorHandle(v{self.vreg}, {self.dtype.name})"

    # -- binary arithmetic -------------------------------------------------
    def __add__(self, o):
        return self._b._binary(Op.ADD, self, o)

    def __radd__(self, o):
        # commutative: keep the handle as vs1, like hand-written code
        return self._b._binary(Op.ADD, self, o)

    def __sub__(self, o):
        return self._b._binary(Op.SUB, self, o)

    def __rsub__(self, o):
        return self._b._binary(Op.SUB, self, o, swap=True)

    def __mul__(self, o):
        return self._b._binary(Op.MUL, self, o)

    def __rmul__(self, o):
        return self._b._binary(Op.MUL, self, o)

    def __xor__(self, o):
        return self._b._binary(Op.XOR, self, o)

    def __and__(self, o):
        return self._b._binary(Op.AND, self, o)

    def __or__(self, o):
        return self._b._binary(Op.OR, self, o)

    def __iadd__(self, o):
        return self._b._binary(Op.ADD, self, o, in_place=True)

    def __isub__(self, o):
        return self._b._binary(Op.SUB, self, o, in_place=True)

    def __imul__(self, o):
        return self._b._binary(Op.MUL, self, o, in_place=True)

    def __ixor__(self, o):
        return self._b._binary(Op.XOR, self, o, in_place=True)

    def __iand__(self, o):
        return self._b._binary(Op.AND, self, o, in_place=True)

    def __ior__(self, o):
        return self._b._binary(Op.OR, self, o, in_place=True)

    def min(self, o):
        return self._b._binary(Op.MIN, self, o)

    def max(self, o):
        return self._b._binary(Op.MAX, self, o)

    # -- shifts / rotates (immediate amounts; integers only) ---------------
    def __lshift__(self, amount: int):
        return self._b._shift(self, amount)

    def __rshift__(self, amount: int):
        return self._b._shift(self, -int(amount))

    def __ilshift__(self, amount: int):
        return self._b._shift(self, amount, in_place=True)

    def __irshift__(self, amount: int):
        return self._b._shift(self, -int(amount), in_place=True)

    def rot(self, amount: int):
        return self._b._emit_unary(Op.ROTI, self, imm=int(amount))

    def shift_by(self, amount: "VectorHandle"):
        """Variable left shift (``vshr``): per-lane amounts."""
        return self._b._binary(Op.SHR, self, amount)

    # -- moves -------------------------------------------------------------
    def copy(self):
        return self._b._emit_unary(Op.CPY, self)

    def astype(self, dtype: DType):
        """Type conversion (``vcvt``): float<->int with saturation to the
        destination's range, exactly like the executors."""
        return self._b._emit_unary(Op.CVT, self, dtype=dtype)

    # -- comparisons: write the per-lane Tag predicate latch ---------------
    def gt(self, o):
        self._b._compare(Op.GT, self, o)

    def gte(self, o):
        self._b._compare(Op.GTE, self, o)

    def lt(self, o):
        self._b._compare(Op.LT, self, o)

    def lte(self, o):
        self._b._compare(Op.LTE, self, o)

    def eq(self, o):
        self._b._compare(Op.EQ, self, o)

    def neq(self, o):
        self._b._compare(Op.NEQ, self, o)


@dataclasses.dataclass(eq=False)      # identity semantics: hashable, so
class Kernel:                         # the engine can track attachments
    """A built kernel: validated program + memory plan + metadata.

    ``program`` targets the existing :class:`repro_torch.core.isa.Program` IR
    unchanged, so every executor (step interpreter, fused engine,
    program-as-data VM) and the serving stack run kernels without any
    semantic changes — ``compile_program``, ``MVEScheduler.submit`` and
    ``MVEProgramServer.submit`` all accept a ``Kernel`` directly.
    """

    name: str
    program: isa.Program
    plan: MemoryPlan
    n_vregs: int
    n_regs: int            # distinct physical registers after allocation
    max_live: int          # peak simultaneous liveness

    # -- memory binding ----------------------------------------------------
    def pack(self, operands: Optional[Dict[str, np.ndarray]] = None
             ) -> np.ndarray:
        """Flat memory image from named arrays (declared inits fill the
        rest)."""
        return self.plan.pack(operands)

    def unpack(self, memory) -> Dict[str, np.ndarray]:
        """Named, shaped results from a (possibly batched) memory image."""
        return self.plan.unpack(memory)

    def pack_batch(self, operand_batches: Dict[str, np.ndarray]
                   ) -> np.ndarray:
        """Stack per-operand leading batch axes into a batch of memory
        images (missing operands broadcast their declared init)."""
        batch = max(np.asarray(v).shape[0]
                    for v in operand_batches.values())
        return np.stack([
            self.pack({k: np.asarray(v)[i]
                       for k, v in operand_batches.items()})
            for i in range(batch)])

    def equivalent(self, other: "Kernel") -> bool:
        """Same memory-image semantics: identical operand layout (names,
        shapes, kinds, bases) and identical declared init data — i.e.
        ``pack``/``unpack`` behave the same on both."""
        a, b = self.plan.operands, other.plan.operands
        if list(a) != list(b):
            return False
        for name in a:
            oa, ob = a[name], b[name]
            if (oa.shape, oa.kind, oa.base, oa.dtype) != \
                    (ob.shape, ob.kind, ob.base, ob.dtype):
                return False
            if (oa.init is None) != (ob.init is None):
                return False
            if oa.init is not None and not np.array_equal(oa.init, ob.init):
                return False
        return True

    # -- execution ---------------------------------------------------------
    def compile(self, cfg=None, mode: Optional[str] = None,
                target: Optional[object] = None,
                opt_level: Optional[int] = None, device=None):
        """The cached :class:`~repro_torch.core.engine.CompiledProgram`
        for this kernel on ``device`` (default ``cuda``).

        ``target=`` (pricing and lowering under another registered target)
        and ``opt_level=`` (the optimizer pass pipeline) are still to be
        ported and raise ``NotImplementedError`` (ROADMAP.md queue A)."""
        if target is not None:
            raise NotImplementedError(
                "target=: the pluggable target API is still to be ported "
                "(ROADMAP.md queue A: targets/)")
        from ..core.engine import compile_program
        return compile_program(self, cfg, mode=mode, opt_level=opt_level,
                               device=device)

    def run(self, operands: Optional[Dict[str, np.ndarray]] = None,
            cfg=None, mode: Optional[str] = None,
            target: Optional[object] = None, device=None):
        """Execute once; returns ``(outputs, state)`` with outputs read
        back by name (every non-scratch operand) as NumPy arrays."""
        mem_after, state = self.compile(cfg, mode, target,
                                        device=device).run(
            self.pack(operands))
        return self.unpack(mem_after), state

    def run_batch(self, operand_batches: Dict[str, np.ndarray],
                  cfg=None, mode: Optional[str] = None,
                  target: Optional[object] = None, device=None):
        """Batched execution over a leading batch axis per operand
        (missing operands broadcast their declared init)."""
        mems = self.pack_batch(operand_batches)
        mem_after, _, _ = self.compile(cfg, mode, target,
                                       device=device).run_batch(mems)
        return self.unpack(mem_after)

    def dump(self) -> str:
        return self.program.dump()


class _Scope:
    """Returned by :meth:`KernelBuilder.dims` — config ops are emitted at
    the call, ``with`` adds structure only (and restores nothing: MVE
    config registers are architectural state, not a stack)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class KernelBuilder:
    """Tracing builder: declare operands, configure dimensions, compute.

    See the module docstring for the programming model.  Every emitted
    instruction uses virtual registers; :meth:`build` runs the register
    allocator and strict validation and returns a :class:`Kernel`.
    """

    def __init__(self, name: str = "kernel",
                 max_regs: int = regalloc.DEFAULT_MAX_REGS):
        self.name = name
        self.max_regs = max_regs
        self._instrs: List[Instr] = []
        self._operands: "List[Operand]" = []
        self._names: Dict[str, Operand] = {}
        self._cursor = 0
        self._next_vreg = 0
        self._dim_lens: Tuple[int, ...] = (1,)
        self._pinned: List[int] = []
        self._built = False
        # Duplicate-config suppression: mirror of the control registers
        # the traced program has established so far, plus the set of
        # cells it has explicitly written (first writes always emit,
        # even when they match the power-on defaults — making the traced
        # configuration explicit is the frontend's job; removing
        # power-on no-ops is the optimizer's).
        self._ctrl = ControlState()
        self._cfg_written: set = set()

    # -- operand declaration ----------------------------------------------
    def _declare(self, kind: str, name: str, shape, dtype: DType,
                 init) -> Operand:
        if self._built:
            raise BuildError("builder already built")
        if name in self._names:
            raise OperandError(f"operand {name!r} declared twice")
        if init is not None:
            init = np.asarray(init)
            shape = tuple(shape) if shape is not None else init.shape
            if init.size != int(np.prod(shape)):
                raise OperandError(
                    f"operand {name!r}: init has {init.size} elements, "
                    f"shape {shape} wants {int(np.prod(shape))}")
        elif shape is None:
            raise OperandError(f"operand {name!r} needs a shape or init")
        else:
            shape = tuple(shape)
        op = Operand(name=name, shape=shape, dtype=dtype, kind=kind,
                     base=self._cursor, init=init, _builder=self)
        self._operands.append(op)
        self._names[name] = op
        self._cursor += op.size
        return op

    def input(self, name: str, shape=None, dtype: DType = DType.F,
              init=None) -> Operand:
        """Declare a named input tensor (bound at pack/run time)."""
        return self._declare("input", name, shape, dtype, init)

    def output(self, name: str, shape=None, dtype: DType = DType.F,
               init=None) -> Operand:
        """Declare a named output tensor (zero-initialised)."""
        return self._declare("output", name, shape, dtype, init)

    def inout(self, name: str, shape=None, dtype: DType = DType.F,
              init=None) -> Operand:
        """Declare a tensor that is both read and written."""
        return self._declare("inout", name, shape, dtype, init)

    def scratch(self, name: str, shape=None, dtype: DType = DType.F,
                init=None) -> Operand:
        """Declare working memory that is not read back by name."""
        return self._declare("scratch", name, shape, dtype, init)

    def operand(self, name: str) -> Operand:
        """A previously declared operand, by name."""
        try:
            return self._names[name]
        except KeyError:
            raise OperandError(
                f"no operand {name!r}; declared: {list(self._names)}"
            ) from None

    # -- machine configuration --------------------------------------------
    def width(self, bits: int) -> None:
        """Configure the live register width (``vsetwidth``): the
        register file holds ``256 // bits`` physical registers."""
        self._emit_config(isa.vsetwidth(bits))

    def dims(self, *lengths: int,
             ld_strides: Optional[Dict[int, int]] = None,
             st_strides: Optional[Dict[int, int]] = None) -> _Scope:
        """Open a dimension scope: ``dims(x, y, z)`` configures a 3-D
        logical register geometry (x fastest) by emitting ``vsetdimc`` +
        one ``vsetdiml`` per dimension, followed by any load/store
        stride control registers (for :data:`~repro_torch.frontend.CR`-mode
        accesses).  Usable bare or as ``with b.dims(...):`` — the
        ``with`` form adds readable structure; configuration is
        architectural state and persists until the next reconfiguration.
        """
        if not (1 <= len(lengths) <= isa.MAX_DIMS):
            raise BuildError(
                f"1..{isa.MAX_DIMS} dimensions, got {len(lengths)}")
        self._emit_config(isa.vsetdimc(len(lengths)))
        for d, ln in enumerate(lengths):
            self._emit_config(isa.vsetdiml(d, int(ln)))
        for d, s in sorted((ld_strides or {}).items()):
            self._emit_config(isa.vsetldstr(d, int(s)))
        for d, s in sorted((st_strides or {}).items()):
            self._emit_config(isa.vsetststr(d, int(s)))
        self._dim_lens = tuple(int(ln) for ln in lengths)
        return _Scope()

    def dim_length(self, dim: int, length: int) -> None:
        """Adjust one dimension's length in place (tail iterations)."""
        self._emit_config(isa.vsetdiml(dim, int(length)))
        lens = list(self._dim_lens)
        if dim < len(lens):
            lens[dim] = int(length)
            self._dim_lens = tuple(lens)

    @contextlib.contextmanager
    def masked_off(self, *mask_bits: int):
        """Scope with the given highest-dimension elements masked off
        (``vunsetmask`` on entry, ``vsetmask`` on exit) — the Section-IV
        reduction idiom."""
        for i in mask_bits:
            self._emit_config(isa.vunsetmask(int(i)))
        try:
            yield
        finally:
            for i in reversed(mask_bits):
                self._emit_config(isa.vsetmask(int(i)))

    def scalar(self, count: int) -> None:
        """Account ``count`` interleaved scalar-core instructions (cost
        model only — no architectural effect)."""
        self._emit(isa.scalar(int(count)))

    # -- values ------------------------------------------------------------
    def const(self, dtype: DType, value) -> VectorHandle:
        """Broadcast an immediate into a fresh register (``vsetdup``)."""
        h = self._fresh(dtype)
        self._emit(Instr(Op.SET_DUP, dtype=dtype, vd=h.vreg, imm=value))
        return h

    def keep(self, *handles: VectorHandle) -> None:
        """Pin values in their registers for the rest of the kernel.

        The allocator frees a register after its value's last read;
        ``keep`` extends the lifetime to the end of the program — for
        values a later kernel revision will read, or to mirror hand
        code that deliberately holds an input resident."""
        for h in handles:
            self._pinned.append(h.vreg)

    def add(self, a, b, predicated: bool = False,
            in_place: bool = False):
        return self._binary(Op.ADD, a, b, predicated=predicated,
                            in_place=in_place)

    def sub(self, a, b, predicated: bool = False,
            in_place: bool = False):
        return self._binary(Op.SUB, a, b, predicated=predicated,
                            in_place=in_place)

    def mul(self, a, b, predicated: bool = False,
            in_place: bool = False):
        """Predicated + in-place is the conditional-update idiom: lanes
        whose Tag is clear keep the destination's previous value, which
        only means something when the destination *is* an existing
        register — the range-reduction loops in :mod:`repro_torch.nn.ops`
        (``s *= 0.5 where s >= 2``) are the motivating use."""
        return self._binary(Op.MUL, a, b, predicated=predicated,
                            in_place=in_place)

    def _compare(self, op: Op, a: VectorHandle, b) -> None:
        """Emit a comparison: writes the per-lane Tag predicate latch
        (no destination register)."""
        bh = self._coerce(b, a.dtype)
        self._emit(Instr(op, dtype=a.dtype, vs1=a.vreg, vs2=bh.vreg))

    # -- internal emission --------------------------------------------------
    def _emit(self, instr: Instr) -> None:
        if self._built:
            raise BuildError("builder already built")
        self._instrs.append(instr)

    def _emit_config(self, instr: Instr) -> None:
        """Emit a config instruction unless it re-establishes state this
        trace has already explicitly written (re-entering a dimension
        scope inside a Python loop re-traces its ``vsetdim*``/stride
        writes — identical state does not need re-emitting).  The state
        *trajectory* at every retained instruction is unchanged, so
        addressing and strict validation are unaffected; regression test
        in ``tests/test_frontend.py``."""
        cell = config_cell(instr)
        before = read_config_cell(self._ctrl, cell)
        apply_config(self._ctrl, instr)
        if cell in self._cfg_written and \
                read_config_cell(self._ctrl, cell) == before:
            return
        self._cfg_written.add(cell)
        self._emit(instr)

    def _fresh(self, dtype: DType) -> VectorHandle:
        h = VectorHandle(self, self._next_vreg, dtype)
        self._next_vreg += 1
        return h

    def _coerce(self, value, dtype: DType) -> VectorHandle:
        if isinstance(value, VectorHandle):
            return value
        if isinstance(value, (int, float, np.integer, np.floating)):
            if isinstance(value, (float, np.floating)) \
                    and not dtype.is_float and value != int(value):
                raise BuildError(
                    f"non-integral scalar {value} into {dtype.name} lanes")
            return self.const(
                dtype, float(value) if dtype.is_float else int(value))
        raise BuildError(f"cannot use {type(value).__name__} as a vector "
                         "operand")

    def _binary(self, op: Op, a: VectorHandle, b, swap: bool = False,
                in_place: bool = False,
                predicated: bool = False) -> VectorHandle:
        bh = self._coerce(b, a.dtype)
        lhs, rhs = (bh, a) if swap else (a, bh)
        if in_place:
            vd = a.vreg
            out = a
        else:
            out = self._fresh(a.dtype)
            vd = out.vreg
        self._emit(Instr(op, dtype=a.dtype, vd=vd, vs1=lhs.vreg,
                         vs2=rhs.vreg, predicated=predicated))
        return out

    def _shift(self, a: VectorHandle, amount: int,
               in_place: bool = False) -> VectorHandle:
        out = a if in_place else self._fresh(a.dtype)
        self._emit(Instr(Op.SHI, dtype=a.dtype, vd=out.vreg, vs1=a.vreg,
                         imm=int(amount)))
        return out

    def _emit_unary(self, op: Op, a: VectorHandle,
                    dtype: Optional[DType] = None,
                    imm: Optional[int] = None) -> VectorHandle:
        out = self._fresh(dtype or a.dtype)
        self._emit(Instr(op, dtype=dtype or a.dtype, vd=out.vreg,
                         vs1=a.vreg, imm=imm))
        return out

    def _load(self, ref: OperandRef, modes: Tuple, dtype: DType,
              random: bool) -> VectorHandle:
        h = self._fresh(dtype)
        self._emit(Instr(Op.RLD if random else Op.SLD, dtype=dtype,
                         vd=h.vreg, base=ref.address,
                         modes=tuple(int(m) for m in modes)))
        return h

    def _store(self, ref: OperandRef, value: VectorHandle, modes: Tuple,
               dtype: Optional[DType], random: bool) -> None:
        if not isinstance(value, VectorHandle):
            raise BuildError("store source must be a VectorHandle")
        self._emit(Instr(Op.RST if random else Op.SST,
                         dtype=dtype or value.dtype, vs1=value.vreg,
                         base=ref.address,
                         modes=tuple(int(m) for m in modes)))

    # -- finalisation -------------------------------------------------------
    def build(self) -> Kernel:
        """Allocate registers, validate strictly, freeze the Kernel."""
        if self._built:
            raise BuildError("builder already built")
        self._built = True
        alloc = regalloc.allocate(self._instrs, self.max_regs,
                                  pinned=self._pinned)
        program = isa.Program(alloc.program)
        program.validate(memory_size=self._cursor, strict=True)
        return Kernel(name=self.name, program=program,
                      plan=MemoryPlan(self._operands),
                      n_vregs=self._next_vreg, n_regs=alloc.n_used,
                      max_live=alloc.max_live)


def kernel(fn=None, *, name: Optional[str] = None,
           max_regs: int = regalloc.DEFAULT_MAX_REGS):
    """Decorator: a function ``f(b, ...)`` becomes a kernel factory —
    calling it traces ``f`` through a fresh :class:`KernelBuilder` and
    returns the built :class:`Kernel`.

        @mve.kernel
        def daxpy(b, n=8192, alpha=1.5): ...

        k = daxpy(n=4096)
    """
    def deco(f):
        @functools.wraps(f)
        def factory(*args, **kwargs) -> Kernel:
            b = KernelBuilder(name or f.__name__, max_regs=max_regs)
            f(b, *args, **kwargs)
            return b.build()
        factory.__mve_kernel__ = True
        return factory
    return deco(fn) if fn is not None else deco
