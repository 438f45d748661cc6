"""MVE instruction set architecture definitions.

Faithful encoding of the ISA in Section III of

    "Multi-Dimensional Vector ISA Extension for Mobile In-Cache Computing"
    (Khadem, Fujiki, Chen, Gu, Talati, Mahlke, Das — 2025)

The ISA treats in-cache physical registers (8K bit-serial SIMD lanes) as
up-to-4-dimensional *logical* registers ``PR[w][z][y][x]`` and provides

  * multi-dimensional strided loads/stores (Algorithm 1 of the paper),
  * random-base + strided-offset loads/stores (Equation 1),
  * dimension-level masking over the highest dimension,
  * the 29 operations of Table II for 6 data types.

Stride encoding uses the paper's 2-bit *stride mode* per dimension:

  mode 0 -> stride 0   (replication)
  mode 1 -> stride 1   (sequential)
  mode 2 -> derived    S_i = S_{i-1} * Dim_{i-1}.Length   (S_{-1} = 1)
  mode 3 -> value taken from the per-dimension stride control register

Full reference with worked examples: docs/ISA.md.  Executable semantics:
:mod:`repro_torch.core.interp` (step oracle) and :mod:`repro_torch.core.engine`
(compiled path, docs/ENGINE.md).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional, Tuple

MAX_DIMS = 4
# Paper Section III-E: the highest dimension is capped at 256 so the mask CR
# stays one bit per element of the outermost loop.
MAX_TOP_DIM = 256


class DType(enum.Enum):
    """MVE data types (paper Section III-F)."""

    # name, bits, float?
    B = ("b", 8, False)       # 8-bit integer
    W = ("w", 16, False)      # 16-bit integer
    DW = ("dw", 32, False)    # 32-bit integer
    QW = ("qw", 64, False)    # 64-bit integer
    HF = ("hf", 16, True)     # half float
    F = ("f", 32, True)       # single float

    def __init__(self, suffix: str, bits: int, is_float: bool):
        self.suffix = suffix
        self.bits = bits
        self.is_float = is_float

    @property
    def nbytes(self) -> int:
        return self.bits // 8


class StrideMode(enum.IntEnum):
    ZERO = 0      # replicate
    ONE = 1       # sequential
    DERIVED = 2   # S_i = S_{i-1} * L_{i-1}
    CR = 3        # use stride control register


class Op(enum.Enum):
    """Operation kinds of Table II."""

    # Config
    SET_DIMC = "vsetdimc"
    SET_DIML = "vsetdiml"
    SET_MASK = "vsetmask"
    UNSET_MASK = "vunsetmask"
    SET_WIDTH = "vsetwidth"
    SET_LDSTR = "vsetldstr"   # load stride CR
    SET_STSTR = "vsetststr"   # store stride CR
    # Move
    CVT = "vcvt"
    CPY = "vcpy"
    # Memory
    SLD = "vsld"
    RLD = "vrld"
    SST = "vsst"
    RST = "vrst"
    # Arithmetic
    SET_DUP = "vsetdup"
    SHI = "vshi"      # shift immediate (constant shift)
    ROTI = "vroti"
    SHR = "vshr"      # shift by register (variable shift)
    ADD = "vadd"
    SUB = "vsub"
    MUL = "vmul"
    MIN = "vmin"
    MAX = "vmax"
    XOR = "vxor"
    AND = "vand"
    OR = "vor"
    GT = "vgt"
    GTE = "vgte"
    LT = "vlt"
    LTE = "vlte"
    EQ = "veq"
    NEQ = "vneq"
    # VM-level pseudo op to account for interleaved scalar work in the
    # trace-driven cost model (the real binary interleaves scalar insts).
    SCALAR = "scalar"


CONFIG_OPS = {Op.SET_DIMC, Op.SET_DIML, Op.SET_MASK, Op.UNSET_MASK,
              Op.SET_WIDTH, Op.SET_LDSTR, Op.SET_STSTR}
MEMORY_OPS = {Op.SLD, Op.RLD, Op.SST, Op.RST}
COMPARE_OPS = {Op.GT, Op.GTE, Op.LT, Op.LTE, Op.EQ, Op.NEQ}
ARITH_OPS = {Op.SET_DUP, Op.SHI, Op.ROTI, Op.SHR, Op.ADD, Op.SUB, Op.MUL,
             Op.MIN, Op.MAX, Op.XOR, Op.AND, Op.OR} | COMPARE_OPS
MOVE_OPS = {Op.CVT, Op.CPY}
VECTOR_OPS = MEMORY_OPS | ARITH_OPS | MOVE_OPS


def reg_defs(instr: "Instr") -> Optional[int]:
    """The register this instruction writes, or ``None``.

    Compares write the Tag latch, not a register; stores and config ops
    write no register.  Shared by the register allocator
    (:mod:`repro_torch.frontend.regalloc`) and the optimizer's dependence
    graph (:mod:`repro_torch.opt`).
    """
    op = instr.op
    if op in (Op.SLD, Op.RLD) or (
            op in ARITH_OPS and op not in COMPARE_OPS) or op in MOVE_OPS:
        return instr.vd
    return None


def reg_uses(instr: "Instr") -> Tuple[int, ...]:
    """The registers this instruction reads, in operand order."""
    op = instr.op
    if op in (Op.SST, Op.RST):
        return (instr.vs1,) if instr.vs1 is not None else ()
    if op in VECTOR_OPS:
        uses = []
        if instr.vs1 is not None:
            uses.append(instr.vs1)
        if instr.vs2 is not None:
            uses.append(instr.vs2)
        return tuple(uses)
    return ()


@dataclasses.dataclass(frozen=True)
class Instr:
    """One MVE instruction.

    ``vd``/``vs1``/``vs2`` name virtual vector registers (ints).  Memory
    instructions carry the base address and the per-dimension stride modes;
    config instructions carry immediates.  ``scalar_count`` is used only by
    ``Op.SCALAR`` pseudo-instructions.
    """

    op: Op
    dtype: Optional[DType] = None
    vd: Optional[int] = None
    vs1: Optional[int] = None
    vs2: Optional[int] = None
    imm: Optional[int] = None
    base: Optional[int] = None                 # element address in VM memory
    modes: Optional[Tuple[int, ...]] = None    # per-dim stride modes
    dim: Optional[int] = None                  # for vsetdiml / vset*str
    length: Optional[int] = None               # for vsetdiml
    stride: Optional[int] = None               # for vset*str
    mask_index: Optional[int] = None           # for v(un)setmask
    predicated: bool = False                   # execute under Tag latch
    scalar_count: int = 0

    def is_vector(self) -> bool:
        return self.op in VECTOR_OPS

    def is_memory(self) -> bool:
        return self.op in MEMORY_OPS

    def is_config(self) -> bool:
        return self.op in CONFIG_OPS


# ---------------------------------------------------------------------------
# Convenience constructors (mirror the intrinsics library of Section III-F).
# ---------------------------------------------------------------------------

def vsetdimc(count: int) -> Instr:
    if not (1 <= count <= MAX_DIMS):
        raise ValueError(f"dim count must be in [1,{MAX_DIMS}], got {count}")
    return Instr(Op.SET_DIMC, imm=count)


def vsetdiml(dim: int, length: int) -> Instr:
    if length < 1:
        raise ValueError("dim length must be >= 1")
    return Instr(Op.SET_DIML, dim=dim, length=length)


def vsetldstr(dim: int, stride: int) -> Instr:
    return Instr(Op.SET_LDSTR, dim=dim, stride=stride)


def vsetststr(dim: int, stride: int) -> Instr:
    return Instr(Op.SET_STSTR, dim=dim, stride=stride)


def vsetmask(index: int) -> Instr:
    return Instr(Op.SET_MASK, mask_index=index)


def vunsetmask(index: int) -> Instr:
    return Instr(Op.UNSET_MASK, mask_index=index)


def vsetwidth(bits: int) -> Instr:
    return Instr(Op.SET_WIDTH, imm=bits)


def vsld(dtype: DType, vd: int, base: int, *modes: int) -> Instr:
    return Instr(Op.SLD, dtype=dtype, vd=vd, base=base, modes=tuple(modes))


def vsst(dtype: DType, vs: int, base: int, *modes: int) -> Instr:
    return Instr(Op.SST, dtype=dtype, vs1=vs, base=base, modes=tuple(modes))


def vrld(dtype: DType, vd: int, ptr_base: int, *modes: int) -> Instr:
    """Random load: ``ptr_base`` addresses an array of row base addresses."""
    return Instr(Op.RLD, dtype=dtype, vd=vd, base=ptr_base, modes=tuple(modes))


def vrst(dtype: DType, vs: int, ptr_base: int, *modes: int) -> Instr:
    return Instr(Op.RST, dtype=dtype, vs1=vs, base=ptr_base, modes=tuple(modes))


def vsetdup(dtype: DType, vd: int, value) -> Instr:
    return Instr(Op.SET_DUP, dtype=dtype, vd=vd, imm=value)


def vbinary(op: Op, dtype: DType, vd: int, vs1: int, vs2: int,
            predicated: bool = False) -> Instr:
    return Instr(op, dtype=dtype, vd=vd, vs1=vs1, vs2=vs2,
                 predicated=predicated)


def vadd(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.ADD, dtype, vd, vs1, vs2, **kw)


def vsub(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.SUB, dtype, vd, vs1, vs2, **kw)


def vmul(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.MUL, dtype, vd, vs1, vs2, **kw)


def vmin(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.MIN, dtype, vd, vs1, vs2, **kw)


def vmax(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.MAX, dtype, vd, vs1, vs2, **kw)


def vxor(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.XOR, dtype, vd, vs1, vs2, **kw)


def vand(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.AND, dtype, vd, vs1, vs2, **kw)


def vor(dtype, vd, vs1, vs2, **kw):
    return vbinary(Op.OR, dtype, vd, vs1, vs2, **kw)


def vshi(dtype, vd, vs, amount: int) -> Instr:
    return Instr(Op.SHI, dtype=dtype, vd=vd, vs1=vs, imm=amount)


def vshr_reg(dtype, vd, vs1, vs2) -> Instr:
    return Instr(Op.SHR, dtype=dtype, vd=vd, vs1=vs1, vs2=vs2)


def vcmp(op: Op, dtype, vs1, vs2) -> Instr:
    """Comparisons write the per-lane Tag latch (predicate)."""
    return Instr(op, dtype=dtype, vs1=vs1, vs2=vs2)


def vcpy(dtype, vd, vs) -> Instr:
    return Instr(Op.CPY, dtype=dtype, vd=vd, vs1=vs)


def vcvt(dst_dtype, vd, vs) -> Instr:
    return Instr(Op.CVT, dtype=dst_dtype, vd=vd, vs1=vs)


def scalar(count: int) -> Instr:
    """``count`` interleaved scalar core instructions (cost model only)."""
    return Instr(Op.SCALAR, scalar_count=count)


# ---------------------------------------------------------------------------
# Programs: validation + disassembly.
#
# Historically ``Program`` was a bare ``Sequence[Instr]`` type alias; it is
# now a tuple subclass so programs carry their own build-time checks
# (:meth:`Program.validate`) and a readable pretty-printer
# (:meth:`Program.dump`).  Plain lists/tuples of :class:`Instr` remain
# accepted everywhere — the executors only iterate.
# ---------------------------------------------------------------------------

class ProgramError(ValueError):
    """A program failed build-time validation.

    Carries the offending instruction index and its disassembly so the
    error reads like a compiler diagnostic instead of an opaque failure
    deep inside the compile walk.
    """

    def __init__(self, message: str, index: Optional[int] = None,
                 instr: Optional[Instr] = None):
        loc = ""
        if index is not None:
            loc = f"\n  at [{index:3d}] {disassemble(instr)}" \
                if instr is not None else f"\n  at instruction {index}"
        super().__init__(message + loc)
        self.index = index
        self.instr = instr


def disassemble(instr: Instr) -> str:
    """One readable line for one instruction (assembly-ish)."""
    op = instr.op
    mn = op.value + (f".{instr.dtype.suffix}" if instr.dtype else "")
    if op is Op.SET_DIMC or op is Op.SET_WIDTH:
        return f"{mn:14s} {instr.imm}"
    if op is Op.SET_DIML:
        return f"{mn:14s} d{instr.dim}, len={instr.length}"
    if op in (Op.SET_LDSTR, Op.SET_STSTR):
        return f"{mn:14s} d{instr.dim}, stride={instr.stride}"
    if op in (Op.SET_MASK, Op.UNSET_MASK):
        return f"{mn:14s} bit={instr.mask_index}"
    if op is Op.SCALAR:
        return f"{mn:14s} x{instr.scalar_count}"
    pred = ", pred" if instr.predicated else ""
    if op in (Op.SLD, Op.RLD):
        kind = "ptrs" if op is Op.RLD else "base"
        return (f"{mn:14s} v{instr.vd}, [{kind}={instr.base}], "
                f"S={tuple(instr.modes or ())}{pred}")
    if op in (Op.SST, Op.RST):
        kind = "ptrs" if op is Op.RST else "base"
        return (f"{mn:14s} v{instr.vs1}, [{kind}={instr.base}], "
                f"S={tuple(instr.modes or ())}{pred}")
    if op is Op.SET_DUP:
        return f"{mn:14s} v{instr.vd}, {instr.imm}{pred}"
    if op in (Op.SHI, Op.ROTI):
        return f"{mn:14s} v{instr.vd}, v{instr.vs1}, {instr.imm}{pred}"
    if op in COMPARE_OPS:
        return f"{mn:14s} v{instr.vs1}, v{instr.vs2}"
    if op in (Op.CPY, Op.CVT):
        return f"{mn:14s} v{instr.vd}, v{instr.vs1}{pred}"
    srcs = [f"v{instr.vs1}"]
    if instr.vs2 is not None:
        srcs.append(f"v{instr.vs2}")
    return f"{mn:14s} v{instr.vd}, {', '.join(srcs)}{pred}"


def dump(program: Iterable[Instr]) -> str:
    """Disassemble a whole program, one numbered line per instruction."""
    return "\n".join(f"[{i:3d}] {disassemble(instr)}"
                     for i, instr in enumerate(program))


def _require(cond: bool, msg: str, i: int, instr: Instr) -> None:
    if not cond:
        raise ProgramError(msg, i, instr)


def validate(program: Iterable[Instr], memory_size: Optional[int] = None,
             strict: bool = False, wordlines: int = 256) -> None:
    """Build-time program checks; raises :class:`ProgramError`.

    Walks the config-register evolution exactly like the compile walk
    (:mod:`repro_torch.core.engine`) and checks each instruction against the
    architectural state it will execute under:

    * structural — operands present, stride modes in ``0..3``, dim/mask
      indices in range, shifts/rotates on integer registers only;
    * register bounds — register ids must fit the *variable* register
      file: ``wordlines // kernel_width`` live PRs (Section III-B);
    * ``strict`` adds frontend-grade checks: element dtype no wider than
      the configured register width, dimension-mask bits that can never
      map onto the current highest dimension, and — when ``memory_size``
      is given — static address ranges within the memory image.

    The step interpreter, fused engine and VM run the *lenient* subset
    (``strict=False``) so hand-written programs that deliberately rely on
    clipping/drop semantics keep executing; the kernel frontend
    (:mod:`repro_torch.frontend`) validates strictly at build time.
    """
    # Late import: machine.py imports this module at load time.
    from .machine import ControlState, apply_config

    ctrl = ControlState()
    for i, instr in enumerate(program):
        op = instr.op
        if op in CONFIG_OPS:
            if op is Op.SET_DIMC:
                _require(instr.imm is not None and
                         1 <= instr.imm <= MAX_DIMS,
                         f"dimension count must be in [1,{MAX_DIMS}]",
                         i, instr)
            elif op is Op.SET_DIML:
                _require(instr.dim is not None and
                         0 <= instr.dim < MAX_DIMS,
                         f"dimension index must be in [0,{MAX_DIMS})",
                         i, instr)
                _require(instr.length is not None and instr.length >= 1,
                         "dimension length must be >= 1", i, instr)
            elif op in (Op.SET_LDSTR, Op.SET_STSTR):
                _require(instr.dim is not None and
                         0 <= instr.dim < MAX_DIMS,
                         f"stride CR index must be in [0,{MAX_DIMS})",
                         i, instr)
                _require(instr.stride is not None,
                         "stride CR write needs a stride value", i, instr)
            elif op in (Op.SET_MASK, Op.UNSET_MASK):
                _require(instr.mask_index is not None and
                         0 <= instr.mask_index < MAX_TOP_DIM,
                         f"mask bit must be in [0,{MAX_TOP_DIM}) — the "
                         "mask CR covers only the highest dimension",
                         i, instr)
                if strict:
                    top = ctrl.dim_lens[ctrl.dim_count - 1]
                    _require(instr.mask_index < top,
                             f"mask bit {instr.mask_index} can never map "
                             f"onto the highest dimension (top length "
                             f"{top}) — dimension-level masks apply to "
                             "the top dimension only", i, instr)
            elif op is Op.SET_WIDTH:
                _require(instr.imm is not None and
                         1 <= instr.imm <= wordlines,
                         f"register width must be in [1,{wordlines}] bits",
                         i, instr)
            apply_config(ctrl, instr)
            continue
        if op is Op.SCALAR:
            _require(instr.scalar_count >= 0,
                     "scalar count must be >= 0", i, instr)
            continue

        # ---- vector instructions -------------------------------------
        _require(instr.dtype is not None,
                 "vector instruction needs a data type", i, instr)
        # Lenient: any register id the machine could ever name (the fused
        # engine hosts programs beyond the current width's physical file —
        # that is what the VM -> fused fallback exists for).  Strict: the
        # variable register count of Section III-B.
        max_regs = wordlines if not strict else \
            max(1, wordlines // max(ctrl.kernel_width, 1))
        for field, r in (("vd", instr.vd), ("vs1", instr.vs1),
                         ("vs2", instr.vs2)):
            if r is None:
                continue
            _require(0 <= r < max_regs,
                     f"register {field}=v{r} out of range: width "
                     f"{ctrl.kernel_width} leaves {max_regs} physical "
                     f"registers ({wordlines} wordlines / width)", i, instr)
        if strict:
            _require(instr.dtype.bits <= ctrl.kernel_width,
                     f"dtype {instr.dtype.name} ({instr.dtype.bits} bits) "
                     f"is wider than the configured register width "
                     f"{ctrl.kernel_width}", i, instr)

        if op in MEMORY_OPS:
            store = op in (Op.SST, Op.RST)
            _require(instr.base is not None and instr.base >= 0,
                     "memory access needs a non-negative base address",
                     i, instr)
            _require(instr.vs1 is not None if store
                     else instr.vd is not None,
                     "store needs a source register" if store
                     else "load needs a destination register", i, instr)
            modes = tuple(instr.modes or ())
            _require(all(0 <= m <= 3 for m in modes),
                     f"stride modes must be 2-bit (0..3), got {modes}",
                     i, instr)
            _require(len(modes) <= MAX_DIMS,
                     f"at most {MAX_DIMS} stride modes", i, instr)
            if strict and memory_size is not None:
                _check_address_range(ctrl, instr, memory_size, i)
            continue

        if op in COMPARE_OPS:
            _require(instr.vs1 is not None and instr.vs2 is not None,
                     "compare needs two source registers", i, instr)
            continue

        _require(instr.vd is not None,
                 "instruction needs a destination register", i, instr)
        if op is Op.SET_DUP:
            _require(instr.imm is not None,
                     "vsetdup needs an immediate value", i, instr)
        elif op in (Op.SHI, Op.ROTI):
            _require(instr.vs1 is not None and instr.imm is not None,
                     "shift/rotate needs a source register and an "
                     "immediate amount", i, instr)
            _require(not instr.dtype.is_float,
                     "shift/rotate on a float register", i, instr)
        elif op is Op.SHR:
            _require(instr.vs1 is not None and instr.vs2 is not None,
                     "variable shift needs two source registers", i, instr)
            _require(not instr.dtype.is_float,
                     "variable shift on a float register", i, instr)
        elif op in (Op.CPY, Op.CVT):
            _require(instr.vs1 is not None,
                     "move needs a source register", i, instr)
        else:
            _require(instr.vs1 is not None and instr.vs2 is not None,
                     f"{op.value} needs two source registers", i, instr)


def _check_address_range(ctrl, instr: Instr, memory_size: int,
                         i: int) -> None:
    """Strict mode: the static address envelope must stay in memory.

    For strided accesses the maximum address over active lanes is
    ``base + sum (len_d - 1) * stride_d``; random-base accesses must at
    least read their whole pointer array from memory.
    """
    store = instr.op in (Op.SST, Op.RST)
    random = instr.op in (Op.RLD, Op.RST)
    dims = ctrl.active_dims()
    strides = ctrl.resolve_strides(tuple(instr.modes or ()), store)
    if random:
        end = instr.base + dims[-1]
        _require(end <= memory_size,
                 f"pointer array [{instr.base}, {end}) exceeds the "
                 f"memory image ({memory_size} elements)", i, instr)
        return
    lo = instr.base + sum(min(0, (ln - 1) * s)
                          for ln, s in zip(dims, strides))
    hi = instr.base + sum(max(0, (ln - 1) * s)
                          for ln, s in zip(dims, strides))
    _require(lo >= 0 and hi < memory_size,
             f"static access spans [{lo}, {hi}] outside the memory "
             f"image ({memory_size} elements)", i, instr)


class Program(tuple):
    """An MVE program: an immutable sequence of :class:`Instr`.

    Adds :meth:`validate` (build-time checks with readable one-line
    errors) and :meth:`dump` (disassembler) over plain tuple semantics.
    Anything iterable of instructions still works wherever a program is
    accepted; this class is what the kernel frontend emits.
    """

    __slots__ = ()

    def __new__(cls, instrs: Iterable[Instr] = ()):
        return super().__new__(cls, tuple(instrs))

    def validate(self, memory_size: Optional[int] = None,
                 strict: bool = False) -> "Program":
        """Run :func:`validate`; returns ``self`` for chaining."""
        validate(self, memory_size=memory_size, strict=strict)
        return self

    def dump(self) -> str:
        """Readable disassembly (used by error messages and the docs)."""
        return dump(self)
