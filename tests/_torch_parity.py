"""Shared helpers of the ``test_torch_*`` parity tests.

The same inputs — made with NumPy from a seed — go through the JAX
reference (``repro``, on the CPU) and the PyTorch port (``repro_torch``, on
``device="cpu"``, where the kernels' wrappers take their plain versions),
and everything observable is compared bit for bit: memory, every register
with its element type, the Tag latch, and the cost-model trace.  NaNs
included: sign and payload must match too.

Outside that contract: a random-base access (``vrld``/``vrst``) whose
pointer is NaN, ±inf or outside int32.  The reference's executors disagree
with each other there (undefined float -> int casts, an int32 add that
wraps); ``test_torch_faults.py::test_c6_nonfinite_pointers`` writes their
values down and holds the port's executors to each other instead.  The
generators here make finite, in-range pointers only.
"""
import numpy as np

from repro.core import isa as ref_isa
from repro.core.interp import MVEInterpreter as RefInterpreter
from repro.core.isa import DType, Op
from repro.core.machine import MVEConfig as RefConfig

from repro_torch import convert
from repro_torch.core.engine import compile_program
from repro_torch.core.interp import MVEInterpreter

REF_ORACLE = RefInterpreter(RefConfig(), compiled=False)
PORT_ORACLE = MVEInterpreter(compiled=False, device="cpu")

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def assert_bits_equal(want, got, what=""):
    """Same element type, same bits (NaN sign and payload included)."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind in "fiu":
        u = _UINT[want.dtype.itemsize]
        want = np.ascontiguousarray(want).view(u)
        got = np.ascontiguousarray(got).view(u)
    np.testing.assert_array_equal(want, got, err_msg=what)


def lane_addresses32(dims, strides, base, active):
    """``csrc/mdv_walk.cuh::mdv_lane_address`` over lanes ``0 .. active -
    1``: lane ids peeled in uint32 (dims clamped to 2**32 - 1), the address
    summed in int64."""
    rem = np.arange(active, dtype=np.uint32)
    addr = np.full(active, base, dtype=np.int64)
    for length, stride in zip(dims, strides):
        length = np.uint32(min(length, 2**32 - 1))
        addr += (rem % length).astype(np.int64) * stride
        rem = rem // length
    return addr


def assert_trace_equal(want, got):
    """TraceEvent streams equal field by field (never a tolerance)."""
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.op.name == b.op.name, (i, a, b)
        assert (None if a.dtype is None else a.dtype.name) == \
            (None if b.dtype is None else b.dtype.name), (i, a, b)
        for f in ("elements", "segments", "scalar_count", "contiguous_run",
                  "unique_elements", "lines"):
            assert getattr(a, f) == getattr(b, f), (i, f, a, b)
        np.testing.assert_array_equal(a.cb_mask, b.cb_mask)


def assert_state_equal(ref_state, port_state, what=""):
    """Reference machine state vs a port state: memory, registers, Tag."""
    got = convert.state_to_numpy(port_state)
    assert_bits_equal(ref_state.memory, got["memory"], f"{what} memory")
    assert set(ref_state.regs) == set(got["regs"]), what
    for r, v in ref_state.regs.items():
        assert_bits_equal(v, got["regs"][r], f"{what} v{r}")
    assert_bits_equal(ref_state.tag, got["tag"], f"{what} tag")


def check_program(ref_program, memory):
    """port fused == port stepwise == reference stepwise on one image;
    returns the port's fused ``(memory, state)``."""
    ref_mem, ref_state = REF_ORACLE.run_stepwise(ref_program, memory)
    program = convert.program_from_reference(ref_program)
    fused = compile_program(program, device="cpu").run(memory)
    stepwise = PORT_ORACLE.run_stepwise(program, memory)
    for name, (_, state) in (("fused", fused), ("stepwise", stepwise)):
        assert_state_equal(ref_state, state, name)
        assert_trace_equal(ref_state.trace, state.trace)
    return fused


def check_all_executors(ref_program, memory):
    """port VM == port fused == port stepwise == reference stepwise ==
    reference VM on one image (memory, registers, Tag, trace); returns the
    port VM's ``(memory, state)`` and its compiled program."""
    from repro.core import compile_program as ref_compile
    ref_mem, ref_state = REF_ORACLE.run_stepwise(ref_program, memory)
    ref_vm = ref_compile(ref_program, mode="vm")
    vm_mem, vm_state = ref_vm.run(memory)
    vm_state.memory = np.asarray(vm_mem)
    what = f"reference {ref_vm.mode}"
    assert_bits_equal(ref_state.memory, vm_state.memory, f"{what} memory")
    assert set(ref_state.regs) == set(vm_state.regs), what
    for r, v in ref_state.regs.items():
        assert_bits_equal(v, np.asarray(vm_state.regs[r]), f"{what} v{r}")
    assert_bits_equal(ref_state.tag, np.asarray(vm_state.tag), what)
    assert_trace_equal(ref_state.trace, vm_state.trace)
    program = convert.program_from_reference(ref_program)
    cp = compile_program(program, mode="vm", device="cpu")
    assert cp.mode == ref_vm.mode           # the same fallback decision
    out = cp.run(memory)
    fused = compile_program(program, mode="fused", device="cpu").run(memory)
    stepwise = PORT_ORACLE.run_stepwise(program, memory)
    for name, (_, state) in (("vm", out), ("fused", fused),
                             ("stepwise", stepwise)):
        assert_state_equal(ref_state, state, name)
        assert_trace_equal(ref_state.trace, state.trace)
    return out, cp


# ---------------------------------------------------------------------------
# Hand-written programs, one per place the two frameworks differ by default.
# Each entry: name -> (reference-ISA instruction list, memory image).
# ---------------------------------------------------------------------------

def _dims1(n=64):
    return [ref_isa.vsetwidth(32), ref_isa.vsetdimc(1),
            ref_isa.vsetdiml(0, n)]


def _image(seed=0):
    rng = np.random.default_rng(seed)
    mem = np.zeros(4096)
    mem[:256] = rng.integers(-70000, 70000, 256)
    mem[256:512] = rng.standard_normal(256) * 100
    mem[512:520] = [300.7, -3.2, np.nan, 1e10, 3e9, -3e9, np.inf, -np.inf]
    return mem


def _int_dtype_program(dt):
    """Every integer op incl. shift counts past the width, rotates in the
    unsigned 32-bit window, variable shifts by wild counts, compares and
    predicated write-back."""
    i = ref_isa
    p = _dims1() + [i.vsld(dt, 0, 0, 1), i.vsld(dt, 1, 100, 1)]
    for n, f in enumerate([i.vadd, i.vsub, i.vmul, i.vmin, i.vmax, i.vxor,
                           i.vand, i.vor]):
        p += [f(dt, 2, 0, 1), i.vsst(dt, 2, 1024 + 64 * n, 1)]
    for n, amt in enumerate([-40, -33, -17, -9, -3, 0, 1, 5, 8, 15, 16, 31,
                             32, 40]):
        p += [i.vshi(dt, 3, 0, amt), i.vsst(dt, 3, 2048 + 64 * n, 1)]
    for amt in [0, 1, 3, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, -1]:
        p += [i.Instr(Op.ROTI, dtype=dt, vd=4, vs1=0, imm=amt),
              i.vcpy(dt, 5 + amt % 3, 4)]
    p += [i.vsetdup(dt, 6, 3), i.vshr_reg(dt, 7, 0, 6),
          i.vshr_reg(dt, 7, 0, 1)]
    for c in [Op.GT, Op.GTE, Op.LT, Op.LTE, Op.EQ, Op.NEQ]:
        p += [i.vcmp(c, dt, 0, 1), i.vadd(dt, 2, 2, 0, predicated=True)]
    return p


def _float_dtype_program(dt):
    """Float arithmetic (fp16 rounds after every instruction), NaN/inf
    operands, and conversion of out-of-range floats to every type."""
    i = ref_isa
    p = _dims1() + [i.vsld(dt, 0, 256, 1), i.vsld(dt, 1, 300, 1),
                    i.vsld(dt, 8, 512, 1)]
    for n, f in enumerate([i.vadd, i.vsub, i.vmul, i.vmin, i.vmax]):
        p += [f(dt, 2, 0, 1), i.vsst(dt, 2, 1024 + 64 * n, 1),
              f(dt, 3, 8, 1)]
    for c in [Op.GT, Op.GTE, Op.LT, Op.LTE, Op.EQ, Op.NEQ]:
        p += [i.vcmp(c, dt, 8, 1), i.vadd(dt, 2, 2, 0, predicated=True)]
    p.append(i.vsetdup(dt, 4, 3.303222656))
    for t in [DType.B, DType.W, DType.DW, DType.QW, DType.HF, DType.F]:
        p += [i.vcvt(t, 5, 8), i.vcvt(t, 6, 2), i.vsst(t, 5, 2048, 1),
              i.vsld(t, 7, 512, 1)]
    return p


def _predication_program():
    i = ref_isa
    return _dims1(8) + [
        i.vsld(DType.DW, 1, 0, 1), i.vsetdup(DType.DW, 0, 3),
        i.vcmp(Op.GT, DType.DW, 1, 0), i.vsetdup(DType.DW, 2, 1),
        i.vadd(DType.DW, 1, 1, 2, predicated=True),
        # a load marked predicated still writes under the lane mask alone
        i.Instr(Op.SLD, dtype=DType.DW, vd=3, base=8, modes=(1,),
                predicated=True),
        i.vsst(DType.DW, 1, 1024, 1)]


def _masked_store_program():
    """Dimension-masked store: masked rows write nowhere, masked lanes of
    a load keep the destination's old value."""
    i = ref_isa
    return [i.vsetwidth(32), i.vsetdimc(2), i.vsetdiml(0, 8),
            i.vsetdiml(1, 4), i.vsld(DType.F, 0, 0, 1, 2),
            i.vsetdup(DType.F, 1, -7.0),
            i.vunsetmask(1), i.vunsetmask(3),
            i.vsld(DType.F, 1, 256, 1, 2), i.vsst(DType.F, 0, 1024, 1, 2),
            # masked lanes aimed at address 0 must not touch it
            i.vsst(DType.F, 1, 0, 0, 0)]


def _collision_program():
    """Stride-0 and CR-stride stores whose lanes collide: the highest lane
    wins; a stride-2 store; a store running off the end of the image."""
    i = ref_isa
    return [i.vsetwidth(32), i.vsetdimc(2), i.vsetdiml(0, 4),
            i.vsetdiml(1, 3), i.vsld(DType.F, 0, 0, 1, 2),
            i.vsst(DType.F, 0, 1024, 1, 0),          # rows collide
            i.vsst(DType.F, 0, 1100, 0, 1),          # columns collide
            i.vsetststr(0, 2), i.vsetststr(1, 3),
            i.vsst(DType.F, 0, 1200, 3, 3),          # 2x+3y: partial overlap
            i.vsst(DType.F, 0, 4090, 1, 2)]          # lanes past the end drop


def _random_base_program():
    """Eq.-1 loads and stores through a pointer table with duplicates;
    the store runs once under a dimension mask (masked lanes must write
    nowhere — in particular not the image's last element) and once
    unmasked with whole rows colliding."""
    i = ref_isa
    return [i.vsetwidth(32), i.vsetdimc(2), i.vsetdiml(0, 8),
            i.vsetdiml(1, 8), i.vsld(DType.F, 0, 0, 1, 2),
            i.vrld(DType.F, 1, 600, 1, 0),
            i.vunsetmask(2), i.vunsetmask(7),
            i.vrst(DType.F, 0, 600, 1, 0),
            i.vrld(DType.DW, 2, 600, 0, 0),
            i.vsetmask(2), i.vrst(DType.F, 0, 600, 0, 0)]


def _random_base_image():
    mem = _image(3)
    mem[600:608] = [2048, 2056, 2048, 4092, 2056, 3000, 2048, 4095]
    return mem


def _int_image_program():
    """An int32 image: exact integers beyond float32, floats saturating on
    the way into memory."""
    i = ref_isa
    return _dims1() + [
        i.vsld(DType.DW, 0, 0, 1), i.vsld(DType.F, 1, 0, 1),
        i.vsld(DType.B, 2, 0, 1), i.vsetdup(DType.F, 3, 3e9),
        i.vsst(DType.F, 3, 128, 1), i.vsst(DType.F, 1, 192, 1),
        i.vsst(DType.B, 2, 256, 1)]


def _int_image():
    rng = np.random.default_rng(5)
    mem = np.zeros(512, dtype=np.int64)
    mem[:64] = rng.integers(-2**31, 2**31, 64)
    return mem


TRAP_PROGRAMS = {
    "predication_tag": (_predication_program, _image),
    "masked_store": (_masked_store_program, _image),
    "stride0_collisions": (_collision_program, _image),
    "random_base_duplicates": (_random_base_program, _random_base_image),
    "int32_image": (_int_image_program, _int_image),
    "float32_image": (lambda: _float_dtype_program(DType.F),
                      lambda: _image(7).astype(np.float32)),
    **{f"dtype_{dt.name}": ((lambda dt=dt: _int_dtype_program(dt)), _image)
       for dt in (DType.B, DType.W, DType.DW, DType.QW)},
    **{f"dtype_{dt.name}": ((lambda dt=dt: _float_dtype_program(dt)), _image)
       for dt in (DType.F, DType.HF)},
}


def random_program(seed):
    """A seeded random program over a 4096-element image: 1-2 dims,
    dimension-mask toggles, loads of every type, contiguous / strided /
    colliding stores, random-base accesses through in-memory pointer
    tables, arithmetic, shifts, rotates, compares, predication, converts.
    Returns ``(reference instruction list, image)``."""
    i = ref_isa
    rng = np.random.default_rng(seed)
    mem = np.zeros(4096)
    mem[:1024] = rng.integers(0, 100, size=1024)
    wild = rng.uniform(-1e6, 1e6, size=512)
    wild[::7] = rng.integers(-300, 70000, size=len(wild[::7]))
    mem[1024:1536] = np.round(wild, 2)
    ints = [DType.B, DType.W, DType.DW, DType.QW]
    prog = [i.vsetwidth(32)]
    kinds = {}                        # reg -> "int" | "float"
    lens = []
    ptr_cursor = 1536

    def set_dims():
        nonlocal lens
        lens = [int(rng.integers(2, 17))
                for _ in range(int(rng.integers(1, 3)))]
        prog.append(i.vsetdimc(len(lens)))
        prog.extend(i.vsetdiml(d, ln) for d, ln in enumerate(lens))

    def pick(kind=None):
        regs = [r for r, k in kinds.items() if kind in (None, k)]
        return int(rng.choice(regs)) if regs else None

    def dense():
        return [1] + [2] * (len(lens) - 1)

    set_dims()
    for _ in range(int(rng.integers(12, 32))):
        c = int(rng.integers(0, 13))
        rd = int(rng.integers(0, 7))
        total = int(np.prod(lens))
        if c == 0:
            set_dims()
        elif c == 1:
            idx = int(rng.integers(0, lens[-1]))
            prog.append(i.vunsetmask(idx) if rng.random() < 0.5
                        else i.vsetmask(idx))
        elif c == 2:
            dt = [*ints, DType.F, DType.HF][int(rng.integers(0, 6))]
            base = int(rng.integers(0, 1536 - total))
            prog.append(i.vsld(dt, rd, base, *dense()))
            kinds[rd] = "float" if dt.is_float else "int"
        elif c == 3 and kinds:
            src = pick()
            dt = DType.F if kinds[src] == "float" else DType.DW
            style = rng.random()
            base = int(rng.integers(3072, 4096 - 2 * total))
            if style < 0.3:
                prog += [i.vsetststr(0, 2),
                         i.vsst(dt, src, base, 3, *dense()[1:])]
            elif style < 0.5:
                prog.append(i.vsst(dt, src, base, 0, *dense()[1:]))
            else:
                prog.append(i.vsst(dt, src, base, *dense()))
        elif c == 4:
            if rng.random() < 0.5:
                prog.append(i.vsetdup(DType.DW, rd,
                                      int(rng.integers(-50, 50))))
                kinds[rd] = "int"
            else:
                prog.append(i.vsetdup(DType.F, rd,
                                      float(np.round(rng.normal(), 3))))
                kinds[rd] = "float"
        elif c == 5 and pick("int") is not None:
            f = [i.vadd, i.vsub, i.vmul, i.vmin, i.vmax, i.vxor, i.vand,
                 i.vor][int(rng.integers(0, 8))]
            prog.append(f(ints[int(rng.integers(0, 4))], rd, pick("int"),
                          pick("int")))
            kinds[rd] = "int"
        elif c == 6 and kinds:
            dt = DType.DW if rng.random() < 0.5 else DType.F
            f = [i.vadd, i.vsub, i.vmul, i.vmin,
                 i.vmax][int(rng.integers(0, 5))]
            prog.append(f(dt, rd, pick(), pick(),
                          predicated=bool(rng.random() < 0.25)))
            kinds[rd] = "float" if dt.is_float else "int"
        elif c == 7 and kinds:
            a, b = pick(), pick()
            dt = DType.F if "float" in (kinds[a], kinds[b]) else DType.DW
            cmp = [Op.GT, Op.GTE, Op.LT, Op.LTE, Op.EQ,
                   Op.NEQ][int(rng.integers(0, 6))]
            prog.append(i.vcmp(cmp, dt, a, b))
        elif c == 8 and pick("int") is not None:
            prog.append(i.vshi(ints[int(rng.integers(0, 4))], rd,
                               pick("int"), int(rng.integers(-9, 10))))
            kinds[rd] = "int"
        elif c == 9 and pick("int") is not None:
            dt = ints[int(rng.integers(0, 4))]
            prog.append(i.Instr(Op.ROTI, dtype=dt, vd=rd, vs1=pick("int"),
                                imm=int(rng.integers(0, 2 * dt.bits))))
            kinds[rd] = "int"
        elif c == 10 and pick("int") is not None:
            prog += [i.vsetdup(DType.DW, 7, int(rng.integers(0, 8))),
                     i.vshr_reg(DType.DW, rd, pick("int"), 7)]
            kinds[7] = kinds[rd] = "int"
        elif c == 11 and kinds:
            dt = [DType.F, DType.HF, *ints][int(rng.integers(0, 6))]
            prog.append(i.vcvt(dt, rd, pick()))
            kinds[rd] = "float" if dt.is_float else "int"
        elif c == 12 and ptr_cursor + lens[-1] <= 2560:
            inner = total // lens[-1]
            base = ptr_cursor
            ptr_cursor += lens[-1]
            store = bool(kinds) and rng.random() < 0.5
            lo, hi = (3072, 4096 - inner) if store else (0, 1536 - inner)
            # sampled with replacement: duplicate pointers collide
            mem[base:base + lens[-1]] = rng.integers(lo, hi, lens[-1])
            modes = dense()[:-1] + [0]
            if store:
                src = pick()
                dt = DType.F if kinds[src] == "float" else DType.DW
                prog.append(i.vrst(dt, src, base, *modes))
            else:
                prog.append(i.vrld(DType.F, rd, base, *modes))
                kinds[rd] = "float"
    if kinds:
        src = pick()
        prog.append(i.vsst(DType.F if kinds[src] == "float" else DType.DW,
                           src, 3072, *dense()))
    return prog, mem
