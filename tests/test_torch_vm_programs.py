"""The VM (``mode="vm"``) on programs: seeded random programs (the
reference's ``tests/test_vm.py`` generator and the port's own), the trap
programs of ``_torch_parity``, every case of the reference's
``tests/test_mve_vm.py``, and one program per place where CPU and CUDA
torch differ from XLA (NaN and infinities into integer loads, shift counts
at and past the width and negative, rotates, float16 rounding).

Each goes through port VM, port fused, port stepwise, reference
``run_stepwise`` and reference VM, compared bit for bit.
"""
import numpy as np
import pytest

from repro.core import isa as ref_isa
from repro.core.isa import DType, Op
from repro.core.machine import ControlState as RefControl
from repro.core.machine import MVEConfig as RefConfig
from repro.core.machine import cbs_touched as ref_cbs_touched
from repro.core.machine import flatten_indices as ref_flatten

from repro_torch.core.machine import (ControlState, MVEConfig, cbs_touched,
                                      flatten_indices)

from _torch_parity import (TRAP_PROGRAMS, check_all_executors,
                           random_program)

I = ref_isa
CFG = MVEConfig()


def _reference_vm_generator():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).with_name("test_vm.py")
    spec = importlib.util.spec_from_file_location("_reference_test_vm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._random_program


@pytest.mark.parametrize("seed", range(12))
def test_reference_random_programs(seed):
    """The reference's own seeded generator (``tests/test_vm.py``)."""
    check_all_executors(*_reference_vm_generator()(seed))


@pytest.mark.parametrize("seed", range(24, 32))
def test_port_random_programs(seed):
    """``_torch_parity.random_program``: adds colliding, stride-0 and
    random-base stores through pointer tables with duplicates."""
    check_all_executors(*random_program(seed))


@pytest.mark.parametrize("name", sorted(TRAP_PROGRAMS))
def test_trap_programs(name):
    make_program, make_image = TRAP_PROGRAMS[name]
    check_all_executors(make_program(), make_image())


# ---------------------------------------------------------------------------
# Where CPU and CUDA torch differ from XLA: one program per trap, each
# within the VM's eight registers.
# ---------------------------------------------------------------------------

_SPECIAL = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e10, -1.5, 300.7, 70000.0,
            -70000.0, 255.5, -0.0, 65504.0, 65520.0, 1e-8, 2.0 ** 31]


def _special_image():
    mem = np.zeros(4096)
    mem[:len(_SPECIAL)] = _SPECIAL
    rng = np.random.default_rng(3)
    mem[64:128] = rng.integers(-2 ** 31, 2 ** 31, 64)
    mem[128:192] = [0, 31, 32, -1, -5, 40, 1, 16] * 8
    mem[256:320] = rng.standard_normal(64) * 1000
    mem[320:384] = rng.standard_normal(64) / 1000
    return mem


def _nonfinite_to_int():
    """NaN, ±inf and out-of-range floats into every integer load and
    ``vcvt``: saturate, NaN -> 0."""
    n = len(_SPECIAL)
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, n),
         I.vsld(DType.F, 0, 0, 1)]
    for k, dt in enumerate([DType.B, DType.W, DType.DW, DType.QW]):
        p += [I.vsld(dt, 1, 0, 1), I.vsst(dt, 1, 1024 + 32 * k, 1),
              I.vcvt(dt, 2, 0), I.vsst(dt, 2, 2048 + 32 * k, 1)]
    p += [I.vsld(DType.HF, 3, 0, 1), I.vcvt(DType.B, 4, 3),
          I.vsst(DType.DW, 4, 3072, 1)]
    return p


def _shifts():
    """``vshi`` by 0, 31, 32 and past, both ways; ``vshr`` by register
    amounts 0, 31, 32, -1, -5, 40."""
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
         I.vsld(DType.DW, 0, 64, 1), I.vsld(DType.DW, 1, 128, 1)]
    k = 0
    for dt in (DType.B, DType.W, DType.DW):
        for amt in (0, 1, 7, 8, 15, 16, 31, 32, 33, -1, -7, -8, -31, -32,
                    -33):
            p += [I.vshi(dt, 2, 0, amt), I.vsst(dt, 2, 1024 + 64 * k, 1)]
            k += 1
        p += [I.vshr_reg(dt, 3, 0, 1), I.vsst(dt, 3, 1024 + 64 * k, 1)]
        k += 1
    return p


def _rotates():
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
         I.vsld(DType.DW, 0, 64, 1)]
    k = 0
    for dt in (DType.B, DType.W, DType.DW, DType.QW):
        for amt in (0, 1, 7, 8, 9, 15, 16, 31, 32, 33, 63, 64, -1):
            p += [I.Instr(Op.ROTI, dtype=dt, vd=1, vs1=0, imm=amt),
                  I.vsst(dt, 1, 1024 + 64 * k, 1)]
            k += 1
    return p


def _half_rounding():
    """float16 add/sub/mul round once per instruction; operands that
    overflow, cancel and fall under the subnormal range."""
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
         I.vsld(DType.HF, 0, 256, 1), I.vsld(DType.HF, 1, 320, 1),
         I.vsld(DType.F, 2, 256, 1)]
    for k, f in enumerate([I.vadd, I.vsub, I.vmul]):
        p += [f(DType.HF, 3, 0, 1), I.vsst(DType.HF, 3, 1024 + 64 * k, 1),
              f(DType.HF, 4, 2, 0), I.vsst(DType.HF, 4, 2048 + 64 * k, 1),
              f(DType.HF, 5, 3, 4)]
    p += [I.vsld(DType.HF, 6, 0, 1), I.vadd(DType.HF, 7, 6, 6),
          I.vsst(DType.HF, 7, 3072, 1)]
    return p


TRAPS = {"nonfinite_to_int": _nonfinite_to_int, "shifts": _shifts,
         "rotates": _rotates, "half_rounding": _half_rounding}


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_datapath_traps(name):
    (_, _), cp = check_all_executors(TRAPS[name](), _special_image())
    assert cp.mode == "vm"


# ---------------------------------------------------------------------------
# The cases of the reference's tests/test_mve_vm.py.
# ---------------------------------------------------------------------------

def _strided_load(dims, strides, base):
    span = base + sum((ln - 1) * s for ln, s in zip(dims, strides)) + 1
    mem = np.arange(span + 4, dtype=np.float64) * 1.5 + 3
    prog = [I.vsetdimc(len(dims))]
    prog += [I.vsetdiml(d, ln) for d, ln in enumerate(dims)]
    prog += [I.vsetldstr(d, s) for d, s in enumerate(strides)]
    prog.append(I.vsld(DType.F, 0, base, *([3] * len(dims))))
    return prog, mem


@pytest.mark.parametrize("dims,strides,base", [
    ((8,), (3,), 5), ((4, 3), (1, 0), 0), ((2, 3, 4), (7, 5, 1), 16),
    ((3, 1, 5, 2), (2, 0, 3, 7), 9), ((5, 6), (0, 0), 11)])
def test_strided_load_matches_the_loop_oracle(dims, strides, base):
    prog, mem = _strided_load(dims, strides, base)
    (_, state), _ = check_all_executors(prog, mem)
    total = int(np.prod(dims))
    want = np.zeros(total)
    for lane in range(total):
        rem, addr = lane, base
        for ln, s in zip(dims, strides):
            addr += (rem % ln) * s
            rem //= ln
        want[lane] = mem[addr]
    np.testing.assert_array_equal(state.regs[0][:total].numpy(),
                                  want.astype(np.float32))


def test_stride_modes():
    for cls in (ControlState, RefControl):
        ctrl = cls()
        ctrl.dim_count = 3
        ctrl.dim_lens[:3] = [4, 5, 6]
        ctrl.ld_strides[:3] = [9, 9, 9]
        assert ctrl.resolve_strides((1, 2, 2), False) == (1, 4, 20)
        assert ctrl.resolve_strides((0, 1, 3), False) == (0, 1, 9)
        assert ctrl.resolve_strides((3, 0, 2), False) == (9, 0, 0)


def _replication():
    return [I.vsetdimc(2), I.vsetdiml(0, 3), I.vsetdiml(1, 5),
            I.vsld(DType.F, 0, 10, 1, 0)], np.arange(64, dtype=np.float64)


def _random_load():
    mem = np.zeros(256)
    mem[:100] = np.arange(100) * 2
    mem[200:203] = [40, 7, 22]
    return [I.vsetdimc(2), I.vsetdiml(0, 4), I.vsetdiml(1, 3),
            I.vrld(DType.F, 0, 200, 1)], mem


def _dimension_masking():
    mem = np.zeros(64)
    mem[:32] = np.arange(32)
    return [I.vsetdimc(2), I.vsetdiml(0, 8), I.vsetdiml(1, 4),
            I.vsld(DType.F, 0, 0, 1, 2), I.vunsetmask(1), I.vunsetmask(3),
            I.vsst(DType.F, 0, 32, 1, 2)], mem


def _masked_compute():
    return [I.vsetdimc(2), I.vsetdiml(0, 4), I.vsetdiml(1, 4),
            I.vsetdup(DType.DW, 0, 5), I.vunsetmask(2),
            I.vsetdup(DType.DW, 0, 9)], np.zeros(64)


def _tag_latch():
    mem = np.zeros(8)
    mem[:8] = np.arange(8)
    return [I.vsetdimc(1), I.vsetdiml(0, 8), I.vsetdup(DType.DW, 0, 3),
            I.vsetdup(DType.DW, 1, 0), I.vsld(DType.DW, 1, 0, 1),
            I.vcmp(Op.GT, DType.DW, 1, 0), I.vsetdup(DType.DW, 2, 1),
            I.vadd(DType.DW, 1, 1, 2, predicated=True)], mem


def _wraparound(dtype, start):
    mem = np.zeros(8)
    mem[0] = start
    return [I.vsetdimc(1), I.vsetdiml(0, 4), I.vsld(dtype, 0, 0, 0),
            I.vsetdup(dtype, 1, 2), I.vadd(dtype, 2, 0, 1)], mem


def _remaining_ops():
    mem = np.zeros(64)
    mem[:8] = [5, -3, 7, 0, 2, 9, -8, 4]
    mem[8:16] = [1, 1, 2, 2, 0, 3, 1, 0]
    return [I.vsetdimc(1), I.vsetdiml(0, 8), I.vsld(DType.DW, 0, 0, 1),
            I.vsld(DType.DW, 1, 8, 1), I.vmin(DType.DW, 2, 0, 1),
            I.vmax(DType.DW, 3, 0, 1), I.vshr_reg(DType.DW, 4, 0, 1),
            I.vcvt(DType.F, 5, 0),
            I.Instr(Op.ROTI, dtype=DType.DW, vd=6, vs1=0, imm=4)], mem


MVE_VM_CASES = {
    "replication_stride_zero": _replication,
    "random_load_eq1": _random_load,
    "dimension_level_masking": _dimension_masking,
    "masked_compute_preserves_old_value": _masked_compute,
    "predicated_execution_tag_latch": _tag_latch,
    "wraparound_B": lambda: _wraparound(DType.B, 255),
    "wraparound_W": lambda: _wraparound(DType.W, 32767),
    "remaining_ops_cvt_min_max_rot_shr": _remaining_ops,
}


@pytest.mark.parametrize("name", sorted(MVE_VM_CASES))
def test_reference_mve_vm_cases(name):
    (mem, state), cp = check_all_executors(*MVE_VM_CASES[name]())
    assert cp.mode == "vm"
    regs = {k: v.numpy() for k, v in state.regs.items()}
    if name == "replication_stride_zero":
        for row in regs[0][:15].reshape(5, 3):
            np.testing.assert_array_equal(row, [10, 11, 12])
    elif name == "random_load_eq1":
        got = regs[0][:12].reshape(3, 4)
        for w, p in enumerate([40, 7, 22]):
            np.testing.assert_array_equal(got[w], np.arange(p, p + 4) * 2)
    elif name == "dimension_level_masking":
        got = mem.numpy()
        np.testing.assert_array_equal(got[32:40], np.arange(8))
        np.testing.assert_array_equal(got[40:48], 0)
    elif name == "masked_compute_preserves_old_value":
        got = regs[0][:16].reshape(4, 4)
        np.testing.assert_array_equal(got[2], 5)
        np.testing.assert_array_equal(got[0], 9)
    elif name == "predicated_execution_tag_latch":
        np.testing.assert_array_equal(regs[1][:8],
                                      np.arange(8) + (np.arange(8) > 3))
    elif name.startswith("wraparound"):
        wrap = 256 if name.endswith("B") else 65536
        start = 255 if name.endswith("B") else 32767
        assert int(regs[2][0]) % wrap == (start + 2) % wrap
    else:
        a = np.array([5, -3, 7, 0, 2, 9, -8, 4], np.int64)
        want = ((a.astype(np.uint32) << 4)
                | (a.astype(np.uint32) >> 28)).astype(np.int32)
        np.testing.assert_array_equal(regs[6][:8], want)


def test_flatten_cb_masking_and_register_count():
    dims = (3, 4, 5)
    np.testing.assert_array_equal(flatten_indices(dims, 128),
                                  ref_flatten(dims, 128))
    mask = np.ones(256, dtype=bool)
    mask[0] = False
    top = (CFG.lanes_per_cb, 8)
    cbm = cbs_touched(top, mask, CFG)
    np.testing.assert_array_equal(cbm, ref_cbs_touched(top, mask,
                                                       RefConfig()))
    assert not cbm[0] and cbm[1:].all()
    assert CFG.num_physical_registers(32) == 8
    assert CFG.num_physical_registers(8) == 32
    assert CFG.effective_lanes(32) == 8192
