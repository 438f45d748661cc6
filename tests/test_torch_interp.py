"""``repro_torch.core.interp``: the port's step oracle vs the reference's
``run_stepwise`` — memory, every register (with its element type), the Tag
latch bit-equal, traces equal — on all 14 Section-IV patterns, the
hand-written trap programs and seeded random programs.
"""
import numpy as np
import pytest
import torch

from repro.core import isa as ref_isa
from repro.core.isa import DType
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert
from repro_torch.core import MVEConfig, MVEInterpreter
from repro_torch.core.interp import MachineState, read_register

from _torch_parity import (PORT_ORACLE, REF_ORACLE, TRAP_PROGRAMS,
                           assert_state_equal, assert_trace_equal,
                           random_program)


def _check_stepwise(ref_program, memory):
    _, want = REF_ORACLE.run_stepwise(ref_program, memory)
    mem, got = PORT_ORACLE.run_stepwise(
        convert.program_from_reference(ref_program), memory)
    assert mem is got.memory
    assert_state_equal(want, got)
    assert_trace_equal(want.trace, got.trace)
    return got


@pytest.mark.parametrize("name", sorted(REF_PATTERNS))
def test_stepwise_matches_reference_on_patterns(name):
    run = REF_PATTERNS[name]()
    got = _check_stepwise(run.program, run.memory)
    run.check(got.memory.numpy(), got)


@pytest.mark.parametrize("name", sorted(TRAP_PROGRAMS))
def test_stepwise_matches_reference_on_trap_programs(name):
    make_program, make_image = TRAP_PROGRAMS[name]
    _check_stepwise(make_program(), make_image())


@pytest.mark.parametrize("seed", range(12))
def test_stepwise_matches_reference_on_random_programs(seed):
    _check_stepwise(*random_program(seed))


def test_float_to_narrow_int_saturates():
    """Loads and converts of out-of-range floats clamp, truncate toward
    zero and map NaN to 0 — not PyTorch's undefined ``Tensor.to``."""
    i = ref_isa
    mem = np.zeros(32)
    mem[:6] = [-1.5, 70000.0, 300.0, 42.0, np.nan, -3e9]
    prog = [i.vsetdimc(1), i.vsetdiml(0, 6), i.vsld(DType.F, 0, 0, 1),
            i.vcvt(DType.B, 1, 0), i.vcvt(DType.W, 2, 0),
            i.vsld(DType.B, 3, 0, 1), i.vsld(DType.DW, 4, 0, 1)]
    st = _check_stepwise(prog, mem)
    np.testing.assert_array_equal(read_register(st, 1, 6),
                                  [0, 255, 255, 42, 0, 0])
    np.testing.assert_array_equal(read_register(st, 2, 6),
                                  [-1, 32767, 300, 42, 0, -32768])
    np.testing.assert_array_equal(read_register(st, 3, 6),
                                  read_register(st, 1, 6))
    np.testing.assert_array_equal(read_register(st, 4, 6),
                                  [-1, 70000, 300, 42, 0, -2**31])


def test_masked_lane_never_beats_an_active_store_to_address_zero():
    """A masked lane writes nowhere: it must not resurrect the old value
    of an address an active lane stores to."""
    i = ref_isa
    mem = np.arange(64, dtype=np.float64) + 1
    prog = [i.vsetdimc(2), i.vsetdiml(0, 4), i.vsetdiml(1, 2),
            i.vsetdup(DType.F, 0, 99.0), i.vunsetmask(1),
            i.vsst(DType.F, 0, 0, 1, 2)]
    st = _check_stepwise(prog, mem)
    np.testing.assert_array_equal(st.memory[:8].numpy(),
                                  [99, 99, 99, 99, 5, 6, 7, 8])


def test_interpreter_routes_and_devices():
    run = REF_PATTERNS["daxpy"]()
    program = convert.program_from_reference(run.program)
    compiled = MVEInterpreter(MVEConfig(), device="cpu")
    mem_c, st_c = compiled.run(program, run.memory)
    mem_s, st_s = MVEInterpreter(compiled=False, device="cpu").run(
        program, run.memory)
    assert torch.equal(mem_c, mem_s)
    assert isinstance(st_s, MachineState) and mem_c.device.type == "cpu"
    run.check(mem_c.numpy(), st_c)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MVEInterpreter()              # default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            MVEInterpreter(device="cuda:0")


def test_state_round_trip_through_numpy():
    rng = np.random.default_rng(0)
    mem = rng.standard_normal(64)
    regs = {0: rng.integers(0, 255, 16).astype(np.uint8),
            3: rng.standard_normal(16).astype(np.float16)}
    tag = rng.random(16) < 0.5
    state = convert.state_from_numpy(mem, regs, tag, device="cpu")
    assert state.memory.dtype == torch.float32
    back = convert.state_to_numpy(state)
    np.testing.assert_array_equal(back["memory"], mem.astype(np.float32))
    np.testing.assert_array_equal(back["tag"], tag)
    for r, v in regs.items():
        assert back["regs"][r].dtype == v.dtype
        np.testing.assert_array_equal(back["regs"][r], v)
