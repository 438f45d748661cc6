"""``repro_torch.targets`` and the RVV lowering (``repro_torch.core.rvv``):
the 13-target registry against the reference's.

On every Section-IV pattern each registered target compiles and runs on the
CPU with memory, registers and Tag bit-equal to the reference target's and
to the stepwise oracle, and prices the run with equal cycles, energy and
instruction mix; ``compile_to_rvv`` and ``segments_for`` equal the
reference's; the compile cache counts per target as the reference's does.
"""
import dataclasses

import numpy as np
import pytest

from repro import targets as ref_targets
from repro.core import rvv as ref_rvv
from repro.core.machine import ControlState as RefControl
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert, targets
from repro_torch.core import MVEConfig, cache_info, isa, rvv
from repro_torch.core.machine import ControlState, apply_config
from repro_torch.core.patterns import PATTERNS

from _torch_parity import (PORT_ORACLE, assert_bits_equal,
                           assert_state_equal, assert_trace_equal)

CFG = MVEConfig()
ALL_BUILTIN = ("mve-bs", "mve-bp", "mve-bh", "mve-ac", "rvv-1d", "neon")


def _fields(obj) -> dict:
    """A pricing result as plain data (dataclass fields, NumPy arrays as
    lists), for equality across the two packages."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return out


def test_registry_equals_the_reference():
    assert targets.list_targets() == ref_targets.list_targets()
    assert len(targets.list_targets()) == 13
    assert targets.DEFAULT_TARGET == "mve-bs"
    for name in targets.list_targets():
        got, want = targets.get_target(name), ref_targets.get_target(name)
        assert type(got).__name__ == type(want).__name__
        assert (got.name, got.description, got.isa_name) == \
            (want.name, want.description, want.isa_name)
        assert dataclasses.asdict(got.machine_config()) == \
            dataclasses.asdict(want.machine_config())
    assert targets.get_target(targets.RVV_1D) is targets.RVV_1D
    with pytest.raises(isa.ProgramError) as err:
        targets.get_target("sve-2d")
    for name in ALL_BUILTIN:
        assert name in str(err.value)


@pytest.mark.parametrize("name", sorted(REF_PATTERNS))
def test_every_target_bit_exact_and_equally_priced(name):
    """All 13 targets: results bit-equal to the reference's target and to
    the stepwise oracle; static and executed cycles, energy and
    instruction mix equal to the reference's."""
    ref_run = REF_PATTERNS[name]()
    program = convert.program_from_reference(ref_run.program)
    step_mem, step_state = PORT_ORACLE.run_stepwise(program, ref_run.memory)
    for tname in targets.list_targets():
        want = ref_targets.compile(ref_run.program, target=tname)
        ref_mem, ref_state = want.run(ref_run.memory)
        ref_state.memory = np.asarray(ref_mem)
        got = targets.compile(program, target=tname, device="cpu")
        mem, state = got.run(ref_run.memory)
        assert got.cp.device.type == "cpu" and got.mode == "fused"
        assert_state_equal(ref_state, state, tname)
        assert_bits_equal(step_mem.numpy(), mem.numpy(), tname)
        assert_trace_equal(step_state.trace, state.trace)
        for source in (None, "run"):
            w = None if source is None else ref_state
            g = None if source is None else state
            assert _fields(got.timeline(g)) == _fields(want.timeline(w)), \
                (tname, source)
            assert _fields(got.energy(g)) == _fields(want.energy(w)), \
                (tname, source)
            assert got.us(g) == want.us(w)
        assert _fields(got.instruction_mix()) == \
            _fields(want.instruction_mix())
        assert len(got.trace(state)) == len(want.trace(ref_state))


@pytest.mark.parametrize("name", sorted(REF_PATTERNS))
def test_rvv_lowering_equals_the_reference(name):
    ref_run = REF_PATTERNS[name]()
    program = convert.program_from_reference(ref_run.program)
    want_trace, want_stats = ref_rvv.compile_to_rvv(ref_run.program)
    got_trace, got_stats = rvv.compile_to_rvv(program, CFG)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    assert_trace_equal(want_trace, got_trace)
    assert dataclasses.asdict(rvv.mve_stats(program)) == \
        dataclasses.asdict(ref_rvv.mve_stats(ref_run.program))
    # segments_for on every memory instruction, under the state it sees
    ctrl, ref_ctrl = ControlState(), RefControl()
    from repro.core.machine import apply_config as ref_apply
    checked = 0
    for instr, ref_instr in zip(program, ref_run.program):
        if instr.op in isa.CONFIG_OPS:
            apply_config(ctrl, instr)
            ref_apply(ref_ctrl, ref_instr)
        elif instr.op in isa.MEMORY_OPS:
            assert rvv.segments_for(ctrl, instr, CFG.lanes) == \
                ref_rvv.segments_for(ref_ctrl, ref_instr, CFG.lanes)
            checked += 1
    assert checked > 0


def test_per_target_cache_keys_never_alias():
    run = PATTERNS["reduction"]()
    before = cache_info()
    a = targets.compile(run.program, target="mve-bs", device="cpu")
    b = targets.compile(run.program, target="rvv-1d", device="cpu")
    c = targets.compile(run.program, target="rvv-1d", device="cpu")
    assert a.cp is not b.cp and b.cp is c.cp
    after = cache_info()
    assert after.per_target["rvv-1d"]["hits"] >= 1
    assert after.per_target["rvv-1d"]["misses"] >= 1
    assert after.per_target["mve-bs"]["misses"] > \
        before.per_target.get("mve-bs", {}).get("misses", 0) - 1


def test_vm_mode_through_every_target():
    """``mode="vm"`` artifacts: same memory as fused on every target."""
    run = PATTERNS["upsample"]()
    want, _ = targets.compile(run.program, device="cpu").run(run.memory)
    for tname in targets.list_targets():
        art = targets.compile(run.program, target=tname, mode="vm",
                              device="cpu")
        assert art.mode == "vm"
        mem, state = art.run(run.memory)
        assert_bits_equal(want.numpy(), mem.numpy(), tname)
        run.check(mem.numpy(), state)


def test_artifact_surface_and_overrides():
    run = PATTERNS["daxpy"]()
    art = targets.compile(run.kernel, target="mve-bp", device="cpu")
    assert art.kernel is run.kernel
    mem, state = art.run()              # declared inits form the image
    assert sorted(state.operands) == ["x", "y"]
    run.check(mem.numpy(), state)
    mems, _, _ = art.run_batch(np.stack([run.kernel.pack()] * 2))
    assert_bits_equal(mem.numpy(), mems[1].numpy())
    raw = targets.compile(run.program, target="mve-bs", device="cpu")
    with pytest.raises(TypeError):
        raw.run()
    assert raw.timeline().total_cycles == raw.timeline(state).total_cycles \
        == raw.timeline(run.memory).total_cycles
    small = targets.compile(run.program, target="mve-bs", num_arrays=8,
                            device="cpu")
    assert small.cfg.lanes == 8 * 256
    bh = targets.compile(run.program, target="mve-bh", device="cpu",
                         cfg=MVEConfig(num_arrays=16))
    assert bh.cfg.scheme == "bh" and bh.cfg.num_arrays == 16


def test_register_target_and_third_party_scheme():
    custom = targets.InCacheTarget(
        "bh8-test", scheme="bh", config_overrides=(("bh_segment_bits", 8),))
    try:
        targets.register_target(custom)
        with pytest.raises(isa.ProgramError):
            targets.register_target(targets.InCacheTarget("bh8-test"))
        with pytest.raises(TypeError):
            targets.register_target("not-a-target")
        run = PATTERNS["daxpy"]()
        art = targets.compile(run.program, target="bh8-test", device="cpu")
        assert art.cfg.bh_segment_bits == 8
        mem, state = art.run(run.memory)
        run.check(mem.numpy(), state)
        assert art.timeline(state).total_cycles > 0
    finally:
        targets.base._REGISTRY.pop("bh8-test", None)


def test_smoke_and_kernel_compile_per_target():
    cycles = targets.smoke("xor_cipher", device="cpu")
    want = ref_targets.smoke("xor_cipher")
    assert cycles == want
    k = PATTERNS["audio_mix"]().kernel
    ref = None
    for tname in ALL_BUILTIN:
        art = k.compile(target=tname, device="cpu")
        assert isinstance(art, targets.CompiledArtifact)
        out, _ = k.run(target=tname, device="cpu")
        if ref is None:
            ref = out
        for n in ref:
            np.testing.assert_array_equal(out[n], ref[n])
