"""``repro_torch.core.isa`` / ``machine`` / ``cost`` vs the reference:
program text, validation, ``TraceEvent`` streams, timeline and energy
totals — all exact (pure NumPy on both sides, never a tolerance).
"""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import cost as ref_cost
from repro.core import isa as ref_isa
from repro.core import machine as ref_machine
from repro.core.engine import compile_program as ref_compile
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert
from repro_torch.core import cost, isa, machine
from repro_torch.core.engine import compile_program
from repro_torch.core.patterns import PATTERNS

from _torch_parity import assert_trace_equal

NAMES = sorted(REF_PATTERNS)
GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_traces.json"


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference run, its static trace, port program, port static trace)."""
    run = REF_PATTERNS[name]()
    ref_trace = ref_compile(run.program, mode="fused").static_trace
    program = convert.program_from_reference(run.program)
    trace = compile_program(program, device="cpu").static_trace
    return run, ref_trace, program, trace


def test_registries_agree():
    assert sorted(PATTERNS) == NAMES
    assert [o.name for o in isa.Op] == [o.name for o in ref_isa.Op]
    assert [(d.name, d.suffix, d.bits, d.is_float) for d in isa.DType] == \
        [(d.name, d.suffix, d.bits, d.is_float) for d in ref_isa.DType]


@pytest.mark.parametrize("name", NAMES)
def test_program_text_and_validation(name):
    run, _, program, _ = _pair(name)
    assert program.dump() == run.program.dump()
    assert program.validate() is program
    assert program.validate(memory_size=run.memory.shape[0],
                            strict=True) is program


@pytest.mark.parametrize("name", NAMES)
def test_static_trace_equal(name):
    _, ref_trace, _, trace = _pair(name)
    assert_trace_equal(ref_trace, trace)


@pytest.mark.parametrize("scheme", ["bs", "bp", "bh", "ac"])
@pytest.mark.parametrize("name", NAMES)
def test_timeline_and_energy_equal(name, scheme):
    run, ref_trace, _, trace = _pair(name)
    ref_cfg = ref_machine.MVEConfig(scheme=scheme)
    cfg = convert.config_from_reference(ref_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    want = ref_cost.simulate(ref_trace, ref_cfg)
    got = cost.simulate(trace, cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert cost.breakdown(got) == ref_cost.breakdown(want)
    assert cost.data_bytes(trace) == ref_cost.data_bytes(ref_trace)
    e_want = ref_cost.mve_energy(want, ref_cfg, ref_cost.data_bytes(ref_trace))
    e_got = cost.mve_energy(got, cfg, cost.data_bytes(trace))
    assert dataclasses.asdict(e_got) == dataclasses.asdict(e_want)


@pytest.mark.parametrize("name", NAMES)
def test_frozen_golden_rows_reproduce(name):
    """A second, JAX-free check: the frozen trace and timeline rows of the
    reference's golden file come out of the port exactly."""
    golden = json.loads(GOLDEN.read_text())["patterns"][name]
    run, _, program, _ = _pair(name)
    # a run's trace: random-base accesses get their line counts from data
    trace = compile_program(program, device="cpu").run(run.memory)[1].trace
    rows = [[ev.op.value, ev.dtype.suffix if ev.dtype else None,
             int(ev.elements), int(ev.segments), int(ev.scalar_count),
             int(ev.contiguous_run), int(ev.unique_elements), int(ev.lines),
             int(sum(1 << i for i, b in enumerate(ev.cb_mask) if b))]
            for ev in trace]
    assert rows == golden["trace"]
    tl = cost.simulate(trace, machine.MVEConfig())
    assert {f: getattr(tl, f) for f in golden["timeline"]} == \
        golden["timeline"]


def test_baseline_models_equal():
    for name in NAMES:
        ref_run, port_run = REF_PATTERNS[name](), PATTERNS[name]()
        assert dataclasses.asdict(port_run.neon) == \
            dataclasses.asdict(ref_run.neon)
        n = ref_run.neon
        assert cost.NeonModel().kernel_cycles(n.vector_ops, n.elements, n.bits,
                                        n.mem_bytes) == \
            ref_cost.NeonModel().kernel_cycles(n.vector_ops, n.elements, n.bits,
                                         n.mem_bytes)
        assert cost.GPUModel().kernel_us(ref_run.flops, ref_run.copy_bytes) \
            == ref_cost.GPUModel().kernel_us(ref_run.flops, ref_run.copy_bytes)
    assert dataclasses.asdict(cost.DEFAULT_ENERGY) == \
        dataclasses.asdict(ref_cost.DEFAULT_ENERGY)


def test_energy_derive_waits_for_the_silicon_model():
    """The silicon model is ported: at the Table IV geometry the derived
    constants are ``DEFAULT_ENERGY`` byte for byte."""
    assert cost.EnergyParams.derive(machine.MVEConfig()) == \
        cost.DEFAULT_ENERGY


def test_machine_helpers_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        nd = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 9, nd))
        strides = tuple(int(s) for s in rng.integers(0, 40, nd))
        np.testing.assert_array_equal(
            machine.flatten_indices(dims, 8192),
            ref_machine.flatten_indices(dims, 8192))
        assert machine.stream_shape(dims, strides, 8192) == \
            ref_machine.stream_shape(dims, strides, 8192)
        dim_mask = rng.random(256) < 0.6
        np.testing.assert_array_equal(
            machine.lane_dim_mask(dims, dim_mask, 8192),
            ref_machine.lane_dim_mask(dims, dim_mask, 8192))
        modes = tuple(int(m) for m in rng.integers(0, 4, nd))
        a, b = machine.ControlState(), ref_machine.ControlState()
        for c in (a, b):
            c.dim_count, c.dim_lens[:nd] = nd, list(dims)
            c.ld_strides[:nd] = list(strides)
        assert a.resolve_strides(modes, False) == \
            b.resolve_strides(modes, False)


def test_config_validation_carries_over():
    with pytest.raises(isa.ProgramError):
        machine.MVEConfig(bitlines=100)
    with pytest.raises(isa.ProgramError):
        machine.MVEConfig(scheme="xx")
    with pytest.raises(isa.ProgramError, match="float register"):
        isa.validate([isa.vshi(isa.DType.F, 0, 1, 2)])


def test_element_types_follow_the_reference():
    """64-bit inputs narrow to 32 bits (the reference runs in 32-bit mode)
    and ``QW`` registers are int32 there, so they are here."""
    assert machine.TORCH_DTYPE[isa.DType.QW] == torch.int32
    assert machine.as_memory(np.zeros(4), "cpu").dtype == torch.float32
    assert machine.as_memory(np.zeros(4, np.int64), "cpu").dtype == \
        torch.int32
    assert machine.as_memory(np.zeros(4, np.uint8), "cpu").dtype == \
        torch.uint8
    host = np.arange(4.0)
    mem = machine.as_memory(host, "cpu")
    mem[0] = 9
    assert host[0] == 0                       # always a copy


def test_saturating_conversion_follows_the_reference():
    import jax.numpy as jnp
    wild = np.array([300.7, -3.2, np.nan, 1e10, 3e9, -3e9, np.inf, -np.inf,
                     3.99, -3.99, 32767.5, -32768.5, 2147483520.0],
                    dtype=np.float32)
    for t_dt, j_dt in ((torch.uint8, jnp.uint8), (torch.int16, jnp.int16),
                       (torch.int32, jnp.int32)):
        np.testing.assert_array_equal(
            machine.convert(torch.from_numpy(wild), t_dt).numpy(),
            np.asarray(jnp.asarray(wild).astype(j_dt)))
    ints = np.array([300, -1, 65537, -40000, 2**31 - 1], dtype=np.int32)
    for t_dt, j_dt in ((torch.uint8, jnp.uint8), (torch.int16, jnp.int16)):
        np.testing.assert_array_equal(
            machine.convert(torch.from_numpy(ints), t_dt).numpy(),
            np.asarray(jnp.asarray(ints).astype(j_dt)))
