"""Built-in targets: the paper's full comparison matrix.

  =========  =====  ==============  =======================================
  name       ISA    engine          what it models
  =========  =====  ==============  =======================================
  mve-bs     MVE    bit-serial      Neural Cache — the paper's default
  mve-bp     MVE    bit-parallel    VRAM: n-bit data horizontal
  mve-bh     MVE    bit-hybrid      EVE: p-bit segments, serial carry
  mve-ac     MVE    associative     CAPE: truth-table search/update
  rvv-1d     RVV    bit-serial      the same engine driven by a 1D ISA
                                    (Section III-C segment decomposition)
  neon       Neon   packed SIMD     2x128-bit ASIMD pipes on a mobile core
  =========  =====  ==============  =======================================

Each row also has a ``-timed`` twin (:mod:`repro_torch.targets.timed`,
registered on package import) that re-prices the same performance trace
through the cycle-accurate in-order pipeline model of
:mod:`repro_torch.timing` — scoreboard hazards, chaining, memory ports —
instead of the analytic timeline.

All six execute through the shared functional engine — bit-exact results
— and differ only in how the program is *issued and priced* (Figures
10/11/13).  The in-cache targets reuse the controller/CB timeline model
under their scheme's latencies; ``rvv-1d`` first lowers every
multi-dimensional access into partial 1D segments
(:func:`repro_torch.core.rvv.compile_to_rvv`); ``neon`` prices the workload
the MVE trace records through the analytic
:class:`~repro_torch.core.cost.NeonModel`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from ..core import cost, isa, rvv
from ..core.cost import (EnergyParams, EnergyReport, NeonModel, Timeline,
                         TimingParams, TraceEvent)
from ..core.machine import MVEConfig
from .base import InstructionMix, Target, register_target

#: The default target: the paper's MVE-on-bit-serial configuration.
DEFAULT_TARGET = "mve-bs"


def _replace_cfg(cfg: MVEConfig, overrides: dict) -> MVEConfig:
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, **overrides)


@dataclasses.dataclass(frozen=True)
class InCacheTarget(Target):
    """MVE driving the in-cache engine under one compute scheme.

    The program IS the target's native ISA, so the performance trace is
    the engine trace itself; the scheme (``bs``/``bp``/``bh``/``ac``)
    changes per-op latencies and effective lane counts through
    :func:`repro_torch.core.cost.compute_cycles` /
    :meth:`~repro_torch.core.machine.MVEConfig.effective_lanes`.
    """

    name: str
    scheme: str = "bs"
    description: str = ""
    isa_name: str = "mve"
    timing: TimingParams = TimingParams()
    energy_params: EnergyParams = cost.DEFAULT_ENERGY
    #: extra MVEConfig fields pinned by this target, e.g.
    #: ``(("bh_segment_bits", 8),)`` — applied before per-call overrides.
    config_overrides: Tuple[Tuple[str, object], ...] = ()

    def machine_config(self, cfg=None, **overrides) -> MVEConfig:
        merged = dict(self.config_overrides)
        merged["scheme"] = self.scheme
        merged.update(overrides)
        return _replace_cfg(cfg or MVEConfig(), merged)

    def performance_trace(self, program, cfg, mve_trace):
        return mve_trace

    def energy_model(self, cfg) -> Tuple[EnergyParams, str]:
        """The ``(params, provenance)`` this target prices energy with.

        Default behaviour derives the constants from the silicon model
        for the *actual* machine geometry (:mod:`repro_torch.silicon.params`)
        — byte-identical to :data:`~repro_torch.core.cost.DEFAULT_ENERGY` at
        the Table IV default by the calibration contract.  A target
        constructed with explicit ``energy_params`` opts out and keeps
        its fixed constants (provenance ``"default"``).
        """
        if self.energy_params is not cost.DEFAULT_ENERGY:
            return self.energy_params, "default"
        from ..silicon.params import derived_energy
        return derived_energy(cfg, self.scheme)

    def energy(self, program, cfg, mve_trace) -> EnergyReport:
        tl = self.timeline(program, cfg, mve_trace)
        ep, source = self.energy_model(cfg)
        return cost.mve_energy(tl, cfg, cost.data_bytes(mve_trace),
                               ep, params_source=source)

    def instruction_mix(self, program, cfg) -> InstructionMix:
        return InstructionMix.from_rvv_stats(rvv.mve_stats(program))


@dataclasses.dataclass(frozen=True)
class RVV1DTarget(InCacheTarget):
    """A 1D long-vector (RVV-style) ISA driving the same in-cache engine.

    Execution is unchanged — the 1D decomposition performs *the same
    access, sliced* — but the performance trace is the Section III-C
    lowering: ``ceil(active_lanes / inner-1D-segment)`` partial accesses,
    each paying a predicate config, the access, a pack move, and scalar
    address generation; dimension-level masks become materialize+load
    sequences.  Defaults to the bit-serial engine (the Figure 10/11
    configuration); instantiate with another ``scheme`` for the Figure 13
    sweep rows.
    """

    name: str = "rvv-1d"
    isa_name: str = "rvv"

    def performance_trace(self, program, cfg, mve_trace):
        trace, _ = rvv.compile_to_rvv(program, cfg)
        return trace

    def instruction_mix(self, program, cfg) -> InstructionMix:
        _, stats = rvv.compile_to_rvv(program, cfg)
        return InstructionMix.from_rvv_stats(stats)


def _neon_work(trace: List[TraceEvent]) -> Tuple[float, int, float]:
    """(element ops, dominant bit width, unique memory bytes) of a trace.

    The MVE trace is the workload record: every non-memory vector event
    contributes its active elements as element-operations; memory traffic
    is the unique-byte count (replication is free on Neon too — it reads
    the value once into a register).  The dominant width is the
    element-op-weighted mode, so a kernel computing in int8 with an f32
    epilogue prices as int8.
    """
    elem_ops = 0.0
    by_bits: dict = {}
    for ev in trace:
        if ev.op is isa.Op.SCALAR or ev.op in isa.CONFIG_OPS:
            continue
        if ev.dtype is None or ev.op in isa.MEMORY_OPS:
            continue
        elem_ops += ev.elements
        by_bits[ev.dtype.bits] = by_bits.get(ev.dtype.bits, 0) + ev.elements
    bits = max(by_bits, key=by_bits.get) if by_bits else 32
    return elem_ops, bits, cost.data_bytes(trace)


@dataclasses.dataclass(frozen=True)
class NeonTarget(Target):
    """Packed-SIMD mobile baseline (2x128-bit ASIMD pipes, Figure 7).

    Execution still goes through the functional engine (Neon computes
    the same arithmetic — bit-exactness holds trivially); timing and
    energy come from the analytic :class:`~repro_torch.core.cost.NeonModel`
    over the workload the MVE trace records (:func:`_neon_work`).
    Patterns carrying a hand-derived analytic workload descriptor
    (``PatternRun.neon``) can be priced more precisely via
    ``benchmarks/paper_claims.fig7_neon``; this target is the generic
    path that works for *any* kernel.
    """

    name: str = "neon"
    description: str = "Arm Neon packed SIMD (Cortex-A76-class, 2x128b)"
    isa_name: str = "neon"
    model: NeonModel = NeonModel()
    energy_params: EnergyParams = cost.DEFAULT_ENERGY

    def machine_config(self, cfg=None, **overrides) -> MVEConfig:
        # Functional execution substrate only — Neon has no in-SRAM
        # scheme; geometry overrides still apply (they bound the lanes
        # the functional engine packs).
        return _replace_cfg(cfg or MVEConfig(), overrides)

    def freq_ghz(self, cfg) -> float:
        return self.model.freq_ghz

    def performance_trace(self, program, cfg, mve_trace):
        # Neon issues no in-cache instructions; the MVE trace is the
        # workload descriptor its analytic model prices.
        return mve_trace

    def timeline(self, program, cfg, mve_trace) -> Timeline:
        elem_ops, bits, mem_bytes = _neon_work(mve_trace)
        m = self.model
        lanes = max(1, m.simd_bits // bits)
        cycles = m.kernel_cycles(1.0, elem_ops, bits, mem_bytes)
        compute = elem_ops / (lanes * m.pipes)
        data = mem_bytes / m.l1_bytes_per_cycle
        simd_ops = int(math.ceil(elem_ops / lanes))
        tl = Timeline(total_cycles=cycles, compute_cycles=compute,
                      data_cycles=data,
                      scalar_cycles=simd_ops * 0.5 / 4.0,
                      vector_instructions=simd_ops,
                      scalar_instructions=int(math.ceil(simd_ops * 0.5)))
        tl.lane_slots = cycles * lanes * m.pipes
        tl.busy_lane_cycles = compute * lanes * m.pipes
        tl.cb_slots = cycles * m.pipes
        tl.busy_cb_cycles = compute * m.pipes
        tl.idle_cycles = max(0.0, cycles - compute - data)
        return tl

    def energy(self, program, cfg, mve_trace) -> EnergyReport:
        elem_ops, bits, mem_bytes = _neon_work(mve_trace)
        simd_ops = elem_ops / max(1, self.model.simd_bits // bits)
        return cost.neon_energy(simd_ops, mem_bytes, self.energy_params)

    def instruction_mix(self, program, cfg) -> InstructionMix:
        trace = _trace_cache_walk(program, cfg, self.name)
        elem_ops, bits, mem_bytes = _neon_work(trace)
        lanes = max(1, self.model.simd_bits // bits)
        simd_ops = int(math.ceil(elem_ops / lanes))
        mem_ops = int(math.ceil(mem_bytes / (self.model.simd_bits // 8)))
        return InstructionMix(vector=simd_ops + mem_ops, memory=mem_ops,
                              scalar=int(math.ceil(simd_ops * 0.5)))


def _trace_cache_walk(program, cfg, cache_tag: str) -> List[TraceEvent]:
    """Static engine trace of a program (compile-walk only, cached via
    the engine LRU under the calling target's tag) — the workload record
    instruction_mix needs when no execution state is at hand.  The walk
    runs on the host and executes nothing, so it is keyed on the CPU and
    needs no card."""
    from ..core.engine import compile_program
    return compile_program(program, cfg, cache_tag=cache_tag,
                           device="cpu").static_trace


# ---------------------------------------------------------------------------
# Registration: the paper's six-way comparison matrix.
# ---------------------------------------------------------------------------

MVE_BS = register_target(InCacheTarget(
    "mve-bs", scheme="bs",
    description="MVE on the bit-serial engine (Neural Cache; default)"))
MVE_BP = register_target(InCacheTarget(
    "mve-bp", scheme="bp",
    description="MVE on the bit-parallel engine (VRAM: n-bit horizontal)"))
MVE_BH = register_target(InCacheTarget(
    "mve-bh", scheme="bh",
    description="MVE on the bit-hybrid engine (EVE: p-bit segments)"))
MVE_AC = register_target(InCacheTarget(
    "mve-ac", scheme="ac",
    description="MVE on the associative engine (CAPE: truth-table rows)"))
RVV_1D = register_target(RVV1DTarget(
    description="1D long-vector (RVV-style) ISA on the bit-serial engine"))
NEON = register_target(NeonTarget())
