"""Cycle-accurate cost models for the in-cache engine.

Latencies follow Table II (bit-serial, BS) and Section II-B for the other
In-SRAM computing schemes:

  BS (Neural Cache):  add n, sub 2n, mul n^2+5n, min/max 2n, xor n, cmp n,
                      shift-imm n, shift-reg n*log2(n), cvt/cpy n.
  BP (VRAM):          n-bit data horizontal; parallelism /n, latency /n.
  BH (EVE):           p-bit segments; parallelism /p, latency ~ /p with a
                      bit-serial carry between segments.
  AC (CAPE):          add/sub 8n+2 (search/update per truth-table row with
                      sequential carry); mul decomposes into n adds.

The *timeline* model reproduces the execution-time breakdown of Section
VII-A (idle / compute / data access) with the controller semantics of
Section V-B: instructions are enqueued by the scalar core, CBs execute
independently (skipping instructions their mask bit-vector drops), and the
controller blocks on vector memory accesses until every CB has finished.

Hardware constants not given in closed form by the paper are documented
inline and kept in one place (:class:`TimingParams`) so the benchmarks can
state their assumptions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from .isa import (ARITH_OPS, COMPARE_OPS, CONFIG_OPS, MEMORY_OPS, MOVE_OPS,
                  DType, Op)
from .machine import MVEConfig


@dataclasses.dataclass
class TraceEvent:
    """One executed instruction with everything the cost model needs.

    Trace events are *data-independent* for strided accesses (addresses are
    fully determined by the control registers), which is what lets the
    compiled engine (:mod:`repro_torch.core.engine`, docs/ENGINE.md) emit them at
    compile time.  Random-base accesses (Eq. 1) additionally depend on the
    pointer array contents, so their exact ``lines`` count is filled in
    after execution.
    """

    op: Op
    dtype: "DType | None"
    elements: int              # active elements (post dimension mask)
    cb_mask: np.ndarray        # which CBs participate
    segments: int = 1          # distinct contiguous runs in memory
    scalar_count: int = 0
    contiguous_run: int = 1    # elements per contiguous run
    unique_elements: int = 1   # memory words actually touched (stride-0
                               # replication is free through the crossbar)
    lines: int = 1             # exact 64B cache lines touched

    def same_as(self, other: "TraceEvent") -> bool:
        """Field-by-field equality (``cb_mask`` is an array, so the
        generated dataclass ``__eq__`` would be ambiguous)."""
        return (self.op is other.op and self.dtype is other.dtype
                and self.elements == other.elements
                and self.segments == other.segments
                and self.scalar_count == other.scalar_count
                and self.contiguous_run == other.contiguous_run
                and self.unique_elements == other.unique_elements
                and self.lines == other.lines
                and bool(np.array_equal(self.cb_mask, other.cb_mask)))


# ---------------------------------------------------------------------------
# Per-operation compute latency (cycles) per scheme.
# ---------------------------------------------------------------------------

def _bs_cycles(op: Op, n: int) -> float:
    if op in (Op.CVT, Op.CPY, Op.SET_DUP):
        return n
    if op is Op.ADD:
        return n
    if op is Op.SUB:
        return 2 * n
    if op is Op.MUL:
        return n * n + 5 * n
    if op in (Op.MIN, Op.MAX):
        return 2 * n
    if op in (Op.XOR, Op.AND, Op.OR):
        return n
    if op in (Op.SHI, Op.ROTI):
        return n
    if op is Op.SHR:
        return n * max(1.0, math.log2(n))
    if op in COMPARE_OPS:
        return n
    raise ValueError(f"no BS latency for {op}")


def _float_cycles(op: Op, bits: int) -> float:
    """Duality Cache [35] extends BS integer ops to floating point:
    multiply is dominated by the mantissa multiply; add/sub by mantissa
    alignment (variable shift) + normalize (~4x the integer add)."""
    mant = 24 if bits == 32 else 11
    if op is Op.MUL:
        return mant * mant + 5 * mant + 3 * bits     # + exp add, normalize
    if op in (Op.ADD, Op.SUB):
        return 4 * bits
    if op in (Op.MIN, Op.MAX) or op in COMPARE_OPS:
        return 2 * bits
    if op in (Op.CVT, Op.CPY, Op.SET_DUP):
        return bits
    return 4 * bits


def _scalar_op_cycles(op: Op, dtype: DType) -> float:
    """Engine-independent per-element serial cost (n-bit slices)."""
    if dtype.is_float:
        return _float_cycles(op, dtype.bits)
    return _bs_cycles(op, dtype.bits)


def compute_cycles(op: Op, dtype: DType, cfg: MVEConfig) -> float:
    """Latency (cycles) of one in-SRAM vector operation on the full engine."""
    n = dtype.bits
    base = _scalar_op_cycles(op, dtype)
    if cfg.scheme == "bs":
        return base
    if cfg.scheme == "bp":
        # VRAM: latency improves by ~n; carry chain across bitlines adds a
        # constant per op. Parallelism loss is accounted by lane count.
        return max(2.0, base / n + 2)
    if cfg.scheme == "bh":
        p = cfg.bh_segment_bits
        segs = max(1, n // p)
        # EVE: p-bit segments bit-parallel (Manchester carry), combined
        # bit-serially across segments.
        return max(2.0, base / n * segs + segs)
    if cfg.scheme == "ac":
        ff = 2.0 if dtype.is_float else 1.0
        if op in (Op.ADD, Op.SUB):
            return (8 * n + 2) * ff
        if op is Op.MUL:
            return n * (8 * n + 2) * ff      # shift-add decomposition
        if op in (Op.XOR, Op.AND, Op.OR) or op in COMPARE_OPS:
            return 8.0                        # O(1) truth-table rows [18]
        return (8 * n + 2) * ff
    raise ValueError(f"unknown scheme {cfg.scheme}")


# ---------------------------------------------------------------------------
# Timeline model.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimingParams:
    """Micro-architectural constants (Table IV unless noted).

    * ``issue_cycles``: core->controller issue of one MVE instruction over
      the fine-grain core/L2 interface; the ROB head commit plus queue write.
    * ``l2_bytes_per_cycle``: regular-half L2 bandwidth feeding the TMU; one
      64 B line per 2 cycles (shared tag/data pipeline).
    * ``l2_latency``: 12-cycle L2 hit latency (Table IV).
    * ``dram_latency``: Ramulator-average miss penalty for misses; we fold a
      hit-rate model instead of simulating DRAM.
    * ``tmu_fill``: cycles to write one bit-slice from TMU into the data
      array (one wordline write per bit).
    * ``scalar_ipc``: 4-way out-of-order core (Table IV).
    """

    issue_cycles: float = 16.0
    l2_bytes_per_cycle: float = 64.0
    l2_latency: float = 12.0
    dram_latency: float = 100.0
    l2_hit_rate: float = 0.85
    tmu_fill_per_bit: float = 1.0
    scalar_ipc: float = 4.0
    segment_overhead: float = 2.0   # pipelined per-run address generation


@dataclasses.dataclass
class Timeline:
    total_cycles: float = 0.0
    compute_cycles: float = 0.0
    data_cycles: float = 0.0
    idle_cycles: float = 0.0
    scalar_cycles: float = 0.0
    issue_cycles: float = 0.0
    vector_instructions: int = 0
    scalar_instructions: int = 0
    config_instructions: int = 0
    busy_cb_cycles: float = 0.0
    cb_slots: float = 0.0
    busy_lane_cycles: float = 0.0
    lane_slots: float = 0.0
    #: Cycles lost at issue, per cause — filled by the pipeline model
    #: (:mod:`repro_torch.timing`: ``dependency`` / ``structural`` /
    #: ``memory-port`` / ``frontend``); empty for analytic timelines,
    #: which don't resolve *why* an instruction waited.
    stalls: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def cb_utilization(self) -> float:
        return self.busy_cb_cycles / self.cb_slots if self.cb_slots else 0.0

    @property
    def lane_utilization(self) -> float:
        """Fraction of (SIMD lane x cycle) slots doing useful work — the
        utilization metric of Section VII-C (23% RVV -> 60% MVE for BS):
        partial 1D accesses activate only a segment of the 8K lanes."""
        return (self.busy_lane_cycles / self.lane_slots
                if self.lane_slots else 0.0)

    def us(self, freq_ghz: float) -> float:
        return self.total_cycles / (freq_ghz * 1e3)


def memory_access_cycles(ev: TraceEvent, cfg: MVEConfig,
                         tp: TimingParams) -> float:
    """Data-access latency of one vector load/store.

    The controller walks ``segments`` contiguous runs (stride-0 dims are
    pure replication through the TMU crossbar — no traffic); each run
    streams cache lines through the MSHRs, then the TMU is drained into
    the arrays bit-serially (one wordline write per bit-slice per CB).
    """
    if ev.dtype is None:
        return 0.0
    lines = max(1, ev.lines)
    stream = lines * 64.0 / tp.l2_bytes_per_cycle
    # Address generation is a hardware 4D walker in the MVE controller
    # (Algorithm 1) pipelined with the MSHR stream — covered by the
    # per-line term.  (RVV pays through its many *instructions* instead.)
    addr_gen = lines * 0.5
    miss = (1.0 - tp.l2_hit_rate) * tp.dram_latency
    tmu = ev.dtype.bits * tp.tmu_fill_per_bit * \
        max(1, math.ceil(ev.elements / cfg.lanes_per_cb))
    return tp.l2_latency + miss + stream + addr_gen + tmu


def data_bytes(trace: List[TraceEvent]) -> float:
    """Unique memory bytes moved by a trace (replication is free)."""
    total = 0.0
    for ev in trace:
        if ev.op in MEMORY_OPS and ev.dtype is not None:
            total += ev.unique_elements * ev.dtype.nbytes
    return total


def simulate(trace: List[TraceEvent], cfg: MVEConfig,
             tp: TimingParams | None = None) -> Timeline:
    """Replay a trace through the controller/CB timeline model.

    Scalar work and MVE issue happen on the core timeline ``t_core``; each CB
    has its own completion time ``t_cb``.  Vector memory accesses are
    serialized across CBs (Section V-B: "MVE controller blocks on vector
    memory accesses until all CBs finish executing it").
    """
    tp = tp or TimingParams()
    ncb = cfg.num_cbs
    t_core = 0.0
    t_cb = np.zeros(ncb)
    tl = Timeline()

    for ev in trace:
        if ev.op is Op.SCALAR:
            dur = ev.scalar_count / tp.scalar_ipc
            t_core += dur
            tl.scalar_cycles += dur
            tl.scalar_instructions += ev.scalar_count
            continue
        if ev.op in CONFIG_OPS:
            t_core += tp.issue_cycles
            tl.issue_cycles += tp.issue_cycles
            tl.config_instructions += 1
            continue

        # vector instruction: issued at t_core, executed by masked CBs
        t_core += tp.issue_cycles
        tl.issue_cycles += tp.issue_cycles
        tl.vector_instructions += 1
        issue_t = t_core

        if ev.op in MEMORY_OPS:
            dur = memory_access_cycles(ev, cfg, tp)
            start = max(issue_t, float(t_cb.max()))   # barrier across CBs
            end = start + dur
            t_cb[:] = np.where(ev.cb_mask, end, np.maximum(t_cb, end))
            tl.data_cycles += dur
            tl.busy_cb_cycles += dur * ev.cb_mask.sum()
            tl.busy_lane_cycles += dur * ev.elements
        else:
            # BP/BH trade lanes for latency (Section II-B): fewer
            # effective lanes mean multiple serial passes over the data.
            eff = cfg.effective_lanes(ev.dtype.bits if ev.dtype else 32)
            passes = max(1, -(-ev.elements // max(eff, 1)))
            dur = compute_cycles(ev.op, ev.dtype, cfg) * passes
            for cb in range(ncb):
                if ev.cb_mask[cb]:
                    start = max(issue_t, t_cb[cb])
                    t_cb[cb] = start + dur
            tl.compute_cycles += dur
            tl.busy_cb_cycles += dur * ev.cb_mask.sum()
            tl.busy_lane_cycles += dur * min(ev.elements, eff)

    tl.total_cycles = max(t_core, float(t_cb.max()) if ncb else t_core)
    tl.cb_slots = tl.total_cycles * ncb
    tl.lane_slots = tl.total_cycles * cfg.lanes
    tl.idle_cycles = max(0.0, tl.cb_slots - tl.busy_cb_cycles) / max(ncb, 1)
    return tl


# ---------------------------------------------------------------------------
# Energy model.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """Energy component model (pJ) — one source of truth for the
    benchmarks (:mod:`benchmarks.paper_claims`) and the pluggable target
    API (:mod:`repro_torch.targets`, docs/TARGETS.md).

    The paper's qualitative claims — large energy wins from
    instruction-count reduction + SRAM-local compute — are what the repo
    validates, not absolute joules; these constants state the assumptions
    in one documented place (they used to be module globals of
    ``benchmarks/paper_claims.py``).

    In-cache engine:

    * ``e_array_cycle`` — per SRAM array per active compute cycle (two
      wordline activations + peripheral logic, Neural-Cache-scale, 7nm);
    * ``e_l2_byte`` — L2 data movement per byte over the in-situ
      L2->TMU path (incl. the transpose write; no core round trip);
    * ``e_issue`` — one MVE instruction issue/dispatch through the
      controller.

    Mobile core baseline (Neon / scalar):

    * ``e_scalar`` — one OoO-core scalar instruction;
    * ``e_simd_op`` — one 128-bit ASIMD operation;
    * ``e_l1_byte`` — L1+L2+register-file round trip per byte.

    Mobile GPU baseline: ``e_gpu_flop`` per int-MAC flop,
    ``e_gpu_launch`` fixed per kernel launch, ``e_gpu_copy_byte`` per
    byte copied into pinned unified memory.
    """

    e_array_cycle: float = 8.0
    e_l2_byte: float = 8.0
    e_issue: float = 50.0
    e_scalar: float = 150.0
    e_simd_op: float = 250.0
    e_l1_byte: float = 25.0
    e_gpu_flop: float = 2.5
    e_gpu_launch: float = 2.0e7
    e_gpu_copy_byte: float = 30.0

    @classmethod
    def derive(cls, cfg: MVEConfig, scheme: "str | None" = None
               ) -> "EnergyParams":
        """Derive the in-cache constants for one (scheme, geometry) from
        the parametric SRAM model (:mod:`repro_torch.silicon`,
        docs/SILICON.md) instead of the fixed defaults.

        Calibration contract: the parametric model supplies *relative*
        scaling only — each derived constant is the default times the
        model's ratio between ``cfg`` and the default Table IV geometry —
        so at the default geometry under the bit-serial scheme the result
        is byte-identical to :data:`DEFAULT_ENERGY` and every frozen
        golden row is preserved exactly.
        """
        from ..silicon.params import derived_energy
        return derived_energy(cfg, scheme)[0]


DEFAULT_ENERGY = EnergyParams()


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Per-component energy (pJ) of one kernel execution on one target.

    ``total_pj`` is stored (not derived) so models control their exact
    summation order — the golden benchmark rows compare floats exactly.

    ``params_source`` records the provenance of the
    :class:`EnergyParams` the report was priced with: ``"default"`` for
    the fixed point-constants, ``"derived:<geometry-digest>"`` when they
    came from the parametric silicon model
    (:func:`repro_torch.silicon.params.derived_energy`) — so a benchmark row
    can always be traced back to the exact (scheme, geometry) pricing.
    """

    compute_pj: float = 0.0
    data_pj: float = 0.0
    issue_pj: float = 0.0
    scalar_pj: float = 0.0
    total_pj: float = 0.0
    params_source: str = "default"


def mve_energy(tl: Timeline, cfg: MVEConfig, mem_bytes: float,
               ep: EnergyParams | None = None,
               params_source: str | None = None) -> EnergyReport:
    """Energy of one in-cache execution: array compute + L2 movement +
    instruction issue + interleaved scalar work.  Shared by every
    in-cache target (MVE under any compute scheme, and the RVV-driven
    engine, which pays through its larger instruction counts).

    ``params_source`` labels the provenance of ``ep`` in the report
    (``"derived:<digest>"`` for silicon-model-derived params); ``None``
    keeps the ``"default"`` label.
    """
    ep = ep or DEFAULT_ENERGY
    compute = tl.compute_cycles * cfg.num_arrays * ep.e_array_cycle
    data = mem_bytes * ep.e_l2_byte
    issue = (tl.vector_instructions + tl.config_instructions) * ep.e_issue
    scalar = tl.scalar_instructions * ep.e_scalar
    return EnergyReport(compute_pj=compute, data_pj=data, issue_pj=issue,
                        scalar_pj=scalar,
                        total_pj=compute + data + issue + scalar,
                        params_source=params_source or "default")


def neon_energy(simd_ops: float, mem_bytes: float,
                ep: EnergyParams | None = None,
                params_source: str | None = None) -> EnergyReport:
    """Energy of a packed-SIMD execution: ``simd_ops`` 128-bit ASIMD ops
    plus loop/address scalar overhead (0.5 scalar per SIMD op) plus the
    L1 round trip for every byte."""
    ep = ep or DEFAULT_ENERGY
    scalar_ops = simd_ops * 0.5
    compute = simd_ops * ep.e_simd_op
    scalar = scalar_ops * ep.e_scalar
    data = mem_bytes * ep.e_l1_byte
    return EnergyReport(compute_pj=compute, data_pj=data, scalar_pj=scalar,
                        total_pj=compute + scalar + data,
                        params_source=params_source or "default")


# ---------------------------------------------------------------------------
# Baseline cost models for comparison figures.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeonModel:
    """Packed-SIMD baseline: 2x128-bit ASIMD pipes on a Cortex-A76.

    Throughput model: each pipe retires one vector op/cycle; loads hit L1 at
    16 B/cycle.  Linear scaling with precision (Section VII-E: "Neon ASIMD
    units achieve linear scaling with lower bit precision").
    """

    simd_bits: int = 128
    pipes: int = 2
    l1_bytes_per_cycle: float = 16.0
    freq_ghz: float = 2.8

    def kernel_cycles(self, vector_ops: float, elements: float,
                      bits: int, mem_bytes: float) -> float:
        lanes = self.simd_bits // bits
        compute = vector_ops * elements / (lanes * self.pipes)
        mem = mem_bytes / self.l1_bytes_per_cycle
        return max(compute, mem) + min(compute, mem) * 0.3  # partial overlap


@dataclasses.dataclass(frozen=True)
class GPUModel:
    """Adreno 640-style model (Section VII-A, Figure 9).

    Key effects the paper measures: a fixed kernel-launch overhead through
    the OpenCL runtime + system fabric, a data-copy cost into pinned unified
    memory, and high raw MAC throughput (13.6x MVE for int32).
    """

    launch_overhead_us: float = 45.0
    copy_bytes_per_us: float = 8_000.0
    int_macs_per_cycle: float = 768.0       # 2 cores x 384 ALUs
    freq_ghz: float = 0.685

    def kernel_us(self, flops: float, copy_bytes: float) -> float:
        compute_us = flops / 2.0 / (self.int_macs_per_cycle *
                                    self.freq_ghz * 1e3)
        copy_us = copy_bytes / self.copy_bytes_per_us
        return self.launch_overhead_us + copy_us + compute_us


def breakdown(tl: Timeline) -> Dict[str, float]:
    """Idle/compute/data fractions as reported in Figure 7(a)."""
    busy = tl.compute_cycles + tl.data_cycles
    total = max(tl.total_cycles, 1e-9)
    comp = tl.compute_cycles / total
    data = tl.data_cycles / total
    return {
        "idle": max(0.0, 1.0 - min(1.0, comp + data)),
        "compute": comp,
        "data": data,
    }
