"""The in-order pipeline model: scoreboard, FU pipes, ports, envelope.

The model replays a :class:`~repro_torch.core.cost.TraceEvent` stream (turned
into :class:`TimedOp` records by :func:`build_timed_ops`) through a
configurable in-order machine (:class:`~repro_torch.timing.uarch.UarchConfig`):

  fetch/decode  ops become issue-ready at ``i // fetch_rate +
                decode_latency``;
  issue         strictly in order, at most ``issue_width`` per cycle,
                gated by the scoreboard and structural availability;
  scoreboard    RAW (wait for the producer — or its chain point when
                chaining is on and both units chain), WAW (wait for the
                prior writer to complete), WAR (a writer waits until
                prior readers have finished reading);
  execute       the op holds one pipe of its functional unit for its
                occupancy; the ``mem`` unit's pipes are the memory
                ports and are held for the whole access.

Per-op durations reuse the analytic per-op costs of
:mod:`repro_torch.core.cost` (``compute_cycles`` x serial passes,
``memory_access_cycles``) so the pipeline model and the analytic
timeline price identical work and differ only in *overlap* — which is
what makes the envelope contract provable:

* :func:`envelope` returns ``(lower, upper)`` computed from the same
  ops.  ``upper`` replays the stream fully serialized (every op waits
  for its predecessor to complete; no chaining, no dual issue); every
  constraint the pipeline model applies is weaker, so by induction its
  cycles never exceed ``upper``.  ``lower`` is the max of the ideal-
  issue bounds (front-end + latency floor per op, issue-slot count,
  per-unit occupancy over pipes) — each a true lower bound of any
  schedule.  ``tests/test_conformance.py`` fuzzes the bracket on random
  programs; ``tests/test_timing.py`` pins hazard semantics.

Stalls are attributed at issue, per cause, into
``TimedTimeline.stalls``: ``dependency`` (scoreboard), ``structural``
(FU pipe busy), ``memory-port`` (mem port busy), ``frontend``
(fetch/decode or issue-width limited).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import cost, isa
from ..core.cost import TimingParams, TraceEvent
from ..core.isa import (COMPARE_OPS, CONFIG_OPS, MEMORY_OPS, Op)
from ..core.machine import MVEConfig
from .uarch import UarchConfig, get_uarch

#: Virtual scoreboard resources beyond architectural vector registers:
#: the control-register file (every vector op reads the live dim/stride
#: config; every config op rewrites it), the Tag latch (compares write,
#: predicated ops read), and a memory-order token (loads read, stores
#: write) that keeps same-address accesses in program order.
CTRL_REG = -1
TAG_REG = -2
MEM_REG = -3

#: Units whose results can chain (stream element-wise to a consumer on a
#: *different* unit).  The controller and scalar core produce whole
#: values, not element streams.
CHAINABLE_FUS = frozenset({"array", "simd", "mem"})


@dataclasses.dataclass(frozen=True)
class TimedOp:
    """One operation as the pipeline model sees it.

    ``defs``/``uses`` name scoreboard resources (architectural registers
    ``>= 0`` plus the virtual ``CTRL_REG``/``TAG_REG``/``MEM_REG``);
    ``duration`` is the op's execution latency on its unit, ``lanes``
    the SIMD lanes it keeps busy (utilization accounting), ``count`` the
    dynamic instructions it stands for (scalar bundles carry many).
    """

    fu: str
    duration: float
    defs: Tuple[int, ...] = ()
    uses: Tuple[int, ...] = ()
    op: Optional[Op] = None
    lanes: float = 0.0
    count: int = 1
    label: str = ""


@dataclasses.dataclass
class TimedTimeline(cost.Timeline):
    """A :class:`~repro_torch.core.cost.Timeline` with the pipeline model's
    extra surface: per-cause ``stalls``, per-unit busy cycles, and the
    verification envelope the totals are guaranteed to sit inside."""

    uarch: str = ""
    lower_bound: float = 0.0
    upper_bound: float = 0.0
    fu_busy: Dict[str, float] = dataclasses.field(default_factory=dict)
    issue_width: int = 1

    @property
    def stall_cycles(self) -> float:
        return sum(self.stalls.values())

    @property
    def issue_utilization(self) -> float:
        """Fraction of issue slots actually used."""
        ops = (self.vector_instructions + self.config_instructions
               + (1 if self.scalar_cycles else 0))
        slots = self.total_cycles * max(1, self.issue_width)
        return min(1.0, ops / slots) if slots else 0.0


class Scoreboard:
    """RAW/WAR/WAW dependency tracking over scoreboard resources.

    ``ready_time`` returns the earliest cycle an op's operands allow it
    to issue; ``commit`` records the op's start/complete times.  With
    chaining enabled, a RAW consumer on a chainable unit may start at
    ``min(producer_complete, producer_start + chain_latency)`` — never
    later than simply waiting, which the envelope proof relies on.
    """

    def __init__(self, chaining: bool = True, chain_latency: float = 8.0):
        self.chaining = chaining
        self.chain_latency = chain_latency
        self._ready: Dict[int, float] = {}    # write fully visible
        self._chain: Dict[int, float] = {}    # first elements usable
        self._readers: Dict[int, float] = {}  # last read completes

    def ready_time(self, op: TimedOp) -> float:
        t = 0.0
        chain_ok = self.chaining and op.fu in CHAINABLE_FUS
        for r in op.uses:                          # RAW
            if chain_ok and r >= 0:
                t = max(t, self._chain.get(r, 0.0))
            else:
                t = max(t, self._ready.get(r, 0.0))
        for r in op.defs:
            t = max(t, self._ready.get(r, 0.0))    # WAW
            t = max(t, self._readers.get(r, 0.0))  # WAR
        return t

    def commit(self, op: TimedOp, start: float, complete: float) -> None:
        for r in op.uses:
            self._readers[r] = max(self._readers.get(r, 0.0), complete)
        for r in op.defs:
            self._ready[r] = complete
            if op.fu in CHAINABLE_FUS and r >= 0:
                self._chain[r] = min(complete, start + self.chain_latency)
            else:
                self._chain[r] = complete
            self._readers[r] = 0.0         # new readers gate the *next* write


def simulate_pipeline(ops: Sequence[TimedOp], uarch,
                      lane_capacity: float = 0.0) -> TimedTimeline:
    """Replay ``ops`` through the in-order pipeline of ``uarch``.

    Deterministic by construction (no randomness, stable pipe
    selection) and monotone in ``issue_width`` / ``mem_ports`` — both
    properties are fuzzed in ``tests/test_timing.py``.
    """
    ua = get_uarch(uarch)
    sb = Scoreboard(ua.chaining, ua.chain_latency)
    pipes: Dict[str, List[float]] = {}
    stalls = {"frontend": 0.0, "dependency": 0.0,
              "structural": 0.0, "memory-port": 0.0}
    tl = TimedTimeline(uarch=ua.name, stalls=stalls,
                       issue_width=ua.issue_width)
    last_issue = 0.0
    slot_cycle, slot_used = -1, 0
    t_end = 0.0

    for i, op in enumerate(ops):
        decode_t = i // ua.fetch_rate + ua.decode_latency
        floor = max(last_issue, 0.0)
        base = max(decode_t, floor)
        stalls["frontend"] += base - floor

        dep = sb.ready_time(op)
        t_dep = max(base, dep)
        stalls["dependency"] += t_dep - base

        unit = pipes.setdefault(op.fu, [0.0] * ua.pipes_for(op.fu))
        j = min(range(len(unit)), key=unit.__getitem__)
        issue = max(t_dep, unit[j])
        stalls["memory-port" if op.fu == "mem" else "structural"] += \
            issue - t_dep

        cyc = int(issue)
        if cyc == slot_cycle and slot_used >= ua.issue_width:
            stalls["frontend"] += (slot_cycle + 1) - issue
            issue = float(slot_cycle + 1)
            cyc = slot_cycle + 1
        if cyc != slot_cycle:
            slot_cycle, slot_used = cyc, 0
        slot_used += 1

        hop = 0.0 if op.fu == "scalar" else ua.issue_latency
        start = issue + hop
        complete = start + op.duration
        unit[j] = start + ua.occupancy(op.fu, op.duration)
        sb.commit(op, start, complete)
        last_issue = issue
        t_end = max(t_end, complete)

        tl.fu_busy[op.fu] = tl.fu_busy.get(op.fu, 0.0) + op.duration
        tl.issue_cycles += hop
        if op.fu not in ("mem", "ctrl", "scalar"):
            # utilization counts compute lanes only; with chaining, mem
            # occupancy overlaps compute and would push the ratio past 1
            tl.busy_lane_cycles += op.duration * op.lanes
        if op.fu == "ctrl":
            tl.config_instructions += op.count
        elif op.fu == "scalar":
            tl.scalar_instructions += op.count
            tl.scalar_cycles += op.duration
        else:
            tl.vector_instructions += op.count
            if op.fu == "mem":
                tl.data_cycles += op.duration
            else:
                tl.compute_cycles += op.duration

    tl.total_cycles = t_end
    tl.lane_slots = t_end * lane_capacity
    busiest = max(tl.fu_busy.values(), default=0.0)
    tl.idle_cycles = max(0.0, t_end - busiest)
    tl.lower_bound, tl.upper_bound = envelope(ops, ua)
    return tl


def envelope(ops: Sequence[TimedOp], uarch) -> Tuple[float, float]:
    """``(ideal-issue lower bound, fully-serialized upper bound)`` for
    ``ops`` under ``uarch`` — the bracket every pipeline-model total is
    contractually inside (module docstring sketches the induction)."""
    ua = get_uarch(uarch)
    if not ops:
        return 0.0, 0.0
    lo = 0.0
    occ: Dict[str, float] = {}
    min_tail = math.inf
    for i, op in enumerate(ops):
        decode_t = i // ua.fetch_rate + ua.decode_latency
        hop = 0.0 if op.fu == "scalar" else ua.issue_latency
        lo = max(lo, decode_t + hop + op.duration)
        occ[op.fu] = occ.get(op.fu, 0.0) + ua.occupancy(op.fu, op.duration)
        min_tail = min(min_tail, hop + op.duration)
    lo = max(lo, math.ceil(len(ops) / ua.issue_width) - 1 + min_tail)
    for fu, total in occ.items():
        lo = max(lo, total / ua.pipes_for(fu))

    hi = 0.0
    for i, op in enumerate(ops):
        decode_t = i // ua.fetch_rate + ua.decode_latency
        issue = decode_t if i == 0 else max(decode_t, hi + 1.0)
        hop = 0.0 if op.fu == "scalar" else ua.issue_latency
        hi = issue + hop + op.duration
    return lo, hi


# ---------------------------------------------------------------------------
# TimedOp builders: trace -> pipeline-model input.
# ---------------------------------------------------------------------------

def _incache_duration(ev: TraceEvent, cfg: MVEConfig,
                      tp: TimingParams, ua: UarchConfig) -> float:
    """Identical to the per-event work :func:`repro_torch.core.cost.simulate`
    charges, so analytic and pipeline models price the same ops."""
    if ev.op in CONFIG_OPS:
        return max(1.0, ua.config_latency)
    if ev.op is Op.SCALAR:
        return max(1.0, ev.scalar_count / tp.scalar_ipc)
    if ev.op in MEMORY_OPS:
        return max(1.0, cost.memory_access_cycles(ev, cfg, tp))
    eff = cfg.effective_lanes(ev.dtype.bits if ev.dtype else 32)
    passes = max(1, -(-ev.elements // max(eff, 1)))
    return max(1.0, cost.compute_cycles(ev.op, ev.dtype, cfg) * passes)


def _simd_duration(ev: TraceEvent, ua: UarchConfig) -> float:
    """Packed-SIMD per-event cost (the mobile-core config): one vector
    loop over 128-bit lanes per compute event; an L1 burst per access."""
    if ev.op in CONFIG_OPS:
        return max(1.0, ua.config_latency)
    if ev.op is Op.SCALAR:
        return max(1.0, ev.scalar_count / 4.0)
    bits = ev.dtype.bits if ev.dtype else 32
    if ev.op in MEMORY_OPS:
        bytes_ = ev.unique_elements * (bits // 8 or 1)
        return max(1.0, ua.simd_mem_latency
                   + bytes_ / ua.simd_bytes_per_cycle)
    lanes = max(1, ua.simd_bits // bits)
    return max(1.0, math.ceil(ev.elements / lanes))


def _fu_lanes(ev: TraceEvent, cfg: MVEConfig, ua: UarchConfig,
              cost_model: str) -> Tuple[str, float]:
    if ev.op in CONFIG_OPS:
        return "ctrl", 0.0
    if ev.op is Op.SCALAR:
        return "scalar", 0.0
    compute_fu = "array" if cost_model == "incache" else "simd"
    if ev.op in MEMORY_OPS:
        fu = "mem"
    else:
        fu = compute_fu
    if cost_model == "incache":
        bits = ev.dtype.bits if ev.dtype else 32
        lanes = float(min(ev.elements, cfg.effective_lanes(bits))
                      if fu != "mem" else ev.elements)
    else:
        bits = ev.dtype.bits if ev.dtype else 32
        lanes = float(min(ev.elements, max(1, ua.simd_bits // bits)))
    return fu, lanes


def _duration(ev: TraceEvent, cfg: MVEConfig, tp: TimingParams,
              ua: UarchConfig, cost_model: str) -> float:
    if cost_model == "simd":
        return _simd_duration(ev, ua)
    return _incache_duration(ev, cfg, tp, ua)


def _aligned_op(instr: "isa.Instr", ev: TraceEvent, cfg: MVEConfig,
                tp: TimingParams, ua: UarchConfig,
                cost_model: str) -> TimedOp:
    """Register-accurate TimedOp when the trace is 1:1 with the program
    (the MVE engine's static trace is — one event per instruction)."""
    fu, lanes = _fu_lanes(ev, cfg, ua, cost_model)
    dur = _duration(ev, cfg, tp, ua, cost_model)
    if fu == "ctrl":
        return TimedOp(fu, dur, defs=(CTRL_REG,), op=ev.op,
                       label=ev.op.value)
    if fu == "scalar":
        return TimedOp(fu, dur, op=ev.op, count=max(1, ev.scalar_count),
                       label="scalar")
    defs: List[int] = []
    uses: List[int] = [CTRL_REG]
    d = isa.reg_defs(instr)
    if d is not None:
        defs.append(d)
    uses.extend(isa.reg_uses(instr))
    if instr.op in COMPARE_OPS:
        defs.append(TAG_REG)
    if instr.predicated:
        uses.append(TAG_REG)
    if instr.op in MEMORY_OPS:
        if instr.op in (Op.SLD, Op.RLD):
            uses.append(MEM_REG)
        else:
            defs.append(MEM_REG)
    return TimedOp(fu, dur, defs=tuple(defs), uses=tuple(uses), op=ev.op,
                   lanes=lanes, label=ev.op.value)


def _synth_op(ev: TraceEvent, cfg: MVEConfig, tp: TimingParams,
              ua: UarchConfig, cost_model: str,
              last_defs: List[int], next_reg: List[int]) -> TimedOp:
    """TimedOp with a synthesized virtual-register chain, for lowered
    streams that are not 1:1 with the program (the RVV 1D decomposition
    interleaves address scalars, predicate config, partial accesses and
    pack moves).  Producers define rotating virtual registers; consumers
    read the most recent definitions — a deterministic, conservative
    dependence structure."""
    fu, lanes = _fu_lanes(ev, cfg, ua, cost_model)
    dur = _duration(ev, cfg, tp, ua, cost_model)
    if fu == "ctrl":
        return TimedOp(fu, dur, defs=(CTRL_REG,), op=ev.op,
                       label=ev.op.value)
    if fu == "scalar":
        return TimedOp(fu, dur, op=ev.op, count=max(1, ev.scalar_count),
                       label="scalar")

    def fresh() -> int:
        r = next_reg[0] % 32            # finite file: WAW/WAR pressure
        next_reg[0] += 1
        last_defs.append(r)
        if len(last_defs) > 2:
            del last_defs[0]
        return r

    defs: List[int] = []
    uses: List[int] = [CTRL_REG]
    op = ev.op
    if op in (Op.SLD, Op.RLD):
        uses.append(MEM_REG)
        defs.append(fresh())
    elif op in (Op.SST, Op.RST):
        uses.extend(last_defs[-1:])
        defs.append(MEM_REG)
    elif op in COMPARE_OPS:
        uses.extend(last_defs[-2:])
        defs.append(TAG_REG)
    elif op in (Op.CPY, Op.CVT, Op.SET_DUP, Op.SHI, Op.ROTI):
        uses.extend(last_defs[-1:])
        defs.append(fresh())
    else:                               # binary arithmetic
        uses.extend(last_defs[-2:])
        defs.append(fresh())
    return TimedOp(fu, dur, defs=tuple(defs), uses=tuple(uses), op=op,
                   lanes=lanes, label=op.value)


def build_timed_ops(program, trace: Sequence[TraceEvent], cfg: MVEConfig,
                    tp: Optional[TimingParams] = None,
                    uarch="mve-bs", cost_model: str = "incache",
                    ) -> Tuple[List[TimedOp], float]:
    """Turn a performance trace into pipeline-model input.

    Returns ``(ops, lane_capacity)``.  When ``trace`` is instruction-
    aligned with ``program`` (same length, same opcode per slot), defs
    and uses come from the real architectural registers; otherwise a
    virtual-register chain is synthesized from the event stream.
    """
    tp = tp or TimingParams()
    ua = get_uarch(uarch)
    instrs = tuple(getattr(program, "program", program) or ())
    aligned = (len(instrs) == len(trace)
               and all(ins.op is ev.op for ins, ev in zip(instrs, trace)))
    ops: List[TimedOp] = []
    if aligned:
        for ins, ev in zip(instrs, trace):
            ops.append(_aligned_op(ins, ev, cfg, tp, ua, cost_model))
    else:
        last_defs: List[int] = []
        next_reg = [0]
        for ev in trace:
            ops.append(_synth_op(ev, cfg, tp, ua, cost_model,
                                 last_defs, next_reg))
    if cost_model == "simd":
        lane_capacity = float(max(
            (op.lanes for op in ops if op.fu == "simd"), default=1.0)
            * ua.simd_pipes)
    else:
        lane_capacity = float(cfg.lanes)
    return ops, lane_capacity
