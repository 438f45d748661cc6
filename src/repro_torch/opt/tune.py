"""``tune()``: pick the cheapest legal schedule for one target.

The list scheduler (:mod:`repro_torch.opt.passes`) is heuristic; which
heuristic wins depends on the target's cost structure (hazards, port
conflicts, and chaining reward different orderings than a single-number
analytic total).  ``tune()`` makes the choice empirical: it sweeps
every registered schedule priority over the dead-config+CSE'd program,
prices each candidate, and returns the artifact of the cheapest one.

By default candidates are priced through the *pipeline model* — the
timed twin of the requested target (:func:`repro_torch.targets.timed_variant`,
docs/TIMING.md) — so the sweep optimizes against the machine the
scheduler is actually reordering for: RAW chains it can hide, memory
ports it can keep busy.  ``timing="analytic"`` restores the previous
single-number pricing; targets without a timed twin fall back to it.

    result = repro_torch.opt.tune(kernel, target="mve-bs")
    result.best                  # winning priority name
    result.artifact.run(...)     # compiled, bit-exact, cheapest schedule
    result.table                 # {priority: total_cycles} sweep record
    result.timing                # "pipeline" or "analytic"
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.isa import Program
from ..core.machine import MVEConfig
from . import passes as _p
from .pipeline import optimize


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one schedule sweep for one target."""

    target: str
    best: str                          # winning schedule priority
    program: Program                   # the winning optimized program
    artifact: object                   # CompiledArtifact of the winner
    table: Dict[str, float]            # priority -> modeled total cycles
    timing: str = "analytic"           # cost model the sweep priced with

    @property
    def cycles(self) -> float:
        return self.table[self.best]


def tune(kernel_or_program, target: str = "mve-bs",
         cfg: Optional[MVEConfig] = None, mode: Optional[str] = None,
         priorities: Optional[Tuple[str, ...]] = None,
         timing: str = "pipeline",
         **overrides) -> TuneResult:
    """Sweep legal schedules for ``target`` and return the cheapest.

    Every candidate starts from the dead-config+CSE'd program (those
    passes are unconditional wins) and differs only in the scheduler's
    priority heuristic, so every candidate is a legal reordering of the
    same instruction multiset — the differential harness's guarantees
    apply to each one.  Pricing uses the static trace (no execution
    happens) under ``timing``: ``"pipeline"`` (default) prices through
    the target's timed twin's in-order pipeline model, ``"analytic"``
    through the target's own timeline; ties resolve to the earlier
    priority in ``SCHEDULE_PRIORITIES`` order, so the result is
    deterministic.  The returned artifact is always compiled for the
    *requested* target, whichever model priced the sweep, on the device
    ``overrides`` names (``device="cpu"``; default ``cuda``).
    """
    from .. import targets                 # late: targets imports engine

    if timing not in ("pipeline", "analytic"):
        raise ValueError(f"timing must be 'pipeline' or 'analytic', "
                         f"got {timing!r}")
    tgt = targets.get_target(target)
    pricer = None
    used = "analytic"
    if timing == "pipeline":
        pricer = targets.timed_variant(tgt)
        if pricer is not None:
            used = "pipeline"
    base = optimize(kernel_or_program, passes=("dead-config", "cse"))
    names = tuple(priorities or _p.SCHEDULE_PRIORITIES)
    table: Dict[str, float] = {}
    best_name = None
    best_art = None
    best_prog = None
    for name in names:
        candidate = _p.schedule(base, priority=name)
        art = targets.compile(candidate, target=tgt, cfg=cfg, mode=mode,
                              **overrides)
        if pricer is None:
            cycles = art.timeline().total_cycles
        else:
            # Same compilation, re-priced through the pipeline model
            # (the twin shares the base target's machine config).
            cycles = pricer.timeline(
                art.program, art.cfg, art.cp.static_trace).total_cycles
        table[name] = cycles
        if best_name is None or cycles < table[best_name]:
            best_name, best_art, best_prog = name, art, candidate
    return TuneResult(target=tgt.name, best=best_name, program=best_prog,
                      artifact=best_art, table=table, timing=used)
