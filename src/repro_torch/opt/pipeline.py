"""The pass pipeline: ordering, opt levels, and the invariant guard.

``optimize()`` is the one entry point the rest of the repo calls
(:func:`repro_torch.core.engine.compile_program`, ``repro_torch.targets.compile`` and
``frontend.Kernel.compile`` all route their ``opt_level=`` through it).
Results are LRU-cached per ``(program, passes)`` — programs are tuples of
frozen instructions, so they hash — which composes with the engine's own
compile cache: an optimized program is just another program.

Every pass runs inside a guard that *enforces* the optimizer's contract
instead of trusting it: if a pass output is longer, needs more registers,
or stops validating, the guard discards it and keeps the input.  The
differential harness (:mod:`repro_torch.opt.verify`) checks the semantic half
of the contract; the guard checks the structural half on every single
invocation, so a buggy third-party pass degrades to a no-op instead of a
miscompile.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..core import isa
from ..core.isa import Program
from . import passes as _p

#: Registered passes, in canonical pipeline order.  Add a pass by
#: inserting it here (docs/OPTIMIZER.md walks through the steps).
PASSES: Dict[str, Callable[[Sequence], Program]] = {
    "dead-config": _p.dead_config,
    "cse": _p.cse,
    "schedule": _p.schedule,
}

DEFAULT_PIPELINE: Tuple[str, ...] = tuple(PASSES)

#: ``opt_level`` -> pipeline prefix.  Level 0 is the identity; the
#: maximum level runs the full pipeline.
OPT_LEVELS: Dict[int, Tuple[str, ...]] = {
    i: DEFAULT_PIPELINE[:i] for i in range(len(DEFAULT_PIPELINE) + 1)
}
MAX_OPT_LEVEL = len(DEFAULT_PIPELINE)


def pipeline_prefixes() -> Tuple[Tuple[str, ...], ...]:
    """Every prefix of the canonical pipeline, shortest first — the unit
    the differential tests iterate over (``()`` included)."""
    return tuple(DEFAULT_PIPELINE[:i]
                 for i in range(len(DEFAULT_PIPELINE) + 1))


@dataclasses.dataclass(frozen=True)
class PassReport:
    """What one guarded pass application did."""

    name: str
    instructions_in: int
    instructions_out: int
    pressure_in: int
    pressure_out: int
    reverted: bool = False                 # guard rejected the output

    @property
    def removed(self) -> int:
        return self.instructions_in - self.instructions_out


def _max_pressure(program: Sequence) -> int:
    # Late import: repro_torch.frontend imports repro_torch.opt (builder
    # dedup helpers come from core.machine, but Kernel.compile calls
    # optimize()).
    from ..frontend.regalloc import max_pressure
    return max_pressure(list(program))


def _guarded(name: str, fn: Callable, program: Program
             ) -> Tuple[Program, PassReport]:
    """Run one pass under the structural contract.

    The output is kept only if it (a) is no longer than the input,
    (b) does not raise under lenient :func:`repro_torch.core.isa.validate`,
    and (c) does not increase register pressure.  Otherwise the input
    passes through unchanged and the report says so.
    """
    n_in = len(program)
    p_in = _max_pressure(program)
    out = Program(fn(program))
    ok = len(out) <= n_in
    p_out = p_in
    if ok:
        try:
            isa.validate(out)
            p_out = _max_pressure(out)
            ok = p_out <= p_in
        except isa.ProgramError:
            ok = False
    if not ok:
        return program, PassReport(name, n_in, n_in, p_in, p_in,
                                   reverted=True)
    return out, PassReport(name, n_in, len(out), p_in, p_out)


@dataclasses.dataclass(frozen=True)
class OptResult:
    """An optimized program plus the per-pass audit trail."""

    program: Program
    source: Program
    reports: Tuple[PassReport, ...]

    @property
    def removed(self) -> int:
        return len(self.source) - len(self.program)


def _resolve_passes(level: Optional[int],
                    passes: Optional[Sequence[str]]) -> Tuple[str, ...]:
    if passes is not None:
        names = tuple(passes)
        unknown = [n for n in names if n not in PASSES]
        if unknown:
            raise isa.ProgramError(
                f"unknown optimizer pass(es) {unknown}; registered: "
                f"{', '.join(PASSES)}")
        return names
    if level is None:
        return ()
    if level is True:                       # opt_level=True reads naturally
        return DEFAULT_PIPELINE
    lvl = max(0, min(int(level), MAX_OPT_LEVEL))
    return OPT_LEVELS[lvl]


@functools.lru_cache(maxsize=256)
def _optimize_cached(program: Program,
                     names: Tuple[str, ...]) -> OptResult:
    reports = []
    out = program
    for name in names:
        out, report = _guarded(name, PASSES[name], out)
        reports.append(report)
    return OptResult(program=out, source=program, reports=tuple(reports))


def optimize_result(program, level: Optional[int] = None,
                    passes: Optional[Sequence[str]] = None) -> OptResult:
    """Run a pipeline (an ``opt_level`` prefix, or an explicit pass list)
    and return the :class:`OptResult` with per-pass reports."""
    prog = Program(getattr(program, "program", program))
    return _optimize_cached(prog, _resolve_passes(level, passes))


def optimize(program, level: Optional[int] = None,
             passes: Optional[Sequence[str]] = None) -> Program:
    """The program after the requested pipeline; ``level=None``/``0`` is
    the identity.  See :func:`optimize_result` for the audit trail."""
    return optimize_result(program, level=level, passes=passes).program


def cache_clear() -> None:
    """Drop memoized optimization results (test hygiene)."""
    _optimize_cached.cache_clear()
