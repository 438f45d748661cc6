"""Pareto autotuner over (compute scheme x cache geometry).

Table IV is one point; this module makes geometry a *search space*.  For
a kernel (or the mixed mobile serving stream — the Swan framing of
arXiv:2309.02680) it prices every candidate on three axes:

* **cycles** — the controller/CB timeline (:func:`repro_torch.core.cost.simulate`)
  over the kernel's static engine trace, under the candidate's scheme
  latencies and lane counts;
* **energy** — :func:`repro_torch.core.cost.mve_energy` with the
  silicon-derived :class:`~repro_torch.core.cost.EnergyParams` for that exact
  (scheme, geometry) (:mod:`repro_torch.silicon.params`);
* **area** — the in-cache additions at that geometry
  (:mod:`repro_torch.silicon.area`).

and returns the non-dominated front.  Two deliberate economies keep a
40-candidate search cheap:

* the engine's *static trace* depends only on the lane geometry
  (``num_arrays`` x ``bitlines`` — via ``lanes`` and ``num_cbs``), not
  on the scheme or wordline depth, so candidates are grouped by that key
  and each group compiles **once**;
* everything downstream (simulate / derive / area) is pure arithmetic
  over that trace.

Candidates keep ``lanes >= 8192`` because only the ``gemm``/``spmm``
pattern factories tile to the geometry (``lanes=`` kwarg); the other
patterns are written for 8192 elements and would spill on narrower
machines.  Everything here is deterministic — no RNG, stable sort keys —
so two runs return identical results (``tests/test_silicon.py``).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import cost
from ..core.engine import compile_program
from ..core.machine import MVEConfig
from .area import area_report
from .params import SCHEME_ARRAY_FACTOR, derived_energy

#: Default lane floor: the fixed-size patterns assume the Table IV lane
#: count, so narrower geometries are out of the portable search space.
MIN_LANES = 8192


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (scheme, geometry) search point."""

    scheme: str = "bs"
    num_arrays: int = 32
    bitlines: int = 256
    wordlines: int = 256

    def cfg(self) -> MVEConfig:
        return MVEConfig(num_arrays=self.num_arrays, bitlines=self.bitlines,
                         wordlines=self.wordlines, scheme=self.scheme)

    @property
    def label(self) -> str:
        return (f"{self.scheme}@{self.num_arrays}x{self.bitlines}"
                f"x{self.wordlines}")


@dataclasses.dataclass(frozen=True)
class EvalPoint:
    """One candidate priced for one workload."""

    candidate: Candidate
    cycles: float
    energy_pj: float
    area_mm2: float
    us: float
    params_source: str

    @property
    def label(self) -> str:
        return self.candidate.label


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """All evaluated points plus the non-dominated subset."""

    workload: str
    points: Tuple[EvalPoint, ...]
    front: Tuple[EvalPoint, ...]

    def best(self, key: str = "energy_pj") -> EvalPoint:
        """Front point minimizing one axis (``cycles`` / ``energy_pj`` /
        ``area_mm2`` / ``us``); ties break on the stable label order."""
        return min(self.front, key=lambda p: (getattr(p, key), p.label))


def default_candidates(min_lanes: int = MIN_LANES) -> List[Candidate]:
    """4 schemes x 5 lane-preserving shapes x 2 wordline depths = 40."""
    shapes = [(32, 256), (64, 128), (16, 512), (64, 256), (32, 512)]
    return [Candidate(scheme=s, num_arrays=na, bitlines=bl, wordlines=wl)
            for s in SCHEME_ARRAY_FACTOR
            for na, bl in shapes
            if na * bl >= min_lanes
            for wl in (256, 512)]


def _make_run(kernel: str, cfg: MVEConfig):
    """Build the pattern, tiling to the geometry when the factory
    supports it (``gemm``/``spmm`` take a ``lanes=`` kwarg)."""
    from ..core.patterns import PATTERNS
    fn = PATTERNS[kernel]
    if "lanes" in inspect.signature(fn).parameters:
        return fn(lanes=cfg.lanes)
    return fn()


def _geometry_groups(candidates: Sequence[Candidate]
                     ) -> Dict[Tuple[int, int], List[Candidate]]:
    groups: Dict[Tuple[int, int], List[Candidate]] = {}
    for c in candidates:
        groups.setdefault((c.num_arrays, c.bitlines), []).append(c)
    return groups


def _evaluate_items(items: Sequence[Tuple[object, float]],
                    candidates: Sequence[Candidate]) -> List[EvalPoint]:
    """Price every candidate as the weighted sum over ``items`` —
    ``[(build_fn, weight)]`` where ``build_fn(geo_cfg)`` returns the
    program to trace at that lane geometry."""
    points: List[EvalPoint] = []
    for (na, bl), group in sorted(_geometry_groups(candidates).items()):
        # compile once per lane geometry: the static trace is scheme- and
        # wordline-independent
        geo_cfg = MVEConfig(num_arrays=na, bitlines=bl)
        traces = []
        for build, weight in items:
            # only the static trace is read: a host compile walk that runs
            # nothing, keyed on the CPU so that it needs no card
            cp = compile_program(build(geo_cfg), geo_cfg,
                                 cache_tag="silicon", device="cpu")
            traces.append((cp.static_trace, weight))
        for cand in group:
            cfg = cand.cfg()
            ep, source = derived_energy(cfg)
            cycles = energy = us = 0.0
            for trace, weight in traces:
                tl = cost.simulate(trace, cfg)
                rep = cost.mve_energy(tl, cfg, cost.data_bytes(trace), ep,
                                      params_source=source)
                cycles += weight * tl.total_cycles
                energy += weight * rep.total_pj
                us += weight * tl.us(cfg.freq_ghz)
            points.append(EvalPoint(
                candidate=cand, cycles=cycles, energy_pj=energy,
                area_mm2=area_report(cfg).added_mm2, us=us,
                params_source=source))
    points.sort(key=lambda p: (p.cycles, p.energy_pj, p.area_mm2, p.label))
    return points


def _evaluate(kernels: Sequence[Tuple[str, float]],
              candidates: Sequence[Candidate]) -> List[EvalPoint]:
    """Price every candidate as the (weighted) sum over ``kernels`` —
    ``[(name, weight)]`` with weight 1.0 for a single kernel."""
    items = [(lambda geo_cfg, n=name: _make_run(n, geo_cfg).program,
              weight) for name, weight in kernels]
    return _evaluate_items(items, candidates)


def pareto_front(points: Iterable[EvalPoint]) -> Tuple[EvalPoint, ...]:
    """Non-dominated subset on (cycles, energy, area), stable order.

    ``a`` dominates ``b`` when it is <= on every axis and < on at least
    one."""
    pts = sorted(points,
                 key=lambda p: (p.cycles, p.energy_pj, p.area_mm2, p.label))
    front: List[EvalPoint] = []
    for p in pts:
        dominated = any(
            q.cycles <= p.cycles and q.energy_pj <= p.energy_pj
            and q.area_mm2 <= p.area_mm2
            and (q.cycles < p.cycles or q.energy_pj < p.energy_pj
                 or q.area_mm2 < p.area_mm2)
            for q in pts if q is not p)
        if not dominated:
            front.append(p)
    return tuple(front)


def autotune(kernel: str = "gemm",
             candidates: Optional[Sequence[Candidate]] = None
             ) -> AutotuneResult:
    """Search (scheme x geometry) for one kernel."""
    cands = list(candidates) if candidates is not None \
        else default_candidates()
    points = _evaluate([(kernel, 1.0)], cands)
    return AutotuneResult(workload=kernel, points=tuple(points),
                          front=pareto_front(points))


def autotune_stream(mix: Sequence[Tuple[str, int]],
                    candidates: Optional[Sequence[Candidate]] = None
                    ) -> AutotuneResult:
    """Search for a weighted kernel mix — e.g. the serving bench's Swan
    mobile stream (``[(kernel_name, request_count), ...]``)."""
    cands = list(candidates) if candidates is not None \
        else default_candidates()
    kernels = [(name, float(count)) for name, count in mix]
    points = _evaluate(kernels, cands)
    label = f"stream[{'+'.join(name for name, _ in mix)}]"
    return AutotuneResult(workload=label, points=tuple(points),
                          front=pareto_front(points))


def autotune_programs(workload: str,
                      programs: Sequence[Tuple[str, object, float]],
                      candidates: Optional[Sequence[Candidate]] = None
                      ) -> AutotuneResult:
    """Search for a weighted mix of *already-built* programs — e.g. the
    ``repro_torch.nn`` model-block mix (``[(label, program_or_kernel,
    weight)]``).  Block programs address fixed operand layouts, so the
    same program prices on every candidate; all default candidates keep
    ``lanes >= 8192``, the engine's full grid, so no block spills."""
    cands = list(candidates) if candidates is not None \
        else default_candidates()

    def _program_of(p):
        return p.program if hasattr(p, "program") and hasattr(p, "plan") \
            else p

    items = [(lambda geo_cfg, prog=_program_of(p): prog, float(w))
             for _, p, w in programs]
    points = _evaluate_items(items, cands)
    return AutotuneResult(workload=workload, points=tuple(points),
                          front=pareto_front(points))
