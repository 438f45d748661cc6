"""Disk-cached (scheme x geometry) silicon sweep.

Mirrors the CACTI workflow the accelergy wrapper uses (SNIPPETS.md 1-2):
evaluating the analytic model over a grid is cheap here but the *cache
discipline* is the point being reproduced — records are persisted to a
JSON sidecar keyed by :data:`~repro_torch.silicon.params.SILICON_MODEL_VERSION`
so a warm run loads instead of recomputing, and a model change
invalidates the whole file rather than silently serving stale numbers.

Python's ``json`` serializes floats via ``repr`` (shortest round-trip),
so a loaded :class:`SiliconRecord` compares **equal** to the freshly
computed one — the cold==warm contract ``tests/test_silicon.py`` and the
``silicon`` bench section assert.

The cache file defaults to ``.silicon_records_torch.json`` in the working
directory (pass ``cache_path=`` for another) and is gitignored.  It is not
the reference package's file: the two packages never share records, and
this one reads no environment variable.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional

from ..core.machine import MVEConfig
from . import params as _params
from .area import area_report
from .params import SILICON_MODEL_VERSION, derived_energy, spec_for
from .sram import estimate


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (scheme, geometry, node) coordinate in the sweep grid."""

    scheme: str = "bs"
    num_arrays: int = 32
    bitlines: int = 256
    wordlines: int = 256
    tech_nm: float = 7.0

    def cfg(self) -> MVEConfig:
        return MVEConfig(num_arrays=self.num_arrays, bitlines=self.bitlines,
                         wordlines=self.wordlines, scheme=self.scheme)

    @property
    def key(self) -> str:
        return (f"{self.scheme}@{self.num_arrays}x{self.bitlines}"
                f"x{self.wordlines}@{self.tech_nm}nm")


@dataclasses.dataclass(frozen=True)
class SiliconRecord:
    """One evaluated sweep point: derived energy constants, raw model
    outputs, and the area accounting."""

    point: SweepPoint
    params_source: str
    e_array_cycle: float
    e_l2_byte: float
    e_issue: float
    compute_cycle_pj: float
    read_pj_per_byte: float
    leakage_mw: float
    macro_area_mm2: float
    added_area_mm2: float
    overhead_pct: float


def default_grid() -> List[SweepPoint]:
    """4 schemes x 5 (arrays, bitlines) shapes x 2 wordline depths = 40
    points around the Table IV default."""
    shapes = [(16, 256), (32, 128), (32, 256), (32, 512), (64, 256)]
    return [SweepPoint(scheme=s, num_arrays=na, bitlines=bl, wordlines=wl)
            for s in _params.SCHEME_ARRAY_FACTOR
            for na, bl in shapes
            for wl in (128, 256)]


def evaluate_point(point: SweepPoint) -> SiliconRecord:
    """Run the analytic model + derivation for one sweep point."""
    cfg = point.cfg()
    ep, source = derived_energy(cfg, tech_nm=point.tech_nm)
    est = estimate(spec_for(cfg, point.tech_nm))
    ar = area_report(cfg, tech_nm=point.tech_nm)
    return SiliconRecord(
        point=point, params_source=source,
        e_array_cycle=ep.e_array_cycle, e_l2_byte=ep.e_l2_byte,
        e_issue=ep.e_issue,
        compute_cycle_pj=est.compute_cycle_pj,
        read_pj_per_byte=est.read_pj_per_byte,
        leakage_mw=est.leakage_mw,
        macro_area_mm2=est.total_area_mm2,
        added_area_mm2=ar.added_mm2,
        overhead_pct=ar.overhead_pct,
    )


def default_cache_path() -> str:
    return ".silicon_records_torch.json"


def _to_json(records: Dict[str, SiliconRecord]) -> dict:
    flat = {}
    for key, rec in records.items():
        row = dataclasses.asdict(rec.point)
        row.update({f.name: getattr(rec, f.name)
                    for f in dataclasses.fields(rec) if f.name != "point"})
        flat[key] = row
    return {"model_version": SILICON_MODEL_VERSION, "records": flat}


def _from_json(doc: dict) -> Optional[Dict[str, SiliconRecord]]:
    if doc.get("model_version") != SILICON_MODEL_VERSION:
        return None
    point_fields = {f.name for f in dataclasses.fields(SweepPoint)}
    out: Dict[str, SiliconRecord] = {}
    for key, raw in doc.get("records", {}).items():
        point = SweepPoint(**{k: v for k, v in raw.items()
                              if k in point_fields})
        rest = {k: v for k, v in raw.items() if k not in point_fields}
        out[key] = SiliconRecord(point=point, **rest)
    return out


def load_cache(path: Optional[str] = None
               ) -> Optional[Dict[str, SiliconRecord]]:
    """Load cached records; ``None`` on missing/corrupt/stale-version."""
    path = path or default_cache_path()
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        return _from_json(doc)
    except (OSError, ValueError, TypeError, KeyError):
        return None


def sweep(points: Optional[Iterable[SweepPoint]] = None,
          cache_path: Optional[str] = None,
          force: bool = False) -> Dict[str, SiliconRecord]:
    """Evaluate ``points`` (default :func:`default_grid`), serving from
    and updating the JSON cache.

    ``force=True`` recomputes everything and rewrites the cache.  A
    cached file with a different :data:`SILICON_MODEL_VERSION` is
    discarded wholesale.
    """
    pts = list(points) if points is not None else default_grid()
    path = cache_path or default_cache_path()
    cached = None if force else (load_cache(path) or {})
    cached = cached or {}
    records: Dict[str, SiliconRecord] = {}
    missing = False
    for p in pts:
        hit = cached.get(p.key)
        if hit is not None and hit.point == p:
            records[p.key] = hit
        else:
            records[p.key] = evaluate_point(p)
            missing = True
    if missing or force:
        merged = {**cached, **records}
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(_to_json(merged), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return records
