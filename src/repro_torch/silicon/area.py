"""Area-overhead report for the in-cache additions (paper Table V).

The paper's headline claim is that the whole MVE apparatus — transpose
management unit, in-cache controller, per-CB FSMs, the bit-serial
peripheral logic and the widened address decoders — costs **3.588 %** of
an ARM big-core's area (vs 16.3 % for a dedicated Neon datapath).  The
repo previously hard-coded the seven Table V component areas in
``benchmarks/paper_claims.py``; this module makes them *parametric* in
the machine geometry and technology node, with the same calibration
contract as :mod:`repro_torch.silicon.params`:

* each component's Table V value (mm^2 at 7 nm, default Table IV
  geometry) is the anchor;
* a documented scaling law maps the anchor to other geometries, and
  every law evaluates to exactly ``1.0`` at the default — so
  ``area_report(MVEConfig())`` reproduces Table V byte-identically and
  ``paper_claims.tableV_area()`` now just delegates here;
* everything shrinks quadratically with the node (digital logic area
  ~ F^2).

Scaling laws (Section V / Table V provenance):

=============  =============================================================
component      grows with
=============  =============================================================
controller     affine in the CB count (fixed decode + per-CB issue queues)
mshr           constant (fixed miss-handling depth)
tmu            lanes (one 32b transpose lane per SIMD lane)
xb             lanes x log2(bitlines) (butterfly crossbar stages)
fsm            CB count (one sequencing FSM per control block)
peripheral     compute cells = arrays x bitlines (single-bit ALUs + latches)
addr_decoder   arrays x log2(wordlines) (binary-tree row decoders)
=============  =============================================================
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from ..core.machine import MVEConfig
from .params import DEFAULT_GEOMETRY, REFERENCE_TECH_NM
from .sram import SRAMSpec, estimate

#: Table V component areas, mm^2 at 7 nm, default Table IV geometry.
TABLE_V_MM2_7NM: Dict[str, float] = {
    "controller": 0.0043,
    "mshr": 0.0018,
    "tmu": 0.0053,
    "xb": 0.0039,
    "fsm": 0.0123,
    "peripheral": 0.0063,
    "addr_decoder": 0.0042,
}

#: ARM big-core area the overhead is quoted against (mm^2, 7 nm).
CORE_AREA_MM2_7NM = 1.07

#: A dedicated 128b Neon datapath, the paper's alternative (mm^2, 7 nm).
NEON_AREA_MM2_7NM = 0.1741


def _component_ratios(cfg: MVEConfig) -> Dict[str, float]:
    """Per-component geometry scaling, each exactly 1.0 at the default."""
    d = DEFAULT_GEOMETRY
    lanes = cfg.lanes / d.lanes
    cbs = cfg.num_cbs / d.num_cbs
    arrays = cfg.num_arrays / d.num_arrays
    bl_stages = math.log2(cfg.bitlines) / math.log2(d.bitlines)
    wl_stages = math.log2(cfg.wordlines) / math.log2(d.wordlines)
    return {
        "controller": 0.5 + 0.5 * cbs,
        "mshr": 1.0,
        "tmu": lanes,
        "xb": lanes * bl_stages,
        "fsm": cbs,
        "peripheral": lanes,
        "addr_decoder": arrays * wl_stages,
    }


@dataclasses.dataclass(frozen=True)
class AreaReport:
    """One geometry's area accounting.

    ``overhead_pct`` is the paper's headline metric (additions over the
    big core).  ``overhead_vs_cache_pct`` additionally amortizes over
    the L2 macro itself — the metric that makes the Bicameral split
    (compute arrays + plain storage arrays sharing one macro) look
    different from a compute-only cache.
    """

    cfg: MVEConfig
    tech_nm: float
    components: Dict[str, float]       # mm^2 per Table V component
    added_mm2: float                   # sum of the additions
    core_mm2: float                    # ARM big core at this node
    l2_mm2: float                      # the SRAM macro (incl. storage arrays)
    neon_mm2: float                    # the dedicated-datapath alternative
    overhead_pct: float                # added / core * 100  (paper: 3.588)
    overhead_vs_cache_pct: float       # added / (core + l2) * 100
    neon_overhead_pct: float           # neon / core * 100   (paper: 16.321)


def area_report(cfg: Optional[MVEConfig] = None,
                tech_nm: float = REFERENCE_TECH_NM,
                storage_arrays: int = 0) -> AreaReport:
    """Price the in-cache additions for one geometry.

    ``storage_arrays`` adds plain (non-compute) subarrays to the L2
    macro — the Bicameral split-cache demo (arXiv:2407.15440): compute
    peripherals are paid on ``cfg.num_arrays`` only, while the macro
    area and the ``overhead_vs_cache_pct`` denominator cover all
    arrays.
    """
    cfg = cfg or DEFAULT_GEOMETRY
    node2 = (tech_nm / REFERENCE_TECH_NM) ** 2
    ratios = _component_ratios(cfg)
    components = {k: TABLE_V_MM2_7NM[k] * ratios[k] * node2
                  for k in TABLE_V_MM2_7NM}
    added = sum(components.values())
    core = CORE_AREA_MM2_7NM * node2
    neon = NEON_AREA_MM2_7NM * node2
    macro = estimate(SRAMSpec(tech_nm=tech_nm,
                              num_arrays=cfg.num_arrays + storage_arrays,
                              bitlines=cfg.bitlines,
                              wordlines=cfg.wordlines))
    return AreaReport(
        cfg=cfg, tech_nm=tech_nm, components=components,
        added_mm2=added, core_mm2=core, l2_mm2=macro.total_area_mm2,
        neon_mm2=neon,
        overhead_pct=added / core * 100.0,
        overhead_vs_cache_pct=added / (core + macro.total_area_mm2) * 100.0,
        neon_overhead_pct=neon / core * 100.0,
    )
