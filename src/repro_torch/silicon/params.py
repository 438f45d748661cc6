"""Derive :class:`~repro_torch.core.cost.EnergyParams` per (scheme, geometry).

The repo's energy constants used to be nine fixed point-values
(:data:`repro_torch.core.cost.DEFAULT_ENERGY`) — correct for the paper's
Table IV geometry (32 arrays x 256 bitlines x 256 wordlines at 7 nm,
bit-serial) and silently wrong for every other point.  This module makes
the in-cache constants *parametric*: each is the calibrated default
scaled by the analytic SRAM model's ratio between the requested geometry
and the default one, times a documented per-scheme peripheral factor.

Calibration contract (docs/SILICON.md):

* the parametric model contributes **relative** scaling only;
* at the default geometry every ratio is exactly ``x / x == 1.0`` (the
  model is pure and memoized, so both sides are the same float), and the
  bit-serial scheme factor is the anchor ``1.0`` — hence
  ``derived_energy(MVEConfig())[0] == DEFAULT_ENERGY`` **byte-identically**
  and the frozen fig7/table2 golden rows are preserved exactly;
* core-side baseline constants (``e_scalar``, ``e_simd_op``,
  ``e_l1_byte``, the GPU trio) describe the *mobile core*, not the
  cache, and never scale with cache geometry.

What scales, and why:

* ``e_array_cycle`` — per-array compute-cycle energy: two wordline
  activations + read swing + per-column logic
  (:attr:`~repro_torch.silicon.sram.SRAMEstimate.compute_cycle_pj`), times the
  scheme's peripheral factor;
* ``e_l2_byte`` — the L2->TMU transfer cost per byte
  (:attr:`~repro_torch.silicon.sram.SRAMEstimate.read_pj_per_byte`), times the
  scheme's transpose factor (bit-parallel layouts skip the TMU
  bit-slice transpose);
* ``e_issue`` — controller dispatch: the instruction broadcast fans out
  to one FSM per control block, so it grows affinely with the CB count.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Dict, Optional, Tuple

from ..core.cost import DEFAULT_ENERGY, EnergyParams
from ..core.machine import MVEConfig
from .sram import SRAMSpec, estimate

#: Bump when the analytic model's equations or constants change — the
#: sweep cache (:mod:`repro_torch.silicon.sweep`) is keyed on it, so stale
#: records recompute instead of silently serving old numbers.
SILICON_MODEL_VERSION = "1"

#: Per-scheme array-cycle peripheral factor, relative to bit-serial
#: (Section II-B).  BS is the calibration anchor.  BP (VRAM) adds the
#: ripple-carry peripheral across bitlines; BH (EVE) adds the segment
#: Manchester-carry logic; AC (CAPE) precharges the match lines for
#: every truth-table search/update row.
SCHEME_ARRAY_FACTOR: Dict[str, float] = {
    "bs": 1.0, "bp": 1.25, "bh": 1.15, "ac": 1.6,
}

#: Per-scheme L2->TMU transfer factor.  Horizontal (bit-parallel)
#: layouts skip the TMU's per-bit transpose writes entirely (bp) or for
#: all but the segment boundaries (bh); bs and ac pay the full bit-slice
#: fill.
SCHEME_L2_FACTOR: Dict[str, float] = {
    "bs": 1.0, "bp": 0.85, "bh": 0.90, "ac": 1.0,
}

#: The calibration anchor: the paper's Table IV geometry.
DEFAULT_GEOMETRY = MVEConfig()


def spec_for(cfg: MVEConfig, tech_nm: float = 7.0) -> SRAMSpec:
    """The :class:`SRAMSpec` for one machine geometry (the compute
    scheme changes peripherals, not the SRAM macro itself)."""
    return SRAMSpec(tech_nm=tech_nm, num_arrays=cfg.num_arrays,
                    bitlines=cfg.bitlines, wordlines=cfg.wordlines)


def geometry_digest(cfg: MVEConfig, scheme: Optional[str] = None,
                    tech_nm: float = 7.0) -> str:
    """Short stable digest naming one (scheme, geometry, model version)
    pricing — the ``derived:<digest>`` provenance tag on
    :class:`~repro_torch.core.cost.EnergyReport`."""
    scheme = scheme or cfg.scheme
    key = (f"v{SILICON_MODEL_VERSION}:{scheme}:{cfg.num_arrays}:"
           f"{cfg.bitlines}:{cfg.wordlines}:{cfg.arrays_per_cb}:{tech_nm}")
    return hashlib.sha256(key.encode()).hexdigest()[:10]


def _issue_fanout(cfg: MVEConfig) -> float:
    """Controller dispatch cost model: half fixed decode/queue, half
    FSM broadcast growing with the CB count (8 CBs at default)."""
    return 0.5 + 0.5 * (cfg.num_cbs / DEFAULT_GEOMETRY.num_cbs)


@functools.lru_cache(maxsize=1024)
def _derived(cfg: MVEConfig, scheme: str,
             tech_nm: float) -> Tuple[EnergyParams, str]:
    base = estimate(spec_for(DEFAULT_GEOMETRY, REFERENCE_TECH_NM))
    cur = estimate(spec_for(cfg, tech_nm))
    array_ratio = cur.compute_cycle_pj / base.compute_cycle_pj
    l2_ratio = cur.read_pj_per_byte / base.read_pj_per_byte
    issue_ratio = _issue_fanout(cfg) / _issue_fanout(DEFAULT_GEOMETRY)
    sf_array = SCHEME_ARRAY_FACTOR[scheme] / SCHEME_ARRAY_FACTOR["bs"]
    sf_l2 = SCHEME_L2_FACTOR[scheme] / SCHEME_L2_FACTOR["bs"]
    d = DEFAULT_ENERGY
    params = EnergyParams(
        e_array_cycle=d.e_array_cycle * array_ratio * sf_array,
        e_l2_byte=d.e_l2_byte * l2_ratio * sf_l2,
        e_issue=d.e_issue * issue_ratio,
        # core-side baselines: geometry-independent by contract
        e_scalar=d.e_scalar, e_simd_op=d.e_simd_op, e_l1_byte=d.e_l1_byte,
        e_gpu_flop=d.e_gpu_flop, e_gpu_launch=d.e_gpu_launch,
        e_gpu_copy_byte=d.e_gpu_copy_byte,
    )
    return params, f"derived:{geometry_digest(cfg, scheme, tech_nm)}"


#: Tech node the derivation prices at unless told otherwise (Table IV).
REFERENCE_TECH_NM = 7.0


def derived_energy(cfg: MVEConfig, scheme: Optional[str] = None,
                   tech_nm: float = REFERENCE_TECH_NM
                   ) -> Tuple[EnergyParams, str]:
    """``(EnergyParams, "derived:<digest>")`` for one (scheme, geometry).

    ``scheme`` defaults to ``cfg.scheme``.  Cached per argument triple —
    pricing a 40-candidate sweep hits the model once per distinct point.
    """
    scheme = scheme or cfg.scheme
    if scheme not in SCHEME_ARRAY_FACTOR:
        raise KeyError(
            f"unknown scheme {scheme!r}; known: "
            f"{', '.join(sorted(SCHEME_ARRAY_FACTOR))}")
    return _derived(cfg, scheme, tech_nm)
