"""Bicameral split-cache demo target (arXiv:2407.15440).

The Bicameral cache splits one physical SRAM macro into an *attentive*
partition (compute-enabled subarrays with the full MVE peripheral
apparatus) and a plain *storage* partition that keeps ordinary cache
capacity.  Mapped onto this repo: the compute partition is exactly the
paper's Table IV geometry (32 arrays — execution, timing and energy are
**bit-exact** with ``mve-bs``), while the macro additionally carries 32
storage-only subarrays that pay cell area but no compute peripherals.

What changes is the *area accounting*: the in-cache additions are
amortized over a twice-as-large L2, so the ``overhead_vs_cache_pct``
metric of :class:`repro_torch.silicon.area.AreaReport` drops relative to a
compute-only macro — the argument the Bicameral paper makes for
retrofitting compute into a big cache instead of shrinking it.

Registered at package import like the built-ins, so it shows up in
``repro_torch.targets.list_targets()``, the conformance fuzz loop and the
``targets`` bench section; also the worked ``register_target()`` example
of docs/TARGETS.md.
"""
from __future__ import annotations

import dataclasses

from ..silicon.area import AreaReport, area_report
from .base import register_target
from .builtin import InCacheTarget


@dataclasses.dataclass(frozen=True)
class BicameralTarget(InCacheTarget):
    """``mve-bs`` compute partition + storage-only subarrays."""

    name: str = "mve-bicameral"
    scheme: str = "bs"
    description: str = ("Bicameral split cache: bit-serial compute "
                        "partition + equal storage partition "
                        "(arXiv:2407.15440)")
    #: Storage-only subarrays sharing the macro with the compute ones.
    storage_arrays: int = 32

    def area_report(self, tech_nm: float = 7.0) -> AreaReport:
        """Area accounting with the storage partition in the macro."""
        return area_report(self.machine_config(), tech_nm=tech_nm,
                           storage_arrays=self.storage_arrays)


MVE_BICAMERAL = register_target(BicameralTarget())
