"""``repro_torch.silicon`` — parametric SRAM energy/area model + autotuner.

The paper's cost story has three legs the rest of the repo prices with:

* :mod:`~repro_torch.silicon.sram` — a first-order CACTI-style analytic model
  of the L2 SRAM macro (per-access energies, leakage, area);
* :mod:`~repro_torch.silicon.params` — per-(scheme, geometry)
  :class:`~repro_torch.core.cost.EnergyParams` derivation, calibrated so the
  Table IV default reproduces ``DEFAULT_ENERGY`` byte-identically;
* :mod:`~repro_torch.silicon.area` — the Table V area-overhead accounting
  (the 3.588 % claim), parametric in geometry and node.

On top of those, :mod:`~repro_torch.silicon.sweep` persists a disk-cached
(scheme x geometry) grid and :mod:`~repro_torch.silicon.autotune` searches it
for cycles/energy/area Pareto fronts per kernel or serving mix.  See
docs/SILICON.md.

``autotune`` is imported lazily (PEP 562): it reaches into the engine
and pattern library, which :mod:`repro_torch.targets` also imports — eager
import here would cycle.
"""
from . import area, params, sram, sweep  # noqa: F401

__all__ = ["sram", "params", "area", "sweep", "autotune"]


def __getattr__(name):
    if name == "autotune":
        import importlib
        return importlib.import_module(".autotune", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
