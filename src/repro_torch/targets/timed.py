"""``*-timed`` targets: the pipeline model behind the uniform Target API.

Each timed target wraps a registered analytic target and changes only
:meth:`~repro_torch.targets.base.Target.timeline`: instead of the analytic
controller/CB model it replays the *same* performance trace through the
in-order pipeline model of :mod:`repro_torch.timing` under a named uarch
config, returning a :class:`~repro_torch.timing.TimedTimeline` with per-cause
``stalls`` and the verified ``[lower_bound, upper_bound]`` envelope.
Execution, energy, and instruction mix delegate to the base target —
the timing layer never touches functional semantics (asserted against
the stepwise oracle by ``tests/test_conformance.py``).

  =============  ==========  ============  ==========================
  name           wraps       uarch config  dependence extraction
  =============  ==========  ============  ==========================
  mve-bs-timed   mve-bs      mve-bs        architectural registers
  mve-bp-timed   mve-bp      mve-bp        architectural registers
  mve-bh-timed   mve-bh      mve-bh        architectural registers
  mve-ac-timed   mve-ac      mve-ac        architectural registers
  rvv-1d-timed   rvv-1d      rvv-1d        synthesized (lowered 1D
                                           stream is not 1:1)
  neon-timed     neon        mobile-core   architectural registers
  =============  ==========  ============  ==========================

:func:`timed_variant` names the timed twin of a target (the optimizer's
schedule sweeps price through it once the optimizer is ported).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .. import timing
from ..core.cost import EnergyReport, Timeline
from ..core.machine import MVEConfig
from .base import InstructionMix, Target, get_target, register_target


@dataclasses.dataclass(frozen=True)
class TimedTarget(Target):
    """A registered target re-priced through the pipeline model.

    ``base_name`` is the wrapped analytic target; ``uarch`` names a
    :data:`repro_torch.timing.UARCH_CONFIGS` entry (or is a config dict);
    ``cost_model`` selects per-event durations: ``"incache"`` reuses
    the scheme's analytic op costs, ``"simd"`` the packed-SIMD costs.
    """

    name: str
    base_name: str
    uarch: str = "mve-bs"
    cost_model: str = "incache"
    description: str = ""
    isa_name: str = "mve"

    @property
    def base(self) -> Target:
        return get_target(self.base_name)

    # -- execution: delegate everything functional --------------------------
    def machine_config(self, cfg: Optional[MVEConfig] = None,
                       **overrides) -> MVEConfig:
        return self.base.machine_config(cfg, **overrides)

    def freq_ghz(self, cfg: MVEConfig) -> float:
        return self.base.freq_ghz(cfg)

    def performance_trace(self, program, cfg, mve_trace):
        return self.base.performance_trace(program, cfg, mve_trace)

    def energy(self, program, cfg, mve_trace) -> EnergyReport:
        return self.base.energy(program, cfg, mve_trace)

    def instruction_mix(self, program, cfg) -> InstructionMix:
        return self.base.instruction_mix(program, cfg)

    # -- pricing: the pipeline model ----------------------------------------
    def timed_ops(self, program, cfg, mve_trace):
        """The pipeline model's input for one compilation —
        ``(ops, lane_capacity)`` (exposed for the conformance harness,
        which recomputes the envelope from the same ops)."""
        trace = self.performance_trace(program, cfg, mve_trace)
        return timing.build_timed_ops(
            program, trace, cfg, tp=self.base.timing, uarch=self.uarch,
            cost_model=self.cost_model)

    def timeline(self, program, cfg, mve_trace) -> Timeline:
        ops, lane_capacity = self.timed_ops(program, cfg, mve_trace)
        return timing.simulate_pipeline(ops, self.uarch,
                                        lane_capacity=lane_capacity)


# ---------------------------------------------------------------------------
# Registration: one timed twin per built-in target.
# ---------------------------------------------------------------------------

_TWINS: Dict[str, str] = {}


def _register_twin(base_name: str, uarch: str,
                   cost_model: str = "incache") -> TimedTarget:
    base = get_target(base_name)
    t = TimedTarget(
        name=f"{base_name}-timed", base_name=base_name, uarch=uarch,
        cost_model=cost_model, isa_name=base.isa_name,
        description=f"{base.description} — pipeline model ({uarch})")
    register_target(t)
    _TWINS[base_name] = t.name
    return t


MVE_BS_TIMED = _register_twin("mve-bs", "mve-bs")
MVE_BP_TIMED = _register_twin("mve-bp", "mve-bp")
MVE_BH_TIMED = _register_twin("mve-bh", "mve-bh")
MVE_AC_TIMED = _register_twin("mve-ac", "mve-ac")
RVV_1D_TIMED = _register_twin("rvv-1d", "rvv-1d")
NEON_TIMED = _register_twin("neon", "mobile-core", cost_model="simd")


def timed_variant(name) -> Optional[Target]:
    """The pipeline-model twin of a registered target name (identity
    for targets that already are timed; ``None`` when no twin exists —
    e.g. an unregistered custom target)."""
    tgt = name if isinstance(name, Target) else None
    tname = tgt.name if tgt is not None else name
    if isinstance(tgt, TimedTarget):
        return tgt
    if tname in _TWINS:
        return get_target(_TWINS[tname])
    try:
        resolved = get_target(tname)
    except Exception:
        return None
    return resolved if isinstance(resolved, TimedTarget) else None
