"""YAML-style micro-architecture configs for the pipeline model.

A :class:`UarchConfig` is the machine the trace replays through:
front-end rates (fetch/decode), in-order issue width, the core->engine
issue hop, chaining, memory ports, and a set of named functional units.
Configs are written as plain nested dicts (the same shape a YAML file
would parse to — see TBM's ``rvv-simple.yaml`` lineage) and frozen into
dataclasses via :meth:`UarchConfig.from_dict`, so a new machine is one
dict entry, not code (docs/TIMING.md shows a worked example).

Shipped configs:

  ===========  ===========================================================
  name         machine
  ===========  ===========================================================
  mobile-core  Cortex-A76-class mobile core: dual-issue, 2 ASIMD pipes,
               2 L/S ports, single-cycle forwarding
  mve-bs       MVE controller on the bit-serial engine: 1-wide issue over
               the 16-cycle core/L2 hop, TMU<->array chaining (8 cycles
               to the first usable bit-slice), one TMU stream port
  mve-bp       bit-parallel engine — word-granular chaining (2 cycles)
  mve-bh       bit-hybrid engine — segment-granular chaining (4 cycles)
  mve-ac       associative engine — no chaining (truth-table search
               consumes whole operand vectors per row)
  rvv-1d       the mve-bs controller driven by the lowered 1D stream
  ===========  ===========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class FUSpec:
    """One functional unit: ``pipes`` parallel instances; a *pipelined*
    unit accepts a new op every ``init_interval`` cycles while an
    unpipelined one is busy for the op's whole duration (in-cache array
    macro-ops hold the subarrays end to end)."""

    pipes: int = 1
    pipelined: bool = False
    init_interval: float = 1.0


@dataclasses.dataclass(frozen=True)
class UarchConfig:
    """One in-order machine the pipeline model simulates.

    ``issue_latency`` is the issue *hop* (core -> engine controller; the
    analytic model's ``TimingParams.issue_cycles``) every non-scalar op
    pays between issue and execution start.  ``chain_latency`` is the
    delay from a producer's start until its first results are usable by
    a chained consumer on a *different* unit; chaining never beats
    simply waiting for the producer to complete.
    """

    name: str
    description: str = ""
    fetch_rate: int = 4            # instructions fetched per cycle
    decode_latency: float = 1.0    # fetch -> issue-ready
    issue_width: int = 1           # in-order issues per cycle
    issue_latency: float = 16.0    # issue -> execution start hop
    config_latency: float = 1.0    # CR write occupancy on the controller
    chaining: bool = True
    chain_latency: float = 8.0
    mem_ports: int = 1
    fus: Tuple[Tuple[str, FUSpec], ...] = ()
    # analytic per-op cost constants for the packed-SIMD cost model
    simd_bits: int = 128
    simd_pipes: int = 2
    simd_mem_latency: float = 4.0
    simd_bytes_per_cycle: float = 16.0

    def spec(self, fu: str) -> FUSpec:
        for name, s in self.fus:
            if name == fu:
                return s
        return FUSpec()

    def pipes_for(self, fu: str) -> int:
        """Parallel instances of ``fu`` (memory ports for the ``mem``
        unit — the monotonicity knob the property suite raises)."""
        if fu == "mem":
            return max(1, self.mem_ports)
        return max(1, self.spec(fu).pipes)

    def occupancy(self, fu: str, duration: float) -> float:
        """Cycles one pipe of ``fu`` is blocked by an op of ``duration``
        (never more than the duration itself)."""
        if fu == "mem":
            return duration
        s = self.spec(fu)
        if s.pipelined:
            return min(duration, max(s.init_interval, 1.0))
        return duration

    @classmethod
    def from_dict(cls, name: str, d: Dict) -> "UarchConfig":
        """Build a config from a YAML-style nested dict; unknown keys
        raise so config typos fail loudly."""
        d = dict(d)
        fus = tuple(sorted(
            (fu, FUSpec(**spec)) for fu, spec in d.pop("fus", {}).items()))
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"uarch config {name!r}: unknown keys {sorted(unknown)}")
        return cls(name=name, fus=fus, **d)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["fus"] = {fu: dataclasses.asdict(s) for fu, s in self.fus}
        del d["name"]
        return d


# ---------------------------------------------------------------------------
# Shipped configs (YAML-style dicts; see module docstring).
# ---------------------------------------------------------------------------

_MVE_BS = {
    "description": "MVE controller, bit-serial engine (Neural Cache)",
    "fetch_rate": 4,
    "decode_latency": 1.0,
    "issue_width": 1,
    "issue_latency": 16.0,
    "config_latency": 1.0,
    "chaining": True,
    "chain_latency": 8.0,
    "mem_ports": 1,
    "fus": {
        "array": {"pipes": 1},                       # the CB subarrays
        "ctrl": {"pipes": 1, "pipelined": True},
        "scalar": {"pipes": 1, "pipelined": True},
    },
}

UARCH_CONFIGS: Dict[str, Dict] = {
    "mobile-core": {
        "description": "Cortex-A76-class mobile core (2x128b ASIMD)",
        "fetch_rate": 8,
        "decode_latency": 1.0,
        "issue_width": 2,
        "issue_latency": 1.0,
        "config_latency": 1.0,
        "chaining": True,
        "chain_latency": 1.0,       # single-cycle forwarding network
        "mem_ports": 2,
        "fus": {
            "simd": {"pipes": 2, "pipelined": True},
            "ctrl": {"pipes": 1, "pipelined": True},
            "scalar": {"pipes": 1, "pipelined": True},
        },
        "simd_bits": 128,
        "simd_pipes": 2,
        "simd_mem_latency": 4.0,
        "simd_bytes_per_cycle": 16.0,
    },
    "mve-bs": _MVE_BS,
    "mve-bp": dict(
        _MVE_BS,
        description="MVE controller, bit-parallel engine (VRAM)",
        chain_latency=2.0),
    "mve-bh": dict(
        _MVE_BS,
        description="MVE controller, bit-hybrid engine (EVE)",
        chain_latency=4.0),
    "mve-ac": dict(
        _MVE_BS,
        description="MVE controller, associative engine (CAPE)",
        chaining=False),
    "rvv-1d": dict(
        _MVE_BS,
        description="mve-bs controller replaying the lowered 1D stream"),
}

_CACHE: Dict[str, UarchConfig] = {}


def get_uarch(name_or_cfg) -> UarchConfig:
    """Resolve a shipped config by name; dicts and :class:`UarchConfig`
    instances pass through (dicts get the name ``"custom"``)."""
    if isinstance(name_or_cfg, UarchConfig):
        return name_or_cfg
    if isinstance(name_or_cfg, dict):
        return UarchConfig.from_dict("custom", name_or_cfg)
    if name_or_cfg not in UARCH_CONFIGS:
        raise ValueError(
            f"unknown uarch config {name_or_cfg!r}; shipped configs: "
            f"{', '.join(sorted(UARCH_CONFIGS))}")
    if name_or_cfg not in _CACHE:
        _CACHE[name_or_cfg] = UarchConfig.from_dict(
            name_or_cfg, UARCH_CONFIGS[name_or_cfg])
    return _CACHE[name_or_cfg]


def list_uarchs() -> Tuple[str, ...]:
    return tuple(sorted(UARCH_CONFIGS))
