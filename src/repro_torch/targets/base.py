"""The :class:`Target` protocol, registry, and :class:`CompiledArtifact`.

A *target* is a named bundle of

  * a **machine configuration** — the engine geometry + in-SRAM compute
    scheme the kernel is priced for;
  * a **program lowering** — how the MVE program's accesses map onto the
    target's ISA (identity for MVE itself; the Section III-C segment
    decomposition of :mod:`repro_torch.core.rvv` for a 1D long-vector ISA;
    an analytic workload extraction for packed SIMD);
  * a **timing model** — cycles via the controller/CB timeline
    (:func:`repro_torch.core.cost.simulate`) or an analytic throughput model;
  * an **energy model** — the shared :class:`~repro_torch.core.cost.EnergyParams`
    component model.

Every target *executes* through the same functional engine
(:func:`repro_torch.core.engine.compile_program`), so results are bit-exact
across targets by contract — the paper's cross-ISA comparisons (Figures
10/11/13) run the *same* kernel and differ only in how instructions are
issued and priced.  The RVV path is literally the same access, sliced
into partial 1D segments; ``tests/test_targets.py`` and
``tests/test_conformance.py`` assert the bit-exactness invariant on
every registered target.

Third-party schemes plug in by subclassing :class:`Target` (or any of
the concrete adapters in :mod:`repro_torch.targets.builtin`) and calling
:func:`register_target` — see docs/TARGETS.md for a worked example.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core import cost
from ..core.cost import EnergyReport, Timeline, TimingParams, TraceEvent
from ..core.engine import CompiledProgram, compile_program
from ..core.isa import ProgramError
from ..core.machine import MVEConfig
from ..core.rvv import RVVStats


@dataclasses.dataclass(frozen=True)
class InstructionMix:
    """Dynamic instruction counts of one program as the target issues it
    (the currency of Figure 11: MVE needs 2.3x fewer vector and 2x fewer
    scalar instructions than the 1D baseline)."""

    vector: int = 0        # vector instructions (incl. memory + moves)
    memory: int = 0        # vector loads/stores
    move: int = 0          # pack/unpack moves
    mask: int = 0          # mask materialization / predicate config
    scalar: int = 0        # scalar-core instructions (addressing, masks)
    config: int = 0        # control-register writes

    @property
    def total(self) -> int:
        return self.vector + self.scalar + self.config

    @classmethod
    def from_rvv_stats(cls, stats: RVVStats) -> "InstructionMix":
        return cls(vector=stats.vector_instructions,
                   memory=stats.memory_instructions,
                   move=stats.move_instructions,
                   mask=stats.mask_instructions,
                   scalar=stats.scalar_instructions,
                   config=stats.config_instructions)


class Target(abc.ABC):
    """One ISA x compute-scheme x cost-model combination.

    Concrete targets are frozen dataclasses (hashable, comparable) with
    at least ``name`` and ``description`` fields; the registry maps
    names to instances.  The protocol splits cleanly into *execution*
    (shared — :meth:`machine_config` feeds the functional engine) and
    *pricing* (per-target — :meth:`performance_trace`, :meth:`timeline`,
    :meth:`energy`, :meth:`instruction_mix`).
    """

    # concrete dataclasses provide these as fields
    name: str
    description: str
    isa_name: str
    #: Timing constants the default :meth:`timeline` simulates with;
    #: dataclass subclasses typically redeclare this as a field.
    timing: TimingParams = TimingParams()

    # -- execution ---------------------------------------------------------
    @abc.abstractmethod
    def machine_config(self, cfg: Optional[MVEConfig] = None,
                       **overrides) -> MVEConfig:
        """The machine configuration this target executes and is priced
        under, derived from ``cfg`` (default geometry when ``None``) with
        per-call ``overrides`` applied last."""

    def freq_ghz(self, cfg: MVEConfig) -> float:
        """Clock used to convert the target's cycles to wall time."""
        return cfg.freq_ghz

    # -- pricing -----------------------------------------------------------
    @abc.abstractmethod
    def performance_trace(self, program, cfg: MVEConfig,
                          mve_trace: List[TraceEvent]) -> List[TraceEvent]:
        """The trace the *target's* ISA would issue for this program.

        ``mve_trace`` is the executed (or static) MVE engine trace — the
        ground-truth record of what the kernel touched; targets that
        re-issue the work differently (1D slicing, packed SIMD) derive
        their own stream from the program and/or that record."""

    def timeline(self, program, cfg: MVEConfig,
                 mve_trace: List[TraceEvent]) -> Timeline:
        """Cycles, by default via the controller/CB timeline model over
        :meth:`performance_trace`."""
        return cost.simulate(self.performance_trace(program, cfg, mve_trace),
                             cfg, self.timing)

    @abc.abstractmethod
    def energy(self, program, cfg: MVEConfig,
               mve_trace: List[TraceEvent]) -> EnergyReport:
        """Per-component energy of one execution (pJ)."""

    @abc.abstractmethod
    def instruction_mix(self, program, cfg: MVEConfig) -> InstructionMix:
        """Dynamic instruction counts as this target issues the program."""


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: "Dict[str, Target]" = {}


def register_target(target: Target, overwrite: bool = False) -> Target:
    """Register a target under ``target.name``.

    Third-party compute schemes call this once at import time; the name
    then works everywhere a target is accepted
    (``repro_torch.targets.compile``, ``Kernel.compile(target=...)``).
    """
    if not isinstance(target, Target):
        raise TypeError(f"register_target wants a Target, got "
                        f"{type(target).__name__}")
    if target.name in _REGISTRY and not overwrite:
        raise ProgramError(
            f"target {target.name!r} is already registered "
            f"(pass overwrite=True to replace it)")
    _REGISTRY[target.name] = target
    return target


def get_target(name) -> Target:
    """Resolve a registered target by name; :class:`Target` instances
    pass through.  Unknown names raise a :class:`ProgramError` that
    names every registered target."""
    if isinstance(name, Target):
        return name
    target = _REGISTRY.get(name)
    if target is None:
        raise ProgramError(
            f"unknown target {name!r}; registered targets: "
            f"{', '.join(sorted(_REGISTRY))}")
    return target


def list_targets() -> Tuple[str, ...]:
    """Registered target names, registration order preserved."""
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# The uniform compiled artifact.
# ---------------------------------------------------------------------------

class CompiledArtifact:
    """What ``repro_torch.targets.compile`` returns: one compiled program bound
    to one target, exposing the uniform surface

        run / run_batch / trace / timeline / energy / instruction_mix

    Execution (`run`, `run_batch`) dispatches to the shared
    :class:`~repro_torch.core.engine.CompiledProgram` — results are bit-exact
    across targets.  Pricing (`timeline`, `energy`, ...) goes through the
    target's models.  The pricing methods take an optional ``source``:

      * ``None`` — price the compile-time static trace (exact unless the
        program uses random-base accesses, whose cache-line counts are
        data-dependent);
      * an execution state (anything with a ``.trace``) — price that
        run's exact trace;
      * a memory image (or dict of named operands for kernel artifacts)
        — execute it and price the exact trace.
    """

    def __init__(self, target: Target, cfg: MVEConfig, cp: CompiledProgram):
        self.target = target
        self.cfg = cfg
        self.cp = cp

    # -- delegation --------------------------------------------------------
    @property
    def program(self):
        return self.cp.program

    @property
    def kernel(self):
        """The frontend kernel this artifact was compiled from (None for
        raw programs)."""
        return self.cp.kernel

    @property
    def mode(self) -> str:
        return self.cp.mode

    def run(self, memory=None):
        """Execute once; ``(memory_after, state)`` exactly like
        :meth:`CompiledProgram.run`.  Kernel artifacts accept a dict of
        named operand arrays or nothing (declared inits apply) and read
        results back via ``state.operands``."""
        if memory is None:
            if self.kernel is None:
                raise TypeError(
                    "run() without a memory image needs a frontend "
                    "kernel artifact (declared inits form the image)")
            memory = self.kernel.pack()
        return self.cp.run(memory)

    def run_batch(self, memories):
        """Batched execution over a leading batch axis (see
        :meth:`CompiledProgram.run_batch`)."""
        return self.cp.run_batch(memories)

    def warmup(self, memory_size, batch=None) -> "CompiledArtifact":
        self.cp.warmup(memory_size, batch)
        return self

    # -- pricing -----------------------------------------------------------
    def _mve_trace(self, source=None) -> List[TraceEvent]:
        if source is None:
            return self.cp.static_trace
        trace = getattr(source, "trace", None)
        # Execution states expose ``trace`` as data; arrays expose a
        # ``trace()`` *method* (matrix trace) — those are memory images.
        if trace is not None and not callable(trace):
            return trace
        return self.run(source)[1].trace

    def trace(self, source=None) -> List[TraceEvent]:
        """The instruction stream this target's ISA issues (see class
        docstring for ``source``)."""
        return self.target.performance_trace(
            self.program, self.cfg, self._mve_trace(source))

    def timeline(self, source=None) -> Timeline:
        """Cycles under this target's timing model."""
        return self.target.timeline(
            self.program, self.cfg, self._mve_trace(source))

    def energy(self, source=None) -> EnergyReport:
        """Per-component energy (pJ) under this target's energy model."""
        return self.target.energy(
            self.program, self.cfg, self._mve_trace(source))

    def instruction_mix(self) -> InstructionMix:
        """Dynamic instruction counts as this target issues the program."""
        return self.target.instruction_mix(self.program, self.cfg)

    def us(self, source=None) -> float:
        """Modeled wall time (microseconds) at the target's clock."""
        return self.timeline(source).us(self.target.freq_ghz(self.cfg))

    def __repr__(self) -> str:
        return (f"CompiledArtifact(target={self.target.name!r}, "
                f"mode={self.mode!r}, "
                f"instructions={len(self.program)})")


def compile(kernel_or_program, target="mve-bs",
            cfg: Optional[MVEConfig] = None, mode: Optional[str] = None,
            opt_level: Optional[int] = None, device=None,
            **overrides) -> CompiledArtifact:
    """THE entry point: compile a frontend kernel or raw MVE program for
    one target.

        art = repro_torch.targets.compile(kernel, target="rvv-1d")
        out, state = art.run({"x": xs, "y": ys})
        art.timeline(state).total_cycles     # 1D-ISA cycles
        art.energy(state).total_pj

    ``target`` is a registered name (``repro_torch.targets.list_targets()``)
    or a :class:`Target` instance; ``cfg`` overrides the base machine
    geometry and ``**overrides`` patch individual
    :class:`~repro_torch.core.machine.MVEConfig` fields (``num_arrays=8``,
    ``bh_segment_bits=8``, ...).  Compilations are cached per target
    (``cache_tag``), so the same program compiled for two targets holds
    two independent LRU entries (``cache_info().per_target``).

    ``device`` is where the artifact executes (default ``cuda``; without a
    card that raises — pass ``"cpu"``); pricing is host arithmetic.
    ``opt_level`` routes the program through the :mod:`repro_torch.opt`
    pass pipeline first (``None`` = as written); the artifact's
    ``program``, ``trace`` and ``timeline`` then describe the optimized
    text, priced under this target's models — which is what
    ``repro_torch.opt.tune()`` sweeps schedules with.
    """
    tgt = get_target(target)
    tcfg = tgt.machine_config(cfg, **overrides)
    cp = compile_program(kernel_or_program, tcfg, mode=mode,
                         cache_tag=tgt.name, opt_level=opt_level,
                         device=device)
    return CompiledArtifact(tgt, tcfg, cp)
