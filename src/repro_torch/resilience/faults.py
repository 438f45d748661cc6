"""Deterministic fault injection for the serving runtime.

In-cache compute makes failure a first-class hazard, not an edge case:
an SRAM bit-cell that computes is an SRAM bit-cell that can flip, a
cache op contended by the host has variable latency, and a serving
worker is one thread among many that the OS may kill.  This module
models that hazard space as **data**: a :class:`FaultPlan` is an
immutable, seedable, JSON-serializable schedule of :class:`FaultSpec`
entries, and a :class:`FaultInjector` executes the plan at well-defined
executor boundaries.  Same plan + same request stream = same faults, so
every chaos run is replayable and every recovery path is a
deterministic test (``tests/test_resilience.py``).

Sites (where a fault can fire)
------------------------------

==============  ========================================================
``compile``      promotion/compilation of an executable
``dispatch``     launching a (possibly batched) execution
``finalize``     materializing device results back to the host
``worker``       the background serving thread itself, between batches
``engine.*``     deep hooks inside :mod:`repro_torch.core.engine` (via
``vm.*``         :func:`repro_torch.core.vm.set_fault_hook`) — same matching
                 rules, used for executor-level chaos
==============  ========================================================

Kinds (what happens)
--------------------

==============  ========================================================
``error``        raise :class:`~repro_torch.resilience.errors.InjectedFault`
``straggler``    sleep ``latency_s`` (variable-latency cache op)
``bitflip``      XOR one bit of one word of the result memory image —
                 the SRAM cell-fault model; *silent* unless audited
``kill``         raise :class:`InjectedWorkerDeath` (``worker`` site)
==============  ========================================================

A spec can be bound to one request (``rid``), one executor tier
(``tier``), fire a bounded number of ``times`` (``-1`` = sticky: a
permanently poisoned request), and skip its first ``after`` matching
occasions (to hit mid-stream).  The injector records every firing in
:attr:`FaultInjector.fired` — the replay log chaos tests compare.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .errors import InjectedFault, InjectedWorkerDeath

KINDS = ("error", "straggler", "bitflip", "kill")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault (see module docstring for the vocabulary)."""

    site: str                      # where: compile|dispatch|finalize|worker|engine.*|vm.*
    kind: str                      # what: error|straggler|bitflip|kill
    rid: Optional[int] = None      # bind to one request (None = any)
    tier: Optional[str] = None     # bind to one executor tier (None = any)
    times: int = 1                 # firings before the spec retires (-1 = sticky)
    after: int = 0                 # matching occasions skipped before the first firing
    latency_s: float = 0.0         # straggler sleep
    word: int = 0                  # bitflip: word index into the memory image
    bit: int = 0                   # bitflip: bit within the word

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


class FaultPlan:
    """An immutable, replayable schedule of faults.

    Build one explicitly from specs, randomly via :meth:`random`
    (deterministic in ``seed``), or from a recorded JSON blob via
    :meth:`from_json` — ``to_json``/``from_json`` round-trip exactly, so
    a chaos run's plan can be committed next to its test.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: Optional[int] = None):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan(n={len(self.specs)}, seed={self.seed})"

    @classmethod
    def random(cls, seed: int, n_requests: int, rate: float,
               kinds: Sequence[str] = ("error", "straggler", "bitflip"),
               sticky_rids: Sequence[int] = (),
               straggler_s: float = 0.002,
               worker_kills: int = 0) -> "FaultPlan":
        """Deterministic per-request fault assignment.

        Each rid in ``[0, n_requests)`` independently draws a fault with
        probability ``rate``; transient kinds fire once (``times=1``) so
        a bounded retry recovers them.  ``sticky_rids`` are permanently
        poisoned (``times=-1`` dispatch errors) — the batch-bisection +
        quarantine path.  ``worker_kills`` schedules that many one-shot
        worker-thread deaths spread across the stream (supervisor path).
        """
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for rid in range(n_requests):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "error":
                specs.append(FaultSpec(site="dispatch", kind="error", rid=rid))
            elif kind == "straggler":
                specs.append(FaultSpec(site="dispatch", kind="straggler",
                                       rid=rid, latency_s=straggler_s))
            elif kind == "bitflip":
                specs.append(FaultSpec(
                    site="finalize", kind="bitflip", rid=rid,
                    word=int(rng.integers(0, 2 ** 16)),
                    bit=int(rng.integers(0, 32))))
            else:   # pragma: no cover - "kill" never drawn per-rid
                specs.append(FaultSpec(site="worker", kind="kill", rid=rid))
        for k in range(worker_kills):
            # spread kills over the stream: fire after k'th third of the
            # expected worker wakeups
            specs.append(FaultSpec(site="worker", kind="kill",
                                   after=1 + 2 * k))
        for rid in sticky_rids:
            specs.append(FaultSpec(site="dispatch", kind="error",
                                   rid=int(rid), times=-1))
        return cls(specs, seed=seed)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "specs": [dataclasses.asdict(s) for s in self.specs],
        }, indent=2)

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        d = json.loads(blob)
        return cls([FaultSpec(**s) for s in d["specs"]], seed=d.get("seed"))


class FaultInjector:
    """Executes a :class:`FaultPlan` at executor boundaries.

    Thread-safe; one injector serves the scheduler's caller threads, the
    background worker, and (optionally, via :meth:`engine_hook` passed to
    :func:`repro_torch.core.vm.set_fault_hook`) the engine/VM internals.

    The scheduler's *recovery* paths — retries, bisection probes, audit
    reference runs — execute under :meth:`suspended`, so a fault plan
    describes faults of the primary serving path and recovery is
    shielded (the real-world analogue: recovery re-executes on a
    known-good resource, not the faulty one).  Sticky specs
    (``times=-1``) are the exception a test opts into via rid binding:
    suspension still wins, so permanently poisoned requests are modeled
    by *not* suspending the single-request retry path for dispatch
    faults (see ``MVEScheduler._run_single``).
    """

    def __init__(self, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self.sleep = sleep
        self._lock = threading.Lock()
        self._remaining: List[int] = [s.times for s in plan.specs]
        self._skip: List[int] = [s.after for s in plan.specs]
        #: replay log: one dict per firing, in firing order
        self.fired: List[Dict] = []
        self._suspend = threading.local()

    # -- suspension (recovery/audit paths run shielded) --------------------
    def suspended(self):
        return _Suspension(self)

    def _is_suspended(self) -> bool:
        return getattr(self._suspend, "depth", 0) > 0

    # -- counters ----------------------------------------------------------
    @property
    def injected(self) -> int:
        with self._lock:
            return len(self.fired)

    def counts(self) -> Dict[str, int]:
        """Firings per kind (health-snapshot payload)."""
        with self._lock:
            out: Dict[str, int] = {}
            for f in self.fired:
                out[f["kind"]] = out.get(f["kind"], 0) + 1
            return out

    # -- site entry points -------------------------------------------------
    def compile(self, rids: Sequence[int] = (), tier: Optional[str] = None):
        self._hit("compile", rids, tier)

    def dispatch(self, rids: Sequence[int] = (), tier: Optional[str] = None,
                 shielded: bool = False):
        """``shielded=True`` matches only rid-bound sticky specs — the
        recovery path's semantics (see class docstring)."""
        self._hit("dispatch", rids, tier, shielded=shielded)

    def finalize(self, rids: Sequence[int], tier: Optional[str],
                 memory: np.ndarray,
                 rows: Optional[Dict[int, int]] = None) -> np.ndarray:
        """Fire finalize faults; returns the (possibly bit-flipped)
        memory.  ``memory`` is one image (1-D) or a stacked batch with
        ``rows`` mapping rid -> leading-axis row."""
        flips = self._hit("finalize", rids, tier, collect_bitflips=True)
        if not flips:
            return memory
        mem = np.array(memory, copy=True)
        for spec, rid in flips:
            row = mem if mem.ndim == 1 else mem[rows[rid]] \
                if rows and rid in rows else mem[0]
            _flip_bit(row, spec.word, spec.bit)
        return mem

    def worker_tick(self):
        """Called by the serving worker between batches."""
        self._hit("worker", (), None)

    def engine_hook(self, site: str, **ctx):
        """Adapter for :func:`repro_torch.core.vm.set_fault_hook` — deep
        executor-boundary chaos (sites ``engine.compile``,
        ``engine.dispatch``, ``engine.finalize``, ``vm.dispatch``,
        ``vm.finalize``)."""
        self._hit(site, ctx.get("rids", ()), ctx.get("tier"))

    # -- matching core -----------------------------------------------------
    def _hit(self, site: str, rids: Sequence[int], tier: Optional[str],
             collect_bitflips: bool = False, shielded: bool = False):
        if self._is_suspended():
            return []
        rids = list(rids)
        sleeps: List[float] = []
        error: Optional[BaseException] = None
        flips: List[Tuple[FaultSpec, int]] = []
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if error is not None:
                    break
                if spec.site != site or self._remaining[i] == 0:
                    continue
                if spec.tier is not None and tier is not None \
                        and spec.tier != tier:
                    continue
                if shielded and not (spec.rid is not None
                                     and spec.times == -1):
                    continue
                rid = None
                if spec.rid is not None:
                    if spec.rid not in rids:
                        continue
                    rid = spec.rid
                if self._skip[i] > 0:
                    self._skip[i] -= 1
                    continue
                # fire
                if self._remaining[i] > 0:
                    self._remaining[i] -= 1
                self.fired.append({"site": site, "kind": spec.kind,
                                   "rid": rid, "tier": tier,
                                   "t": time.perf_counter()})
                if spec.kind == "straggler":
                    sleeps.append(spec.latency_s)
                elif spec.kind == "bitflip":
                    if collect_bitflips:
                        flips.append((spec, rid if rid is not None
                                      else (rids[0] if rids else 0)))
                elif spec.kind == "kill":
                    error = InjectedWorkerDeath(
                        f"injected worker death at {site}")
                else:
                    error = InjectedFault(
                        f"injected {site} fault"
                        + (f" for rid {rid}" if rid is not None else "")
                        + (f" on tier {tier}" if tier else ""))
        for s in sleeps:
            if s > 0:
                self.sleep(s)
        if error is not None:
            raise error
        return flips


class _Suspension:
    def __init__(self, inj: FaultInjector):
        self._inj = inj

    def __enter__(self):
        tl = self._inj._suspend
        tl.depth = getattr(tl, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        self._inj._suspend.depth -= 1
        return False


def _flip_bit(row: np.ndarray, word: int, bit: int) -> None:
    """XOR one bit of one word in-place (SRAM cell-fault model)."""
    itemsize = row.dtype.itemsize
    if itemsize == 8:
        u = row.view(np.uint64)
    elif itemsize == 4:
        u = row.view(np.uint32)
    elif itemsize == 2:
        u = row.view(np.uint16)
    else:
        u = row.view(np.uint8)
    w = word % u.size
    u[w] ^= np.asarray(1 << (bit % (8 * itemsize)), dtype=u.dtype)
