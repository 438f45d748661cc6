"""Signature-batched multi-tenant scheduler for MVE program serving.

Every ``CompiledProgram.run`` pays its own host round trip (upload,
dispatch, a wait for the device, copy-back), so a serving stream — many
logical clients submitting daxpy/gemv/spmm/conv programs concurrently,
the Swan workload mix of Table III — leaves the batch dimension of the
8192-lane array and the device's launch queue idle.  An
:class:`MVEScheduler` accepts ``submit(program, memory)`` requests from
many clients, coalesces them, and executes each group as one batched
dispatch on its device (``cuda`` unless the caller passes another).

Scheduling policy (the reference's, ``docs/SERVING.md``):

* Pending requests are bucketed by :meth:`CompiledProgram.batch_group_key`
  — for VM-routed requests that is the **VM signature bucket** (plus the
  program and memory geometry); groups of one signature are dispatched
  back to back.
* Within a bucket, requests for the *same* program are padded to a
  power-of-two batch (bounded by ``max_batch``), their memory images
  stacked, and executed as **one** ``run_batch`` dispatch.
* Two executor tiers, as in the reference: the **VM tier** (the
  scheduler's base mode, ``mode="vm"``) and, for a program submitted
  ``promote_after`` times, the **fused tier**.  In this port the VM runs
  the fused executor's datapath, so the two tiers are two names for one
  datapath (``ROADMAP.md``, "Deliberate divergences"); the tier labels,
  batch caps and counters are the reference's.  ``promote_after=None``
  disables promotion.
* All group dispatches of a drain cycle are enqueued on the device's
  current stream (images uploaded from pinned host memory, results
  copied back without blocking); the scheduler blocks on the host **once
  per cycle**, before it reads the first copy-back (``host_syncs`` counts
  those waits), not once per request.

Targets: ``submit(..., target="rvv-1d")`` accepts any registered
:mod:`repro_torch.targets` target — requests bucket per target and the
resolved machine config rides on the ticket; unknown or
geometry-mismatched targets raise a readable
:class:`~repro_torch.core.isa.ProgramError`.

Determinism: with ``background=False`` (default) nothing executes until
:meth:`MVEScheduler.drain`, which processes every pending request on the
calling thread — submission order decides batch composition, so tests
replay identical schedules.  With ``background=True`` a worker thread
forms batches with a ``max_batch``/``max_wait_ms`` window policy (and
issues the device work from that thread), and :meth:`submit` returns
tickets that resolve concurrently.

Failure semantics (the components live in :mod:`repro_torch.resilience`):

* **Every submit() resolves** — with a result or a typed
  :class:`~repro_torch.resilience.errors.SchedulerError`.  No orphaned
  tickets: a timed-out waiter can :meth:`Ticket.cancel`, :meth:`close`
  resolves everything still pending with ``SchedulerClosedError``, and
  the serve cycle carries a backstop that resolves any ticket an
  internal error would otherwise drop.
* **Bounded retry + per-request deadlines** (``RetryPolicy``).
* **Batch bisection** — a failed group dispatch is split in half and
  re-dispatched until the poison is isolated; clean halves still serve
  batched, the poisoned request is retried alone, then **quarantined**.
* **Circuit breakers + tier degradation** — failures are recorded per
  ``(signature bucket, target, tier)``; an open breaker demotes traffic
  down the ladder *fused → VM → stepwise oracle*.  The oracle tier runs
  on the scheduler's device too (never on the CPU instead); each step
  down counts in ``SchedulerStats.demotions`` and shows in
  :meth:`MVEScheduler.health`.
* **Bounded admission queue** — ``max_queue`` + ``admission="block"``
  or ``"shed"``.
* **Supervised worker** — a background worker that dies mid-stream has
  its in-hand tickets re-queued and is restarted.
* **Sampled integrity audit** (:class:`~repro_torch.resilience.audit.
  ResultAuditor`).

Results come back to the host, as the reference's do: a
:class:`ServeResult` holds NumPy arrays.  They are bit-identical to
per-request ``CompiledProgram.run`` (and to the stepwise oracle):
batching only stacks independent memory images along a leading axis.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import isa
from ..core.cost import TraceEvent
from ..core.engine import CompiledProgram, cache_info, compile_program
from ..core.machine import (MVEConfig, as_memory, next_pow2,
                            resolve_device, to_numpy)
from ..resilience.audit import ResultAuditor
from ..resilience.breaker import CircuitBreaker, RetryPolicy
from ..resilience.errors import (CancelledError, DeadlineExceededError,
                                 InjectedWorkerDeath, QuarantinedError,
                                 QueueFullError, SchedulerClosedError,
                                 SchedulerError, WorkerDiedError)
from .health import HeartbeatMonitor, StragglerDetector

# Bookkeeping bounds: a long-lived server facing an endless stream of
# fresh (data-dependent) programs must not grow per-program state without
# limit — mirrors the engine's bounded program LRU.
_SEEN_CAP = 4096          # submission counters (promotion heat)
_PROMOTED_CAP = 64        # fused-tier executables pinned by the scheduler
_BUCKET_STAT_CAP = 4096   # distinct group keys tracked for stats
_QUARANTINE_CAP = 1024    # poisoned program keys remembered

#: name of the (single) serving worker in the heartbeat monitor
_WORKER_HOST = "serve-worker"


class ServeResult:
    """Per-request outcome, duck-type compatible with
    :class:`repro_torch.core.engine.ExecutionResult` for the common fields.

    ``tier`` records which executor produced it: ``"vm"`` / ``"fused"``
    (batched dispatches), ``"single"`` (un-batched engine dispatch) or
    ``"oracle"`` (stepwise-interpreter fallback of the degradation
    ladder).

    ``memory``, ``regs`` and ``tag`` are host NumPy arrays (the device's
    results copied back), as the reference's are.  ``trace`` is
    materialized lazily for batched results (a fresh copy of the
    compile-time static trace): serving loops that never read it pay
    nothing for it.
    """

    __slots__ = ("memory", "regs", "tag", "batch_size", "tier",
                 "_trace", "_trace_fn", "kernel", "_operands")

    def __init__(self, memory: np.ndarray, regs: Dict[int, np.ndarray],
                 tag: np.ndarray, batch_size: int, tier: str,
                 trace: Optional[List[TraceEvent]] = None,
                 trace_fn: Optional[Callable[[], List[TraceEvent]]] = None,
                 kernel=None):
        self.memory = memory
        self.regs = regs
        self.tag = tag
        self.batch_size = batch_size   # how many requests shared the dispatch
        self.tier = tier               # "vm" | "fused" | "single" | "oracle"
        self._trace = trace
        self._trace_fn = trace_fn
        self.kernel = kernel           # frontend Kernel, when submitted as one
        self._operands = None

    @property
    def trace(self) -> List[TraceEvent]:
        if self._trace is None:
            self._trace = self._trace_fn() if self._trace_fn else []
        return self._trace

    @property
    def operands(self) -> Optional[Dict[str, np.ndarray]]:
        """Results read back by operand name (kernel submissions only);
        materialised lazily like ``trace``."""
        if self._operands is None and self.kernel is not None:
            self._operands = self.kernel.unpack(self.memory)
        return self._operands

    def __repr__(self) -> str:
        return (f"ServeResult(tier={self.tier!r}, "
                f"batch_size={self.batch_size}, "
                f"memory.shape={tuple(np.shape(self.memory))})")


class Ticket:
    """Future-like handle returned by :meth:`MVEScheduler.submit`.

    Resolution is race-safe and exactly-once: the first of {scheduler
    result, scheduler error, :meth:`cancel`, :meth:`MVEScheduler.close`}
    wins and the rest are no-ops, so a timed-out :meth:`result` waiter
    can always cancel without racing an in-flight resolution.
    """

    def __init__(self, rid: int, program, memory, cp: CompiledProgram,
                 submitted_at: Optional[float] = None, kernel=None,
                 cfg: Optional[MVEConfig] = None,
                 target: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.rid = rid
        self.program = program
        self.memory = memory
        self.cp = cp
        self.kernel = kernel
        self.cfg = cfg                 # machine config this request runs under
        self.target = target           # registered target name (None=default)
        self.deadline = deadline       # absolute perf_counter() deadline
        self.submitted_at = submitted_at if submitted_at is not None \
            else time.perf_counter()
        self.done_at: Optional[float] = None
        self._event = threading.Event()
        self._resolve_lock = threading.Lock()
        self._result: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block until the request is served (or ``timeout`` seconds).

        A ``TimeoutError`` does **not** orphan the ticket: it stays
        pending and will still be resolved by the scheduler — call
        :meth:`cancel` to resolve it now and drop the request."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not served in time "
                f"(ticket still pending; cancel() to abandon it)")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        """The resolution error, if the ticket failed (non-blocking)."""
        return self._error if self._event.is_set() else None

    def cancel(self) -> bool:
        """Resolve the ticket with
        :class:`~repro_torch.resilience.errors.CancelledError` if it is still
        pending.  Returns ``True`` when the cancellation won the race,
        ``False`` when the ticket was already resolved (its result/error
        stands).  The scheduler skips cancelled tickets at dispatch."""
        return self._resolve(error=CancelledError(
            f"request {self.rid} cancelled by client"))

    @property
    def latency(self) -> float:
        """Submit-to-completion wall time in seconds."""
        if self.done_at is None:
            raise RuntimeError("request not finished")
        return self.done_at - self.submitted_at

    def _resolve(self, result=None, error=None) -> bool:
        """First resolution wins; returns whether this call resolved."""
        with self._resolve_lock:
            if self._event.is_set():
                return False
            self._result, self._error = result, error
            self.done_at = time.perf_counter()
            self._event.set()
            return True


@dataclasses.dataclass
class SchedulerStats:
    """Counters since construction (see also :meth:`cache_info` and
    :meth:`MVEScheduler.health`)."""

    requests: int = 0
    dispatches: int = 0          # executable launches (any tier)
    batched_requests: int = 0    # requests served by a >1 dispatch
    vm_batches: int = 0
    fused_batches: int = 0
    singles: int = 0
    promotions: int = 0          # programs promoted to the fused tier
    drains: int = 0
    max_batch_seen: int = 0
    signature_buckets: int = 0   # distinct group keys seen
    # -- resilience (PR 7) -------------------------------------------------
    retries: int = 0             # single-request re-executions after failure
    bisections: int = 0          # failed batches split to isolate poison
    recovered: int = 0           # requests served after >= 1 failure
    oracle_serves: int = 0       # requests served by the stepwise oracle tier
    demotions: int = 0           # tier steps down the fused->vm->oracle ladder
    quarantines: int = 0         # requests resolved with QuarantinedError
    quarantine_rejects: int = 0  # submissions rejected while quarantined
    breaker_opens: int = 0       # circuit-breaker open transitions
    breaker_skips: int = 0       # dispatches skipped because a breaker was open
    promotion_failures: int = 0  # fused-tier compiles that failed
    deadline_misses: int = 0     # requests resolved with DeadlineExceededError
    sheds: int = 0               # requests shed by the bounded admission queue
    audit_checked: int = 0       # served results integrity-audited
    audit_corrected: int = 0     # audited results replaced by the reference
    worker_restarts: int = 0     # background worker deaths survived
    worker_errors: int = 0       # serve-cycle failures caught by the backstop

    @property
    def batch_efficiency(self) -> float:
        """Mean requests per dispatch — the lane-saturation proxy."""
        return self.requests / self.dispatches if self.dispatches else 0.0


@dataclasses.dataclass
class _DispatchCtx:
    """Everything the recovery path needs to replay a group dispatch."""

    prog: tuple
    key: tuple                   # target-tagged signature bucket
    fused: Optional[CompiledProgram]
    routed_vm: bool


class MVEScheduler:
    """Multi-tenant MVE program scheduler with signature batching and
    self-healing failure semantics (module docstring; docs/SERVING.md).

    Parameters
    ----------
    cfg: machine config shared by every request (one lane geometry).
    mode: executor for the base tier (default ``"vm"``, the reference
        engine's default; this port's engine defaults to ``"fused"``).
    max_batch: largest fused-tier dispatch; groups beyond it are split.
    vm_max_batch: largest VM-tier dispatch (the reference's cap, kept).
    promote_after: submissions of one program after which it is compiled
        into the fused tier (``None`` disables promotion).
    background: serve from a worker thread (``max_wait_ms`` batching
        window) instead of explicit :meth:`drain` calls.
    max_queue: bound on the pending-request queue (``None`` = unbounded).
    admission: ``"block"`` (submit waits for space — needs a concurrent
        drainer, i.e. ``background=True`` or another thread calling
        :meth:`drain`) or ``"shed"`` (resolve immediately with
        ``QueueFullError``).
    default_deadline_s: deadline applied to submissions that do not pass
        their own (``None`` = no deadline).
    retry: :class:`~repro_torch.resilience.breaker.RetryPolicy` for failed
        single-request re-executions.
    breaker: :class:`~repro_torch.resilience.breaker.CircuitBreaker` keyed per
        ``(signature bucket, tier)``; open tiers are skipped (degradation
        ladder fused → vm → oracle).
    quarantine_cooldown_s: how long a poisoned program key is rejected
        before one probe submission is allowed again.
    audit_rate / audit_method / audit_seed: sampled integrity audit of
        served results (:class:`~repro_torch.resilience.audit.ResultAuditor`);
        rate 0 disables.
    injector: :class:`~repro_torch.resilience.faults.FaultInjector` executing a
        deterministic chaos plan against this scheduler's serve paths.
    device: where every tier executes (default ``cuda``; without a card
        that raises — pass ``"cpu"``).
    """

    def __init__(self, cfg: Optional[MVEConfig] = None,
                 mode: Optional[str] = None, max_batch: int = 16,
                 vm_max_batch: int = 4,
                 promote_after: Optional[int] = 2,
                 background: bool = False, max_wait_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 admission: str = "block",
                 default_deadline_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 quarantine_cooldown_s: float = 30.0,
                 audit_rate: float = 0.0,
                 audit_method: str = "cross",
                 audit_seed: int = 0,
                 injector=None, device=None):
        self.cfg = cfg or MVEConfig()
        self.mode = mode if mode is not None else "vm"
        self.device = resolve_device(device)
        #: host waits for the device: one per healthy drain cycle, plus
        #: one per recovery-path execution
        self.host_syncs = 0
        # Batch caps are floored to powers of two: dispatch stacks are
        # padded to the next power of two, so a non-pow2 cap would let a
        # padded dispatch exceed it.
        self.max_batch = _floor_pow2(max(1, int(max_batch)))
        self.vm_max_batch = _floor_pow2(max(1, int(vm_max_batch)))
        self.promote_after = promote_after
        self.max_wait_ms = max_wait_ms
        if admission not in ("block", "shed"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.max_queue = max_queue
        self.admission = admission
        self.default_deadline_s = default_deadline_s
        self.retry = retry or RetryPolicy()
        self.quarantine_cooldown_s = quarantine_cooldown_s
        self.stats = SchedulerStats()
        # Threshold > (1 + default max_retries): one permanently poisoned
        # request exhausting its per-tier retries must not open a breaker
        # that healthy siblings of the same signature bucket share.
        self._breaker = breaker or CircuitBreaker(threshold=5,
                                                  cooldown_s=5.0)
        self._injector = injector
        self._auditor = ResultAuditor(
            rate=audit_rate, seed=audit_seed, method=audit_method,
            injector=injector, device=self.device) \
            if audit_rate > 0.0 else None
        self._heartbeat = HeartbeatMonitor(hosts=[], timeout_s=10.0)
        self._stragglers = StragglerDetector(window=8)
        self._sleep = time.sleep           # patchable in tests
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._serve_lock = threading.Lock()      # drain() vs worker _serve
        self._pending: List[Ticket] = []
        # program key -> submissions (bounded LRU: promotion heat only)
        self._seen: "OrderedDict[Tuple, int]" = OrderedDict()
        self._promoted: "OrderedDict[Tuple, CompiledProgram]" = OrderedDict()
        self._quarantined: "OrderedDict[Tuple, float]" = OrderedDict()
        self._oracles: Dict[MVEConfig, object] = {}
        self._group_keys_seen = set()
        self._wake = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)  # queue has room
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        if background:
            self._worker = threading.Thread(
                target=self._worker_main, daemon=True, name="mve-scheduler")
            self._worker.start()

    # -- client API --------------------------------------------------------
    def _resolve_target(self, target) -> Tuple[MVEConfig, Optional[str]]:
        """(machine config, cache tag) for one submission's target.

        Unknown names raise :class:`~repro_torch.core.isa.ProgramError` naming
        every registered target; a target whose machine geometry cannot
        share this scheduler's lane/CB layout is rejected the same way —
        both used to surface as ``KeyError``-shaped internal failures.
        """
        if target is None:
            return self.cfg, None
        from .. import targets as _targets
        tgt = _targets.get_target(target)      # ProgramError when unknown
        cfg = tgt.machine_config(self.cfg)
        if (cfg.lanes, cfg.num_cbs) != (self.cfg.lanes, self.cfg.num_cbs):
            raise isa.ProgramError(
                f"target {tgt.name!r} needs machine geometry "
                f"(lanes={cfg.lanes}, cbs={cfg.num_cbs}) but this "
                f"scheduler batches for (lanes={self.cfg.lanes}, "
                f"cbs={self.cfg.num_cbs}); submit it to a scheduler "
                f"built with that geometry.  Registered targets: "
                f"{', '.join(_targets.list_targets())}")
        return cfg, tgt.name

    def submit(self, program: isa.Program, memory=None,
               target=None, deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue one program execution; returns a :class:`Ticket`.

        ``program`` is a raw instruction sequence plus a flat memory
        image, or a frontend :class:`~repro_torch.frontend.Kernel` plus a dict
        of named operand arrays (or nothing — declared inits apply);
        kernel submissions read results back by name through
        ``ticket.result().operands``.

        ``target`` selects a registered :mod:`repro_torch.targets` target (a
        name or instance).  Execution is bit-identical on every target —
        the scheduler's value per target is *bucketing*: requests are
        grouped per target (so per-target compilations never alias,
        ``cache_info().per_target``) and the resolved machine config
        rides on the ticket for downstream pricing.  Unknown or
        geometry-mismatched targets raise a
        :class:`~repro_torch.core.isa.ProgramError` naming the registered
        targets.

        ``deadline_s`` bounds this request's submit-to-resolution time
        (default: the scheduler's ``default_deadline_s``); past it the
        ticket resolves with ``DeadlineExceededError`` instead of
        retrying further.

        The returned ticket **always resolves** — with a
        :class:`ServeResult` or a typed
        :class:`~repro_torch.resilience.errors.SchedulerError`.

        Thread-safe; callable from any number of client threads.  In
        deterministic mode nothing runs until :meth:`drain`."""
        submitted_at = time.perf_counter()   # before the (cold) compile
        cfg, tag = self._resolve_target(target)
        kernel = None
        if hasattr(program, "plan") and hasattr(program, "program"):
            kernel = program
            if memory is None or isinstance(memory, dict):
                memory = kernel.pack(memory)  # named arrays / inits
            # else: an already-packed flat memory image — pass through
            program = kernel.program
        elif memory is None:
            raise TypeError("raw program submissions need a memory image")
        cp = compile_program(kernel or program, cfg, mode=self.mode,
                             cache_tag=tag, device=self.device)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        t = Ticket(next(self._rid), tuple(program), memory, cp,
                   submitted_at=submitted_at, kernel=kernel,
                   cfg=cfg, target=tag,
                   deadline=None if deadline_s is None
                   else submitted_at + deadline_s)
        with self._lock:
            if self._closed:
                raise SchedulerClosedError("scheduler is closed")
            if self.max_queue is not None:
                while len(self._pending) >= self.max_queue \
                        and not self._closed:
                    if self.admission == "shed":
                        self.stats.sheds += 1
                        t._resolve(error=QueueFullError(
                            f"admission queue full "
                            f"({self.max_queue} pending); request "
                            f"{t.rid} shed — back off and resubmit"))
                        return t
                    self._space.wait(timeout=0.05)
                if self._closed:
                    raise SchedulerClosedError("scheduler closed while "
                                               "waiting for queue space")
            self.stats.requests += 1
            pk = (t.program, cfg, tag)
            self._seen[pk] = self._seen.get(pk, 0) + 1
            self._seen.move_to_end(pk)
            while len(self._seen) > _SEEN_CAP:
                self._seen.popitem(last=False)
            self._pending.append(t)
            self._wake.notify()
        return t

    def submit_many(self, requests: Sequence[Tuple[isa.Program, object]]
                    ) -> List[Ticket]:
        return [self.submit(p, m) for p, m in requests]

    def drain(self) -> None:
        """Serve every pending request on the calling thread and return
        when all are resolved — the deterministic mode tests replay."""
        while True:
            with self._lock:
                batch, self._pending = self._pending, []
                self._space.notify_all()
            if not batch:
                return
            self._serve(batch)

    def close(self, drain: bool = True) -> None:
        """Shut down: stop the background worker, optionally serve what
        is still pending (``drain=True``, the default), then resolve
        every ticket that remains unresolved with a typed
        :class:`~repro_torch.resilience.errors.SchedulerClosedError` — no
        waiter is ever left hanging on a closed scheduler."""
        with self._lock:
            self._closed = True
            self._wake.notify_all()
            self._space.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
        if drain:
            self.drain()
        with self._lock:
            leftovers, self._pending = self._pending, []
        for t in leftovers:
            t._resolve(error=SchedulerClosedError(
                f"scheduler closed before request {t.rid} was served"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def cache_info(self):
        """The engine/VM compile-cache counters this scheduler feeds —
        promotion compiles land in the same program LRU, VM dispatches in
        the same signature-keyed executable cache
        (:func:`repro_torch.core.engine.cache_info`)."""
        return cache_info()

    def health(self) -> Dict:
        """One structured snapshot of the runtime's failure state:
        worker liveness/heartbeats, per-tier straggler flags, open
        circuit breakers, quarantine population, and the
        retry/shed/deadline/audit counters — the payload a mesh-level
        coordinator would scrape (ROADMAP device-mesh item)."""
        with self._lock:
            pending = len(self._pending)
            quarantined = len(self._quarantined)
            worker = self._worker
        st = self.stats
        snap = {
            "pending": pending,
            "closed": self._closed,
            "worker": {
                "alive": worker.is_alive() if worker is not None else None,
                "restarts": st.worker_restarts,
                "errors": st.worker_errors,
                "dead_hosts": self._heartbeat.dead_hosts(),
            },
            "stragglers": self._stragglers.stragglers(),
            "breakers": {"open": self._breaker.snapshot(),
                         "opens": st.breaker_opens,
                         "skips": st.breaker_skips},
            "quarantine": {"active": quarantined,
                           "total": st.quarantines,
                           "rejects": st.quarantine_rejects},
            "counters": {
                "requests": st.requests,
                "retries": st.retries,
                "bisections": st.bisections,
                "recovered": st.recovered,
                "oracle_serves": st.oracle_serves,
                "demotions": st.demotions,
                "deadline_misses": st.deadline_misses,
                "sheds": st.sheds,
                "promotion_failures": st.promotion_failures,
            },
            "audit": (self._auditor.counters()
                      if self._auditor is not None else None),
            "injected": (self._injector.counts()
                         if self._injector is not None else None),
        }
        return snap

    # -- background worker -------------------------------------------------
    def _worker_main(self) -> None:
        """Supervisor shell around :meth:`_serve_loop`: a worker death
        (injected or real) re-queues whatever the dead incarnation held
        and restarts the loop — zero orphaned tickets, invisible to
        clients."""
        while True:
            try:
                self._serve_loop()
                return                          # clean close
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException:
                with self._lock:
                    self.stats.worker_restarts += 1
                    if self._closed and not self._pending:
                        return
                continue

    def _serve_loop(self) -> None:
        while True:
            batch: List[Ticket] = []
            try:
                with self._lock:
                    while not self._pending and not self._closed:
                        self._wake.wait()
                    if self._closed and not self._pending:
                        return
                    deadline = time.perf_counter() + self.max_wait_ms / 1e3
                    # batching window: wait for more work until the window
                    # closes or a full batch is ready
                    while (len(self._pending) < self.max_batch
                           and not self._closed):
                        left = deadline - time.perf_counter()
                        if left <= 0 or not self._wake.wait(timeout=left):
                            break
                    batch, self._pending = self._pending, []
                    self._space.notify_all()
                self._heartbeat.beat(_WORKER_HOST)
                if self._injector is not None:
                    self._injector.worker_tick()   # may kill this worker
                if batch:
                    self._serve(batch)
            except InjectedWorkerDeath:
                # Simulated thread death: put the work back for the next
                # incarnation (the supervisor restarts us) and die.
                self._requeue(batch)
                raise
            except (KeyboardInterrupt, SystemExit) as e:
                # Re-raise after resolving: in-flight tickets must never
                # be dropped on the interpreter-shutdown path.
                self.stats.worker_errors += 1
                for t in batch:
                    t._resolve(error=WorkerDiedError(
                        f"serving worker interrupted "
                        f"({type(e).__name__})"))
                raise
            except BaseException as e:   # pragma: no cover - backstop
                # _serve() has its own per-ticket error handling; anything
                # that still escapes is an internal error — account for it
                # and resolve, never drop.
                self.stats.worker_errors += 1
                for t in batch:
                    t._resolve(error=e)

    def _requeue(self, batch: List[Ticket]) -> None:
        alive = [t for t in batch if not t.done()]
        if not alive:
            return
        with self._lock:
            self._pending[:0] = alive       # head: preserve arrival order
            self._wake.notify_all()

    # -- the scheduling core -----------------------------------------------
    def _serve(self, batch: List[Ticket]) -> None:
        """Group -> dispatch (async) -> finalize -> recover, one sync per
        healthy cycle.

        Serialized with ``_serve_lock``: an explicit :meth:`drain` racing
        the background worker must not interleave stats/promotion
        bookkeeping (each still serves only tickets it popped itself).
        The ``finally`` backstop upholds the resolution guarantee even
        against internal scheduler bugs."""
        with self._serve_lock:
            try:
                self._serve_locked(batch)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                self.stats.worker_errors += 1
                for t in batch:
                    t._resolve(error=e)
            finally:
                for t in batch:
                    if t._resolve(error=SchedulerError(
                            f"request {t.rid} fell through the serve "
                            f"cycle (internal scheduler error)")):
                        self.stats.worker_errors += 1

    def _serve_locked(self, batch: List[Ticket]) -> None:
        self.stats.drains += 1
        now = time.perf_counter()
        live: List[Ticket] = []
        for t in batch:
            if t.done():                    # cancelled / shed / pre-resolved
                continue
            if t.deadline is not None and now > t.deadline:
                self.stats.deadline_misses += 1
                t._resolve(error=DeadlineExceededError(
                    f"request {t.rid} missed its deadline before "
                    f"dispatch"))
                continue
            live.append(t)

        buckets: "OrderedDict[tuple, OrderedDict[tuple, List[Ticket]]]" = \
            OrderedDict()
        for t in live:
            # Per-target signature bucketing: the leading tag keeps one
            # target's groups from stacking with another's even when the
            # VM signature coincides (their cost models differ; pricing
            # rides on the ticket's target).
            key = (t.target,) + tuple(t.cp.batch_group_key(t.memory))
            gkey = (t.program, key)
            buckets.setdefault(key, OrderedDict()).setdefault(
                gkey, []).append(t)
            if len(self._group_keys_seen) < _BUCKET_STAT_CAP:
                self._group_keys_seen.add(key)
        self.stats.signature_buckets = len(self._group_keys_seen)

        inflight = []   # (ctx, tickets, tier, stage_thunk)
        for key, groups in buckets.items():
            # Same signature bucket back to back: every VM group replays
            # through the same signature-keyed executable while it is hot.
            # Only VM-routed requests (key[1], after the target tag) get
            # the VM-tier batch cap; fused-routed ones
            # (non-float32-canonical images, VM fallbacks) batch at the
            # full fused cap.
            routed_vm = key[1] == "vm"
            for (prog, _), tickets in groups.items():
                tickets = [t for t in tickets if not t.done()]
                if not tickets:
                    continue
                pk = (tickets[0].program, tickets[0].cfg,
                      tickets[0].target)
                if self._quarantine_active(pk):
                    self.stats.quarantine_rejects += len(tickets)
                    for t in tickets:
                        t._resolve(error=QuarantinedError(
                            f"request {t.rid}: program is quarantined "
                            f"after repeated failures (cooldown "
                            f"{self.quarantine_cooldown_s:.0f}s)"))
                    continue
                fused = self._promotable_safe(key, tickets[0])
                ctx = _DispatchCtx(prog=prog, key=key, fused=fused,
                                   routed_vm=routed_vm)
                btier = "fused" if fused is not None else tickets[0].cp.mode
                if not self._breaker.allow((key, btier)):
                    # Tier breaker open: skip the batched dispatch and
                    # walk each request down the degradation ladder.
                    self.stats.breaker_skips += 1
                    for t in tickets:
                        self._serve_one_resilient(ctx, t, None)
                    continue
                cap = self.vm_max_batch if routed_vm and fused is None \
                    else self.max_batch
                for chunk in _chunks(tickets, cap):
                    try:
                        inflight.append(
                            (ctx,) + self._dispatch(prog, chunk, fused,
                                                    routed_vm))
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except Exception as e:
                        self._failed_group(ctx, btier, chunk, e)

        # Every group's copy-back is enqueued behind its dispatch; the host
        # then waits once for the whole cycle and reads the copies.
        staged = []
        for ctx, tickets, tier, stage in inflight:
            btier = "fused" if ctx.fused is not None \
                else tickets[0].cp.mode
            t0 = time.perf_counter()
            try:
                staged.append((ctx, tickets, btier, stage(), t0))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                self._failed_group(ctx, btier, tickets, e)
        if staged:
            try:
                self._host_wait()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:       # an asynchronous device fault
                for ctx, tickets, btier, _, _ in staged:
                    self._failed_group(ctx, btier, tickets, e)
                staged = []
        for ctx, tickets, btier, finish, t0 in staged:
            try:
                results = finish()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                self._failed_group(ctx, btier, tickets, e)
                continue
            self._stragglers.record(btier, time.perf_counter() - t0)
            self._breaker.record_success((ctx.key, btier))
            for t, r in zip(tickets, results):
                t._resolve(result=r)

    def _failed_group(self, ctx: _DispatchCtx, btier: str,
                      tickets: List[Ticket], err: BaseException) -> None:
        """A group that failed to dispatch or finalize: a breaker failure
        against its tier, then the recovery ladder."""
        self._breaker.record_failure((ctx.key, btier)) and self._note_open()
        self._recover_group(ctx, [t for t in tickets if not t.done()], err)

    # -- the device boundary -----------------------------------------------
    def _upload(self, memory) -> torch.Tensor:
        """One image or a stacked batch on this scheduler's device, in its
        canonical element type (converted on the host, as the reference
        converts), copied from pinned memory without blocking."""
        host = as_memory(memory, "cpu")
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, pending, trace: bool):
        """Enqueue the copy-back of a dispatch's results (``pending`` of
        ``run_async``/``run_batch_async``) without blocking; returns the
        same handle over host tensors, readable after :meth:`_host_wait`.
        ``trace``: also the random-base addresses a single run's trace
        needs."""
        kind, (mem, regs, tag, rand) = pending
        if self.device.type != "cuda":
            return pending
        keys = list(regs)
        rand = list(rand) if trace else []
        host = [x.to("cpu", non_blocking=True)
                for x in [mem, tag] + [regs[k] for k in keys] + rand]
        return kind, (host[0], dict(zip(keys, host[2:2 + len(keys)])),
                      host[1], host[2 + len(keys):])

    def _host_wait(self) -> None:
        """Block until the device has finished everything enqueued so far
        (the cycle's dispatches and copy-backs)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            self.host_syncs += 1

    def _complete(self, stage) -> List[ServeResult]:
        """A dispatch's results now: stage, wait, finish (recovery paths)."""
        finish = stage()
        self._host_wait()
        return finish()

    def _host_state(self, mem, regs, tag):
        """Device results as host NumPy arrays, after one wait."""
        _, (mem, regs, tag, _) = self._stage(("", (mem, regs, tag, [])),
                                             trace=False)
        self._host_wait()
        return (self._numpy(mem),
                {r: self._numpy(v) for r, v in regs.items()},
                self._numpy(tag))

    def _numpy(self, x) -> np.ndarray:
        """A staged result as a NumPy array the caller owns.  Copy-backs
        land in pinned memory, which a served result must not hold: the
        copy hands it back to the host allocator's cache for the next
        cycle instead of pinning fresh memory every cycle."""
        a = to_numpy(x)
        return a.copy() if self.device.type == "cuda" else a

    def _promotable_safe(self, key, ticket) -> Optional[CompiledProgram]:
        """:meth:`_promotable` behind the fused-tier breaker: a failed
        promotion compile is a tier failure, not a request failure — the
        group still serves on its base tier."""
        if self.promote_after is None or ticket.cp.mode == "fused":
            return None
        if not self._breaker.allow((key, "fused")):
            self.stats.breaker_skips += 1
            return None
        try:
            return self._promotable(ticket)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            self.stats.promotion_failures += 1
            self._breaker.record_failure((key, "fused")) and \
                self._note_open()
            return None

    def _note_open(self) -> bool:
        self.stats.breaker_opens += 1
        return True

    # -- recovery ladder ---------------------------------------------------
    def _recover_group(self, ctx: _DispatchCtx, tickets: List[Ticket],
                       err: Optional[BaseException]) -> None:
        """Bisect a failed group until the poison is isolated: clean
        halves re-dispatch *batched* (shielded from one-shot injected
        faults — the retry semantics), single failures walk the
        per-request resilient path."""
        tickets = [t for t in tickets if not t.done()]
        if not tickets:
            return
        if len(tickets) == 1:
            self._serve_one_resilient(ctx, tickets[0], err)
            return
        self.stats.bisections += 1
        mid = len(tickets) // 2
        for half in (tickets[:mid], tickets[mid:]):
            try:
                _, tier, stage = self._dispatch(ctx.prog, half, ctx.fused,
                                                ctx.routed_vm, shielded=True)
                results = self._complete(stage)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                self._recover_group(ctx, half, e)
                continue
            for t, r in zip(half, results):
                if t._resolve(result=r):
                    self.stats.recovered += 1

    def _serve_one_resilient(self, ctx: _DispatchCtx, t: Ticket,
                             first_err: Optional[BaseException]) -> None:
        """Serve one request through the degradation ladder
        fused → vm → stepwise oracle, with bounded retry + backoff per
        tier, deadline checks before every attempt, and quarantine as
        the end state."""
        if t.done():
            return
        last = first_err
        attempts = 0
        ladder: List[Tuple[str, Optional[CompiledProgram]]] = []
        if ctx.fused is not None:
            ladder.append(("fused", ctx.fused))
        if t.cp.mode not in [name for name, _ in ladder]:
            ladder.append((t.cp.mode, t.cp))
        ladder.append(("oracle", None))
        for tier, runner in ladder:
            bkey = (ctx.key, tier)
            if tier != "oracle" and not self._breaker.allow(bkey):
                self.stats.breaker_skips += 1
                self.stats.demotions += 1       # skipped == stepped down
                continue
            for delay in itertools.chain([0.0], self.retry.delays()):
                if delay > 0:
                    self._sleep(delay)
                if t.done():
                    return
                if t.deadline is not None \
                        and time.perf_counter() > t.deadline:
                    self.stats.deadline_misses += 1
                    t._resolve(error=DeadlineExceededError(
                        f"request {t.rid} exceeded its deadline after "
                        f"{attempts} recovery attempt(s)"))
                    return
                attempts += 1
                if attempts > 1 or first_err is not None:
                    self.stats.retries += 1
                try:
                    r = self._run_single(ctx, t, tier, runner)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    last = e
                    if tier != "oracle":
                        if self._breaker.record_failure(bkey):
                            self._note_open()
                            break           # tier just opened: demote now
                    continue
                if tier != "oracle":
                    self._breaker.record_success(bkey)
                if t._resolve(result=r):
                    if first_err is not None or attempts > 1:
                        self.stats.recovered += 1
                return
            self.stats.demotions += 1
        # Every tier (oracle included) failed: isolate the poison.
        self._quarantine_request(ctx, t, last, attempts)

    def _run_single(self, ctx: _DispatchCtx, t: Ticket, tier: str,
                    runner: Optional[CompiledProgram]) -> ServeResult:
        """One shielded single-request execution on a given tier.

        Shielded = one-shot injected faults do not re-fire (a retry runs
        on a fresh resource), but rid-bound *sticky* faults — the model
        of a permanently poisoned request — still do."""
        inj = self._injector
        if inj is not None:
            inj.dispatch([t.rid], tier, shielded=True)
        self.stats.dispatches += 1
        self.stats.singles += 1
        self.stats.max_batch_seen = max(self.stats.max_batch_seen, 1)
        if tier == "oracle":
            self.stats.oracle_serves += 1
            mem_i, st_i = self._oracle(t.cfg).run_stepwise(
                list(t.program), t.memory)
            mem, regs, tag = self._host_state(mem_i, st_i.regs, st_i.tag)
            return ServeResult(
                memory=mem, regs=regs, tag=tag, batch_size=1,
                tier="oracle", trace=st_i.trace, kernel=t.kernel)
        if inj is not None:
            with inj.suspended():           # recovery path is shielded
                mem_j, state = runner.run(self._upload(t.memory))
        else:
            mem_j, state = runner.run(self._upload(t.memory))
        mem, regs, tag = self._host_state(mem_j, state.regs, state.tag)
        if self._auditor is not None and self._auditor.should_audit(t.rid):
            self.stats.audit_checked += 1
            ref = self._auditor.check(t.program, t.memory, t.cfg, mem,
                                      tag, runner.mode)
            if ref is not None:
                self.stats.audit_corrected += 1
                self._breaker.record_failure((ctx.key, tier)) and \
                    self._note_open()
                mem, regs, tag = ref
        return ServeResult(memory=mem, regs=regs, tag=tag, batch_size=1,
                           tier="single", trace=state.trace,
                           kernel=t.kernel)

    def _oracle(self, cfg: MVEConfig):
        o = self._oracles.get(cfg)
        if o is None:
            from ..core.interp import MVEInterpreter
            o = self._oracles[cfg] = MVEInterpreter(cfg, compiled=False,
                                                    device=self.device)
        return o

    # -- quarantine --------------------------------------------------------
    def _quarantine_active(self, pk) -> bool:
        with self._lock:
            ts = self._quarantined.get(pk)
            if ts is None:
                return False
            if time.monotonic() - ts >= self.quarantine_cooldown_s:
                del self._quarantined[pk]   # parole: allow one probe
                return False
            return True

    def _quarantine_request(self, ctx: _DispatchCtx, t: Ticket,
                            last: Optional[BaseException],
                            attempts: int) -> None:
        pk = (t.program, t.cfg, t.target)
        with self._lock:
            self._quarantined[pk] = time.monotonic()
            self._quarantined.move_to_end(pk)
            while len(self._quarantined) > _QUARANTINE_CAP:
                self._quarantined.popitem(last=False)
        self.stats.quarantines += 1
        err = QuarantinedError(
            f"request {t.rid} failed on every tier after {attempts} "
            f"attempt(s); program quarantined for "
            f"{self.quarantine_cooldown_s:.0f}s "
            f"(last error: {type(last).__name__ if last else 'n/a'}: "
            f"{last})", attempts=attempts)
        err.__cause__ = last
        t._resolve(error=err)

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, prog: tuple, tickets: List[Ticket], fused,
                  routed_vm: bool = True, shielded: bool = False):
        """Launch one group asynchronously; returns ``(tickets, tier,
        stage)``: ``stage()`` enqueues the copy-back and returns the
        ``finish()`` thunk that, after :meth:`_host_wait`, finalizes the
        dispatch and builds the results."""
        cp = tickets[0].cp
        btier = "fused" if fused is not None else cp.mode
        inj = self._injector
        rids = [t.rid for t in tickets]
        if inj is not None:
            inj.dispatch(rids, btier, shielded=shielded)
        n = len(tickets)
        auditor = self._auditor
        if n == 1:
            # Singleton: skip the batch axis (and get the exact
            # random-access trace via finalize_run).
            runner = fused if fused is not None else cp
            pending = runner.run_async(self._upload(tickets[0].memory))
            self.stats.dispatches += 1
            self.stats.singles += 1
            self.stats.max_batch_seen = max(self.stats.max_batch_seen, 1)

            def stage_single():
                staged = self._stage(pending, trace=True)
                return lambda: fin_single(staged)

            def fin_single(staged):
                mem, state = runner.finalize_run(staged)
                mem = self._numpy(mem)
                regs = {r: self._numpy(v) for r, v in state.regs.items()}
                tag = self._numpy(state.tag)
                if inj is not None and not shielded:
                    mem = inj.finalize(rids, btier, mem)
                if auditor is not None \
                        and auditor.should_audit(tickets[0].rid):
                    self.stats.audit_checked += 1
                    ref = auditor.check(tickets[0].program,
                                        tickets[0].memory, tickets[0].cfg,
                                        mem, tag, runner.mode)
                    if ref is not None:
                        self.stats.audit_corrected += 1
                        self._breaker.record_failure(
                            (ticket_key(tickets[0]), btier)) and \
                            self._note_open()
                        mem, regs, tag = ref
                return [ServeResult(memory=mem,
                                    regs=regs, tag=tag,
                                    batch_size=1, tier="single",
                                    trace=state.trace,
                                    kernel=tickets[0].kernel)]
            return tickets, "single", stage_single

        runner = fused if fused is not None else cp
        tier = "vm" if fused is None and routed_vm else "fused"
        # Pad the stack to a power of two so each program compiles at most
        # log2(max_batch) batched executables; padded rows replay the
        # first request's image and are dropped after the dispatch.
        bucket = next_pow2(n)
        mems = [np.asarray(t.memory) for t in tickets]
        stacked = np.stack(mems + [mems[0]] * (bucket - n))
        pending = runner.run_batch_async(self._upload(stacked))
        self.stats.dispatches += 1
        self.stats.batched_requests += n
        self.stats.max_batch_seen = max(self.stats.max_batch_seen, n)
        if tier == "fused":
            self.stats.fused_batches += 1
        else:
            self.stats.vm_batches += 1

        def stage_batch():
            staged = self._stage(pending, trace=False)
            return lambda: fin_batch(staged)

        def fin_batch(staged):
            mem, regs, tag = runner.finalize_batch(staged)
            # One device->host transfer per array (not per request): the
            # per-request views below slice host memory.
            mem = self._numpy(mem)
            tag = self._numpy(tag)
            regs = {r: self._numpy(v) for r, v in regs.items()}
            if inj is not None and not shielded:
                rows = {t.rid: b for b, t in enumerate(tickets)}
                mem = inj.finalize(rids, btier, mem, rows)

            def trace_fn():
                # Deferred static_trace access too: unread traces cost
                # nothing on the dispatch hot path.
                return [dataclasses.replace(ev) for ev in cp.static_trace]

            out = []
            for b in range(n):
                t = tickets[b]
                rmem = mem[b]
                rregs = {r: v[b] for r, v in regs.items()}
                rtag = tag[b]
                if auditor is not None and auditor.should_audit(t.rid):
                    self.stats.audit_checked += 1
                    ref = auditor.check(t.program, t.memory, t.cfg,
                                        rmem, rtag, runner.mode)
                    if ref is not None:
                        self.stats.audit_corrected += 1
                        self._breaker.record_failure(
                            (ticket_key(t), btier)) and self._note_open()
                        rmem, rregs, rtag = ref
                out.append(ServeResult(
                    memory=rmem, regs=rregs, tag=rtag,
                    batch_size=n, tier=tier,
                    trace_fn=trace_fn, kernel=t.kernel))
            return out
        return tickets, tier, stage_batch

    def _promotable(self, ticket: Ticket) -> Optional[CompiledProgram]:
        """The fused-tier executable for a hot program, compiling it on
        first promotion; ``None`` while the program stays in the VM tier
        (or when promotion is off / the program already runs fused).
        Promotion heat and the fused compilation are both per
        ``(program, config, target)`` — one target's promotion never
        serves (or evicts) another's."""
        cp = ticket.cp
        if self.promote_after is None or cp.mode == "fused":
            return None
        pk = (ticket.program, ticket.cfg, ticket.target)
        hot = self._promoted.get(pk)
        if hot is not None:
            self._promoted.move_to_end(pk)
            return hot
        if self._seen.get(pk, 0) < self.promote_after:
            return None
        if self._injector is not None:
            self._injector.compile([ticket.rid], tier="fused")
        hot = compile_program(list(pk[0]), ticket.cfg, mode="fused",
                              cache_tag=ticket.target, device=self.device)
        self._promoted[pk] = hot
        while len(self._promoted) > _PROMOTED_CAP:
            self._promoted.popitem(last=False)
        self.stats.promotions += 1
        return hot


def ticket_key(t: Ticket) -> tuple:
    """The target-tagged signature bucket a ticket groups under."""
    return (t.target,) + tuple(t.cp.batch_group_key(t.memory))


def _chunks(seq: List, n: int):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def _floor_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)
