"""Typed failure vocabulary for the serving runtime.

Every :meth:`~repro_torch.runtime.scheduler.MVEScheduler.submit` resolves with
a result **or one of these errors** — never a bare ``RuntimeError`` from
three frames inside an executor, and never a waiter left hanging on an
orphaned ticket.  Clients branch on the type:

==========================  ==============================================
error                        meaning / recommended client action
==========================  ==============================================
``SchedulerClosedError``     scheduler shut down before (or while) the
                             request was in flight — resubmit elsewhere
``CancelledError``           the client cancelled the ticket
``DeadlineExceededError``    retries/backoff could not finish before the
                             request deadline — the request *may* be
                             retried with a fresher deadline
``QueueFullError``           shed by the bounded admission queue
                             (backpressure) — back off and resubmit
``QuarantinedError``         the request (or its program) keeps poisoning
                             dispatches on every tier; it is isolated so
                             the rest of the batch serves.  Carries the
                             final underlying error as ``__cause__``
``WorkerDiedError``          the serving worker died while the request
                             was in hand and could not be recovered
==========================  ==============================================

The executor-level types (:class:`repro_torch.core.engine.ExecutorError` and
its ``CompileError`` / ``DispatchError`` / ``FinalizeError`` subclasses)
classify *where* inside the execution stack a failure surfaced; the
scheduler consumes those internally — what escapes to a client is always
one of the types above, or the executor error itself once every tier and
retry is exhausted.
"""
from __future__ import annotations


class SchedulerError(RuntimeError):
    """Base of every typed serving-runtime failure."""


class SchedulerClosedError(SchedulerError):
    """The scheduler was closed; the request was resolved, not served."""


class CancelledError(SchedulerError):
    """The client cancelled the ticket before it was served."""


class DeadlineExceededError(SchedulerError):
    """The per-request deadline passed before a successful dispatch."""


class QueueFullError(SchedulerError):
    """Bounded admission queue is full and the policy is ``"shed"``."""


class QuarantinedError(SchedulerError):
    """The request failed on every tier and was quarantined.

    ``attempts`` counts executions tried across tiers/retries; the last
    underlying failure is chained as ``__cause__``.
    """

    def __init__(self, msg: str, attempts: int = 0):
        super().__init__(msg)
        self.attempts = attempts


class WorkerDiedError(SchedulerError):
    """The background worker died with this request in hand."""


class InjectedFault(RuntimeError):
    """An error deliberately raised by the fault injector (chaos runs).

    Deliberately *not* a :class:`SchedulerError`: injected faults model
    infrastructure failures (a flaky executor, a dying thread), so the
    scheduler must classify and recover from them exactly as it would
    from the real thing.
    """


class InjectedWorkerDeath(InjectedFault):
    """Injected death of the serving worker thread (supervisor test)."""
