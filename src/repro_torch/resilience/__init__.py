"""repro_torch.resilience — fault injection, breakers, retries, result audit.

The failure-semantics layer under the serving runtime
(:mod:`repro_torch.runtime.scheduler` composes these; docs/SERVING.md
"Failure semantics" is the design note):

* :mod:`~repro_torch.resilience.faults` — deterministic, replayable fault
  injection (:class:`FaultPlan` / :class:`FaultInjector`): compile and
  dispatch errors, artificial straggler latency, SRAM-model memory
  bit-flips, worker-thread death.
* :mod:`~repro_torch.resilience.breaker` — :class:`CircuitBreaker` (per
  signature x target x tier) and :class:`RetryPolicy` (bounded,
  exponential backoff).
* :mod:`~repro_torch.resilience.audit` — :class:`ResultAuditor`, the sampled
  bit-exact re-execution check that catches silent corruption.
* :mod:`~repro_torch.resilience.errors` — the typed error vocabulary every
  ticket resolves with when it cannot resolve with a result.
"""
from .audit import ResultAuditor  # noqa: F401
from .breaker import CircuitBreaker, RetryPolicy  # noqa: F401
from .errors import (CancelledError, DeadlineExceededError,  # noqa: F401
                     InjectedFault, InjectedWorkerDeath, QueueFullError,
                     QuarantinedError, SchedulerClosedError, SchedulerError,
                     WorkerDiedError)
from .faults import FaultInjector, FaultPlan, FaultSpec  # noqa: F401
