"""Runtime substrate: serving scheduler, health, stragglers, elasticity.

The typed errors a scheduler ticket can resolve with live in
:mod:`repro_torch.resilience` and are re-exported here for serving callers.
"""
from ..resilience.errors import (CancelledError,  # noqa: F401
                                 DeadlineExceededError, QuarantinedError,
                                 QueueFullError, SchedulerClosedError,
                                 SchedulerError, WorkerDiedError)
from .health import (ElasticPlan, HeartbeatMonitor,  # noqa: F401
                     StragglerDetector, plan_elastic_remesh)
from .scheduler import (MVEScheduler, SchedulerStats,  # noqa: F401
                        ServeResult, Ticket)
