"""Circuit breaking and bounded retry for the serving runtime.

Small, deterministic, clock-injectable policy objects — the scheduler
composes them, tests drive them with fake clocks.

* :class:`CircuitBreaker` — classic three-state breaker keyed by an
  arbitrary hashable (the scheduler keys per ``(signature bucket,
  target, tier)``): ``closed`` serves normally, ``threshold``
  consecutive failures **open** it (callers skip the tier — graceful
  degradation), and after ``cooldown_s`` it goes **half-open**, letting
  one probe through; a probe success closes it, a probe failure re-opens
  the cooldown window.
* :class:`RetryPolicy` — bounded retry with exponential backoff;
  ``delays()`` yields the sleep before each retry, so the total added
  latency is a closed-form bound the deadline checker can reason about.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable, Iterator, List, Tuple

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-key failure breaker (see module docstring).

    ``allow(key)`` is the gate: ``True`` while closed — and exactly once
    per cooldown window while open (the half-open probe).  Record the
    outcome of every allowed attempt via ``record_success`` /
    ``record_failure``.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        # key -> [consecutive_failures, opened_at | None, probing]
        self._state: Dict[Hashable, List] = {}
        self.opens = 0           # lifetime open transitions (stats)

    def allow(self, key: Hashable) -> bool:
        with self._lock:
            st = self._state.get(key)
            if st is None or st[1] is None:
                return True
            if st[2]:                       # a probe is already out
                return False
            if self.clock() - st[1] >= self.cooldown_s:
                st[2] = True                # half-open: let one probe through
                return True
            return False

    def record_success(self, key: Hashable) -> None:
        with self._lock:
            self._state.pop(key, None)      # fully closed + forgotten

    def record_failure(self, key: Hashable) -> bool:
        """Returns ``True`` when this failure opened (or re-opened) the
        breaker."""
        with self._lock:
            st = self._state.setdefault(key, [0, None, False])
            st[0] += 1
            if st[2] or (st[1] is None and st[0] >= self.threshold):
                st[1], st[2] = self.clock(), False
                self.opens += 1
                return True
            return False

    def state(self, key: Hashable) -> str:
        with self._lock:
            st = self._state.get(key)
            if st is None or st[1] is None:
                return CLOSED
            if st[2] or self.clock() - st[1] >= self.cooldown_s:
                return HALF_OPEN
            return OPEN

    def snapshot(self) -> Dict[str, str]:
        """Non-closed breakers as ``{str(key): state}`` (health payload)."""
        with self._lock:
            keys = list(self._state)
        out = {}
        for k in keys:
            s = self.state(k)
            if s != CLOSED:
                out[str(k)] = s
        return out


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff.

    ``max_retries`` is the number of *re*-executions after the first
    attempt; ``delays()`` yields the pre-retry sleeps:
    ``backoff_s * factor**i`` for ``i in range(max_retries)``.
    """

    max_retries: int = 2
    backoff_s: float = 0.001
    factor: float = 2.0

    def delays(self) -> Iterator[float]:
        for i in range(self.max_retries):
            yield self.backoff_s * (self.factor ** i)

    @property
    def worst_case_sleep_s(self) -> float:
        return sum(self.delays())
