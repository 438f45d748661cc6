"""Cluster-health runtime: heartbeats, straggler detection, elastic plans.

On a real multi-host deployment these observers run on the coordinator
(host 0) next to the JAX distributed service; here they are fully
deterministic, clock-injectable components with unit tests, wired into
``launch/train.py``:

  * ``HeartbeatMonitor`` — hosts report each step; silence beyond a
    timeout marks the host dead and triggers a restart-from-checkpoint
    decision (fail-stop model, the standard for TPU pods).
  * ``StragglerDetector`` — robust (median/MAD) per-host step-time outlier
    detection; persistent stragglers are proposed for eviction rather than
    letting them gate every synchronous step.
  * ``plan_elastic_remesh`` — given survivors, picks the largest
    supported (pods, data, model) mesh <= available chips and the
    checkpoint resharding plan (keep TP extent, shrink DP — gradients
    stay correct under data-parallel rescaling).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self._last: Dict[str, float] = {h: now for h in hosts}
        self._dead: set = set()

    def beat(self, host: str) -> None:
        if host in self._dead:
            self._dead.discard(host)       # host came back (restart)
        self._last[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        for h, t in self._last.items():
            if now - t > self.timeout_s:
                self._dead.add(h)
        return sorted(self._dead)

    def healthy(self) -> bool:
        return not self.dead_hosts()


class StragglerDetector:
    """Flags hosts whose step time is a robust outlier for several
    consecutive windows (mitigation: eviction or re-balancing)."""

    def __init__(self, window: int = 8, mad_threshold: float = 4.0,
                 persistence: int = 3):
        self.window = window
        self.mad_threshold = mad_threshold
        self.persistence = persistence
        self._times: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._flags: Dict[str, int] = defaultdict(int)

    def record(self, host: str, step_time_s: float) -> None:
        self._times[host].append(step_time_s)

    def stragglers(self) -> List[str]:
        meds = {h: float(np.median(t)) for h, t in self._times.items()
                if len(t) >= self.window // 2}
        if len(meds) < 3:
            return []
        vals = np.array(list(meds.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        out = []
        for h, v in meds.items():
            if (v - med) / mad > self.mad_threshold:
                self._flags[h] += 1
            else:
                self._flags[h] = 0
            if self._flags[h] >= self.persistence:
                out.append(h)
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    pods: int
    data: int
    model: int
    dropped_chips: int

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_elastic_remesh(available_chips: int, model_parallel: int = 16,
                        chips_per_pod: int = 256) -> ElasticPlan:
    """Largest (pod, data, model) mesh that fits the survivors.

    TP extent is preserved (parameter shardings stay valid); the DP extent
    shrinks to the largest power-of-two of surviving chips; whole pods are
    preferred so the pod axis keeps its DCN meaning.
    """
    if available_chips < model_parallel:
        raise ValueError("not enough chips for one model-parallel group")
    pods = max(1, available_chips // chips_per_pod)
    while pods > 1:
        if pods * chips_per_pod <= available_chips:
            break
        pods -= 1
    per_pod = available_chips // pods
    data = 1
    while data * 2 * model_parallel <= per_pod:
        data *= 2
    used = pods * data * model_parallel
    return ElasticPlan(pods=pods, data=data, model=model_parallel,
                       dropped_chips=available_chips - used)
