"""Host spans, and the device trace of a traced slice of the window.

Spans are the benchmark's own: host clock around its calls into each layer
of the program, kept in memory.  The device side comes from
``torch.profiler`` (CUPTI): every kernel, copy and set on the card, with its
start and end, reduced to a :class:`TraceSummary` as soon as the profiler
stops.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


class Spans:
    """Host-clock spans by name, in seconds."""

    def __init__(self) -> None:
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> Optional[float]:
        xs = self.seconds.get(name)
        return sum(xs) / len(xs) * 1e3 if xs else None


@dataclasses.dataclass
class TraceSummary:
    """What the traced slice showed: the slice's length and the seconds in
    which some device operation ran (the union of their intervals), device
    seconds and count by operation name, and the longest idle gaps named by
    the innermost host operation running when each began."""
    window_s: float
    busy_s: float
    device_ops: Dict[str, Tuple[float, int]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.device_ops.values())

    def seconds_of(self, parts: Tuple[str, ...]) -> float:
        """Device seconds of the operations whose name holds one of
        ``parts`` (kernel names come demangled: ``void name<...>(...)``)."""
        return sum(s for name, (s, _) in self.device_ops.items()
                   if any(p in name for p in parts))

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[name, s] for name, (s, _) in top],
                "idle_gaps": [[name, s] for name, s in self.idle_gaps[:TOP]]}


def _is_device(ev) -> bool:
    """A kernel, copy or set on the device; not the device-side copy of a
    host annotation (``record_function``), which spans the work it
    names."""
    return (ev.device_type.name != "CPU"
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("portbench."))


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce a profiler's events (``prof.events()``) to a summary."""
    device, host = [], []
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if _is_device(ev):
            device.append((start, end, ev.name))
        elif ev.device_type.name == "CPU" and end > start:
            host.append((start, end, ev.name))
    ops: Dict[str, List[float]] = {}
    for start, end, name in device:
        acc = ops.setdefault(name, [0.0, 0])
        acc[0] += (end - start) * 1e-6
        acc[1] += 1
    device.sort()
    busy, gaps = 0.0, []
    cur_start = cur_end = None
    for start, end, _ in device:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
                gaps.append((start - cur_end, cur_end))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps[:TOP]:
        # the innermost host operation running when the gap began
        best = None
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            h0, h1, name = host[i]
            if h1 > at:
                best = name
                break
        named.append((best or "(no host operation)", length * 1e-6))
    return TraceSummary(window_s, busy * 1e-6,
                        {k: (v[0], int(v[1])) for k, v in ops.items()},
                        named)


class DeviceTrace:
    """A ``torch.profiler`` session over one slice of work: ``start()``,
    the work, ``stop()`` (which waits for the device and reduces the
    trace).  Without ``host`` only the device's activity is recorded,
    which leaves the host's pace nearly as it is untraced; with it every
    host operation is recorded too, to name what the host did in each
    idle gap."""

    def __init__(self, host: bool = False) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] if host else []
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities or [ProfilerActivity.CPU])
        self._t0 = 0.0

    def start(self) -> None:
        synchronize()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> TraceSummary:
        synchronize()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        summary = summarize(self._prof.events(), window)
        self._prof = None
        return summary


def traced(step, units: int, naming_units: int) -> TraceSummary:
    """The device trace of ``units`` calls of ``step`` (each ending with
    the work drained), its idle gaps named from a second, host-recorded
    trace of ``naming_units`` more calls."""
    trace = DeviceTrace()
    trace.start()
    for _ in range(units):
        step()
    summary = trace.stop()
    naming = DeviceTrace(host=True)
    naming.start()
    for _ in range(naming_units):
        step()
    summary.idle_gaps = naming.stop().idle_gaps
    return summary


class Marker:
    """A point in the device's queue: ``wait()`` blocks until the device
    has passed it (on the CPU, where work is done when enqueued, at
    once)."""

    def __init__(self, device: torch.device) -> None:
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()


def synchronize(device: Optional[torch.device] = None) -> None:
    """Wait for ``device`` (by default every CUDA device there is)."""
    if device is None and torch.cuda.is_available():
        torch.cuda.synchronize()
    elif device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_memory_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
