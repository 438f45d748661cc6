"""Spans of the port: where its host and device time go.

A span is a named interval of the host's clock, entered with
``with span(name):``.  It records its count, its total seconds and its self
seconds (the total less the spans opened inside it), and the span it opened
in.  ``span(name, device=True)`` also records a pair of
``torch.cuda.Event``\\ s on the current stream, resolved into device seconds
only by :func:`snapshot`.  Each span instance is summed into the record of
its *root*, the outermost span open when it began; a root instance stands
for one unit of work (a batch, a step), so a reader takes medians over
instances.

Each thread has its own open spans, so threads that run at once (a
scheduler's worker beside its caller) keep their roots apart.  Autograd
runs a CUDA backward on a thread of its own while the thread that called it
waits; a span that thread opens inside the backward joins the waiting
thread's open spans, so that a step's backward and recompute land in the
step.  The waiting thread is the one whose ``grad=True`` span's backward
(below) ran first in that backward, or else the one thread with spans
open.

Spans record while :func:`enable` is in force or while a ``torch.profiler``
session records host operations (``ProfilerActivity.CPU``).  A session
that records the device alone is left as it is: its host keeps its pace.
Under a host-recording session a span also enters
``_RecordFunctionFast("repro_torch.<name>")``, so that the profile shows
the program's spans beside the host operations, on the clock of the
device's events.  Otherwise a span costs one check and records nothing;
code that opens a span per step checks :func:`recording` once per call and
skips the ``with``.

Names:

* a span entered while autograd runs a backward (a checkpointed region's
  recompute) is recorded as ``<name>.recompute``;
* ``span(name, device=True, grad=True)`` labels the region's backward too,
  as ``<name>.backward``: the region passes its inputs through
  ``s.inputs(...)`` and its result through ``s.output(...)``, identity
  functions whose backwards close and open that span.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity

PREFIX = "repro_torch."


class Stat(NamedTuple):
    """One name's numbers within one root instance: instances, host
    seconds in all and without child spans, device seconds (``None``
    where no device time was taken), and the span it opened in."""
    count: int
    host_s: float
    self_s: float
    device_s: Optional[float]
    parent: Optional[str]


@dataclasses.dataclass(eq=False)
class _Open:
    """A span that has begun and not ended."""
    name: str
    parent: Optional["_Open"]
    stack: List["_Open"]             # the open spans it is one of
    record: Dict[str, list]          # its root instance's record
    t0: float
    rf: object = None                # the profiler's range, if any
    start: object = None             # the device start event
    child_s: float = 0.0


def in_backward() -> bool:
    """Whether autograd runs a backward on this thread now (a checkpointed
    region's forward is then its recompute)."""
    return torch._C._current_graph_task_id() != -1


class _Recorder:
    """What the process has recorded: each thread's open spans, each
    root's instances and the device events not yet resolved."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.stacks: Dict[int, List[_Open]] = {}      # by thread
        self.lent: Dict[int, List[_Open]] = {}        # by backward
        self.roots: Dict[str, List[Dict[str, list]]] = {}
        # (stat, start, end, the events to reuse once it is resolved)
        self.pending = collections.deque()
        self.pool: List[torch.cuda.Event] = []
        self.enabled = 0
        # whether the profiler session last started records host
        # operations; until one is seen starting, any session is taken to
        self.host_profiled = True

    def stack(self) -> List[_Open]:
        """The open spans that a span begun now on this thread joins (see
        the module's docstring)."""
        tid = threading.get_ident()
        own = self.stacks.get(tid)
        if own:
            return own
        if in_backward():
            lent = self.lent.get(torch._C._current_graph_task_id())
            if lent is None:
                waiting = [s for t, s in self.stacks.items() if s and t != tid]
                lent = waiting[0] if len(waiting) == 1 else None
            if lent is not None:
                return lent
        return self.stacks.setdefault(tid, [])

    def _event(self):
        if not self.pool:
            # reuse the events the device has passed, oldest first
            while self.pending and self.pending[0][2].query():
                self._resolve(*self.pending.popleft())
        ev = self.pool.pop() if self.pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _resolve(self, stat, start, end, free) -> None:
        end.synchronize()
        stat[3] = (stat[3] or 0.0) + start.elapsed_time(end) * 1e-3
        self.pool += free

    def open(self, name: str, device: bool, start=None,
             stack: Optional[List[_Open]] = None) -> _Open:
        """Begin a span on this thread's open spans, or on ``stack`` (which
        a backward running now then lends to this thread's later spans)."""
        with self.lock:
            if stack is None:
                stack = self.stack()
            elif in_backward():
                self.lent[torch._C._current_graph_task_id()] = stack
            parent = stack[-1] if stack else None
            if parent is None:
                record: Dict[str, list] = {}
                self.roots.setdefault(name, []).append(record)
            else:
                record = parent.record
            span = _Open(name, parent, stack, record, 0.0)
            stack.append(span)
            if _profiler._is_profiler_enabled and self.host_profiled:
                span.rf = _RecordFunctionFast(PREFIX + name)
                span.rf.__enter__()
            if start is not None:
                span.start = start
            elif device and torch.cuda.is_initialized():
                span.start = self._event()
            span.t0 = time.perf_counter()   # the span's own cost left out
            return span

    def close(self, span: _Open, chain: bool = False):
        """End ``span``; with ``chain``, return its end event for the next
        span to begin at (which reuses it once resolved)."""
        with self.lock:
            stack = span.stack
            if not any(s is span for s in stack):
                return None
            while stack[-1] is not span:          # left open inside it
                self.close(stack[-1])
            stack.pop()
            total = time.perf_counter() - span.t0
            end = self._event() if span.start is not None else None
            if span.rf is not None:
                span.rf.__exit__(None, None, None)
            if not stack:                         # a root ended
                for spans in (self.stacks, self.lent):
                    for key in [k for k, s in spans.items() if s is stack]:
                        del spans[key]
            if span.parent is not None:
                span.parent.child_s += total
            stat = span.record.setdefault(
                span.name, [0, 0.0, 0.0, None,
                            span.parent.name if span.parent else None])
            stat[0] += 1
            stat[1] += total
            stat[2] += total - span.child_s
            if end is None:
                return None
            free = (span.start,) if chain else (span.start, end)
            self.pending.append((stat, span.start, end, free))
            return end if chain else None

    def snapshot(self) -> Dict[str, List[Dict[str, Stat]]]:
        with self.lock:
            while self.pending:
                self._resolve(*self.pending.popleft())
            return {root: [{name: Stat(*stat) for name, stat in rec.items()}
                           for rec in records]
                    for root, records in self.roots.items()}

    def reset(self) -> None:
        with self.lock:
            self.roots.clear()
            self.pending.clear()


_REC = _Recorder()


def watch_profiler(module=_profiler) -> None:
    """Have ``module._enable_profiler``, which every ``torch.profiler``
    session calls with its activities as it starts, tell the recorder
    whether the session records host operations.  Where the module has no
    such function, any session is taken to record them."""
    start = getattr(module, "_enable_profiler", None)
    if start is None or hasattr(start, "__wrapped__"):
        return

    @functools.wraps(start)
    def watched(config, activities, *args, **kwargs):
        _REC.host_profiled = ProfilerActivity.CPU in activities
        return start(config, activities, *args, **kwargs)
    module._enable_profiler = watched


watch_profiler()


def recording() -> bool:
    """Whether spans record now: under :func:`enable` or while a
    ``torch.profiler`` session records host operations."""
    return bool(_REC.enabled) or (_profiler._is_profiler_enabled
                                  and _REC.host_profiled)


@contextlib.contextmanager
def enable():
    """Spans record inside this ``with`` block, profiler or none."""
    _REC.enabled += 1
    try:
        yield
    finally:
        _REC.enabled -= 1


class _Backward(torch.autograd.Function):
    """The identity forward; its backward opens (``opens``) or closes the
    label's span."""

    @staticmethod
    def forward(ctx, label, opens, *xs):
        ctx.label, ctx.opens = label, opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.opens:
            ctx.label.open()
        else:
            ctx.label.close()
        return (None, None) + grads


class _Label:
    """The ``<name>.backward`` span of one region."""

    def __init__(self, name: str, device: bool) -> None:
        self.name, self.device = name, device
        self.stack = _REC.stack()        # the forward's open spans
        self.span: Optional[_Open] = None

    def open(self) -> None:
        self.span = _REC.open(self.name, self.device, stack=self.stack)

    def close(self) -> None:
        if self.span is not None:
            _REC.close(self.span)
            self.span = None


class _Span:
    """A recording span (see :func:`span`)."""
    __slots__ = ("name", "device", "label", "_open")

    def __init__(self, name: str, device: bool, grad: bool) -> None:
        self.device = device
        self.label = None
        if in_backward():
            name += ".recompute"       # its graph is never differentiated
        elif grad and torch.is_grad_enabled():
            self.label = _Label(name + ".backward", device)
        self.name = name

    def __enter__(self):
        self._open = _REC.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        _REC.close(self._open)

    def inputs(self, *xs):
        """``xs``, through the identity whose backward closes the
        region's ``.backward`` span once every input's gradient is in."""
        needs = [i for i, x in enumerate(xs)
                 if isinstance(x, torch.Tensor) and x.requires_grad]
        if self.label is None or not needs:
            self.label = None
            return xs
        out = list(xs)
        for i, y in zip(needs, _Backward.apply(self.label, False,
                                               *(xs[i] for i in needs))):
            out[i] = y
        return tuple(out)

    def output(self, x):
        """``x``, through the identity whose backward opens the region's
        ``.backward`` span."""
        if self.label is None or not x.requires_grad:
            return x
        return _Backward.apply(self.label, True, x)[0]


class _Off:
    """The span of a process that is not recording: nothing at all."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def inputs(self, *xs):
        return xs

    def output(self, x):
        return x


_OFF = _Off()


def span(name: str, device: bool = False, grad: bool = False):
    """A context manager over one span named ``name`` (see the module's
    docstring); without recording, a shared object that does nothing."""
    if not recording():
        return _OFF
    return _Span(name, device, grad)


class StepSpans:
    """Spans over consecutive steps of one loop, for loops that check
    :func:`recording` once: ``step(name)`` ends the previous step's span
    and begins one for the next step; ``close()`` ends the last."""

    def __init__(self, device: bool = False) -> None:
        self.device = device
        self._open: Optional[_Open] = None

    def step(self, name: str) -> None:
        link = (_REC.close(self._open, chain=True)
                if self._open is not None else None)
        self._open = _REC.open(name, self.device, start=link)

    def close(self) -> None:
        if self._open is not None:
            _REC.close(self._open)
            self._open = None


def snapshot() -> Dict[str, List[Dict[str, Stat]]]:
    """``{root name: [{name: Stat}, one per root instance]}`` of every
    span recorded since the last :func:`reset`; waits for the device to
    pass every device span's end."""
    return _REC.snapshot()


def reset() -> None:
    """Forget every recorded span."""
    _REC.reset()
