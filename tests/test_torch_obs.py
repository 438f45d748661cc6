"""The port's spans (``repro_torch.obs``) on the CPU: nothing recorded and
no profiler range entered while off; recording under ``enable()`` and under
a profiler that records host operations, and not under one that records the
device alone; nesting, self time and root instances; threads that run at
once keeping their own roots, and a backward run on another thread landing
in the step that waits for it; ``.recompute`` under a non-reentrant
checkpoint and ``.backward`` labels on an autograd graph; the
``repro_torch.*`` names in a profile with their parents; device events
resolved and reused (a fake event class stands in for the card's); and a
tiny training step and an MVE batch yielding every span of the program,
with the same values as with recording off."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import engine
from repro_torch.core.machine import MVEConfig
from repro_torch.core.patterns import PATTERNS
from repro_torch.launch.train import TrainLoopConfig, train_loop
from repro_torch.optim import AdamWConfig

TRAIN_SPANS = {"data.pack", "launch.batch_to", "launch.train_step",
               "model.layer", "model.layer.recompute", "model.attention",
               "model.attention.recompute", "model.attention.backward",
               "model.ce", "model.ce.recompute", "model.ce.backward",
               "optim.adamw"}
MVE_SPANS = {"engine.dispatch", "engine.load", "engine.store", "engine.alu",
             "kernels.route"}


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def _names(snap):
    return {name for records in snap.values() for rec in records
            for name in rec}


def _region(x, w, label="region"):
    """``tanh(x @ w) * 2`` in a ``grad=True`` span."""
    with obs.span(label, grad=True) as s:
        x, w = s.inputs(x, w)
        return s.output(torch.tanh(x @ w) * 2)


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(obs, "_RecordFunctionFast",
                        lambda name: entered.append(name))
    assert not obs.recording()
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 2, requires_grad=True)
    with obs.span("outer", device=True) as s:
        assert s is obs.span("another", device=True, grad=True)
        _region(x, w).sum().backward()
    assert obs.snapshot() == {} and entered == []
    # enable() alone records, and still enters no profiler range
    with obs.enable(), obs.span("outer"):
        _region(x, w).sum().backward()
    assert set(obs.snapshot()["outer"][0]) == {"outer", "region",
                                               "region.backward"}
    assert entered == []


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_enable_and_a_profiler_each_turn_recording_on(how):
    from torch.profiler import ProfilerActivity, profile
    on = (obs.enable() if how == "enable"
          else profile(activities=[ProfilerActivity.CPU]))
    with on:
        assert obs.recording()
        with obs.span("a"):
            pass
    assert not obs.recording()
    with obs.span("b"):
        pass
    snap = obs.snapshot()
    assert list(snap) == ["a"] and snap["a"][0]["a"].count == 1


@pytest.mark.parametrize("activities, records", [
    ({"CPU", "CUDA"}, True), ({"CPU"}, True), ({"CUDA"}, False)])
def test_a_profiler_that_records_the_device_alone_records_no_span(
        monkeypatch, activities, records):
    """A session's activities reach the recorder through the wrapped
    ``_enable_profiler`` (a stand-in here: this host has no CUDA
    activity to profile); a real host-recording session turns it back."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(obs._REC, "host_profiled", True)
    started = []
    fake = type("Profiler", (), {"_enable_profiler": staticmethod(
        lambda config, acts: started.append(acts))})
    obs.watch_profiler(fake)
    obs.watch_profiler(fake)                   # wrapped once only
    acts = {getattr(ProfilerActivity, a) for a in activities}
    fake._enable_profiler("config", acts)
    assert started == [acts]
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    assert obs.recording() is records
    with obs.span("step", device=True):
        pass
    assert bool(obs.snapshot()) is records
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)
    assert not obs.recording()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.recording()


def test_nesting_self_time_and_root_instances():
    with obs.enable():
        for _ in range(2):
            with obs.span("root"):
                with obs.span("child"):
                    time.sleep(0.02)
                    with obs.span("leaf"):
                        time.sleep(0.01)
                with obs.span("child"):
                    pass
        with obs.span("other"):
            pass
    snap = obs.snapshot()
    assert sorted(snap) == ["other", "root"]
    assert len(snap["root"]) == 2 and len(snap["other"]) == 1
    for rec in snap["root"]:
        assert set(rec) == {"root", "child", "leaf"}
        root, child, leaf = rec["root"], rec["child"], rec["leaf"]
        assert (root.count, child.count, leaf.count) == (1, 2, 1)
        assert (root.parent, child.parent, leaf.parent) == (
            None, "root", "child")
        assert leaf.host_s >= 0.01 and child.host_s >= 0.03
        assert child.self_s == pytest.approx(child.host_s - leaf.host_s)
        assert root.self_s == pytest.approx(root.host_s - child.host_s)
        assert root.device_s is None           # no device time on the CPU
    obs.reset()
    assert obs.snapshot() == {}


def test_a_span_left_open_inside_another_is_ended_with_it():
    with obs.enable():
        with obs.span("root"):
            steps = obs.StepSpans()
            steps.step("first")
            steps.step("second")
            steps.step("second")
            steps.step("third")                # never closed by the loop
    (rec,) = obs.snapshot()["root"]
    assert {k: v.count for k, v in rec.items()} == {
        "root": 1, "first": 1, "second": 2, "third": 1}
    assert all(rec[k].parent == "root" for k in ("first", "second", "third"))


def test_threads_running_at_once_keep_their_own_roots():
    both_open = threading.Barrier(2)

    def work(name):
        with obs.span(name):
            both_open.wait()
            for _ in range(3):
                with obs.span(name + ".child"):
                    time.sleep(0.001)
            both_open.wait()

    with obs.enable():
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    snap = obs.snapshot()
    assert sorted(snap) == ["a", "b"]
    for name in ("a", "b"):
        (rec,) = snap[name]
        assert {k: (v.count, v.parent) for k, v in rec.items()} == {
            name: (1, None), name + ".child": (3, name)}


@pytest.mark.parametrize("labelled", [True, False],
                         ids=["a label lends the step", "one step waits"])
def test_a_backward_on_another_thread_lands_in_the_waiting_step(labelled):
    """Autograd runs a CUDA backward on a thread of its own; here a thread
    calls the backward while the step's thread waits.  With a labelled
    region, a third thread holds a root open all the while."""
    x = torch.randn(4, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)
    other_open, step_done = threading.Event(), threading.Event()

    def layer(h):
        with obs.span("layer"):
            return torch.sin(h) @ h

    def other():
        with obs.span("other"):
            other_open.set()
            step_done.wait()

    def step():
        with obs.span("step"):
            h = checkpoint(layer, x, use_reentrant=False)
            if labelled:
                h = _region(h, w)
            backward = threading.Thread(
                target=lambda: h.sum().backward())
            backward.start()
            backward.join()

    with obs.enable():
        if labelled:
            side = threading.Thread(target=other)
            side.start()
            other_open.wait()
        step()
        step_done.set()
        if labelled:
            side.join()
    snap = obs.snapshot()
    assert sorted(snap) == (["other", "step"] if labelled else ["step"])
    (rec,) = snap["step"]
    assert rec["layer.recompute"].parent == "step"
    if labelled:
        assert rec["region.backward"].parent == "step"
        assert set(snap["other"][0]) == {"other"}


def test_recompute_under_a_non_reentrant_checkpoint():
    x = torch.randn(4, 4, requires_grad=True)

    def layer(h):
        with obs.span("layer"):
            return torch.sin(h) @ h

    with obs.enable(), obs.span("step"):
        assert torch._C._current_graph_task_id() == -1
        checkpoint(layer, x, use_reentrant=False).sum().backward()
    (rec,) = obs.snapshot()["step"]
    assert rec["layer"].count == 1 and rec["layer.recompute"].count == 1
    assert rec["layer.recompute"].parent == "step"


def test_backward_labels_hold_the_region_s_backward():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(8, 4, requires_grad=True)
    w = torch.randn(4, 3, requires_grad=True)

    def loss(label):
        h = torch.exp(x)                         # before the region
        return (_region(h, w, label) ** 2).sum()  # after it

    plain = torch.autograd.grad(loss("off"), (x, w))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("step"):
            labelled = torch.autograd.grad(loss("region"), (x, w))
    for a, b in zip(plain, labelled):
        assert torch.equal(a, b)
    (rec,) = obs.snapshot()["step"]
    assert rec["region"].count == rec["region.backward"].count == 1
    assert rec["region.backward"].parent == "step"
    events = prof.events()
    (span,) = [e for e in events if e.name == "repro_torch.region.backward"]
    lo, hi = span.time_range.start, span.time_range.end

    def inside(fragment):
        (ev,) = [e for e in events if e.name.startswith(
            "autograd::engine::evaluate_function: " + fragment)]
        return lo <= ev.time_range.start and ev.time_range.end <= hi

    assert inside("TanhBackward0") and inside("MmBackward0")
    assert not inside("PowBackward0") and not inside("ExpBackward0")


def test_no_label_where_no_input_needs_a_gradient():
    x, w = torch.randn(2, 3), torch.randn(3, 2)
    with obs.enable(), obs.span("step"):
        with torch.no_grad():
            _region(x, w)
        _region(x, w)
    (rec,) = obs.snapshot()["step"]
    assert rec["region"].count == 2 and "region.backward" not in rec


def _tiny_step(record: bool):
    cfg = get_config("qwen2-0.5b", reduced=True)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=2)

    def run():
        return train_loop(cfg, ShapeCell("t", 64, 2, "train"),
                          TrainLoopConfig(steps=2, log_every=100),
                          opt_cfg=opt, seed=0, device="cpu")
    if record:
        with obs.enable():
            return run()
    return run()


def test_profile_names_the_program_s_spans_with_their_parents():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tiny_step(record=False)
    parents = {}
    for ev in prof.events():
        if ev.name.startswith("repro_torch."):
            up = ev.cpu_parent
            while up is not None and not up.name.startswith("repro_torch."):
                up = up.cpu_parent
            parents.setdefault(ev.name[len("repro_torch."):], set()).add(
                up.name[len("repro_torch."):] if up is not None else None)
    assert set(parents) == TRAIN_SPANS
    assert parents["model.attention"] == {"model.layer"}
    assert parents["model.layer"] == {"launch.train_step"}
    assert parents["optim.adamw"] == {"launch.train_step"}
    assert parents["model.ce"] == {"launch.train_step"}
    assert parents["launch.train_step"] == {None}
    assert parents["data.pack"] == {None}
    # the spans read the same, from the recorder, as the profiler saw them
    assert _names(obs.snapshot()) == TRAIN_SPANS


def test_a_training_step_yields_every_span_and_the_same_values():
    plain = _tiny_step(record=False)
    assert obs.snapshot() == {}
    recorded = _tiny_step(record=True)
    assert plain == {**recorded, "step_time_s": plain["step_time_s"]}
    snap = obs.snapshot()
    assert _names(snap) == TRAIN_SPANS
    assert [len(snap[r]) for r in ("data.pack", "launch.batch_to",
                                   "launch.train_step")] == [2, 2, 2]
    for rec in snap["launch.train_step"]:
        layers = rec["model.layer"].count
        assert layers == 2 and rec["model.layer.recompute"].count == layers
        assert rec["model.attention.backward"].count == layers
        assert rec["model.ce.recompute"].parent == "model.ce.backward"
        assert rec["model.attention.recompute"].parent == \
            "model.layer.recompute"


@pytest.mark.parametrize("mode", ["fused", "vm"])
def test_an_mve_batch_yields_every_span_and_the_same_values(mode):
    run = PATTERNS["daxpy"](n=64)      # two loads, three ALU steps, a store
    cp = engine.compile_program(run.program, MVEConfig(), mode=mode,
                                device="cpu")
    images = torch.from_numpy(np.stack([run.memory] * 3)).float()
    images[1:] += torch.randn(images[1:].shape)
    plain = cp.run_batch(images.clone())
    with obs.enable():
        recorded = cp.run_batch(images.clone())
    for a, b in zip((plain[0], plain[2]), (recorded[0], recorded[2])):
        assert torch.equal(a, b)
    snap = obs.snapshot()
    assert _names(snap) == MVE_SPANS and list(snap) == ["engine.dispatch"]
    (rec,) = snap["engine.dispatch"]
    assert {k: v.count for k, v in rec.items()} == {
        "engine.dispatch": 1, "engine.load": 2, "engine.alu": 3,
        "engine.store": 1, "kernels.route": 3}
    assert rec["kernels.route"].parent in ("engine.load", "engine.store")
    assert all(rec[k].parent == "engine.dispatch"
               for k in ("engine.load", "engine.alu", "engine.store"))


class _FakeEvent:
    """A CUDA event whose device reaches it ``lag`` queries after it is
    recorded, ``ms`` apart from the event recorded before it."""
    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at, self.polls = None, 0

    def record(self):
        type(self).clock += 1.5
        self.at, self.polls = type(self).clock, 0

    def query(self):
        self.polls += 1
        return self.polls > 1

    def synchronize(self):
        self.polls = 2

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_events_are_resolved_and_reused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with obs.enable():
        for _ in range(50):
            with obs.span("batch"):
                steps = obs.StepSpans(device=True)
                for name in ("engine.load", "engine.alu", "engine.store"):
                    steps.step(name)
                steps.close()
            with obs.span("copy", device=True):
                pass
    snap = obs.snapshot()
    assert len(snap["batch"]) == 50 and len(snap["copy"]) == 50
    for rec in snap["batch"]:
        assert rec["batch"].device_s is None       # host-only span
        for name in ("engine.load", "engine.alu", "engine.store"):
            assert rec[name].device_s == pytest.approx(1.5e-3)
    assert {rec["copy"].device_s for rec in snap["copy"]} == {1.5e-3}
    # 400 events recorded; those the device had passed were used again
    assert _FakeEvent.made < 40
