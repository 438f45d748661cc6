"""The comparison that decides ``correct`` fails where it has to: the
control (the plain reference one precision lower, in the program's place)
and each fault that a cell can have, planted underneath a run that
otherwise goes as the benchmark drives it (at a size the CPU holds; the
readings at the cells' own sizes are in PERF.md)."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness, mve
from portbench.tests.conftest import tiny_cell

MVE = "mve-table4.suite-b4096"
TRAIN = ("qwen2-7b.train-packed-4k", "qwen2-7b.train-stream-4k")
SEED = 2**31 + 4242


def _run(cell):
    return cell.loop.run(cell, seed=SEED, seconds=1.5, trace=False,
                         device=torch.device("cpu"), started=time.time())


# ---------------------------------------------------------------------------
# MVE: the executor's batched path broken underneath
# ---------------------------------------------------------------------------

def _mve_fault(monkeypatch, cell, kind):
    from repro_torch.core import engine
    ref = harness.reference_module(cell.config)
    names = {tuple(mve.program(p)): n
             for n, p in cell.config["patterns"].items()}
    real = engine.CompiledProgram.run_batch_async

    def broken(self, memories, device=None):
        kind_, (out, regs, tag, rand) = real(self, memories, device)
        if kind == "unchanged":
            out = memories.clone()
        elif kind == "half_batch":
            half = out.shape[0] // 2
            out[half:] = memories[half:]
        elif kind == "answer_altered":
            out[0, -1] += 1.0
        elif kind == "control":
            name = names[self.program]
            out = ref.expected(name, cell.config["patterns"][name], memories,
                               lower=True)
        return kind_, (out, regs, tag, rand)
    monkeypatch.setattr(engine.CompiledProgram, "run_batch_async", broken)


def test_mve_sound_run_is_correct():
    outcome = _run(tiny_cell(MVE))
    assert harness.checks_correct(outcome.checks), outcome.checks


@pytest.mark.parametrize("kind", ["control", "unchanged", "half_batch",
                                  "answer_altered"])
def test_mve_control_and_faults_are_not_correct(monkeypatch, kind):
    cell = tiny_cell(MVE)
    _mve_fault(monkeypatch, cell, kind)
    outcome = _run(cell)
    assert not harness.checks_correct(outcome.checks), outcome.checks
    assert outcome.checks["mismatched_values"].value > 0


# ---------------------------------------------------------------------------
# Training: the step and the feed broken underneath
# ---------------------------------------------------------------------------

def _train_fault(monkeypatch, kind):
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    if kind == "unchanged":
        def make_train_step(model, opt_cfg):
            def train_step(params, opt_state, batch):
                (loss, metrics), _ = steps._loss_and_grads(model, params,
                                                           batch)
                return params, opt_state, {**metrics, "loss": loss}
            return train_step
        monkeypatch.setattr(steps, "make_train_step", make_train_step)
    elif kind == "half_batch":
        real = steps._loss_and_grads

        def half(model, params, batch):
            rows = batch["tokens"].shape[0] // 2
            return real(model, params, {k: x[:rows] for k, x in batch.items()})
        monkeypatch.setattr(steps, "_loss_and_grads", half)
    elif kind == "token_altered":
        real = pipeline.make_train_batches

        def altered(*args, **kwargs):
            for batch in real(*args, **kwargs):
                batch["tokens"] = batch["tokens"].copy()
                batch["tokens"][0, 5] = (batch["tokens"][0, 5] + 1) % 400 + 2
                yield batch
        monkeypatch.setattr(pipeline, "make_train_batches", altered)
    elif kind == "window_batch_reused":
        real = pipeline.make_train_batches

        def reused(*args, **kwargs):
            feed = real(*args, **kwargs)
            first = [next(feed) for _ in range(4)]
            yield from first
            while True:                 # the window's feed stuck on one batch
                yield first[-1]
        monkeypatch.setattr(pipeline, "make_train_batches", reused)


# At this size the key bias's change, over the median leaf's, reads about
# 1e-2 in sound runs (a two-layer, 128-wide model has small leaves; at the
# cell's own size it reads under 1e-3, PERF.md): the sound run here is
# held to every limit but that one, and each fault to the number it breaks.
@pytest.mark.parametrize("name", TRAIN)
def test_train_sound_run_is_correct(name):
    checks = _run(tiny_cell(name)).checks
    assert all(c.ok for k, c in checks.items() if k != "change_gap"), checks
    assert checks["change_gap"].value < 0.05


BREAKS = {"unchanged": ("change_gap", "grad_gap"),
          "half_batch": ("change_gap", "moment2_gap"),
          "token_altered": ("packing_mismatches",),
          "window_batch_reused": ("packing_mismatches",)}


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("kind", sorted(BREAKS))
def test_train_faults_are_not_correct(monkeypatch, name, kind):
    _train_fault(monkeypatch, kind)
    checks = _run(tiny_cell(name)).checks
    assert not harness.checks_correct(checks), checks
    for number in BREAKS[kind]:
        assert not checks[number].ok, (number, checks)


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_is_not_correct(name):
    """The reference with every product's operands in float8, in the
    program's place, against the float32 reference."""
    cell = tiny_cell(name)
    config, traffic = cell.config, cell.traffic
    from portbench import lm
    ref = harness.reference_module(config)
    batches = lm.reference_batches(config, traffic, SEED, 3)
    cpu = torch.device("cpu")
    low = ref.readings(config, SEED, batches, cpu, lower=True)
    want = ref.readings(config, SEED, batches, cpu)
    checks = cell.loop.compare(low, want, batches, batches, traffic["limits"])
    assert not harness.checks_correct(checks), checks
