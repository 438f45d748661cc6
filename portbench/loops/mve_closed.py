"""The MVE closed loop: one client keeps ``in_flight`` batches of memory
images in flight, going through the configuration's patterns in rounds,
each round in an order drawn from the seed.

Set-up compiles each frozen program (``compile_program``, the
configuration's executor mode and optimisation level), draws
``distinct_batches`` input batches per pattern on the device from the
seed, and runs every batch twice.  The window submits a batch through
``run_batch_async`` / ``finalize_batch``, marks its end in the device
queue, and, with ``in_flight`` batches queued, waits for the oldest.
Images per second count every image of the batches that completed, over
the window from its first submission to its last completion.  With a
trace, ``trace_rounds`` more rounds run after the window under the
profiler.  The check compares, bit for bit, the outputs of the first
round, a round drawn from the seed and the last completed round of every
pattern with the plain reference.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench import harness, mve
from portbench.trace import (Marker, Spans, memory_peak, reset_memory_peak,
                             synchronize, traced)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float) -> harness.Outcome:
    from repro_torch.core.engine import compile_program

    config, traffic = cell.config, cell.traffic
    names = mve.pattern_names(config)
    rng = np.random.default_rng(seed)
    batch = traffic["images_per_batch"]
    in_flight = traffic["in_flight"]
    distinct = traffic["distinct_batches"]
    sample_round = 1 + int(rng.integers(traffic["check_round_within"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    patterns = config["patterns"]
    machine = mve.machine(config)
    ex = config["executor"]
    programs = {n: compile_program(mve.program(patterns[n]), machine,
                                   mode=ex["mode"], opt_level=ex["opt_level"],
                                   device=device) for n in names}
    pool = {n: [mve.images(patterns[n], batch, gen, device)
                for _ in range(distinct)] for n in names}
    for _ in range(2):                      # every shape the window uses
        for n in names:
            for images in pool[n]:
                programs[n].finalize_batch(programs[n].run_batch_async(images))
    synchronize(device)
    setup_s = time.time() - started

    spans = Spans()
    kept, last = {}, {}
    pending = collections.deque()
    order: list = []
    state = {"submitted": 0, "images": 0, "done_at": 0.0}

    def complete() -> None:
        marker, rnd, name, out = pending.popleft()
        marker.wait()
        state["done_at"] = time.perf_counter()
        state["images"] += batch
        last[name] = (rnd, out)
        if rnd in (0, sample_round):
            kept[(rnd, name)] = out

    def submit() -> str:
        i = state["submitted"]
        rnd = i // len(names)
        if not order or i % len(names) == 0:
            order[:] = [names[k] for k in rng.permutation(len(names))]
        name = order[i % len(names)]
        with spans.span("enqueue"):
            cp = programs[name]
            out, _, _ = cp.finalize_batch(
                cp.run_batch_async(pool[name][rnd % distinct]))
            pending.append((Marker(device), rnd, name, out))
        state["submitted"] += 1
        if len(pending) >= in_flight:
            complete()
        return name

    reset_memory_peak(device)
    t0 = state["done_at"] = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        submit()
    window_s = state["done_at"] - t0
    window_images = state["images"]
    window_spans, spans = spans, Spans()
    while pending:                           # finished after the window
        complete()

    summary, traced_patterns = None, []
    if trace:
        def one_round():
            for _ in range(len(names)):
                traced_patterns.append(submit())
        summary = traced(one_round, traffic["trace_rounds"], 1)
        del traced_patterns[len(names) * traffic["trace_rounds"]:]
        while pending:
            complete()
    peak = memory_peak(device)

    for name, (rnd, out) in last.items():
        kept[(rnd, name)] = out
    ref = harness.reference_module(config)
    mismatched = compared = 0
    for (rnd, name), out in sorted(kept.items()):
        want = ref.expected(name, patterns[name], pool[name][rnd % distinct])
        mismatched += int((_bits(out) != _bits(want)).sum())
        compared += out.shape[0]
    unchecked = len(set(names) - {name for _, name in kept})
    limits = traffic["limits"]
    checks = {"mismatched_values": harness.Check(
                  mismatched, limits["mismatched_values"]),
              "patterns_unchecked": harness.Check(
                  unchecked, limits["patterns_unchecked"])}
    return harness.Outcome(
        cell=cell,
        metrics={"setup_s": setup_s,
                 "mve_images_per_s": (window_images / window_s
                                      if window_s > 0 else 0.0)},
        attempted=state["submitted"], failed=0, checks=checks,
        memory_peak_bytes=peak, trace=summary, spans=window_spans,
        window={"images_per_batch": batch, "traced_patterns": traced_patterns,
                "window_s": window_s, "images_compared": compared})
