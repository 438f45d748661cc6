"""The training loop: one training object, fed packed batches, stepped
back to back.

Set-up draws the weights on the device from the seed, builds the port's
training step (``launch/steps.py::make_train_step``: ``LM.loss`` under
``torch.autograd``, then AdamW) and its data feed
(``data/pipeline.py::make_train_batches`` over the mix's documents, whose
tokens the seed relabels: ``lm.relabeling``), and drives that same object
through its first ``first_steps`` steps, through the window's own call and
feed.  The window goes on with it: each step fetches its batch on the host,
moves it to the device as the port's training loop does
(``launch/train.py::_batch_to``) and enqueues the step; with
``in_flight`` steps queued it waits for the oldest.  Tokens per second
count the tokens that the loss counts (the loss mask) of the steps that
completed, over the window from its first step to its last completion.
With a trace, ``trace_steps`` more steps run after the window under the
profiler.

The check, once the window has closed and the program's state is freed:
every batch the run fetched, in set-up, in the window and after it,
against the reference's packing of the same documents (exact), and the
reference's three steps from the same weights and documents against the
program's losses, first gradients (as the optimizer's first moment holds
them), changes of the weights and second moments.  Only the first steps
can be followed: a window step's state is the sum of every step before
it, and the reference would have to run them all.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness, lm
from portbench.trace import (Marker, Spans, memory_peak, reset_memory_peak,
                             synchronize, traced)

# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone (a key bias under softmax); its change
# is not compared
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Trainer:
    """The one training object: step, state and feed."""
    step_fn: object
    params: dict
    opt: dict
    feed: object
    traffic: dict
    table: np.ndarray
    device: torch.device
    spans: Spans
    host_batches: List[Dict[str, np.ndarray]] = dataclasses.field(
        default_factory=list)

    def fetch(self) -> Dict[str, torch.Tensor]:
        from repro_torch.launch.train import _batch_to
        with self.spans.span("fetch"):
            batch = lm.shape_batch(next(self.feed), self.traffic, self.table)
            self.host_batches.append(batch)
            return _batch_to(batch, self.device)

    def step(self) -> dict:
        batch = self.fetch()
        with self.spans.span("step"):
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
        return metrics


def build(cell: harness.Cell, seed: int, device: torch.device,
          spans: Spans) -> Trainer:
    from repro_torch.data.pipeline import DataConfig, make_train_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, adamw_init

    config, traffic = cell.config, cell.traffic
    model = LM(lm.model_config(config))
    opt_cfg = AdamWConfig(**config["run"]["optimizer"])
    params = lm.nest(lm.draw(config, seed, device))
    data = DataConfig(vocab_size=config["vocab_size"],
                      seq_len=traffic["seq_len"],
                      global_batch=traffic["rows"],
                      seed=traffic["documents_seed"],
                      mean_doc_len=traffic["mean_doc_len"],
                      min_doc_len=traffic["min_doc_len"])
    return Trainer(make_train_step(model, opt_cfg), params,
                   adamw_init(params, opt_cfg.state_format),
                   make_train_batches(data), traffic,
                   lm.relabeling(config, seed), device, spans)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def first_steps(trainer: Trainer, config: dict, steps: int = 3) -> dict:
    """Drive the trainer through its first ``steps`` steps and read what
    the reference follows: each step's loss, each leaf's gradient as the
    optimizer took it in step 1 (its first moment over ``1 - b1``), and
    each leaf's change and second moment after the last step."""
    b1 = config["run"]["optimizer"]["b1"]
    start = {k: x.clone() for k, x in _flat(trainer.params).items()}
    losses, grad_norms = [], {}
    for i in range(steps):
        metrics = trainer.step()
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(x)) / (1 - b1)
                          for k, x in _flat(trainer.opt["m"]).items()}
    change = {k: float(torch.linalg.vector_norm(x.float() - start[k].float()))
              for k, x in _flat(trainer.params).items()}
    moment2 = {k: float(torch.linalg.vector_norm(x))
               for k, x in _flat(trainer.opt["v"]).items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "moment2_norms": moment2}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves=None) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    leaves = sorted(ref) if leaves is None else leaves
    median = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in leaves)


def compare(prog: dict, ref: dict, batches_prog, batches_ref, limits: dict
            ) -> Dict[str, harness.Check]:
    """The numbers compared, each with its limit from the mix's file
    (a number the mix gives no limit is not compared): the packing of
    every batch (exact), each step's loss, the worst leaf's first
    gradient and second moment, and the worst moving leaf's change."""
    mismatched = 0
    for bp, br in zip(batches_prog, batches_ref):
        for k in br:
            mismatched += int(np.sum(np.asarray(bp[k]) != np.asarray(br[k])))
    mismatched += abs(len(batches_prog) - len(batches_ref))
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"], ref["losses"]))
    median = float(np.median(list(ref["grad_norms"].values())))
    moving = [k for k, g in ref["grad_norms"].items() if g >= STILL_LEAF * median]
    values = {"packing_mismatches": mismatched, "loss_gap": loss_gap,
              "grad_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"]),
              "change_gap": worst_leaf_gap(prog["change_norms"],
                                           ref["change_norms"], moving),
              "moment2_gap": worst_leaf_gap(prog["moment2_norms"],
                                            ref["moment2_norms"])}
    return {k: harness.Check(values[k], limit) for k, limit in limits.items()}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float) -> harness.Outcome:
    config, traffic = cell.config, cell.traffic
    trainer = build(cell, seed, device, Spans())
    prog = first_steps(trainer, config)
    first = len(trainer.host_batches)
    synchronize(device)
    setup_s = time.time() - started

    window_spans = trainer.spans = Spans()
    pending = collections.deque()
    state = {"steps": 0, "tokens": 0.0, "done_at": 0.0}

    def complete() -> None:
        marker, tokens = pending.popleft()
        marker.wait()
        state["done_at"] = time.perf_counter()
        state["tokens"] += tokens
        state["steps"] += 1

    def step() -> None:
        trainer.step()
        tokens = float(trainer.host_batches[-1]["loss_mask"].sum())
        pending.append((Marker(device), tokens))
        if len(pending) >= traffic["in_flight"]:
            complete()

    reset_memory_peak(device)
    t0 = state["done_at"] = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        step()
    window_s = state["done_at"] - t0
    window_tokens, window_steps = state["tokens"], state["steps"]
    trainer.spans = Spans()
    while pending:                           # finished after the window
        complete()
    traced_from = len(trainer.host_batches)
    summary = (traced(step, traffic["trace_steps"], 1) if trace else None)
    while pending:
        complete()
    peak = memory_peak(device)
    fed = trainer.host_batches
    attempted = len(fed) - first
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_batches = lm.reference_batches(config, traffic, seed, len(fed))
    ref = harness.reference_module(config).readings(config, seed, ref_batches,
                                                    device)
    checks = compare(prog, ref, fed, ref_batches, traffic["limits"])
    return harness.Outcome(
        cell=cell,
        metrics={"setup_s": setup_s,
                 "train_tokens_per_s": (window_tokens / window_s
                                        if window_s > 0 else 0.0)},
        attempted=attempted, failed=0, checks=checks,
        memory_peak_bytes=peak, trace=summary, spans=window_spans,
        window={"window_s": window_s, "steps": window_steps,
                "first_step": first, "traced_from": traced_from,
                "traced_steps": traffic["trace_steps"] if trace else 0,
                "batches": fed})
