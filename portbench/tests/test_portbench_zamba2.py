"""The Zamba2 cell (``zamba2-7b.train-hybrid-packed-4k``): its files are
found by name, its readers read the program's new spans, its work count
matches a hand count, and the comparison that decides ``correct`` passes a
sound run and fails the control, half a batch and a state left unchanged
(at a size the CPU holds; the readings at the cell's own size are in
PERF.md)."""
from __future__ import annotations

import time
import types

import pytest
import torch

from portbench import counts_hybrid, harness, lm, program_spans
from portbench.tests.test_portbench_control import _train_fault

CELL = "zamba2-7b.train-hybrid-packed-4k"
SEED = 2**31 + 977
NEW = ("ssd_ms.train", "shared_block_ms.train", "mfu_hybrid.train")


def tiny_cell() -> harness.Cell:
    """Six layers (two hybrid) of width 64 over 64-token rows of
    documents of mean 16."""
    cell = harness.find_cell(CELL)
    blocks = ["mamba", "hybrid", "mamba", "mamba", "hybrid", "mamba"]
    cell.config = dict(
        cell.config, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=4, attention_head_dim=32,
        attention_hidden_size=128, intermediate_size=96, ffn_hidden_size=96,
        vocab_size=500, mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8,
        chunk_size=16, adapter_rank=8, num_hidden_layers=len(blocks),
        layers_block_type=blocks, hybrid_layer_ids=[1, 4],
        run=dict(cell.config["run"], attn_chunk=16, ce_chunk=32))
    cell.traffic = dict(cell.traffic, seq_len=64, mean_doc_len=16,
                        min_doc_len=4)
    return cell


def _run(cell, trace=False):
    return cell.loop.run(cell, seed=SEED, seconds=1.0, trace=trace,
                         device=torch.device("cpu"), started=time.time())


def test_the_cell_finds_its_new_files():
    cell = harness.find_cell(CELL)
    assert cell.loop.__file__.endswith("loops/train_hybrid.py")
    assert harness.reference_module(cell.config).__file__.endswith(
        "reference/zamba2.py")
    assert cell.traffic["segment_ids"] is True
    readers = harness.metric_readers(cell)
    assert set(NEW) <= set(readers)
    assert {"mfu.train", "roofline_flash.train"}.isdisjoint(readers)
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s",
                                                    "setup_s"]
    for name in ("qwen2-7b.train-packed-4k", "qwen2-7b.train-stream-4k"):
        assert set(NEW).isdisjoint(harness.metric_readers(
            harness.find_cell(name)))


def _stat(device, parent=None):
    from repro_torch.obs import Stat
    return Stat(1, 0.0, 0.0, device, parent)


def test_the_span_readers_sum_forward_recompute_and_backward(monkeypatch):
    step = {"launch.train_step": _stat(1.0),
            "model.ssd": _stat(0.010, "model.layer"),
            "model.ssd.recompute": _stat(0.011, "model.layer.recompute"),
            "model.ssd.backward": _stat(0.020, "launch.train_step"),
            "model.shared": _stat(0.030, "launch.train_step"),
            "model.shared.backward": _stat(0.090, "launch.train_step"),
            "model.attention": _stat(0.005, "model.layer")}
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: {"launch.train_step": [step]})
    readers = harness.metric_readers(harness.find_cell(CELL))
    assert readers["ssd_ms.train"](None) == pytest.approx(41.0)
    assert readers["shared_block_ms.train"](None) == pytest.approx(120.0)
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    assert readers["ssd_ms.train"](None) is None
    assert readers["shared_block_ms.train"](None) is None


def test_counts_match_a_hand_count():
    """At the published widths (d 3584, d_inner 7168, 112 heads of 64,
    ngroups 2, state 64, 32 attention heads of 224, FFN 14336, adapter
    rank 128, vocab 32000) and the cell's 12 layers and 2 applications."""
    cfg = harness.find_cell(CELL).config
    mamba = 3584 * (2 * 7168 + 2 * 2 * 64 + 112) + 7168 * 3584
    shared = 3 * 7168 * 7168 + 7168 * 3584 + 3584 * 28672 + 14336 * 3584
    application = shared + 3584 * 128 + 128 * 28672 + 3584 * 3584
    params = 12 * mamba + 2 * application + 3584 * 32000
    assert counts_hybrid.matmul_params(cfg) == params == 1_757_249_536
    ssd = 2 * 256 * 64 * 2 + 2 * 256 * 64 * 112 + 4 * 64 * 64 * 112
    assert counts_hybrid.ssd_flops_per_token(cfg) == ssd == 5_570_560
    tokens, pairs = 16384, 4_140_847
    want = (6 * params * tokens + 12 * 2 * 32 * 224 * pairs
            + 3 * ssd * tokens * 12)
    assert counts_hybrid.step_model_flops(cfg, tokens, pairs) == want


def test_mfu_hybrid_reads_the_window():
    cell = harness.find_cell(CELL)
    batch = {"tokens": torch.zeros(4, 4096).numpy(),
             "segment_ids": torch.ones(4, 4096, dtype=torch.int32).numpy()}
    outcome = types.SimpleNamespace(cell=cell, window={
        "steps": 2, "first_step": 0, "window_s": 2.0, "batches": [batch] * 2})
    read = harness.metric_readers(cell)["mfu_hybrid.train"]
    flops = 2 * counts_hybrid.step_model_flops(cell.config, 16384,
                                               4 * 4096 * 4097 // 2)
    assert read(outcome) == pytest.approx(100 * flops / 2.0 / 989e12)
    outcome.window["steps"] = 0
    assert read(outcome) is None


# At this size the change of the widest moving leaf, over the median leaf's,
# reads about 7e-4 in sound runs (a 64-wide model's leaves are small; at
# the cell's own size it reads 1.0e-4-3.0e-4 over 34 seeds, PERF.md): the
# sound run here is held to every limit but that one, and each fault to
# the number it breaks.
SOUND_CHANGE_HERE = 2e-3


def test_a_sound_traced_run_is_correct_and_reads_its_spans():
    from repro_torch import obs
    obs.reset()
    cell = tiny_cell()
    outcome = _run(cell, trace=True)
    line, _ = harness.result_line(cell, outcome, True,
                                  harness.metric_readers(cell),
                                  {"platform": "cpu"})
    obs.reset()
    checks = outcome.checks
    assert all(c.ok for k, c in checks.items() if k != "change_gap"), checks
    assert checks["change_gap"].value < SOUND_CHANGE_HERE
    # a window too short for a step to complete (a loaded CPU) has none
    assert ("mfu_hybrid.train" in line["metrics"]) == bool(
        outcome.window["steps"])
    if outcome.window["steps"]:
        assert line["metrics"]["mfu_hybrid.train"]["value"] > 0
    # the CPU takes no device time: the device readers are left out
    assert not {"ssd_ms.train", "shared_block_ms.train"} & set(line["metrics"])


BREAKS = {"half_batch": ("change_gap", "grad_elementwise_gap"),
          "unchanged": ("change_gap", "grad_gap", "grad_elementwise_gap")}


@pytest.mark.parametrize("kind", sorted(BREAKS))
def test_faults_are_not_correct(monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    checks = _run(tiny_cell()).checks
    assert not harness.checks_correct(checks), checks
    for number in BREAKS[kind]:
        assert checks[number].value > max(checks[number].limit,
                                          SOUND_CHANGE_HERE), (number, checks)


def test_control_is_not_correct():
    """The reference with every product's operands in float8, in the
    program's place, against the float32 reference."""
    cell = tiny_cell()
    ref = harness.reference_module(cell.config)
    batches = lm.reference_batches(cell.config, cell.traffic, SEED, 3)
    cpu = torch.device("cpu")
    low = ref.readings(cell.config, SEED, batches, cpu, lower=True)
    want = ref.readings(cell.config, SEED, batches, cpu)
    checks = cell.loop.compare(low, want, batches, batches,
                               cell.traffic["limits"])
    assert not harness.checks_correct(checks), checks
    assert checks["change_gap"].value > SOUND_CHANGE_HERE, checks


def test_elementwise_gap_reads_the_worst_leaf():
    from portbench.loops import train_hybrid
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0])}
    assert train_hybrid.elementwise_gap(ref, ref) == 0.0
    prog = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([0.0, 1.0])}
    assert train_hybrid.elementwise_gap(prog, ref) == pytest.approx(2 ** 0.5)
    assert train_hybrid.elementwise_gap({"a": ref["a"]}, ref) == 1.0
    assert train_hybrid.elementwise_gap(
        {"a": ref["a"], "b": torch.tensor([1.0, 0.1])}, ref) == pytest.approx(
            0.1)


def test_the_loop_runs_train_code_and_leaves_train_as_it_is():
    from portbench.loops import train, train_hybrid
    assert train_hybrid.run.__code__ is train.run.__code__
    assert train_hybrid.run.__globals__["build"] is train_hybrid.build
    assert train_hybrid.run.__globals__["compare"] is train_hybrid.compare
    assert train_hybrid.run.__globals__["first_steps"] is (
        train_hybrid.first_steps)
    assert (train.build.__module__, train.compare.__module__,
            train.first_steps.__module__) == ("portbench.loops.train",) * 3
