"""The readers of the program's own spans (``program_spans`` and the ten
metrics built on it): on hand-made snapshots, medians over training steps
and means over the MVE cell's batches; ``None`` where the program has no
such span or took no device time; and a traced CPU run of each loop
reporting the host metrics and leaving out the device ones."""
from __future__ import annotations

import time
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.conftest import tiny_cell

DEVICE = {"platform": "gpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 1}
TRAIN = ("host_pack_ms.train", "host_copy_ms.train", "attention_ms.train",
         "ce_ms.train", "recompute_ms.train", "adamw_ms.train")
MVE = ("load_ms.mve", "store_ms.mve", "alu_ms.mve", "host_route_us.mve")


def _stat(host=0.0, device=None, parent=None, count=1):
    from repro_torch.obs import Stat
    return Stat(count, host, host, device, parent)


def _step(k):
    """One training step's record, its device times scaled by ``k``."""
    s = "launch.train_step"
    return {s: _stat(1.0, 1.0 * k),
            "model.attention": _stat(device=0.010 * k, parent="model.layer"),
            "model.attention.recompute": _stat(
                device=0.010 * k, parent="model.layer.recompute"),
            "model.attention.backward": _stat(device=0.020 * k, parent=s),
            "model.ce": _stat(device=0.003 * k, parent=s),
            "model.ce.backward": _stat(device=0.007 * k, parent=s),
            "model.ce.recompute": _stat(device=0.003 * k,
                                        parent="model.ce.backward"),
            "model.layer.recompute": _stat(device=0.2 * k, parent=s),
            "optim.adamw": _stat(device=0.05 * k, parent=s)}


def _batch(k, with_store=True):
    d = "engine.dispatch"
    rec = {d: _stat(0.001 * k),
           "engine.load": _stat(device=0.001 * k, parent=d),
           "engine.alu": _stat(device=0.002 * k, parent=d),
           "kernels.route": _stat(20e-6 * k, parent="engine.load")}
    if with_store:
        rec["engine.store"] = _stat(device=0.0005 * k, parent=d)
    return rec


SNAP = {"data.pack": [{"data.pack": _stat(h)} for h in (0.02, 0.5, 0.03)],
        "launch.batch_to": [{"launch.batch_to": _stat(h)}
                            for h in (0.2, 0.25, 0.21, 0.9)],
        "launch.train_step": [_step(k) for k in (1, 2, 3, 100)],
        "engine.dispatch": [_batch(1), _batch(2), _batch(3, False)]}
OUTCOME = types.SimpleNamespace(window={})

EXPECT = {"host_pack_ms.train": 30.0, "host_copy_ms.train": 230.0,
          "attention_ms.train": 100.0,    # 40 ms a step, the median of 2, 3
          "ce_ms.train": 25.0,            # the recompute is in the backward
          "recompute_ms.train": 500.0, "adamw_ms.train": 125.0,
          "load_ms.mve": 2.0, "store_ms.mve": 0.5, "alu_ms.mve": 4.0,
          "host_route_us.mve": 40.0}      # means of batches 1, 2 and 3


def _readers():
    out = {}
    for name in ("mve-table4.suite-b4096", "qwen2-7b.train-packed-4k"):
        out.update(harness.metric_readers(harness.find_cell(name)))
    return out


def test_every_new_metric_is_read_by_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in TRAIN + MVE:
        m = entries[name]
        assert (m["source"], m["better"]) == ("program_span", "lower")
        assert m["workloads"] == (
            ["mve-table4.suite-b4096"] if name in MVE else
            ["qwen2-7b.train-packed-4k", "qwen2-7b.train-stream-4k"])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_a_reader_takes_its_root_instances_median_or_mean(monkeypatch,
                                                           name):
    monkeypatch.setattr(program_spans, "snapshot", lambda: SNAP)
    assert _readers()[name](OUTCOME) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("snap", [None, {}, {"other": [{}]}],
                         ids=["no obs module", "nothing recorded",
                              "other roots"])
@pytest.mark.parametrize("name", sorted(EXPECT))
def test_a_reader_that_finds_no_instance_returns_none(monkeypatch, name,
                                                       snap):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert _readers()[name](OUTCOME) is None


@pytest.mark.parametrize("name", sorted(set(EXPECT) - {
    "host_pack_ms.train", "host_copy_ms.train", "host_route_us.mve"}))
def test_a_device_reader_without_device_time_returns_none(monkeypatch,
                                                          name):
    cpu = {root: [{k: v._replace(device_s=None) for k, v in rec.items()}
                  for rec in records] for root, records in SNAP.items()}
    monkeypatch.setattr(program_spans, "snapshot", lambda: cpu)
    assert _readers()[name](OUTCOME) is None


@pytest.mark.parametrize("cell_name, host, device", [
    ("mve-table4.suite-b4096", ["host_route_us.mve"],
     ["load_ms.mve", "store_ms.mve", "alu_ms.mve"]),
    ("qwen2-7b.train-packed-4k", ["host_pack_ms.train", "host_copy_ms.train"],
     ["attention_ms.train", "ce_ms.train", "recompute_ms.train",
      "adamw_ms.train"]),
])
def test_a_traced_cpu_run_reports_the_host_spans(cell_name, host, device):
    """On the CPU both traced slices record host operations, so the
    program records its spans in both; the CPU takes no device time, so
    the device readers find nothing and are left out of the line."""
    import torch
    from repro_torch import obs
    obs.reset()
    cell = tiny_cell(cell_name)
    outcome = cell.loop.run(cell, seed=2**31 + 17, seconds=1.0, trace=True,
                            device=torch.device("cpu"), started=time.time())
    line, _ = harness.result_line(cell, outcome, True,
                                  harness.metric_readers(cell), DEVICE)
    assert line["correct"] is True
    for name in host:
        assert line["metrics"][name]["value"] > 0
    assert not set(device) & set(line["metrics"])
    snap = obs.snapshot()
    roots = ({"engine.dispatch"} if cell.config["kind"] != "lm" else
             {"data.pack", "launch.batch_to", "launch.train_step"})
    assert set(snap) == roots
    traced = (len(outcome.window["traced_patterns"])
              if cell.config["kind"] != "lm"
              else outcome.window["traced_steps"])
    # the traced slice and the one that names the idle gaps, nothing else
    naming = (len(cell.config["patterns"]) if cell.config["kind"] != "lm"
              else 1)
    assert {len(v) for v in snap.values()} == {traced + naming}
    obs.reset()
