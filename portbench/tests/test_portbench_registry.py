"""The harness finds configurations, mixes, loops and per-layer metrics by
the names in BENCHMARK.json, refuses names it has no file for, and picks
up a new mix and a new metric added as new files only."""
from __future__ import annotations

import json
import shutil

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = harness.find_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.loop, "run")
    readers = harness.metric_readers(cell)
    assert set(readers) == {m["name"] for m in cell.per_layer}
    assert harness.reference_module(cell.config)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in cell.per_layer:           # each moves a metric the cell reports
        assert m["moves"] in names


@pytest.mark.parametrize("edit, message", [
    (lambda b: None, "no workload 'nope'"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="nope",
                                          traffic="no-such-mix")),
     "no traffic file"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="nope",
                                          config="no-such-config")),
     "no configuration"),
])
def test_unknown_names_are_refused(edit, message):
    bench = json.loads(json.dumps(BENCH))
    edit(bench)
    with pytest.raises(harness.UnknownName, match=message):
        harness.find_cell("nope", bench)


def test_unknown_metric_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "no_such_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "setup_s"})
    cell = harness.find_cell(BENCH["workloads"][0]["name"], bench)
    with pytest.raises(harness.UnknownName, match="no metric file"):
        harness.metric_readers(cell)


def test_a_new_mix_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark's folder gains a mix and a metric as new
    files, and ``BENCHMARK.json`` gains entries: no file that was there
    changes, and the harness finds both."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(harness.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    mix = json.loads((bench_dir / "traffic" / "suite-b4096.json").read_text())
    mix["images_per_batch"] = 256
    (bench_dir / "traffic" / "suite-b256.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "dummy_ms.mve.py").write_text(
        "def read(outcome):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mve-table4.suite-b256",
                               "config": "mve-table4",
                               "traffic": "suite-b256", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "dummy_ms.mve", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "device", "moves": "mve_images_per_s",
                               "workloads": ["mve-table4.suite-b256"]})
    cell = harness.find_cell("mve-table4.suite-b256", bench, bench_dir)
    assert cell.traffic["images_per_batch"] == 256
    readers = harness.metric_readers(cell, bench_dir)
    assert readers["dummy_ms.mve"](None) == 42.0
    assert "host_enqueue_ms.mve" not in readers      # not listed for it
    after = {p.relative_to(bench_dir): p.read_bytes()
             for p in bench_dir.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {k: after[k] for k in before} == before
