"""The result line's shape, and the command failing, never falling back
to the CPU, where no CUDA device is present."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests.conftest import tiny_cell

DEVICE = {"platform": "gpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 1}


@pytest.fixture(scope="module")
def mve_outcome():
    import torch
    cell = tiny_cell("mve-table4.suite-b4096")
    return cell, cell.loop.run(cell, seed=2**31 + 99, seconds=2.0, trace=True,
                               device=torch.device("cpu"),
                               started=time.time())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(mve_outcome, trace):
    cell, outcome = mve_outcome
    readers = harness.metric_readers(cell)
    line, lines = harness.result_line(cell, outcome, trace, readers, DEVICE)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"                 # the numbers compared last
    assert ("breakdown" in line) == trace
    assert line["correct"] is True and line["attempted"] > 0
    json.loads(json.dumps(line))
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(units)
    assert lines == [f"check {k}: {c['value']!r} (limit {c['limit']!r}) ok"
                     for k, c in line["checks"].items()]


def test_a_reader_that_finds_nothing_is_left_out(mve_outcome):
    cell, outcome = mve_outcome          # no device operations on the CPU
    line, _ = harness.result_line(cell, outcome, True,
                                  harness.metric_readers(cell), DEVICE)
    assert "roofline_mdgather.mve" not in line["metrics"]
    assert "idle_share.mve" not in line["metrics"]
    assert "host_enqueue_ms.mve" in line["metrics"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mve-table4.suite-b4096", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_device_fails_without_a_result():
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_fail_without_a_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_exit_code_on_a_forbidden_module(monkeypatch, capsys):
    from portbench import run
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: ["jax"])
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    cell = tiny_cell("mve-table4.suite-b4096")
    monkeypatch.setattr(harness, "find_cell", lambda name: cell)
    import torch
    real = cell.loop.run
    monkeypatch.setattr(cell.loop, "run", lambda c, **kw: real(
        c, **dict(kw, device=torch.device("cpu"))))
    code = run.main(["--workload", "x", "--seed", "1", "--seconds", "0.2"])
    out = capsys.readouterr()
    assert code == run.EXIT_FORBIDDEN and out.out == ""
    assert "jax" in out.err
