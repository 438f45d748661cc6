"""``benchmarks/torch_run.py``, the port's runner, and
``examples/mve_patterns_torch.py`` on the CPU.

* The runner has every section of ``benchmarks/run.py`` under the same
  name and order, and the same quick sections.
* ``--only table2,fig7 --device cpu --json <file>`` prints and writes the
  rows, equal to the golden file's; an ``--only`` run merges into the
  file.
* ``--json BENCH_engine.json`` is refused before anything runs.
* A section that raises is reported as an ``ERROR`` row, the other
  sections still run, the file is not written and the exit code is 1.
* ``--device cuda`` with no card raises before any section runs.
* The example prints the reference example's table row for row.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from benchmarks import run as ref_run
from benchmarks import torch_run

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "golden_traces.json"


def _run(argv, capsys):
    code = torch_run.main(argv)
    return code, capsys.readouterr()


def test_sections_equal_the_reference_runners():
    assert list(torch_run.SECTIONS) == list(ref_run.SECTIONS)
    assert len(torch_run.SECTIONS) == 21
    assert set(torch_run.QUICK_SECTIONS) == set(ref_run._QUICK_SECTIONS)


def test_paper_rows_to_json(tmp_path, capsys):
    out = tmp_path / "rows.json"
    out.write_text(json.dumps({"kept/row": {"us": 1.0, "derived": "x"}}))
    code, cap = _run(["--only", "table2,fig7", "--device", "cpu",
                      "--json", str(out)], capsys)
    assert code == 0, cap.err
    lines = cap.out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    written = json.loads(out.read_text())
    golden = json.loads(GOLDEN.read_text())
    want = {**golden["table2"], **golden["fig7"]}
    assert len(lines) == 1 + len(want)
    assert written.pop("kept/row") == {"us": 1.0, "derived": "x"}
    assert {n: [r["us"], r["derived"]] for n, r in written.items()} == want
    for line in lines[1:]:
        name, us, derived = line.split(",", 2)
        assert derived == want[name][1]
        assert us == f"{want[name][0]:.3f}"


def test_the_reference_record_is_refused(tmp_path, monkeypatch):
    record = ROOT / "BENCH_engine.json"
    before = record.read_bytes()
    called = []
    monkeypatch.setitem(torch_run.SECTIONS, "table2",
                        lambda device: called.append(device) or [])
    for path in ("BENCH_engine.json", str(record),
                 str(tmp_path / "BENCH_engine.json")):
        with pytest.raises(SystemExit, match="reference"):
            torch_run.main(["--only", "table2", "--device", "cpu",
                            "--json", path])
    assert called == []
    assert record.read_bytes() == before
    assert not (tmp_path / "BENCH_engine.json").exists()


def test_a_failing_section_exits_1(tmp_path, capsys, monkeypatch):
    def broken(device):
        raise ValueError("broken section")
    monkeypatch.setitem(torch_run.SECTIONS, "table2", broken)
    out = tmp_path / "rows.json"
    code, cap = _run(["--only", "table2,fig12c", "--device", "cpu",
                      "--json", str(out)], capsys)
    assert code == 1
    lines = cap.out.splitlines()
    assert "table2/ERROR,0,ValueError:broken section" in lines
    assert any(ln.startswith("fig12c/int8,") for ln in lines)
    assert not out.exists()
    assert "1 section(s) failed" in cap.err


def test_cuda_without_a_card_raises_before_any_section(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setitem(torch_run.SECTIONS, "table2",
                        lambda device: called.append(device) or [])
    for argv in (["--only", "table2"],
                 ["--only", "table2", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="cuda"):
            torch_run.main(argv)
    assert called == []
    assert "name,us_per_call" not in capsys.readouterr().out


def test_unknown_section_is_an_error(capsys):
    with pytest.raises(SystemExit):
        torch_run.main(["--only", "fig99", "--device", "cpu"])
    assert "fig99" in capsys.readouterr().err


def test_serving_dicts_become_rows():
    rows = torch_run.dict_rows("serving", {
        "steady": {"requests": 4, "seconds": 0.5, "req_per_s": 8.0}})
    assert rows == [("serving/steady", 0.5e6, "requests=4;req_per_s=8")]


def _example(path, **env):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / path), "--device", "cpu"]
        if "torch" in path else [sys.executable, str(ROOT / "examples" /
                                                     path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env))


def test_example_prints_the_reference_speedups():
    port = _example("mve_patterns_torch.py")
    ref = _example("mve_patterns.py", JAX_PLATFORMS="cpu")
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    got, want = port.stdout.splitlines(), ref.stdout.splitlines()
    assert got[:15] == want[:15]            # header + the 14 patterns
    assert got[-1] == want[-1] == \
        "  8x8 transpose through the TMU-analogue kernels: OK"
