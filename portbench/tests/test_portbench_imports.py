"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), and the
plain references load nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

WALK = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from portbench import harness, run, calibrate, counts, lm, mve, trace
from portbench import metrics_common
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for w in bench["workloads"]:
    cell = harness.find_cell(w["name"])
    harness.metric_readers(cell)
    harness.reference_module(cell.config)
# what the loops import of the port when they run
import repro_torch.core.engine, repro_torch.launch.steps
import repro_torch.data.pipeline, repro_torch.models.lm, repro_torch.optim
from portbench.tests.conftest import tiny_cell
cell = tiny_cell("mve-table4.suite-b4096")
cell.loop.run(cell, seed=3, seconds=0.2, trace=False,
              device=torch.device("cpu"), started=time.time())
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCES = r"""
import json, sys
sys.path[:0] = [{root!r}]
from portbench import harness
for name in {names!r}:
    harness.load_module(harness.BENCH_DIR / "reference" / (name + ".py"),
                        "reference")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_and_no_jax_package_is_loaded():
    loaded = _modules(WALK.format(root=str(harness.ROOT),
                                  src=str(harness.PROGRAM_DIR)))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES), \
        loaded & set(harness.FORBIDDEN_MODULES)


def test_the_references_load_nothing_of_the_program():
    names = sorted({harness.load_json(harness.ROOT / c["file"])["reference"]
                    for c in harness.load_json(
                        harness.ROOT / "BENCHMARK.json")["configs"]})
    loaded = _modules(REFERENCES.format(root=str(harness.ROOT), names=names))
    assert not loaded & {"repro_torch", *harness.FORBIDDEN_MODULES}


@pytest.mark.parametrize("name, expect", [
    (["jax"], ["jax"]), (["repro.core"], ["repro"]),
    (["repro_torch.core", "jaxtyping", "flaxen"], []),
])
def test_forbidden_names_compare_whole(monkeypatch, name, expect):
    for m in name:
        monkeypatch.setitem(sys.modules, m, object())
    assert harness.forbidden_loaded() == expect
