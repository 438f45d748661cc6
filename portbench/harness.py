"""Finds a cell's files by name, runs it once and assembles the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run (its ``kind``
  and its plain reference, ``reference/<reference>.py``);
* ``traffic/<traffic>.json``: the mix's parameters, read by the general
  loop it names (``loops/<loop>.py``);
* ``metrics/<metric>.py``: one reader per per-layer metric,
  ``read(readings) -> float | None``.

A later cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM_DIR = ROOT / "src"          # the port, ``repro_torch``

# Modules that may not be loaded by the time the result is printed,
# compared by the whole top-level name ("repro_torch" is not "repro").
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class UnknownName(LookupError):
    """A cell, configuration, mix, loop, reference or metric that has no
    entry or no file."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str) -> ModuleType:
    """A Python file of the benchmark as a module (file names may hold a
    dot, so they are loaded by path, not imported by name)."""
    if not path.is_file():
        raise UnknownName(f"no {label} file {path.relative_to(ROOT)}")
    name = "portbench._found." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    loop: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def _in_cell(metric: dict, cell: str, e2e_names=None) -> bool:
    """A metric with ``workloads`` is reported in those cells; an
    end-to-end metric without it in every cell, a per-layer one in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(name: str, bench: Optional[dict] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and the files it names;
    raises :class:`UnknownName` for a name or file that does not exist."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise UnknownName(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise UnknownName(f"no configuration {entry['config']!r}")
    config_path = ROOT / conf["file"]
    if not config_path.is_file():
        raise UnknownName(f"no configuration file {conf['file']}")
    traffic_path = bench_dir / "traffic" / f"{entry['traffic']}.json"
    if not traffic_path.is_file():
        raise UnknownName(f"no traffic file traffic/{entry['traffic']}.json")
    config = load_json(config_path)
    traffic = load_json(traffic_path)
    loop = load_module(bench_dir / "loops" / f"{traffic['loop']}.py", "loop")
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _in_cell(m, name, e2e_names)]
    return Cell(name, entry, config, traffic, loop, e2e, layer)


def metric_readers(cell: Cell, bench_dir: Path = BENCH_DIR
                   ) -> Dict[str, Callable]:
    return {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                   "metric").read
            for m in cell.per_layer}


def reference_module(config: dict, bench_dir: Path = BENCH_DIR
                     ) -> ModuleType:
    return load_module(bench_dir / "reference" / f"{config['reference']}.py",
                       "reference")


def process_start_time() -> float:
    """``time.time()`` at which this process started (Linux: from
    ``/proc``), so that ``setup_s`` counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def use_program() -> None:
    """Make the port importable from the checkout's ``src``."""
    if str(PROGRAM_DIR) not in sys.path:
        sys.path.insert(0, str(PROGRAM_DIR))


def cache_environment() -> Dict[str, str]:
    """Fixed cache directories inside the checkout, for anything that
    compiles (the port builds its kernels into ``build/`` on its own)."""
    build = ROOT / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache")}


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: the run is correct where every
    number is at or under its limit."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What one run of a cell gives: its end-to-end metrics, the work
    attempted and failed, the numbers compared, the device's memory peak
    (read before the reference runs), the traced slice's summary (with
    ``--trace 1``), the host spans, and the facts of the window that the
    per-layer readers need (``window``)."""
    cell: Cell
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, "Check"]
    memory_peak_bytes: int
    trace: object = None
    spans: object = None
    window: dict = dataclasses.field(default_factory=dict)


def checks_correct(checks: Dict[str, Check]) -> bool:
    return bool(checks) and all(c.ok for c in checks.values())


def check_lines(checks: Dict[str, Check]) -> List[str]:
    return [f"check {name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}" for name, c in checks.items()]


def result_line(cell: Cell, outcome, trace: bool, readers: Dict[str, Callable],
                device: dict) -> Tuple[dict, List[str]]:
    """The result object and the lines for standard error: with
    ``trace`` the cell's per-layer metrics (a reader that finds nothing is
    left out), else its end-to-end metrics; the checks come last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]](outcome)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in outcome.metrics:
                metrics[m["name"]] = {"value": float(outcome.metrics[m["name"]]),
                                      "unit": m["unit"]}
    line = {"correct": checks_correct(outcome.checks),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": c.value, "limit": c.limit}
                      for k, c in outcome.checks.items()}
    return line, check_lines(outcome.checks)
