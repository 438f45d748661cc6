"""Benchmark runner of the PyTorch/CUDA port: the twin of
``benchmarks/run.py``, with its 21 sections under the same names — one
per paper table and figure, the executor, frontend, optimizer, timing,
silicon and resilience sections, the kernels bench, the per-target
sweeps, serving and the roofline table of the dry run.

    PYTHONPATH=src python -m benchmarks.torch_run [--only fig7,fig10]
    PYTHONPATH=src python -m benchmarks.torch_run --device cpu \
        --only table2,fig7 --json paper.json
    PYTHONPATH=src python -m benchmarks.torch_run --only engine --quick
    PYTHONPATH=src python -m benchmarks.torch_run --only targets \
        --targets mve-bs,rvv-1d

Prints ``name,us_per_call,derived`` CSV.  ``--device`` (default ``cuda``)
is where every section runs; without a card ``cuda`` raises before any
section starts — nothing falls back to the CPU.  ``--json`` also writes
the rows to the given file (an ``--only`` run merges into it) and never
to ``BENCH_engine.json``, which holds the reference's record.  A section
that raises is reported as a ``<section>/ERROR`` row, the run goes on,
and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import Callable, Dict, List, Tuple

from . import torch_paper_claims as paper_claims
from .torch_engine_bench import engine_vs_interp
from .torch_frontend_bench import frontend_overhead, frontend_overhead_quick
from .torch_kernels_bench import kernel_microbench
from .torch_models_bench import models_bench
from .torch_opt_bench import opt_report
from .torch_resilience_bench import (resilience_report,
                                     resilience_report_quick)
from .torch_roofline import roofline_rows
from .torch_serving_bench import mve_serving, serving_lm
from .torch_silicon_bench import silicon_report, silicon_report_quick
from .torch_targets_bench import target_sweep
from .torch_timing_bench import timing_report

Row = Tuple[str, float, str]

#: The reference's record, which no run of this port writes.
REFERENCE_RECORD = "BENCH_engine.json"


def dict_rows(section: str, rows: Dict[str, Dict]) -> List[Row]:
    """``torch_serving_bench``'s ``{row: {metric: value}}`` as CSV rows:
    ``<section>/<row>``, the row's seconds in us, the other metrics
    ``k=v`` joined by ``;``."""
    out = []
    for name, metrics in rows.items():
        derived = ";".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items() if k != "seconds")
        out.append((f"{section}/{name}", metrics.get("seconds", 0.0) * 1e6,
                    derived))
    return out


def _serving(quick: bool) -> Callable:
    return lambda device: dict_rows("serving", mve_serving(device, quick))


def _serving_lm(quick: bool) -> Callable:
    return lambda device: dict_rows("serving_lm", serving_lm(device, quick))


_PAPER = paper_claims.SECTIONS

# each section: device -> rows, in the reference's order
SECTIONS: Dict[str, Callable] = {
    "engine": lambda device: engine_vs_interp(device=device),
    "frontend": lambda device: frontend_overhead(device=device),
    "targets": lambda device, **kw: target_sweep(device=device, **kw),
    "models": lambda device, **kw: models_bench(device=device, **kw),
    "timing": lambda device: timing_report(device=device),
    "opt": lambda device: opt_report(device=device),
    "table2": _PAPER["table2"],
    "fig7": _PAPER["fig7"],
    "fig8": _PAPER["fig8"],
    "fig9": _PAPER["fig9"],
    "fig10": _PAPER["fig10"],
    "fig12b": _PAPER["fig12b"],
    "fig12c": _PAPER["fig12c"],
    "fig13": _PAPER["fig13"],
    "tableV": _PAPER["tableV"],
    "kernels": kernel_microbench,
    "serving": _serving(False),
    "serving_lm": _serving_lm(False),
    "resilience": lambda device: resilience_report(device=device),
    "roofline": lambda device: roofline_rows(),
    "silicon": lambda device: silicon_report(device=device),
}

# sections that understand the reduced-size smoke mode
QUICK_SECTIONS: Dict[str, Callable] = {
    "engine": lambda device: engine_vs_interp(iters=1, quick=True,
                                              device=device),
    "frontend": frontend_overhead_quick,
    "opt": lambda device: opt_report(quick=True, device=device),
    "serving": _serving(True),
    "resilience": resilience_report_quick,
    "targets": lambda device, **kw: target_sweep(quick=True, device=device,
                                                 **kw),
    "models": lambda device, **kw: models_bench(quick=True, device=device,
                                                **kw),
    "serving_lm": _serving_lm(True),
    "timing": lambda device: timing_report(quick=True, device=device),
    "silicon": silicon_report_quick,
}


def refuse_reference_record(path: str) -> None:
    if os.path.basename(path) == REFERENCE_RECORD:
        raise SystemExit(f"--json {path}: {REFERENCE_RECORD} holds the "
                         "reference's record; name another file")


def run_sections(only=None, quick: bool = False, device="cuda",
                 target_filter=None):
    """Run the chosen sections on ``device``, printing CSV rows; returns
    ``(rows by name, number of failed sections)``."""
    collected: Dict[str, Dict] = {}
    failures = 0
    for section, fn in SECTIONS.items():
        if only and section not in only:
            continue
        if quick and section in QUICK_SECTIONS:
            fn = QUICK_SECTIONS[section]
        kw = ({"only_targets": target_filter}
              if section in ("targets", "models") else {})
        try:
            for name, us, derived in fn(device, **kw):
                print(f"{name},{us:.3f},{derived}")
                collected[name] = {"us": us, "derived": derived}
        except Exception as e:                    # keep the run going
            failures += 1
            print(f"{section}/ERROR,0,{type(e).__name__}:{e}")
            traceback.print_exc(file=sys.stderr)
    return collected, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section names")
    ap.add_argument("--json", default=None,
                    help="also write the collected rows to this JSON file")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sizes/iterations where supported")
    ap.add_argument("--targets", default=None,
                    help="comma-separated target names for the `targets` "
                         "and `models` sections (default: every registered "
                         "target)")
    ap.add_argument("--device", default="cuda",
                    help="where every section runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    unknown = sorted(only - set(SECTIONS)) if only else []
    if unknown:
        ap.error(f"unknown section(s) {','.join(unknown)}; known: "
                 f"{','.join(SECTIONS)}")
    if args.json:
        refuse_reference_record(args.json)
    from repro_torch.core.machine import resolve_device
    device = resolve_device(args.device)       # no card: raises here
    target_filter = args.targets.split(",") if args.targets else None

    print("name,us_per_call,derived")
    collected, failures = run_sections(only, args.quick, device,
                                       target_filter)
    if args.json:
        if failures:
            print(f"not writing {args.json}: {failures} section(s) failed",
                  file=sys.stderr)
        else:
            # --only runs merge into the existing file so one section can
            # be refreshed without dropping the others' recorded rows
            merged = {}
            if only:
                try:
                    with open(args.json) as f:
                        merged = json.load(f)
                except (OSError, ValueError):
                    merged = {}
            merged.update(collected)
            with open(args.json, "w") as f:
                json.dump(merged, f, indent=2)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
