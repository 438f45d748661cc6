"""``silicon`` section on the PyTorch/CUDA port: the parametric SRAM
model's acceptance claims — the twin of ``benchmarks/silicon_bench.py``.

Every row asserts its claim before reporting it, as in the reference:

* ``silicon/params/default_identity`` — ``EnergyParams.derive(MVEConfig())``
  is byte-identical to ``DEFAULT_ENERGY`` (what keeps the fig7/table2
  goldens frozen).
* ``silicon/area/default`` — the Table V overhead at the default geometry
  lands in [2%, 6%], bracketing the paper's 3.588%.
* ``silicon/area/bicameral`` — the split-cache target amortizes the same
  additions over a doubled macro.
* ``silicon/sweep_cache`` — cold compute == warm JSON-cache load, in a
  temporary directory.
* ``silicon/pareto/{gemm,spmm,stream}`` — the (scheme x geometry)
  autotuner with its (cycles, energy, area) non-dominated front.

The model is host arithmetic and the autotuner's compile walks execute
nothing, so nothing here runs on the card; ``device`` (default ``cuda``)
is resolved all the same, as in every section::

    PYTHONPATH=src python -m benchmarks.torch_silicon_bench --device cpu \
        --quick
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Tuple

from repro_torch.core import cost
from repro_torch.core.machine import MVEConfig, resolve_device
from repro_torch.silicon import area, autotune, params, sweep

from .torch_serving_bench import _QUICK_MIX, _STREAM_MIX

#: The paper's area-overhead acceptance bracket (claim: 3.588%).
AREA_BRACKET = (2.0, 6.0)


def _pareto_row(name: str, result, elapsed_s: float,
                min_candidates: int) -> Tuple[str, float, str]:
    n = len(result.points)
    assert n >= min_candidates, \
        f"{name}: only {n} candidates evaluated (< {min_candidates})"
    front = result.front
    assert front, f"{name}: empty Pareto front"
    best_e = result.best("energy_pj")
    best_c = result.best("cycles")
    return (name, elapsed_s * 1e6,
            f"candidates={n};front={len(front)};"
            f"best_energy={best_e.label};best_cycles={best_c.label};"
            f"front_labels={'|'.join(p.label for p in front)}")


def silicon_report(quick: bool = False, device=None
                   ) -> List[Tuple[str, float, str]]:
    resolve_device(device)
    rows: List[Tuple[str, float, str]] = []

    # -- calibration identity ----------------------------------------------
    derived = cost.EnergyParams.derive(MVEConfig())
    _, source = params.derived_energy(MVEConfig())
    assert derived == cost.DEFAULT_ENERGY, \
        "default-geometry derivation drifted from DEFAULT_ENERGY"
    rows.append(("silicon/params/default_identity", 0.0,
                 f"byte_identical=True;source={source}"))

    # -- area overhead ------------------------------------------------------
    ar = area.area_report()
    lo, hi = AREA_BRACKET
    assert lo <= ar.overhead_pct <= hi, \
        f"area overhead {ar.overhead_pct:.2f}% outside [{lo}%, {hi}%]"
    rows.append(("silicon/area/default", ar.added_mm2,
                 f"overhead={ar.overhead_pct:.2f}%[paper:3.588%];"
                 f"bracket=[{lo}%,{hi}%];core={ar.core_mm2}mm2;"
                 f"l2={ar.l2_mm2:.3f}mm2"))

    from repro_torch import targets
    bicameral = targets.get_target("mve-bicameral")
    bar = bicameral.area_report()
    assert bar.overhead_vs_cache_pct < ar.overhead_vs_cache_pct, \
        "storage partition should amortize the additions over more cache"
    rows.append(("silicon/area/bicameral", bar.added_mm2,
                 f"overhead={bar.overhead_pct:.2f}%;"
                 f"vs_cache={bar.overhead_vs_cache_pct:.2f}%"
                 f"(compute_only={ar.overhead_vs_cache_pct:.2f}%);"
                 f"storage_arrays={bicameral.storage_arrays}"))

    # -- sweep cache: cold compute == warm load -----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "silicon_records.json")
        t0 = time.perf_counter()
        cold = sweep.sweep(cache_path=path, force=True)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = sweep.sweep(cache_path=path)
        warm_s = time.perf_counter() - t0
        assert warm == cold, "warm cache load diverged from cold compute"
    rows.append(("silicon/sweep_cache", cold_s * 1e6,
                 f"points={len(cold)};warm_equal=True;"
                 f"warm_us={warm_s * 1e6:.0f};"
                 f"model_version={params.SILICON_MODEL_VERSION}"))

    # -- Pareto autotuner ---------------------------------------------------
    if quick:
        cands = [autotune.Candidate(scheme=s, num_arrays=na, bitlines=bl)
                 for s in ("bs", "bp")
                 for na, bl in ((32, 256), (64, 256))]
        jobs = [("gemm", lambda: autotune.autotune("gemm", cands))]
        stream_mix, min_cands = _QUICK_MIX, len(cands)
    else:
        cands = None
        jobs = [("gemm", lambda: autotune.autotune("gemm")),
                ("spmm", lambda: autotune.autotune("spmm"))]
        stream_mix, min_cands = _STREAM_MIX, 24

    for kernel, job in jobs:
        t0 = time.perf_counter()
        result = job()
        rows.append(_pareto_row(f"silicon/pareto/{kernel}", result,
                                time.perf_counter() - t0, min_cands))

    t0 = time.perf_counter()
    stream = autotune.autotune_stream(stream_mix, cands)
    rows.append(_pareto_row("silicon/pareto/stream", stream,
                            time.perf_counter() - t0, min_cands))
    return rows


def silicon_report_quick(device=None) -> List[Tuple[str, float, str]]:
    return silicon_report(quick=True, device=device)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for name, us, derived in silicon_report(quick=args.quick,
                                            device=args.device):
        print(f"{name},{us:.3f},{derived}")
