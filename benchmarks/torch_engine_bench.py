"""Interpreter vs compiled executors (VM and fused) on the pattern sweep,
on the PyTorch/CUDA port: the twin of ``benchmarks/engine_bench.py``.

Rows, as in the reference, all on ``device`` (default ``cuda``; each wall
time read after ``torch.cuda.synchronize()`` there):

* ``interp/sweep_total`` — the stepwise interpreter
  (``MVEInterpreter(cfg, compiled=False, device=)``), the semantic oracle
  and the baseline of every speedup.
* ``vm/compile_sweep`` / ``fused/compile_sweep`` — cold start of all
  patterns: lowering plus first run, after the compile cache is cleared.
  The port compiles nothing (eager PyTorch and hand-written kernels built
  once per process), so ``xla_compiles`` keeps the reference's key with
  the port's own count: for ``vm`` it is ``cache_info().vm_xla_compiles``,
  the (signature, single-or-batch) executors seen; for ``fused`` it is 0.
* per-pattern steady-state rows of both modes, memory asserted bit-equal
  to the interpreter's, with the interpreter's time and the speedup.
* ``engine/cache`` — the program cache's and the VM's counters.
* ``engine/vmap_daxpy_x16`` — ``compile_program(...).warmup(...)`` and
  :func:`repro_torch.core.patterns.run_pattern_batch`, the port's
  counterpart of ``vmap``: one ``run_batch`` over 16 images.

The reference's persistent XLA cache has no counterpart here
(``vm.enable_disk_cache`` is a no-op)::

    PYTHONPATH=src python -m benchmarks.torch_engine_bench --device cpu \
        --quick
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Tuple

import torch

from repro_torch.core import (MVEConfig, MVEInterpreter, cache_info,
                              compile_program)
from repro_torch.core import vm
from repro_torch.core.engine import clear_cache
from repro_torch.core.machine import resolve_device
from repro_torch.core.patterns import PATTERNS, run_pattern_batch

from .torch_targets_bench import bits

QUICK_SET = ["daxpy", "gemm", "spmm", "upsample"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def engine_vs_interp(iters: int = 3, quick: bool = False, device=None
                     ) -> List[Tuple[str, float, str]]:
    dev = resolve_device(device)
    cfg = MVEConfig()
    names = QUICK_SET if quick else sorted(PATTERNS)
    runs = {name: PATTERNS[name]() for name in names}
    rows: List[Tuple[str, float, str]] = []

    # stepwise-interpreter baseline (the semantic oracle), measured once
    oracle = MVEInterpreter(cfg, compiled=False, device=dev)
    interp_us = {}
    interp_mem = {}
    for name, r in runs.items():
        _sync(dev)
        t0 = time.perf_counter()
        mem_i, _ = oracle.run_stepwise(r.program, r.memory)
        _sync(dev)
        interp_us[name] = (time.perf_counter() - t0) * 1e6
        interp_mem[name] = mem_i
    rows.append(("interp/sweep_total", sum(interp_us.values()),
                 f"programs={len(runs)}"))

    for mode in ("vm", "fused"):
        clear_cache()
        if mode == "vm":
            vm.clear_executors()

        # cold start: lowering + first run, all programs
        _sync(dev)
        t0 = time.perf_counter()
        if mode == "vm":
            vm.prewarm(cfg)
        compiled = {n: compile_program(r.program, cfg, mode=mode, device=dev)
                    for n, r in runs.items()}
        for n, r in runs.items():
            compiled[n].run(r.memory)
        _sync(dev)
        cold_s = time.perf_counter() - t0
        if mode == "vm":
            info = cache_info()
            detail = (f"xla_compiles={info.vm_xla_compiles};"
                      f"vm_signatures={info.vm_signatures}")
        else:
            detail = "xla_compiles=0;one_per_program"
        rows.append((f"{mode}/compile_sweep", cold_s * 1e6,
                     f"programs={len(runs)};{detail}"))

        total = 0.0
        for name, r in runs.items():
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                mem_e, _ = compiled[name].run(r.memory)
            _sync(dev)
            t_e = (time.perf_counter() - t0) / iters
            if not torch.equal(bits(mem_e), bits(interp_mem[name])):
                raise AssertionError(f"{mode} != interpreter on {name}")
            total += t_e
            rows.append((f"{mode}/{name}", t_e * 1e6,
                         f"interp_us={interp_us[name]:.0f};"
                         f"speedup={interp_us[name] / (t_e * 1e6):.1f}x"))
        interp_total = sum(interp_us.values())
        rows.append((f"{mode}/sweep_total", total * 1e6,
                     f"interp_us={interp_total:.0f};"
                     f"speedup={interp_total / (total * 1e6):.1f}x"))

    info = cache_info()
    rows.append(("engine/cache", float(info.vm_xla_compiles),
                 f"program_hits={info.program_hits};"
                 f"program_misses={info.program_misses};"
                 f"vm_signatures={info.vm_signatures};"
                 f"vm_hits={info.vm_hits};"
                 f"vm_fallbacks={info.vm_fallbacks}"))

    # batching after an explicit warmup (the port's counterpart of vmap)
    batch, name = 16, "daxpy"
    r0 = PATTERNS[name]()
    _sync(dev)
    t0 = time.perf_counter()
    compile_program(r0.program, cfg, device=dev).warmup(
        r0.memory.shape[0], batch=batch)
    _sync(dev)
    warm_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    run_pattern_batch(name, seeds=list(range(batch)), device=dev)
    t_first = time.perf_counter() - t0       # the result ends on the host
    t0 = time.perf_counter()
    run_pattern_batch(name, seeds=list(range(batch)), device=dev)
    t_b = time.perf_counter() - t0
    rows.append((f"engine/vmap_{name}_x{batch}", t_b * 1e6,
                 f"per_image_us={t_b / batch * 1e6:.0f};"
                 f"first_call_us={t_first * 1e6:.0f};"
                 f"warmup_us={warm_us:.0f}"))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="also write the rows to this JSON file")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep + 1 iteration (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    args = ap.parse_args()
    if args.json:
        from .torch_run import refuse_reference_record
        refuse_reference_record(args.json)
    rows = engine_vs_interp(iters=1 if args.quick else 3, quick=args.quick,
                            device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    if args.json:
        payload = {name: {"us": us, "derived": derived}
                   for name, us, derived in rows}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)


if __name__ == "__main__":
    main()
