"""Frontend overhead on the PyTorch/CUDA port: kernel build + lowering vs
a cold compile, per pattern — the twin of ``benchmarks/frontend_bench.py``.

The tracing frontend adds work before a program reaches an executor:
tracing the kernel function, liveness register allocation, strict
validation, operand packing, then the engine's compile walk.  Rows, as in
the reference:

* ``frontend/<pattern>`` — the build (us), the walk alone
  (``CompiledProgram(..., mode="fused")``), and ``cold_fused_us``: a cold
  ``CompiledProgram`` after the compile cache is cleared plus its first
  run on ``device`` (default ``cuda``, synchronized there);
  ``lower_ratio = (build + walk) / cold``.
* ``frontend/total`` — the sums, with the reference's ``budget=0.05``.

The reference's cold time includes an XLA compile; the port compiles
nothing, so its ``lower_ratio`` is far above that budget.  The budget is
printed as the reference prints it, not asserted::

    PYTHONPATH=src python -m benchmarks.torch_run --only frontend \
        --device cpu --quick
"""
from __future__ import annotations

import time
from typing import Iterable, List, Tuple

import torch

from repro_torch.core.engine import CompiledProgram, clear_cache
from repro_torch.core.machine import MVEConfig, resolve_device

QUICK_SET = ["daxpy", "gemm", "upsample", "reduction"]


def _ms(fn, iters: int = 3) -> float:
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def frontend_overhead(names: Iterable[str] | None = None, device=None
                      ) -> List[Tuple[str, float, str]]:
    from repro_torch.core.patterns import PATTERNS

    dev = resolve_device(device)
    cfg = MVEConfig()
    rows: List[Tuple[str, float, str]] = []
    total_build = total_walk = total_cold = 0.0
    for name in (sorted(PATTERNS) if names is None else names):
        factory = PATTERNS[name]
        run = factory()
        # frontend build: trace + regalloc + strict validate + data/pack
        build_ms = _ms(factory)
        # engine compile walk alone (shared by fused and VM modes)
        walk_ms = _ms(lambda: CompiledProgram(run.program, cfg,
                                              mode="fused", device=dev))

        # cold: walk + first run on the device
        def cold():
            clear_cache()
            CompiledProgram(run.program, cfg, mode="fused",
                            device=dev).run(run.memory)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        cold_ms = _ms(cold, iters=1)
        ratio = (build_ms + walk_ms) / max(cold_ms, 1e-9)
        total_build += build_ms
        total_walk += walk_ms
        total_cold += cold_ms
        rows.append((f"frontend/{name}", build_ms * 1e3,
                     f"walk_us={walk_ms * 1e3:.0f};"
                     f"cold_fused_us={cold_ms * 1e3:.0f};"
                     f"lower_ratio={ratio:.3f}"))
    ratio = (total_build + total_walk) / max(total_cold, 1e-9)
    rows.append(("frontend/total", total_build * 1e3,
                 f"walk_us={total_walk * 1e3:.0f};"
                 f"cold_fused_us={total_cold * 1e3:.0f};"
                 f"lower_ratio={ratio:.3f};budget=0.05"))
    return rows


def frontend_overhead_quick(device=None) -> List[Tuple[str, float, str]]:
    return frontend_overhead(QUICK_SET, device=device)
