"""Optimizer effect on the pattern sweep on the PyTorch/CUDA port: the twin
of ``benchmarks/opt_bench.py``.

One row per Section-IV pattern comparing opt level 0 (the program as
written) against the full pipeline: static instruction count, modeled
total cycles (controller/CB timeline over the VM static trace) and the
VM's lowered step count, with the per-pass removal audit in the derived
column — all equal to the reference's.  ``us_per_call`` is the wall time
of the (uncached) optimizer run on the host.  The closing rows record the
sweep totals and a ``tune()`` schedule sweep on daxpy.  The programs
compile for ``device`` (default ``cuda``)::

    PYTHONPATH=src python -m benchmarks.torch_run --only opt --device cpu \
        --quick
"""
from __future__ import annotations

import time
from typing import List, Tuple

from repro_torch import opt
from repro_torch.core import MVEConfig, compile_program, cost
from repro_torch.core.patterns import PATTERNS

QUICK_SET = ["daxpy", "gemm", "spmm", "upsample"]


def _vm_steps(cp) -> int:
    """Rows of the VM's lowered step table (``VMProgram.n_steps``, the
    reference's ``table_rows["steps"]``); programs that fell back to fused
    mode report their length."""
    lowered = getattr(cp, "_vm", None)
    return lowered.n_steps if lowered is not None else len(cp.program)


def opt_report(quick: bool = False, device=None
               ) -> List[Tuple[str, float, str]]:
    cfg = MVEConfig()
    names = QUICK_SET if quick else sorted(PATTERNS)
    rows: List[Tuple[str, float, str]] = []
    ti0 = tif = tc0 = tcf = 0
    total_us = 0.0
    for name in names:
        run = PATTERNS[name]()
        opt.cache_clear()                      # honest pipeline timing
        t0 = time.perf_counter()
        res = opt.optimize_result(run.program, level=opt.MAX_OPT_LEVEL)
        us = (time.perf_counter() - t0) * 1e6
        cp0 = compile_program(run.program, cfg, mode="vm", device=device)
        cpf = compile_program(res.program, cfg, mode="vm", device=device)
        c0 = int(cost.simulate(cp0.static_trace, cfg).total_cycles)
        cf = int(cost.simulate(cpf.static_trace, cfg).total_cycles)
        audit = ",".join(f"{r.name}:{r.removed}" for r in res.reports)
        rows.append((
            f"opt/{name}", us,
            f"instr {len(res.source)}->{len(res.program)} "
            f"cycles {c0}->{cf} "
            f"vm_steps {_vm_steps(cp0)}->{_vm_steps(cpf)} [{audit}]"))
        ti0 += len(res.source)
        tif += len(res.program)
        tc0 += c0
        tcf += cf
        total_us += us
    tuned = opt.tune(PATTERNS["daxpy"]().program, target="mve-bs",
                     device=device)
    sweep = " ".join(f"{k}:{v:.0f}" for k, v in tuned.table.items())
    rows.append(("opt/tune_daxpy_mve-bs", 0.0,
                 f"best={tuned.best} {sweep}"))
    rows.append(("opt/sweep_total", total_us,
                 f"instr {ti0}->{tif} cycles {tc0}->{tcf}"))
    return rows
