"""Per-target cycles/energy sweep over the Section-IV patterns on the
PyTorch/CUDA port: the twin of ``benchmarks/targets_bench.py``.

The ``targets`` section prices every registered target
(:mod:`repro_torch.targets`) on the 14-pattern library and emits the
MVE-vs-RVV-vs-Neon comparison, with the reference's rows:

* ``targets/<pattern>/<target>`` — modeled wall time (us) at the target's
  clock, with cycles, total energy and the vector-instruction count in the
  derived column.  Each pattern executes once per target on ``device``
  (default ``cuda``) and the memories are asserted bit-equal across all of
  them (``torch.equal`` on the bits) before any pricing happens.
* ``targets/<pattern>/mve_vs_rvv`` — cycle speedup, vector-instruction
  ratio and energy ratio of ``mve-bs`` over ``rvv-1d``.
* ``targets/summary`` — geomean ratios plus ``mve_ahead_on_multidim``.

Pricing is host arithmetic over the run's trace, so every row equals the
reference's on any device.  ``--quick`` takes a 4-pattern subset::

    PYTHONPATH=src python -m benchmarks.torch_run --only targets \
        --device cpu --quick
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

QUICK_PATTERNS = ["daxpy", "gemm", "xor_cipher", "transpose"]

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as an integer tensor of the same element size."""
    return t.view(_BITS[t.element_size()])


def target_sweep(only_targets: Optional[Sequence[str]] = None,
                 quick: bool = False, device=None
                 ) -> List[Tuple[str, float, str]]:
    from repro_torch import targets
    from repro_torch.core.machine import to_numpy
    from repro_torch.core.patterns import PATTERNS

    names = QUICK_PATTERNS if quick else sorted(PATTERNS)
    # the `timing` section owns the `*-timed` pipeline-model twins; an
    # explicit --targets filter can still sweep them here
    tnames = [t for t in targets.list_targets()
              if (t in only_targets if only_targets
                  else not t.endswith("-timed"))]
    if not tnames:
        raise ValueError(
            f"--targets matched nothing; registered: "
            f"{', '.join(targets.list_targets())}")

    rows: List[Tuple[str, float, str]] = []
    speedups, vratios, eratios = [], [], []
    multidim_ahead = []
    for pname in names:
        run = PATTERNS[pname]()
        state = ref_mem = None
        per_target = {}
        for tname in tnames:
            art = targets.compile(run.program, target=tname, device=device)
            mem_after, st = art.run(run.memory)
            if ref_mem is None:
                ref_mem, state = mem_after, st
                run.check(to_numpy(mem_after), st)   # NumPy-oracle check
            elif not torch.equal(bits(mem_after), bits(ref_mem)):
                # the cross-target invariant, re-asserted on every sweep
                raise AssertionError(f"{tname} diverged on {pname}")
            tl = art.timeline(state)
            energy = art.energy(state)
            mix = art.instruction_mix()
            per_target[tname] = (tl, energy, mix)
            rows.append((
                f"targets/{pname}/{tname}",
                tl.us(art.target.freq_ghz(art.cfg)),
                f"cycles={tl.total_cycles:.0f};"
                f"energy_pj={energy.total_pj:.0f};"
                f"vinstr={mix.vector};scalar={mix.scalar}"))
        if "mve-bs" in per_target and "rvv-1d" in per_target:
            tl_m, e_m, mix_m = per_target["mve-bs"]
            tl_r, e_r, mix_r = per_target["rvv-1d"]
            sp = tl_r.total_cycles / tl_m.total_cycles
            vr = mix_r.vector / max(mix_m.vector, 1)
            er = e_r.total_pj / max(e_m.total_pj, 1e-9)
            speedups.append(sp)
            vratios.append(vr)
            eratios.append(er)
            if run.dim != "1D":
                multidim_ahead.append((pname, sp > 1.0 and vr > 1.0))
            rows.append((f"targets/{pname}/mve_vs_rvv", 0.0,
                         f"dim={run.dim};speedup={sp:.2f}x;"
                         f"vinstr_ratio={vr:.1f}x;energy_ratio={er:.2f}x"))
    if speedups:
        geo = float(np.exp(np.mean(np.log(speedups))))
        geo_v = float(np.exp(np.mean(np.log(vratios))))
        geo_e = float(np.exp(np.mean(np.log(eratios))))
        ahead = all(ok for _, ok in multidim_ahead)
        behind = [p for p, ok in multidim_ahead if not ok]
        rows.append(("targets/summary", 0.0,
                     f"targets={len(tnames)};patterns={len(names)};"
                     f"mve_vs_rvv={geo:.2f}x;vinstr={geo_v:.2f}x;"
                     f"energy={geo_e:.2f}x;"
                     f"mve_ahead_on_multidim={ahead}" +
                     (f";behind={','.join(behind)}" if behind else "")))
    return rows
