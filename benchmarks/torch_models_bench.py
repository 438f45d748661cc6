"""Per-target cycles/energy sweep over the ``repro_torch.nn`` model blocks:
the twin of the reference's ``models`` section (``benchmarks/
models_bench.py``) on the PyTorch/CUDA port.

The same per-target pricing machinery as ``targets``, over the
model-block kernel zoo instead of the Section-IV patterns — attention,
KV, GEMM, SSM and MoE tiles assembled from the qwen2-0.5b, mamba2-2.7b
and llama4-scout configs (:func:`repro_torch.nn.model_blocks`).  Rows, as
in the reference:

* ``models/<block>/<target>`` — modeled wall time (us) at the target's
  clock, with cycles, total energy and instruction mix derived.  Each
  block executes once per target on ``--device``; every result is
  asserted bit-exact across targets before pricing.
* ``models/<block>/oracle`` — the block's oracle contract (bit-exact, or
  the ``rtol`` bound with the measured error), checked on the device.
* ``models/<block>/layer`` — per-tile numbers scaled by the block's
  ``tiles_per_layer``: one full transformer layer of that block on
  ``mve-bs``.
* ``models/<block>/mve_vs_rvv`` — cycle speedup / vector-instruction
  ratio / energy ratio of ``mve-bs`` over ``rvv-1d``.
* ``models/summary`` — geomeans plus ``mve_ahead_on_multidim``.
* ``models/block_mix_autotune`` — the silicon autotuner over the
  layer-weighted block mix.

The cycles and energy are the paper's cost models over the run's trace:
host arithmetic, the same on every device.  Writes its own JSON
(``--out``), never ``BENCH_engine.json``::

    PYTHONPATH=src python -m benchmarks.torch_models_bench \
        --device cpu --quick
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def models_bench(only_targets: Optional[Sequence[str]] = None,
                 quick: bool = False, device="cuda"
                 ) -> List[Tuple[str, float, str]]:
    from repro_torch import targets
    from repro_torch.nn import model_blocks
    from repro_torch.silicon.autotune import (Candidate, autotune_programs,
                                              default_candidates)

    specs = model_blocks(quick=quick)
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
    for spec in specs:
        run = spec.run
        state = ref_mem = None
        per_target = {}
        for tname in tnames:
            art = targets.compile(run.kernel, target=tname, device=device)
            mem_after, st = art.run(run.memory)
            if ref_mem is None:
                ref_mem, state = mem_after, st
                run.check(mem_after, st)
                rows.append((
                    f"models/{spec.name}/oracle", 0.0,
                    f"exactness={run.exactness};"
                    f"max_rel_err={run.error_of(mem_after):.2e};"
                    f"family={run.family}"))
            elif not torch.equal(mem_after.view(torch.int32),
                                 ref_mem.view(torch.int32)):
                # the cross-target invariant, re-asserted on every sweep
                raise AssertionError(f"{tname} diverged on {spec.name}")
            tl = art.timeline(state)
            energy = art.energy(state)
            mix = art.instruction_mix()
            per_target[tname] = (tl, energy, mix)
            rows.append((
                f"models/{spec.name}/{tname}",
                tl.us(art.target.freq_ghz(art.cfg)),
                f"cycles={tl.total_cycles:.0f};"
                f"energy_pj={energy.total_pj:.0f};"
                f"vinstr={mix.vector};scalar={mix.scalar}"))
        if "mve-bs" in per_target:
            tl_m, e_m, _ = per_target["mve-bs"]
            rows.append((
                f"models/{spec.name}/layer", 0.0,
                f"tiles_per_layer={spec.tiles_per_layer:.1f};"
                f"layer_cycles={tl_m.total_cycles * spec.tiles_per_layer:.3e};"
                f"layer_energy_pj="
                f"{e_m.total_pj * spec.tiles_per_layer:.3e};"
                f"arch={spec.arch}"))
        if "mve-bs" in per_target and "rvv-1d" in per_target:
            tl_m, e_m, mix_m = per_target["mve-bs"]
            tl_r, e_r, mix_r = per_target["rvv-1d"]
            sp = tl_r.total_cycles / tl_m.total_cycles
            vr = mix_r.vector / max(mix_m.vector, 1)
            er = e_r.total_pj / max(e_m.total_pj, 1e-9)
            speedups.append(sp)
            vratios.append(vr)
            eratios.append(er)
            if spec.multidim:
                multidim_ahead.append((spec.name, sp > 1.0 and vr > 1.0))
            rows.append((f"models/{spec.name}/mve_vs_rvv", 0.0,
                         f"dim={run.dim};speedup={sp:.2f}x;"
                         f"vinstr_ratio={vr:.1f}x;energy_ratio={er:.2f}x"))
    if speedups:
        geo = float(np.exp(np.mean(np.log(speedups))))
        geo_v = float(np.exp(np.mean(np.log(vratios))))
        geo_e = float(np.exp(np.mean(np.log(eratios))))
        ahead = all(ok for _, ok in multidim_ahead)
        behind = [p for p, ok in multidim_ahead if not ok]
        rows.append(("models/summary", 0.0,
                     f"targets={len(tnames)};blocks={len(specs)};"
                     f"mve_vs_rvv={geo:.2f}x;vinstr={geo_v:.2f}x;"
                     f"energy={geo_e:.2f}x;"
                     f"mve_ahead_on_multidim={ahead}" +
                     (f";behind={','.join(behind)}" if behind else "")))

    # -- which silicon should a phone build for this LM? -------------------
    mix = [(s.name, s.run.kernel, s.tiles_per_layer) for s in specs]
    cands = ([Candidate(scheme=s, num_arrays=na, bitlines=bl)
              for s in ("bs", "bp") for na, bl in ((32, 256), (64, 128))]
             if quick else default_candidates())
    res = autotune_programs("nn_block_mix", mix, candidates=cands)
    best_e = res.best("energy_pj")
    best_c = res.best("cycles")
    rows.append(("models/block_mix_autotune", best_e.us,
                 f"candidates={len(res.points)};front={len(res.front)};"
                 f"best_energy={best_e.label};"
                 f"energy_pj={best_e.energy_pj:.3e};"
                 f"best_cycles={best_c.label};"
                 f"cycles={best_c.cycles:.3e};"
                 f"area_mm2={best_e.area_mm2:.2f}"))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--targets", default=None,
                    help="comma-separated target names (default: every "
                         "untimed target)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from repro_torch.core.machine import resolve_device
    device = resolve_device(args.device)
    only = args.targets.split(",") if args.targets else None
    rows = models_bench(only, quick=args.quick, device=device)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "models": [{"name": n, "us": us, "derived": d}
                      for n, us, d in rows]}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
