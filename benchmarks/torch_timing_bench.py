"""The ``timing`` section on the PyTorch/CUDA port: the pipeline-model
sweep and the tune guard, the twin of ``benchmarks/timing_bench.py``.

Per pattern x timed target, the pipeline model's verdict on the static
trace: total cycles, lane/issue utilization, the per-cause stall breakdown
(dependency / structural / memory-port / frontend) and the verification
envelope, asserting on every row that the total sits inside ``[lb, ub]``.
Then the tune guard: ``opt.tune()`` pricing its schedule sweep through the
pipeline model never picks a schedule worse (under that model) than the
analytic model's choice.  The artifacts compile for ``device`` (default
``cuda``); pricing is host arithmetic over the static trace, so every row
equals the reference's::

    PYTHONPATH=src python -m benchmarks.torch_timing_bench --device cpu \
        --quick
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

QUICK_PATTERNS = ("daxpy", "gemm", "spmm", "reduction")
TIMED_TARGETS = ("mve-bs-timed", "mve-bp-timed", "mve-bh-timed",
                 "mve-ac-timed", "rvv-1d-timed", "neon-timed")


def _row(pname: str, tname: str, tl, freq: float) -> Tuple[str, float, str]:
    s = tl.stalls
    derived = (f"cycles={tl.total_cycles:.0f}"
               f";util={tl.lane_utilization:.3f}"
               f";issue_util={tl.issue_utilization:.3f}"
               f";stall_dep={s['dependency']:.0f}"
               f";stall_struct={s['structural']:.0f}"
               f";stall_port={s['memory-port']:.0f}"
               f";stall_front={s['frontend']:.0f}"
               f";lb={tl.lower_bound:.0f};ub={tl.upper_bound:.0f}")
    return f"timing/{pname}/{tname}", tl.us(freq), derived


def timing_report(quick: bool = False,
                  only_targets: Optional[Sequence[str]] = None,
                  device=None) -> List[Tuple[str, float, str]]:
    from repro_torch import opt, targets
    from repro_torch.core.patterns import PATTERNS

    names = QUICK_PATTERNS if quick else sorted(PATTERNS)
    tnames = [t for t in TIMED_TARGETS
              if not only_targets or t in only_targets]
    rows: List[Tuple[str, float, str]] = []

    for pname in names:
        run = PATTERNS[pname]()
        for tname in tnames:
            art = targets.compile(run.program, target=tname, device=device)
            tl = art.timeline()
            assert tl.lower_bound - 1e-6 <= tl.total_cycles \
                <= tl.upper_bound + 1e-6, \
                f"{pname}/{tname}: cycles outside the analytic envelope"
            rows.append(_row(pname, tname, tl,
                             art.target.freq_ghz(art.cfg)))

    # -- tune guard: pipeline-model tuning never loses to analytic ----------
    guarded = 0
    saved = 0.0
    pipeline_total = 0.0
    for pname in names:
        run = PATTERNS[pname]()
        rp = opt.tune(run.program, target="mve-bs", timing="pipeline",
                      device=device)
        ra = opt.tune(run.program, target="mve-bs", timing="analytic",
                      device=device)
        twin = targets.timed_variant("mve-bs")
        aa = ra.artifact
        analytic_choice = twin.timeline(
            aa.program, aa.cfg, aa.cp.static_trace).total_cycles
        assert rp.cycles <= analytic_choice + 1e-6, \
            (f"{pname}: pipeline-tuned schedule ({rp.best}, "
             f"{rp.cycles:.0f}cy) is worse than the analytic choice "
             f"({ra.best}, {analytic_choice:.0f}cy) under the "
             f"pipeline model")
        guarded += 1
        saved += analytic_choice - rp.cycles
        pipeline_total += rp.cycles
    rows.append((
        "timing/tune_guard",
        0.0,
        f"patterns={guarded};pipeline_never_worse=1"
        f";cycles_saved_vs_analytic_choice={saved:.0f}"
        f";pipeline_tuned_total={pipeline_total:.0f}"))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="pattern subset (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="where the artifacts run: cuda (default) or cpu")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in timing_report(quick=args.quick,
                                           device=args.device):
        print(f"{name},{us:.3f},{derived}")


if __name__ == "__main__":
    main()
