"""MVE program serving on the PyTorch/CUDA port: the multi-tenant scheduler
(:mod:`repro_torch.runtime.scheduler`) replaying the mixed request stream
of ``benchmarks/serving_bench.py`` (the Swan workload mix of Table III),
regenerated here from the port's own patterns.

Rows, as in the ``serving`` section of the reference's benchmark:

* ``sequential_run`` — per-request ``CompiledProgram.run()`` (the port's
  default mode), warm, each request ending in its copy-back;
* ``scheduler_cold`` — the first replay through a fresh scheduler with
  promotion off (the VM tier only) after the program cache is cleared;
* ``scheduler_steady`` — a warmed scheduler (``promote_after=2``,
  ``max_batch=16``): requests per second, p50/p95 latency, batch
  efficiency, host waits per drain cycle;
* ``oracle_check`` — every steady result equal, bit for bit, to the
  port's stepwise oracle on the same device.

``serving_lm`` replays *model* work instead: the :mod:`repro_torch.nn`
zoo blocks a decode layer issues (KV gather/scatter, attention tiles, GEMM
tiles, SSM steps, MoE gathers), each request a distinct instance submitted
as a :class:`~repro_torch.frontend.Kernel` — the twin of the reference's
``serving_lm`` section (``benchmarks/serving_bench.py``).  Rows:
``sequential_run``, ``scheduler_steady`` and ``oracle_check`` (every
result bit-equal to the port's stepwise oracle on the same device and
passing its block's own oracle check).

Writes its own JSON (``--out``), never ``BENCH_engine.json``::

    PYTHONPATH=src python -m benchmarks.torch_serving_bench \
        --device cuda --out serving.json
    PYTHONPATH=src python -m benchmarks.torch_serving_bench \
        --device cpu --quick --sections serving_lm
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# The reference's mix (benchmarks/serving_bench.py): hot BLAS/codec kernels
# dominate; the data-dependent families (spmm, fir) arrive as a tail of
# fresh programs.
_STREAM_MIX: List[Tuple[str, int]] = [
    ("daxpy", 7), ("gemm", 6), ("memcpy", 6), ("alpha_blend", 6),
    ("xor_cipher", 5), ("rgb2gray", 5), ("transpose", 4), ("audio_mix", 4),
    ("reduction", 4), ("intra_pred", 4), ("png_up", 3), ("upsample", 2),
    ("spmm", 4), ("fir", 4),
]

_QUICK_MIX: List[Tuple[str, int]] = [
    ("daxpy", 4), ("gemm", 3), ("alpha_blend", 3), ("spmm", 2),
]


def request_stream(mix: Sequence[Tuple[str, int]] = _STREAM_MIX,
                   seed: int = 0):
    """``count`` requests per pattern with distinct memory images (and,
    for the data-dependent families, distinct programs), interleaved
    round-robin like concurrent tenants — the reference's stream, made
    from the port's patterns with the same seeds."""
    from repro_torch.core.patterns import PATTERNS

    per_pattern = {name: [PATTERNS[name](seed=seed + 17 * i + 1)
                          for i in range(count)] for name, count in mix}
    stream = []
    for i in range(max(count for _, count in mix)):
        for name, count in mix:
            if i < count:
                stream.append((name, per_pattern[name][i]))
    return stream


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def replay(sched, stream) -> Tuple[float, list]:
    """Submit the whole stream, drain it; ``(drain seconds, tickets)``."""
    tickets = [sched.submit(r.program, r.memory) for _, r in stream]
    _sync(sched.device)
    t0 = time.perf_counter()
    sched.drain()
    _sync(sched.device)
    return time.perf_counter() - t0, tickets


def sequential_run(cfg, stream, device, repeats: int) -> float:
    """The stream's requests one ``CompiledProgram.run()`` after another,
    each ending in its copy-back, warm: the best of ``repeats`` walls."""
    from repro_torch.core import compile_program
    from repro_torch.core.machine import to_numpy

    cps = [compile_program(r.program, cfg, device=device) for _, r in stream]
    for cp, (_, r) in zip(cps, stream):
        to_numpy(cp.run(r.memory)[0])
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for cp, (_, r) in zip(cps, stream):
            to_numpy(cp.run(r.memory)[0])
        walls.append(time.perf_counter() - t0)
    return min(walls)


def mve_serving(device="cuda", quick: bool = False) -> Dict[str, Dict]:
    """The four rows, as ``{row: {metric: value}}``."""
    from repro_torch.core import MVEConfig
    from repro_torch.core.engine import cache_info, clear_cache
    from repro_torch.core.interp import MVEInterpreter
    from repro_torch.core.machine import to_numpy
    from repro_torch.runtime.scheduler import MVEScheduler

    cfg = MVEConfig()
    stream = request_stream(_QUICK_MIX if quick else _STREAM_MIX)
    n = len(stream)
    rows: Dict[str, Dict] = {}

    # -- sequential per-request run() (warm) -------------------------------
    seq_wall = sequential_run(cfg, stream, device, 1 if quick else 3)
    rows["sequential_run"] = {"requests": n, "seconds": seq_wall,
                              "req_per_s": n / seq_wall}

    # -- cold replay: the VM tier, program cache cleared -------------------
    clear_cache()
    before = cache_info()
    cold = MVEScheduler(cfg, promote_after=None, device=device)
    cold_wall, _ = replay(cold, stream)
    rows["scheduler_cold"] = {
        "requests": n, "seconds": cold_wall, "req_per_s": n / cold_wall,
        "compiles": cache_info().program_misses - before.program_misses,
        "batch_efficiency": cold.stats.batch_efficiency,
        "dispatches": cold.stats.dispatches}

    # -- steady replay: promoted, warmed ------------------------------------
    sched = MVEScheduler(cfg, promote_after=2, max_batch=16, device=device)
    for _ in range(2):
        replay(sched, stream)
    best = None
    for _ in range(1 if quick else 5):
        syncs, drains = sched.host_syncs, sched.stats.drains
        wall, tickets = replay(sched, stream)
        per_cycle = (sched.host_syncs - syncs) / (sched.stats.drains
                                                  - drains)
        if best is None or wall < best[0]:
            best = (wall, tickets, per_cycle)
    wall, tickets, per_cycle = best
    lat = np.array([t.latency for t in tickets])
    st = sched.stats
    rows["scheduler_steady"] = {
        "requests": n, "seconds": wall, "req_per_s": n / wall,
        "speedup_vs_sequential": seq_wall / wall,
        "batch_efficiency": st.batch_efficiency,
        "promotions": st.promotions, "demotions": st.demotions,
        "p50_latency_ms": float(np.percentile(lat, 50)) * 1e3,
        "p95_latency_ms": float(np.percentile(lat, 95)) * 1e3,
        "host_syncs_per_cycle": per_cycle}

    # -- bit-exactness vs the stepwise oracle ------------------------------
    oracle = MVEInterpreter(cfg, compiled=False, device=device)
    t0 = time.perf_counter()
    for (name, r), t in zip(stream, tickets):
        res = t.result()
        mem_i, st_i = oracle.run_stepwise(list(r.program), r.memory)
        np.testing.assert_array_equal(to_numpy(mem_i).view(np.uint32),
                                      res.memory.view(np.uint32))
        np.testing.assert_array_equal(to_numpy(st_i.tag), res.tag)
        r.check(res.memory, res)
    rows["oracle_check"] = {"requests_checked": n, "bit_identical": True,
                            "seconds": time.perf_counter() - t0}
    return rows


# ---------------------------------------------------------------------------
# LM serving on the MVE engine itself: the repro_torch.nn block stream.
# ---------------------------------------------------------------------------

# blocks a decode layer issues, weighted toward the ones it issues most
_LM_WEIGHTS = {"kv_gather": 3, "kv_scatter": 3, "attn_tile": 1,
               "gemm_tile": 2, "ssm_scan": 2, "moe_gather": 2}
_LM_QUICK_KWARGS = {
    "kv_gather": dict(window=8, head_dim=8, max_seq=16, pos0=2),
    "kv_scatter": dict(window=8, head_dim=8, max_seq=16, pos0=2),
    "attn_tile": dict(tq=8, tk=8, d=4, chunk=4),
    "gemm_tile": dict(n=16, kdim=4, m=16),
    "ssm_scan": dict(n_state=8, d_inner=16),
    "moe_gather": dict(tokens=16, d_expert=8),
}


def lm_block_stream(quick: bool = False, copies: int = 2):
    """A decode-step request stream drawn from the model-block zoo, as the
    reference builds it: several distinct instances per block (seeds
    ``100 + 17 i``: new KV tiles and routing decisions per request),
    interleaved round-robin like concurrent decode slots."""
    from repro_torch.nn import BLOCK_KERNELS

    per_block = {}
    for name, w in _LM_WEIGHTS.items():
        count = max(1, (w * copies) // 2) if quick else w * copies
        kwargs = _LM_QUICK_KWARGS[name] if quick else {}
        per_block[name] = [BLOCK_KERNELS[name](seed=100 + 17 * i, **kwargs)
                           for i in range(count)]
    stream = []
    for i in range(max(len(v) for v in per_block.values())):
        for name in _LM_WEIGHTS:
            if i < len(per_block[name]):
                stream.append((name, per_block[name][i]))
    return stream


def replay_kernels(sched, stream) -> Tuple[float, list]:
    """Submit every block as a kernel, drain; ``(drain seconds,
    tickets)``."""
    tickets = [sched.submit(r.kernel) for _, r in stream]
    _sync(sched.device)
    t0 = time.perf_counter()
    sched.drain()
    _sync(sched.device)
    return time.perf_counter() - t0, tickets


def serving_lm(device="cuda", quick: bool = False) -> Dict[str, Dict]:
    """``serving_lm``: the decode-layer block stream through the
    scheduler, as ``{row: {metric: value}}``."""
    from repro_torch.core import MVEConfig
    from repro_torch.core.interp import MVEInterpreter
    from repro_torch.core.machine import to_numpy
    from repro_torch.runtime.scheduler import MVEScheduler

    cfg = MVEConfig()
    stream = lm_block_stream(quick, copies=1 if quick else 2)
    n = len(stream)
    rows: Dict[str, Dict] = {}

    # -- sequential per-request run() (warm) -------------------------------
    seq_wall = sequential_run(cfg, stream, device, 1 if quick else 3)
    rows["sequential_run"] = {"requests": n, "seconds": seq_wall,
                              "req_per_s": n / seq_wall}

    # -- steady scheduler replay (kernels submitted directly) --------------
    sched = MVEScheduler(cfg, promote_after=2, max_batch=16, device=device)
    for _ in range(2):                  # warm: promotions + batch shapes
        replay_kernels(sched, stream)
    best = None
    for _ in range(1 if quick else 3):
        wall, tickets = replay_kernels(sched, stream)
        if best is None or wall < best[0]:
            best = (wall, tickets)
    wall, tickets = best
    st = sched.stats
    rows["scheduler_steady"] = {
        "requests": n, "seconds": wall, "req_per_s": n / wall,
        "speedup_vs_sequential": seq_wall / wall,
        "batch_efficiency": st.batch_efficiency,
        "promotions": st.promotions, "demotions": st.demotions}

    # -- every result: the stepwise oracle's bits and the block's oracle ---
    oracle = MVEInterpreter(cfg, compiled=False, device=device)
    t0 = time.perf_counter()
    for (name, r), t in zip(stream, tickets):
        res = t.result()
        mem_i, _ = oracle.run_stepwise(list(r.program), r.memory)
        np.testing.assert_array_equal(to_numpy(mem_i).view(np.uint32),
                                      res.memory.view(np.uint32))
        r.check(res.memory, res)
    rows["oracle_check"] = {"requests_checked": n, "bit_identical": True,
                            "blocks": len({nm for nm, _ in stream}),
                            "seconds": time.perf_counter() - t0}
    return rows


SECTIONS = {"serving": mve_serving, "serving_lm": serving_lm}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated, of {', '.join(SECTIONS)}")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from repro_torch.core.machine import resolve_device
    device = resolve_device(args.device)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for name in args.sections.split(","):
        if name not in SECTIONS:
            raise SystemExit(f"unknown section {name!r}; known: "
                             f"{', '.join(SECTIONS)}")
        out[name] = SECTIONS[name](device, quick=args.quick)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
