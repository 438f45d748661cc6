"""Serving throughput under injected faults on the PyTorch/CUDA port: the
twin of ``benchmarks/resilience_bench.py``.

The ``resilience`` section: the self-healing scheduler
(:mod:`repro_torch.runtime.scheduler` + :mod:`repro_torch.resilience`) on
``device`` (default ``cuda``) replaying the mixed Swan request stream of
``benchmarks/torch_serving_bench.py`` under deterministic chaos plans.
Rows, as in the reference:

* ``resilience/fault_rate_0`` — the fault-free steady state with the
  resilience machinery armed but no fault firing.
* ``resilience/fault_rate_1`` / ``resilience/fault_rate_10`` — 1 % / 10 %
  of requests drawing a transient fault (dispatch errors and straggler
  latency, seeded): throughput and p95 latency with bisection and retry in
  the loop.
* ``resilience/worker_kill_recovery`` — background mode with a worker
  death injected on its first wakeup: time from the kill to the first
  request served by the restarted worker.

Every ticket must resolve; the wall times are the host's clock around a
drain, whose results end on the host::

    PYTHONPATH=src python -m benchmarks.torch_run --only resilience \
        --device cpu --quick
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from .torch_serving_bench import _QUICK_MIX, _STREAM_MIX, request_stream


def _percentile_us(tickets, q) -> float:
    return float(np.percentile([t.latency for t in tickets], q) * 1e6)


def _chaos_replay(cfg, stream, plan, device, sched_kw=None):
    from repro_torch.resilience import FaultInjector
    from repro_torch.runtime.scheduler import MVEScheduler

    inj = FaultInjector(plan) if plan is not None else None
    sched = MVEScheduler(cfg, promote_after=2, injector=inj, device=device,
                         **(sched_kw or {}))
    tickets = [sched.submit(r.program, r.memory) for _, r in stream]
    t0 = time.perf_counter()
    sched.drain()
    wall = time.perf_counter() - t0
    sched.close()
    unresolved = [t.rid for t in tickets if not t.done()]
    if unresolved:
        raise AssertionError(f"tickets {unresolved} never resolved")
    return wall, tickets, sched, inj


def resilience_report(quick: bool = False, device=None
                      ) -> List[Tuple[str, float, str]]:
    from repro_torch.core import MVEConfig, vm
    from repro_torch.core.machine import resolve_device
    from repro_torch.resilience import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.scheduler import MVEScheduler

    dev = resolve_device(device)
    cfg = MVEConfig()
    vm.prewarm(cfg)
    stream = request_stream(_QUICK_MIX if quick else _STREAM_MIX)
    n = len(stream)
    rows: List[Tuple[str, float, str]] = []

    # Transient-only plans: every injected fault exercises a recovery path.
    # seed=0 draws a non-empty victim set at both rates for both the quick
    # (12-request) and full (64-request) streams.
    plans = {
        1: FaultPlan.random(seed=0, n_requests=n, rate=0.01,
                            kinds=("error", "straggler")),
        10: FaultPlan.random(seed=0, n_requests=n, rate=0.10,
                             kinds=("error", "straggler")),
    }

    # steady state: one unmeasured replay of each plan
    _chaos_replay(cfg, stream, None, dev)
    for plan in plans.values():
        _chaos_replay(cfg, stream, plan, dev)

    wall_clean = None
    for pct, plan in [(0, None)] + sorted(plans.items()):
        walls, tickets, sched, inj = [], None, None, None
        for _ in range(1 if quick else 3):
            w, tickets, sched, inj = _chaos_replay(cfg, stream, plan, dev)
            walls.append(w)
        wall = min(walls)
        if pct == 0:
            wall_clean = wall
        st = sched.stats
        derived = (f"requests={n};req_per_s={n / wall:.0f};"
                   f"p95_lat_us={_percentile_us(tickets, 95):.0f};"
                   f"injected={inj.injected if inj else 0};"
                   f"retries={st.retries};bisections={st.bisections};"
                   f"recovered={st.recovered}")
        if pct > 0:
            derived += f";slowdown_vs_clean={wall / wall_clean:.2f}x"
        rows.append((f"resilience/fault_rate_{pct}", wall * 1e6, derived))

    # -- recovery latency after an injected worker death -------------------
    # after=0: the worker dies on its first wakeup holding the whole burst

    def kill_run():
        plan = FaultPlan([FaultSpec(site="worker", kind="kill")])
        inj = FaultInjector(plan)
        sched = MVEScheduler(cfg, promote_after=2, background=True,
                             injector=inj, device=dev)
        tickets = [sched.submit(r.program, r.memory) for _, r in stream]
        for t in tickets:
            t.result(timeout=120)
        sched.close()
        return tickets, sched, inj

    kill_run()                               # unmeasured warm pass
    tickets, sched, inj = kill_run()
    kills = [f["t"] for f in inj.fired if f["kind"] == "kill"]
    if kills:
        t_kill = kills[0]
        after = [t.done_at for t in tickets if t.done_at > t_kill]
        recovery = (min(after) - t_kill) if after else 0.0
        derived = (f"requests={n};restarts={sched.stats.worker_restarts};"
                   f"served_after_kill={len(after)};all_resolved=True")
    else:
        # the whole stream served inside one worker wakeup: no kill fired
        recovery = 0.0
        derived = f"requests={n};kill_never_fired=True;all_resolved=True"
    rows.append(("resilience/worker_kill_recovery", recovery * 1e6,
                 derived))
    return rows


def resilience_report_quick(device=None) -> List[Tuple[str, float, str]]:
    return resilience_report(quick=True, device=device)
