"""MVE program serving on the port (``repro_torch.runtime``,
``repro_torch.resilience``, ``repro_torch.launch.serve.MVEProgramServer``)
against the reference on the same seeded streams, ``device="cpu"``.

Every scenario runs through both packages with the same programs and
memory images (the port's instructions converted from the reference's),
in drain mode where the schedule is deterministic, and compares:

* the results bit for bit (memory, registers, Tag), with their tier and
  batch size;
* the typed errors tickets resolve with;
* ``SchedulerStats`` (every counter, where nothing depends on time);
* the fault injector's replay log (site, kind, rid, tier).

The full 64-request Table III stream is replayed once, under the seeded
10 % fault plan; the other scenarios use the quick mix or a few daxpy
requests.  No assertion reads a clock.
"""
import dataclasses

import numpy as np
import pytest

from benchmarks.serving_bench import _QUICK_MIX, _STREAM_MIX
from benchmarks.serving_bench import request_stream as ref_request_stream
from benchmarks.torch_serving_bench import request_stream
from repro.core import engine as ref_engine
from repro.core.machine import MVEConfig as RefConfig
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.interp import MVEInterpreter
from repro_torch.core.machine import MVEConfig

from _torch_parity import assert_bits_equal

_PORT_ORACLE = MVEInterpreter(compiled=False, device="cpu")


class _Side:
    """One package's serving API behind one interface."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            from repro_torch import resilience as res
            from repro_torch.launch.serve import MVEProgramServer
            from repro_torch.runtime.scheduler import MVEScheduler
            self.engine, self.cfg = engine, MVEConfig()
            self.extra = {"device": "cpu"}
        else:
            from repro import resilience as res
            from repro.launch.serve import MVEProgramServer
            from repro.runtime.scheduler import MVEScheduler
            self.engine, self.cfg = ref_engine, RefConfig()
            self.extra = {}
        self.res, self._sched, self._server = res, MVEScheduler, \
            MVEProgramServer

    def scheduler(self, **kw):
        return self._sched(self.cfg, **kw, **self.extra)

    def server(self, **kw):
        return self._server(**kw, **self.extra)

    def program(self, ref_program):
        return convert.program_from_reference(ref_program) if self.port \
            else ref_program

    def plan(self, ref_plan):
        """The same fault plan in this package's types."""
        if ref_plan is None:
            return None
        return self.res.FaultPlan.from_json(ref_plan.to_json())


REF, PORT = _Side(port=False), _Side(port=True)


def _daxpy(n, seed0=1):
    return [(REF_PATTERNS["daxpy"](seed=seed0 + i).program,
             REF_PATTERNS["daxpy"](seed=seed0 + i).memory) for i in range(n)]


def _fired(inj):
    return [(f["site"], f["kind"], f["rid"], f["tier"]) for f in inj.fired]


def _outcome(t):
    """A ticket's outcome as comparable data (arrays as host bits)."""
    err = t.error()
    if err is not None:
        return type(err).__name__
    r = t.result()
    return (r.tier, r.batch_size, np.asarray(r.memory),
            {k: np.asarray(v) for k, v in r.regs.items()}, np.asarray(r.tag))


def _assert_same_outcomes(ref_tickets, port_tickets):
    assert len(ref_tickets) == len(port_tickets)
    for a, b in zip(ref_tickets, port_tickets):
        oa, ob = _outcome(a), _outcome(b)
        if isinstance(oa, str) or isinstance(ob, str):
            assert oa == ob, (a.rid, oa, ob)
            continue
        assert oa[:2] == ob[:2], (a.rid, oa[:2], ob[:2])
        assert_bits_equal(oa[2], ob[2], f"rid {a.rid} memory")
        assert set(oa[3]) == set(ob[3]), a.rid
        for k in oa[3]:
            assert_bits_equal(oa[3][k], ob[3][k], f"rid {a.rid} v{k}")
        assert_bits_equal(oa[4], ob[4], f"rid {a.rid} tag")


def _run_both(requests, plan=None, submit_kw=None, hook=None, **sched_kw):
    """Submit ``requests`` (reference programs + images) to a drain-mode
    scheduler of each package, drain, close; returns ``{side: (sched,
    tickets, injector)}``."""
    out = {}
    for side in (REF, PORT):
        inj = None if plan is None else side.res.FaultInjector(
            side.plan(plan), sleep=lambda s: None)
        prev = side.engine.set_fault_hook(inj.engine_hook) if hook else None
        try:
            s = side.scheduler(injector=inj, **sched_kw)
            ts = [s.submit(side.program(p), m, **(submit_kw or {}))
                  for p, m in requests]
            s.drain()
            s.close()
        finally:
            if hook:
                side.engine.set_fault_hook(prev)
        out[side.port] = (s, ts, inj)
    return out[False], out[True]


def _assert_parity(ref, port, stats=True):
    (rs, rt, ri), (ps, pt, pi) = ref, port
    _assert_same_outcomes(rt, pt)
    if stats:
        assert dataclasses.asdict(ps.stats) == dataclasses.asdict(rs.stats)
    if ri is not None:
        assert _fired(pi) == _fired(ri)


def _port_oracle_memory(ref_program, memory):
    mem, _ = _PORT_ORACLE.run_stepwise(
        convert.program_from_reference(ref_program), memory)
    return mem.numpy()


# ---------------------------------------------------------------------------
# The streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", [_QUICK_MIX, _STREAM_MIX],
                         ids=["quick", "table3"])
def test_port_stream_twin_equals_the_reference_stream(mix):
    """``benchmarks/torch_serving_bench.request_stream`` makes the
    reference's requests from the port's patterns: same names, programs
    and images."""
    ref, port = ref_request_stream(mix), request_stream(mix)
    assert [n for n, _ in ref] == [n for n, _ in port]
    for (_, a), (_, b) in zip(ref, port):
        assert list(b.program) == list(
            convert.program_from_reference(a.program))
        np.testing.assert_array_equal(a.memory, b.memory)


@pytest.mark.parametrize("promote_after", [None, 2])
def test_quick_stream_matches_the_reference(promote_after):
    stream = [(r.program, r.memory) for _, r in ref_request_stream(
        _QUICK_MIX)]
    ref, port = _run_both(stream, promote_after=promote_after)
    _assert_parity(ref, port)
    for t, (p, m) in zip(port[1], stream):
        assert_bits_equal(_port_oracle_memory(p, m), t.result().memory)


def test_chaos_replay_64_request_stream_matches_the_reference():
    """The reference's acceptance replay (``tests/test_resilience.py``): the
    64-request stream under ``FaultPlan.random(seed=2026, rate=0.1,
    sticky_rids=(11,))`` with the cross audit on every request.  Same
    firing log, same stats, the sticky request quarantined, every other
    result bit-exact (to the reference and to the port's oracle)."""
    from repro.resilience import FaultPlan
    stream = [(r.program, r.memory) for _, r in ref_request_stream()]
    assert len(stream) == 64
    plan = FaultPlan.random(seed=2026, n_requests=64, rate=0.10,
                            sticky_rids=(11,))
    assert len(plan) > 3
    ref, port = _run_both(stream, plan=plan, promote_after=2,
                          audit_rate=1.0, audit_method="cross")
    _assert_parity(ref, port)
    sched, tickets, inj = port
    failed = {t.rid: t.error() for t in tickets if t.error() is not None}
    assert set(failed) == {11}
    assert isinstance(failed[11], PORT.res.QuarantinedError)
    assert sched.stats.quarantines == 1 and sched.stats.recovered > 0
    assert inj.injected >= len(plan) - 1
    for t, (p, m) in zip(tickets, stream):
        if t.rid != 11:
            assert_bits_equal(_port_oracle_memory(p, m), t.result().memory)


# ---------------------------------------------------------------------------
# The resilience mechanisms, scenario by scenario
# ---------------------------------------------------------------------------

def _spec(**kw):
    from repro.resilience import FaultPlan, FaultSpec
    return FaultPlan([FaultSpec(**kw)])


SCENARIOS = {
    # bisection + quarantine of a permanently poisoned request
    "sticky_quarantine": (4, _spec(site="dispatch", kind="error", rid=2,
                                   times=-1), {}),
    # one transient fault, recovered by a retry
    "transient_retry": (1, _spec(site="dispatch", kind="error", rid=0), {}),
    # a failed promotion compile serves on the base tier
    "failed_promotion": (4, _spec(site="compile", kind="error", times=-1),
                         {"promote_after": 2}),
    # a bit-flip caught and corrected by the cross audit
    "bitflip_audited": (4, _spec(site="finalize", kind="bitflip", rid=1,
                                 word=5, bit=12),
                        {"audit_rate": 1.0, "audit_method": "cross"}),
    # the same bit-flip, served silently without the audit
    "bitflip_silent": (1, _spec(site="finalize", kind="bitflip", rid=0,
                                word=5, bit=12), {}),
    # the oracle-method audit
    "oracle_audit": (2, _spec(site="finalize", kind="bitflip", rid=0,
                              word=3, bit=30),
                     {"audit_rate": 1.0, "audit_method": "oracle"}),
    "straggler": (1, _spec(site="dispatch", kind="straggler", rid=0,
                           latency_s=0.25), {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_scenarios_match_the_reference(name):
    n, plan, kw = SCENARIOS[name]
    kw = {"promote_after": None, **kw}
    ref, port = _run_both(_daxpy(n), plan=plan, **kw)
    _assert_parity(ref, port)


def test_open_breaker_degrades_to_the_oracle_tier_on_the_device():
    """A VM tier that keeps failing opens its breaker (threshold 1); the
    requests walk down to the stepwise oracle, which runs on the
    scheduler's device; every demotion is counted and shows in
    ``health()``."""
    from repro.resilience import CircuitBreaker as RefBreaker
    from repro_torch.resilience import CircuitBreaker
    plan = _spec(site="dispatch", kind="error", tier="vm", times=-1)
    outs = []
    for side, breaker in ((REF, RefBreaker), (PORT, CircuitBreaker)):
        inj = side.res.FaultInjector(side.plan(plan))
        s = side.scheduler(promote_after=None, injector=inj,
                           breaker=breaker(threshold=1, cooldown_s=60.0))
        ts = []
        for p, m in _daxpy(3):
            ts.append(s.submit(side.program(p), m))
            s.drain()
        outs.append((s, ts, inj))
        s.close()
    _assert_parity(*outs)
    s, ts, _ = outs[1]
    assert s.stats.oracle_serves >= 1 and s.stats.demotions >= 1
    assert any(t.result().tier == "oracle" for t in ts)
    health = s.health()
    assert health["breakers"]["open"]
    assert health["counters"]["demotions"] == s.stats.demotions
    assert s._oracles[s.cfg].device == s.device


def test_deep_engine_fault_hook_recovers_like_the_reference():
    ref, port = _run_both(_daxpy(2), plan=_spec(site="engine.dispatch",
                                                kind="error"),
                          hook=True, promote_after=None)
    _assert_parity(ref, port)
    assert any(f[0] == "engine.dispatch" for f in _fired(port[2]))


def test_quarantine_cooldown_allows_a_probe():
    plan = _spec(site="dispatch", kind="error", rid=0, times=-1)
    outs = []
    for side in (REF, PORT):
        inj = side.res.FaultInjector(side.plan(plan))
        with side.scheduler(promote_after=None, injector=inj,
                            quarantine_cooldown_s=0.0) as s:
            (p, m), = _daxpy(1)
            ts = [s.submit(side.program(p), m)]
            s.drain()
            ts.append(s.submit(side.program(p), m))   # re-admitted probe
            s.drain()
        outs.append((s, ts, inj))
    _assert_parity(*outs)
    assert isinstance(outs[1][1][0].error(), PORT.res.QuarantinedError)
    assert outs[1][1][1].error() is None


def test_quarantine_rejects_resubmission_while_active():
    plan = _spec(site="dispatch", kind="error", rid=2, times=-1)
    outs = []
    for side in (REF, PORT):
        inj = side.res.FaultInjector(side.plan(plan))
        with side.scheduler(promote_after=None, injector=inj) as s:
            reqs = _daxpy(4)
            ts = [s.submit(side.program(p), m) for p, m in reqs]
            s.drain()
            ts.append(s.submit(side.program(reqs[2][0]), reqs[2][1]))
            s.drain()
        outs.append((s, ts, inj))
    _assert_parity(*outs)
    s, ts, _ = outs[1]
    assert s.stats.quarantine_rejects == 1 and s.stats.bisections > 0
    assert ts[2].error().attempts > 1


# ---------------------------------------------------------------------------
# Deadlines, admission, cancellation, close
# ---------------------------------------------------------------------------

def test_expired_deadline_resolves_the_typed_error():
    ref, port = _run_both(_daxpy(2), submit_kw={"deadline_s": -1.0},
                          promote_after=None)
    _assert_parity(ref, port)
    assert port[0].stats.deadline_misses == 2
    with pytest.raises(PORT.res.DeadlineExceededError):
        port[1][0].result()


def test_shed_admission_matches_the_reference():
    ref, port = _run_both(_daxpy(5), promote_after=None, max_queue=2,
                          admission="shed")
    _assert_parity(ref, port)
    assert [type(t.error()).__name__ for t in port[1]].count(
        "QueueFullError") == 3


def test_block_admission_backpressures_until_space():
    reqs = _daxpy(6)
    with PORT.scheduler(promote_after=None, background=True, max_queue=2,
                        admission="block") as s:
        ts = [s.submit(PORT.program(p), m) for p, m in reqs]
        for t, (p, m) in zip(ts, reqs):
            assert_bits_equal(_port_oracle_memory(p, m),
                              t.result(timeout=60).memory)
        assert s.stats.sheds == 0


def test_cancel_and_close_match_the_reference():
    outs = []
    for side in (REF, PORT):
        reqs = _daxpy(4)
        s = side.scheduler(promote_after=None)
        ts = [s.submit(side.program(p), m) for p, m in reqs[:2]]
        assert ts[0].cancel()
        s.drain()
        assert not ts[1].cancel()             # already served: it stands
        with pytest.raises(TimeoutError):     # nothing drained yet
            ts.append(s.submit(side.program(reqs[2][0]), reqs[2][1]))
            ts[-1].result(timeout=0.001)
        s.close(drain=False)
        with pytest.raises(side.res.SchedulerClosedError):
            s.submit(side.program(reqs[3][0]), reqs[3][1])
        outs.append((s, ts, None))
    _assert_parity(*outs)
    assert [_outcome(t) for t in outs[1][1]][::2] == \
        ["CancelledError", "SchedulerClosedError"]


def test_close_with_drain_serves_whats_pending():
    reqs = _daxpy(2)
    s = PORT.scheduler(promote_after=None)
    ts = [s.submit(PORT.program(p), m) for p, m in reqs]
    s.close()
    for t, (p, m) in zip(ts, reqs):
        assert_bits_equal(_port_oracle_memory(p, m), t.result().memory)


# ---------------------------------------------------------------------------
# The background worker
# ---------------------------------------------------------------------------

def test_worker_death_requeues_and_the_supervisor_restarts():
    """A background worker killed mid-stream: its tickets are re-queued,
    the supervisor restarts it, every ticket resolves bit-exactly and no
    ticket leaks."""
    from repro_torch.resilience import FaultInjector, FaultPlan, FaultSpec
    reqs = _daxpy(8)
    inj = FaultInjector(FaultPlan([FaultSpec(site="worker", kind="kill")]))
    s = PORT.scheduler(promote_after=None, background=True, injector=inj)
    ts = [s.submit(PORT.program(p), m) for p, m in reqs]
    for t, (p, m) in zip(ts, reqs):
        assert_bits_equal(_port_oracle_memory(p, m),
                          t.result(timeout=60).memory)
    assert s.stats.worker_restarts == 1
    assert s.health()["worker"]["alive"]
    assert inj.counts() == {"kill": 1}
    s.close()
    assert all(t.done() for t in ts) and s.health()["pending"] == 0


def test_background_chaos_stream_with_a_worker_kill():
    from repro_torch.resilience import FaultInjector, FaultPlan
    stream = request_stream(_QUICK_MIX)
    inj = FaultInjector(FaultPlan.random(seed=3, n_requests=len(stream),
                                         rate=0.2, worker_kills=1))
    s = PORT.scheduler(promote_after=None, background=True, injector=inj,
                       audit_rate=1.0)
    ts = [s.submit(r.program, r.memory) for _, r in stream]
    for t, (_, r) in zip(ts, stream):
        mem, _ = _PORT_ORACLE.run_stepwise(r.program, r.memory)
        assert_bits_equal(mem.numpy(), t.result(timeout=60).memory)
    s.close()


# ---------------------------------------------------------------------------
# The server facade, health, and the engine's typed errors
# ---------------------------------------------------------------------------

def test_program_server_matches_the_reference():
    from repro.resilience import FaultPlan, FaultSpec
    plan = FaultPlan([FaultSpec(site="dispatch", kind="error", rid=1,
                                times=-1)])
    outs = []
    for side in (REF, PORT):
        srv = side.server(promote_after=None,
                          injector=side.res.FaultInjector(side.plan(plan)))
        handles = [srv.submit(side.program(p), m) for p, m in _daxpy(3)]
        done = srv.run_until_drained()
        assert sorted(done) == [0, 1, 2]
        assert srv.health()["quarantine"]["total"] == 1
        stats = srv.latency_stats()
        assert set(stats) == {"mean", "p50", "p95"}
        outs.append((srv.scheduler, [h.ticket for h in handles], None))
        srv.scheduler.close()
        assert handles[1].result is None
        assert isinstance(handles[1].error, side.res.QuarantinedError)
    _assert_parity(*outs)
    result = outs[1][1][0].result()
    assert isinstance(result.memory, np.ndarray) and all(
        isinstance(v, np.ndarray) for v in result.regs.values())


def test_health_snapshot_matches_the_reference():
    plan = _spec(site="dispatch", kind="error", rid=0)
    ref, port = _run_both(_daxpy(2), plan=plan, promote_after=None,
                          audit_rate=1.0)
    _assert_parity(ref, port)
    hr, hp = ref[0].health(), port[0].health()
    assert set(hp) == set(hr)
    for key in ("pending", "closed", "breakers", "quarantine", "counters",
                "audit", "injected"):
        assert hp[key] == hr[key], key
    assert hp["counters"]["recovered"] == 2


@pytest.mark.parametrize("site,error", [("vm.dispatch", "DispatchError"),
                                        ("vm.finalize", "FinalizeError")])
def test_a_failing_dispatch_raises_the_same_typed_error(site, error):
    """The engine's pass-through tuples agree: a ``NotImplementedError``
    raised inside a dispatch or finalize comes out as the same
    ``ExecutorError`` subclass in both packages (and a ``ValueError``
    passes through untyped in both)."""
    (p, m), = _daxpy(1)
    for raised, want in ((NotImplementedError, error),
                         (ValueError, "ValueError")):
        got = []
        for side in (REF, PORT):
            def hook(name, **ctx):
                if name == site:
                    raise raised("failing " + name)
            kw = side.extra
            cp = side.engine.compile_program(side.program(p), mode="vm",
                                             **kw)
            prev = side.engine.set_fault_hook(hook)
            try:
                with pytest.raises(Exception) as ei:
                    cp.run(m)
            finally:
                side.engine.set_fault_hook(prev)
            got.append(type(ei.value).__name__)
        assert got == [want, want], (site, raised)


def test_serve_results_live_on_the_host():
    """``ServeResult`` holds NumPy arrays, batched or single, and no
    scheduler wait happens on the CPU device."""
    stream = request_stream(_QUICK_MIX)
    with PORT.scheduler(promote_after=2) as s:
        ts = [s.submit(r.program, r.memory) for _, r in stream]
        s.drain()
        assert s.host_syncs == 0
    for t in ts:
        r = t.result()
        assert isinstance(r.memory, np.ndarray)
        assert isinstance(r.tag, np.ndarray)
        assert r.trace                        # lazily materialized
