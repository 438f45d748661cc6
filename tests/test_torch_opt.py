"""The optimizer (``repro_torch.opt``) against the reference's
(``repro.opt``): the same program text in, the same program text out.

* ``optimize`` at every level up to ``MAX_OPT_LEVEL`` and every single pass
  gives the reference's output instruction for instruction, with the same
  per-pass audit (counts, pressures, reverts), on the 14 Section-IV
  patterns and on seeded random programs (the reference's conformance
  fuzzer and the port's own generator);
* every row of ``tests/data/opt_goldens.json`` reproduces (read, never
  regenerated);
* ``verify_prefixes``/``verify_optimized``/``verify_across_targets`` pass
  on the port's executors (``device="cpu"``);
* ``opt_level=`` threads through ``compile_program``, ``Kernel.compile``
  and ``targets.compile``; ``tune`` sweeps the reference's table.
"""
import json
import pathlib

import numpy as np
import pytest

from repro import opt as ref_opt
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert, opt, targets
from repro_torch.core import MVEConfig, compile_program, cost, isa
from repro_torch.core.patterns import PATTERNS

from _torch_parity import random_program

GOLDEN = pathlib.Path(__file__).parent / "data" / "opt_goldens.json"
CFG = MVEConfig()


def _reports(res):
    return [(r.name, r.instructions_in, r.instructions_out, r.pressure_in,
             r.pressure_out, r.reverted) for r in res.reports]


def _check_same_pipeline(ref_program, what):
    """Every level and every single pass: port output == reference output
    (as the port's instructions), audit trail included."""
    port_program = convert.program_from_reference(ref_program)
    runs = [{"level": k} for k in range(ref_opt.MAX_OPT_LEVEL + 1)]
    runs += [{"passes": (name,)} for name in ref_opt.DEFAULT_PIPELINE]
    for kw in runs:
        want = ref_opt.optimize_result(ref_program, **kw)
        got = opt.optimize_result(port_program, **kw)
        assert list(got.program) == list(
            convert.program_from_reference(want.program)), (what, kw)
        assert _reports(got) == _reports(want), (what, kw)


def test_registry_matches_the_reference():
    assert opt.DEFAULT_PIPELINE == ref_opt.DEFAULT_PIPELINE
    assert opt.MAX_OPT_LEVEL == ref_opt.MAX_OPT_LEVEL
    assert opt.OPT_LEVELS == ref_opt.OPT_LEVELS
    assert list(opt.SCHEDULE_PRIORITIES) == list(ref_opt.SCHEDULE_PRIORITIES)
    assert opt.pipeline_prefixes() == ref_opt.pipeline_prefixes()


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_optimize_matches_the_reference_on_patterns(name):
    _check_same_pipeline(REF_PATTERNS[name]().program, name)
    for priority in opt.SCHEDULE_PRIORITIES:
        want = ref_opt.schedule(REF_PATTERNS[name]().program,
                                priority=priority)
        got = opt.schedule(PATTERNS[name]().program, priority=priority)
        assert list(got) == list(convert.program_from_reference(want))


def _conformance_program(seed):
    from test_conformance import _random_program_ex
    return _random_program_ex(seed, variants=1)[0]


@pytest.mark.parametrize("seed", range(10))
def test_optimize_matches_the_reference_on_random_programs(seed):
    """The reference's conformance fuzzer and the port's own generator
    (colliding, stride-0 and random-base stores)."""
    _check_same_pipeline(_conformance_program(seed), f"fuzz {seed}")
    _check_same_pipeline(random_program(100 + seed)[0], f"port {seed}")


# ---------------------------------------------------------------------------
# The frozen goldens
# ---------------------------------------------------------------------------

def _pattern_entry(name: str) -> dict:
    """``tests/test_opt_goldens.py::_pattern_entry`` on the port."""
    run = PATTERNS[name]()
    res = opt.optimize_result(run.program, level=opt.MAX_OPT_LEVEL)
    prefix_counts = {
        "+".join(prefix) or "none":
            len(opt.optimize(run.program, passes=prefix))
        for prefix in opt.pipeline_prefixes()
    }
    tl0 = cost.simulate(compile_program(run.program, CFG, mode="vm",
                                        device="cpu").static_trace, CFG)
    tl3 = cost.simulate(compile_program(res.program, CFG, mode="vm",
                                        device="cpu").static_trace, CFG)
    return {
        "instructions": {"level0": len(res.source),
                         "full": len(res.program)},
        "prefix_instructions": prefix_counts,
        "removed_by_pass": {r.name: r.removed for r in res.reports},
        "cycles": {"level0": int(tl0.total_cycles),
                   "full": int(tl3.total_cycles)},
    }


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_pipeline_and_patterns(golden):
    assert golden["pipeline"] == list(opt.DEFAULT_PIPELINE)
    assert sorted(golden["patterns"]) == sorted(PATTERNS)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_opt_goldens_reproduce(golden, name):
    assert _pattern_entry(name) == golden["patterns"][name]


# ---------------------------------------------------------------------------
# Differential verification on the port's executors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["daxpy", "reduction", "spmm", "upsample",
                                  "transpose"])
def test_verify_prefixes_on_the_port(name):
    run = PATTERNS[name]()
    opt.verify_prefixes(run.program, run.memory, cfg=CFG,
                        modes=("vm", "fused"), device="cpu")


def test_verify_across_targets_on_the_port():
    run = PATTERNS["upsample"]()
    opt.verify_across_targets(run.program, run.memory,
                              level=opt.MAX_OPT_LEVEL, device="cpu")


def test_verify_catches_a_miscompile(monkeypatch):
    """The harness is not vacuous: a pass that drops a store fails it."""
    run = PATTERNS["daxpy"]()

    def drop_last_store(program):
        out = list(program)
        last = max(i for i, ins in enumerate(out) if ins.op is isa.Op.SST)
        return out[:last] + out[last + 1:]

    monkeypatch.setitem(opt.PASSES, "drop-store", drop_last_store)
    try:
        opt.cache_clear()
        with pytest.raises(AssertionError):
            opt.verify_optimized(run.program, run.memory,
                                 passes=("drop-store",), cfg=CFG,
                                 modes=("fused",), device="cpu")
    finally:
        opt.cache_clear()


# ---------------------------------------------------------------------------
# The compile surfaces and tune()
# ---------------------------------------------------------------------------

def test_opt_level_threads_through_compile_surfaces():
    """compile_program, targets.compile and Kernel.compile all run the
    same pipeline, agree with the reference's optimized text, and leave
    the results bit-exact."""
    run = PATTERNS["reduction"]()
    want = convert.program_from_reference(
        ref_opt.optimize(REF_PATTERNS["reduction"]().program,
                         level=ref_opt.MAX_OPT_LEVEL))
    base = compile_program(run.program, CFG, device="cpu")
    lvl = compile_program(run.program, CFG, opt_level=opt.MAX_OPT_LEVEL,
                          device="cpu")
    assert list(lvl.program) == list(want)
    assert len(lvl.program) < len(base.program)
    mem_b, _ = base.run(run.memory)
    mem_o, _ = lvl.run(run.memory)
    np.testing.assert_array_equal(mem_b.numpy(), mem_o.numpy())

    art = targets.compile(run.program, target="mve-bs", opt_level=True,
                          device="cpu")
    assert list(art.program) == list(want)
    cp = run.kernel.compile(opt_level=opt.MAX_OPT_LEVEL, device="cpu")
    assert list(cp.program) == list(want)
    run.check(cp.run(run.memory)[0].numpy(), None)


@pytest.mark.parametrize("target", ["mve-bs", "rvv-1d"])
def test_tune_sweeps_the_reference_table(target):
    """The same cycles per schedule priority and the same winner (pricing
    is host arithmetic); the winner still runs bit-exactly."""
    want = ref_opt.tune(REF_PATTERNS["daxpy"]().program, target=target)
    run = PATTERNS["daxpy"]()
    got = opt.tune(run.program, target=target, device="cpu")
    assert (got.target, got.best, got.timing) == \
        (want.target, want.best, want.timing)
    assert got.table == want.table
    assert list(got.program) == list(
        convert.program_from_reference(want.program))
    from repro_torch.core.interp import MVEInterpreter
    mem_i, st_i = MVEInterpreter(CFG, compiled=False,
                                 device="cpu").run_stepwise(run.program,
                                                            run.memory)
    opt.assert_states_equal(st_i, mem_i, got.artifact.run(run.memory)[1])
