"""``repro_torch.nn`` vs ``repro.nn``: the model-block zoo on the MVE path.

Every case of the reference's ``tests/test_nn.py`` contract, run on the
port (``device="cpu"``, where the MVE kernels' wrappers take their plain
versions) and held against the reference on the same NumPy inputs:

* the three composite ops — ``exp_approx`` and ``recip_approx`` within
  their stated errors, ``tree_reduce_dim0`` for add, max and min — with
  the port's memory bit-equal to the reference's;
* every block: the same program and image as the reference's, and the
  port's stepwise, fused and VM executions bit-equal to the reference's
  ``run_stepwise`` (memory, registers, Tag, trace) — ``attn_tile`` too,
  since the program is the same; only its oracle check is the
  ``ATTN_RTOL`` bound;
* every block on every target and at the highest ``opt_level``, through
  the port's scheduler, and assembled per model by ``model_blocks``
  (rows and multipliers equal to the reference's).

The frozen cost rows of ``tests/data/nn_goldens.json`` are checked in
``tests/test_torch_nn_goldens.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.isa import DType as RefDType
from repro.frontend import KernelBuilder as RefBuilder
from repro.kernels import ref as ref_oracles
from repro.nn import BLOCK_KERNELS as REF_BLOCKS
from repro.nn import model_blocks as ref_model_blocks
from repro.nn import ops as ref_ops

from repro_torch import convert, opt, targets
from repro_torch.core import MVEConfig
from repro_torch.core.engine import compile_program
from repro_torch.core.isa import DType
from repro_torch.frontend import SEQ, KernelBuilder
from repro_torch.kernels import ref
from repro_torch.nn import (ATTN_RTOL, BLOCK_KERNELS, MULTIDIM_BLOCKS,
                            model_blocks, ops)

from _torch_parity import (PORT_ORACLE, REF_ORACLE, assert_bits_equal,
                           assert_state_equal, assert_trace_equal)

CFG = MVEConfig()


# ---------------------------------------------------------------------------
# Composite ops: the three ISA gaps.
# ---------------------------------------------------------------------------

REF = (RefBuilder, ref_ops, RefDType)
PORT = (KernelBuilder, ops, DType)


def _unary(pkg, build, xs):
    """Trace ``y = build(ops, b, x)`` over a 1-D input with one package's
    builder, ops and types; returns the kernel."""
    builder, op_module, dtypes = pkg
    b = builder("unary")
    xo = b.input("x", (len(xs),), dtypes.F, init=xs)
    yo = b.output("y", (len(xs),), dtypes.F)
    b.width(32)
    with b.dims(len(xs)):
        yo.store(build(op_module, b, xo.load(SEQ)), SEQ)
    return b.build()


def _run_unary_both(build, xs):
    """The port's ``y`` (fused, on the CPU), after checking that its
    program and result equal the reference's bit for bit."""
    xs = np.asarray(xs, np.float32)
    k, rk = _unary(PORT, build, xs), _unary(REF, build, xs)
    assert list(convert.program_from_reference(rk.program)) == \
        list(k.program)
    mem, _ = k.compile(device="cpu").run(k.pack())
    ref_mem, _ = REF_ORACLE.run_stepwise(rk.program, rk.pack())
    assert_bits_equal(np.asarray(ref_mem), mem.numpy(), "memory")
    return k.unpack(mem)["y"]


def test_exp_approx_accuracy():
    """Relative error < 1e-5 over the whole post-max-subtract domain, and
    ``exp(0) == 1`` exactly (the online softmax's running sum relies on
    the current chunk's max contributing exactly 1.0)."""
    xs = np.linspace(-60.0, 0.0, 2048).astype(np.float32)
    got = _run_unary_both(lambda o, b, v: o.exp_approx(b, v), xs)
    want = np.exp(xs.astype(np.float64))
    assert float((np.abs(got - want) / want).max()) < 1e-5
    assert _run_unary_both(lambda o, b, v: o.exp_approx(b, v),
                           [0.0])[0] == 1.0


def test_exp_approx_clamps_underflow():
    got = _run_unary_both(lambda o, b, v: o.exp_approx(b, v),
                          [-1e4, -500.0])
    assert np.all(got > 0.0) and np.allclose(got, np.exp(-60.0), rtol=1e-5)


def test_recip_approx_accuracy():
    """1/s to ~fp32 precision over [1, max_val] — softmax denominators."""
    xs = np.concatenate([np.linspace(1.0, 64.0, 1024),
                         [1.0, 2.0, 63.999, 64.0]]).astype(np.float32)
    got = _run_unary_both(
        lambda o, b, v: o.recip_approx(b, v, max_val=64.0), xs)
    assert float(np.abs(got * xs.astype(np.float64) - 1.0).max()) < 1e-6


def _reduce_kernel(pkg, x, op):
    builder, op_module, dtypes = pkg
    rows, n = x.shape
    b = builder("reduce")
    xo = b.inout("x", (rows, n), dtypes.F, init=x)
    ro = b.scratch("r", (rows, n), dtypes.F)
    yo = b.output("y", (rows,), dtypes.F)
    b.width(32)
    op_module.tree_reduce_dim0(b, xo, ro, n, rows, op=op)
    b.dims(rows, ld_strides={0: n})
    yo.store(ro.at(0, 0).load(op_module.CR), SEQ)
    return b.build()


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_tree_reduce_dim0(op):
    """Cross-dimension reduction, bit-equal to the reference's memory;
    add in the pairwise tree order ``tree_sum_ref`` mirrors, max/min
    equal to NumPy's."""
    x = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    k, rk = _reduce_kernel(PORT, x, op), _reduce_kernel(REF, x, op)
    assert list(convert.program_from_reference(rk.program)) == \
        list(k.program)
    ref_mem, ref_state = REF_ORACLE.run_stepwise(rk.program, rk.pack())
    for mode in ("fused", "vm"):
        mem, state = k.compile(mode=mode, device="cpu").run(k.pack())
        assert_state_equal(ref_state, state, mode)
    got = k.unpack(mem)["y"]
    if op == "add":
        np.testing.assert_array_equal(
            got, ref.tree_sum_ref(torch.from_numpy(x)).numpy())
    else:
        np.testing.assert_array_equal(got, getattr(np, op)(x, axis=1))


def test_tree_reduce_rejects_non_pow2():
    b = KernelBuilder("bad")
    xo = b.scratch("x", (4, 6), DType.F)
    b.width(32)
    with pytest.raises(ValueError):
        ops.tree_reduce_dim0(b, xo, xo, 6, 4)


def test_oracles_equal_the_reference_bit_for_bit():
    """``tree_sum_ref``, ``ssm_scan_ref`` and ``moe_gather_ref`` against
    the reference's on the same inputs (every axis of the tree sum)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 16, 8)).astype(np.float32)
    for axis in (0, 1, 2, -1):
        assert_bits_equal(np.asarray(ref_oracles.tree_sum_ref(x, axis)),
                          ref.tree_sum_ref(torch.from_numpy(x), axis).numpy(),
                          f"tree_sum axis {axis}")
    h, a = (rng.standard_normal((32, 16)).astype(np.float32)
            for _ in range(2))
    b, c = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    xv = rng.standard_normal(32).astype(np.float32)
    want = ref_oracles.ssm_scan_ref(h, a, b, xv, c)
    got = ref.ssm_scan_ref(*map(torch.from_numpy, (h, a, b, xv, c)))
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy(), "ssm_scan_ref")
    w = rng.standard_normal((8, 32)).astype(np.float32)
    experts = rng.integers(0, 8, (64, 3))
    gates = rng.uniform(0.1, 1.0, (64, 3)).astype(np.float32)
    assert_bits_equal(
        np.asarray(ref_oracles.moe_gather_ref(w, experts, gates)),
        ref.moe_gather_ref(*map(torch.from_numpy,
                                (w, experts, gates))).numpy(), "moe")


# ---------------------------------------------------------------------------
# Block kernels: the reference's programs and images, its results.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BLOCK_KERNELS))
def test_block_matches_the_reference_stepwise(name):
    """Same program, image and register budget as the reference's block;
    port stepwise == fused == VM == the reference's ``run_stepwise``
    (memory, registers, Tag, trace), each passing the block's oracle
    check; a batch of three images through fused and VM passes it too."""
    run, rrun = BLOCK_KERNELS[name](), REF_BLOCKS[name]()
    assert list(convert.program_from_reference(rrun.program)) == \
        list(run.program)
    np.testing.assert_array_equal(run.memory, rrun.memory)
    assert (run.kernel.n_regs, run.kernel.max_live, run.exactness,
            run.family, run.dim) == (rrun.kernel.n_regs,
                                     rrun.kernel.max_live, rrun.exactness,
                                     rrun.family, rrun.dim)
    assert run.kernel.n_regs <= 8
    ref_mem, ref_state = REF_ORACLE.run_stepwise(rrun.program, rrun.memory)
    rrun.check(np.asarray(ref_mem), ref_state)
    results = {"stepwise": PORT_ORACLE.run_stepwise(run.program, run.memory)}
    for mode in ("fused", "vm"):
        results[mode] = compile_program(run.program, CFG, mode=mode,
                                        device="cpu").run(run.memory)
    for what, (mem, state) in results.items():
        assert_state_equal(ref_state, state, what)
        assert_trace_equal(ref_state.trace, state.trace)
        run.check(mem, state)
    batch = np.stack([run.memory] * 3)
    for mode in ("fused", "vm"):
        mem, _, _ = compile_program(run.program, CFG, mode=mode,
                                    device="cpu").run_batch(batch)
        run.check(mem)
        assert_bits_equal(np.asarray(ref_mem), mem[2].numpy(), mode)


def test_attention_error_within_documented_bound():
    run = BLOCK_KERNELS["attn_tile"]()
    mem, _ = run.kernel.compile(device="cpu").run(run.memory)
    rrun = REF_BLOCKS["attn_tile"]()
    err = run.error_of(mem)
    assert 0.0 < err < ATTN_RTOL
    assert err == pytest.approx(rrun.error_of(mem.numpy()), rel=0.5)


@pytest.mark.parametrize("name", ["kv_scatter", "attn_tile", "gemm_tile"])
def test_check_catches_a_wrong_image(name):
    """The oracle check is not vacuous: one output element moved by a
    little more than the contract allows fails it, on one image and in a
    batch."""
    run = BLOCK_KERNELS[name]()
    mem, _ = run.kernel.compile(device="cpu").run(run.memory)
    out = next(iter(run.expected))
    op = run.kernel.plan.operands[out]
    bad = mem.clone()
    step = 1e-2 if name == "attn_tile" else 1.0
    bad[op.base + op.size - 1] += step
    with pytest.raises(AssertionError, match=name):
        run.check(bad)
    with pytest.raises(AssertionError, match=name):
        run.check(torch.stack([mem, bad]))
    run.check(torch.stack([mem, mem]))


@pytest.mark.parametrize("name", sorted(BLOCK_KERNELS))
def test_block_every_target_and_opt_level(name):
    """Each block compiles and runs bit-identically on every registered
    target (the ``*-timed`` twins included) and at the highest opt
    level."""
    run = BLOCK_KERNELS[name]()
    base, _ = run.kernel.compile(device="cpu").run(run.memory)
    assert len(targets.list_targets()) == 13
    for tname in targets.list_targets():
        mem, _ = run.kernel.compile(target=tname, device="cpu").run(
            run.memory)
        assert_bits_equal(base.numpy(), mem.numpy(), f"{name} on {tname}")
    mem, state = run.kernel.compile(opt_level=opt.MAX_OPT_LEVEL,
                                    device="cpu").run(run.memory)
    assert_bits_equal(base.numpy(), mem.numpy(), "opt")
    run.check(mem, state)


def test_blocks_through_scheduler():
    """Zoo kernels submit directly to the port's scheduler and come back
    oracle-correct and equal to the reference's run (the serving_lm
    path)."""
    from repro_torch.runtime.scheduler import MVEScheduler

    names = ("kv_gather", "moe_gather", "ssm_scan")
    runs = [BLOCK_KERNELS[n](seed=7) for n in names]
    sched = MVEScheduler(CFG, promote_after=1, device="cpu")
    tickets = [sched.submit(r.kernel) for r in runs]
    sched.drain()
    for n, r, t in zip(names, runs, tickets):
        res = t.result()
        r.check(res.memory, res)
        rrun = REF_BLOCKS[n](seed=7)
        want, _ = REF_ORACLE.run_stepwise(rrun.program, rrun.memory)
        assert_bits_equal(np.asarray(want), res.memory, n)


# ---------------------------------------------------------------------------
# Workload assembly.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quick", [True, False])
def test_model_blocks_equal_the_reference(quick):
    """The seven specs: names, multipliers, archs and notes equal to the
    reference's, each tile the reference's program and image; the quick
    tiles run and pass their checks (the full tiles run in
    ``chip_smoke.py`` and the models benchmark)."""
    specs = model_blocks(quick=quick)
    want = ref_model_blocks(quick=quick)
    assert [(s.name, s.tiles_per_layer, s.arch, s.note, s.multidim)
            for s in specs] == [(s.name, s.tiles_per_layer, s.arch, s.note,
                                 s.multidim) for s in want]
    for s, w in zip(specs, want):
        assert list(convert.program_from_reference(w.run.program)) == \
            list(s.run.program), s.name
        np.testing.assert_array_equal(s.run.memory, w.run.memory)
        assert s.tiles_per_layer >= 1.0
    assert [s.name for s in specs if s.multidim] == list(MULTIDIM_BLOCKS)
    if quick:
        for s in specs:
            mem, state = s.run.kernel.compile(device="cpu").run(s.run.memory)
            s.run.check(mem, state)


def test_model_blocks_seed_keeps_each_program_and_moves_its_image():
    """``seed`` draws other images under the same programs (a batch of
    distinct images runs one compiled program); each image passes its own
    oracle, and not another seed's."""
    base, other = model_blocks(quick=True), model_blocks(quick=True, seed=3)
    for b, o in zip(base, other):
        assert list(b.run.program) == list(o.run.program), b.name
        assert not np.array_equal(b.run.memory, o.run.memory), b.name
        mem, state = o.run.kernel.compile(device="cpu").run(o.run.memory)
        o.run.check(mem, state)
        with pytest.raises(AssertionError):
            b.run.check(mem, state)


def test_models_bench_quick_rows():
    """The port's models benchmark (``benchmarks/torch_models_bench.py``):
    the reference's rows and derived metrics, equal on ``mve-bs`` and
    ``rvv-1d``."""
    from benchmarks.models_bench import models_bench as ref_bench
    from benchmarks.torch_models_bench import models_bench

    kw = dict(only_targets=("mve-bs", "rvv-1d"), quick=True)
    rows = {name: derived for name, _, derived
            in models_bench(device="cpu", **kw)}
    want = {name: derived for name, _, derived in ref_bench(**kw)}
    assert sorted(rows) == sorted(want)
    assert "mve_ahead_on_multidim=True" in rows["models/summary"]
    assert "exactness=bit" in rows["models/qkv_gemm/oracle"]
    assert "exactness=rtol" in rows["models/attn_tile/oracle"]
    for name, derived in want.items():
        if not name.endswith("/oracle"):       # measured error differs
            assert rows[name] == derived, name


@pytest.mark.parametrize("quick", [True, False])
def test_serving_lm_stream_equals_the_reference(quick):
    """``benchmarks/torch_serving_bench.lm_block_stream`` is the reference's
    ``serving_lm`` stream: the same blocks in the same order, each the
    reference's program and image."""
    from benchmarks.serving_bench import _lm_block_stream
    from benchmarks.torch_serving_bench import lm_block_stream

    copies = 1 if quick else 2
    got, want = lm_block_stream(quick, copies), _lm_block_stream(quick,
                                                                 copies)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, r), (_, w) in zip(got, want):
        assert list(convert.program_from_reference(w.program)) == \
            list(r.program)
        np.testing.assert_array_equal(r.memory, w.memory)


def test_serving_lm_quick_rows():
    """The ``serving_lm`` section on the CPU: every served block bit-equal
    to the stepwise oracle and passing its own oracle check."""
    from benchmarks.torch_serving_bench import serving_lm

    rows = serving_lm("cpu", quick=True)
    assert rows["oracle_check"] == dict(
        rows["oracle_check"], requests_checked=6, bit_identical=True,
        blocks=6)
    assert rows["scheduler_steady"]["demotions"] == 0


def test_autotune_programs_deterministic_and_equal_to_the_reference():
    """The silicon autotuner over a block mix: the same points twice, and
    the reference's points (labels, energy, cycles) for the reference's
    blocks."""
    from repro.silicon.autotune import Candidate as RefCandidate
    from repro.silicon.autotune import autotune_programs as ref_autotune
    from repro_torch.silicon.autotune import Candidate, autotune_programs

    names = ("kv_gather", "ssm_scan")
    mix = [(n, BLOCK_KERNELS[n]().kernel, float(i + 1))
           for i, n in enumerate(names)]
    cands = [Candidate(scheme=s) for s in ("bs", "bp")]
    a = autotune_programs("mix", mix, candidates=cands)
    b = autotune_programs("mix", mix, candidates=cands)
    assert [p.label for p in a.points] == [p.label for p in b.points]
    assert a.best("energy_pj").energy_pj == b.best("energy_pj").energy_pj
    assert len(a.points) == 2 and len(a.front) >= 1
    want = ref_autotune("mix", [(n, REF_BLOCKS[n]().kernel, float(i + 1))
                                for i, n in enumerate(names)],
                        candidates=[RefCandidate(scheme=s)
                                    for s in ("bs", "bp")])
    assert [(p.label, p.energy_pj, p.cycles) for p in a.points] == \
        [(p.label, p.energy_pj, p.cycles) for p in want.points]


def test_kernels_package_imports_lazily():
    """Importing ``repro_torch.kernels`` (or just ``ref``, where the zoo's
    oracles live) loads no kernel wrapper module."""
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys; import repro_torch.kernels as kp; from "
        "repro_torch.kernels import ref; "
        "assert 'repro_torch.kernels.ref' in sys.modules; "
        "assert 'repro_torch.kernels.ops' not in sys.modules; "
        "assert 'repro_torch.kernels.mdgather' not in sys.modules; "
        "assert hasattr(ref, 'tree_sum_ref'); assert 'ops' in dir(kp)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(src)))
