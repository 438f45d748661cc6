"""``repro_torch.core.vm``: the program-as-data VM (``mode="vm"``).

Port VM == port fused == port stepwise == reference ``run_stepwise`` ==
reference VM — memory, registers, Tag bit for bit, traces equal — on the 14
Section-IV patterns and on every case of the reference's ``tests/test_vm.py``;
the lowering's tables and signatures equal the reference's; the signature
cache counts as the reference's does.
"""
import numpy as np
import pytest
import torch

from repro.core import compile_program as ref_compile
from repro.core import isa as ref_isa
from repro.core import vm as ref_vm
from repro.core.isa import DType, Op
from repro.core.machine import MVEConfig as RefConfig
from repro.core.machine import store_layout as ref_store_layout
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert
from repro_torch.core import MVEConfig, cache_info, compile_program, vm
from repro_torch.core.machine import OOB_BASE, next_pow2, store_layout
from repro_torch.core.patterns import PATTERNS, run_pattern_batch

from _torch_parity import (PORT_ORACLE, assert_bits_equal,
                           check_all_executors)

CFG = MVEConfig()
I = ref_isa


@pytest.mark.parametrize("name", sorted(REF_PATTERNS))
def test_vm_matches_every_executor_on_patterns(name):
    run = REF_PATTERNS[name]()
    (mem, state), cp = check_all_executors(run.program, run.memory)
    assert cp.mode == "vm"
    run.check(mem.numpy(), state)


@pytest.mark.parametrize("name", ["daxpy", "gemm", "spmm", "transpose",
                                  "upsample", "intra_pred"])
def test_lowering_tables_equal_the_reference(name):
    """The NumPy lowering is the reference's: every table bit for bit, the
    same register map, dtypes, row counts and signature."""
    run = REF_PATTERNS[name]()
    want = ref_compile(run.program, mode="vm")._vm
    got = compile_program(convert.program_from_reference(run.program),
                          mode="vm", device="cpu")._vm
    for a, b in zip(want.tables, got.tables):
        assert_bits_equal(np.asarray(a), b)
    assert got.regmap == want.regmap
    assert {k: v.name for k, v in got.final_dtype.items()} == \
        {k: v.name for k, v in want.final_dtype.items()}
    assert got.table_rows == want.table_rows
    assert got.rand_slot_to_step == want.rand_slot_to_step
    n = run.memory.shape[0]
    assert got._signature(n) == want._signature(n)
    assert vm.default_signature(CFG) == ref_vm.default_signature()


def test_store_layout_equals_the_reference_on_every_pattern_store():
    """The VM's compile walk classifies every store as the reference's
    does; the fused walk, which reads no layout, computes none."""
    from repro.core.engine import CompiledProgram as RefCompiled
    checked = 0
    for name in sorted(REF_PATTERNS):
        run = REF_PATTERNS[name]()
        want = RefCompiled(run.program, RefConfig(), mode="fused").steps
        program = convert.program_from_reference(run.program)
        assert all(s.store_layout is None for s in compile_program(
            program, mode="fused", device="cpu").steps)
        got = compile_program(program, mode="vm", device="cpu").steps
        for a, b in zip(want, got):
            if a.store_layout is None:
                assert b.store_layout is None
                continue
            assert a.store_layout[0] == b.store_layout[0]
            for x, y in zip(a.store_layout[1:], b.store_layout[1:]):
                assert_bits_equal(np.asarray(x), np.asarray(y))
            checked += 1
    assert checked >= 14


def test_store_layout_classification():
    lanes = 16
    lane = np.arange(lanes, dtype=np.int64)
    mask = np.ones(lanes, dtype=bool)
    assert store_layout(lane + 7, mask) == ("contig", 7)
    assert store_layout(lane, np.zeros(lanes, dtype=bool)) == ("none",)
    kind, idx, perm = store_layout(lane * 2, mask)
    assert kind == "scatter"
    assert (np.diff(idx) > 0).all()
    np.testing.assert_array_equal(idx[idx < OOB_BASE], lane * 2)
    want = ref_store_layout(lane * 2, mask)
    assert_bits_equal(want[1], idx)
    assert_bits_equal(want[2], perm)
    assert next_pow2(1) == 1 and next_pow2(5) == 8 and next_pow2(8) == 8


def test_store_layout_last_lane_wins():
    addr = np.array([5, 5, 9, 5, 9, 3], dtype=np.int64)
    mask = np.array([True, True, True, True, False, True])
    kind, idx, perm = store_layout(addr, mask)
    assert kind == "scatter"
    live = idx < OOB_BASE
    assert {int(a): int(p) for a, p in zip(idx[live], perm[live])} == \
        {3: 5, 5: 3, 9: 2}
    want = ref_store_layout(addr, mask)
    assert_bits_equal(want[1], idx)
    assert_bits_equal(want[2], perm)


# ---------------------------------------------------------------------------
# The cases of the reference's tests/test_vm.py, through every executor.
# ---------------------------------------------------------------------------

def _predication():
    mem = np.zeros(16)
    mem[:8] = np.arange(8)
    return [I.vsetdimc(1), I.vsetdiml(0, 8), I.vsld(DType.DW, 1, 0, 1),
            I.vsetdup(DType.DW, 0, 3), I.vcmp(Op.GT, DType.DW, 1, 0),
            I.vsetdup(DType.DW, 2, 1),
            I.vadd(DType.DW, 1, 1, 2, predicated=True)], mem


def _predicated_load():
    mem = np.zeros(32)
    mem[:8] = np.arange(8)
    mem[8:16] = np.arange(100, 108)
    return [I.vsetdimc(1), I.vsetdiml(0, 8), I.vsld(DType.DW, 0, 0, 1),
            I.vsetdup(DType.DW, 1, 3), I.vcmp(Op.GT, DType.DW, 0, 1),
            I.Instr(Op.SLD, dtype=DType.DW, vd=0, base=8, modes=(1,),
                    predicated=True)], mem


def _saturation():
    mem = np.zeros(32)
    mem[:4] = [-1.5, 70000.0, 300.0, 42.0]
    return [I.vsetdimc(1), I.vsetdiml(0, 4), I.vsld(DType.F, 0, 0, 1),
            I.vcvt(DType.B, 1, 0), I.vcvt(DType.W, 2, 0),
            I.vsld(DType.B, 3, 0, 1), I.vsld(DType.W, 4, 0, 1)], mem


def _masked_blend():
    mem = np.zeros(64)
    mem[:32] = np.arange(32)
    return [I.vsetdimc(2), I.vsetdiml(0, 8), I.vsetdiml(1, 4),
            I.vsld(DType.F, 0, 0, 1, 2), I.vunsetmask(1), I.vunsetmask(3),
            I.vsst(DType.F, 0, 32, 1, 2)], mem


def _strided_scatter():
    mem = np.zeros(128)
    mem[:16] = np.arange(16) + 1
    return [I.vsetdimc(1), I.vsetdiml(0, 16), I.vsetststr(0, 2),
            I.vsld(DType.F, 0, 0, 1), I.vsst(DType.F, 0, 64, 3)], mem


def _colliding_store():
    mem = np.zeros(64)
    mem[:12] = np.arange(12)
    return [I.vsetdimc(2), I.vsetdiml(0, 4), I.vsetdiml(1, 3),
            I.vsld(DType.F, 0, 0, 1, 2), I.vsst(DType.F, 0, 32, 1, 0)], mem


VM_CASES = {"predication_and_tag": _predication,
            "predicated_load_ignores_tag": _predicated_load,
            "float_to_narrow_int_saturates": _saturation,
            "masked_store_blend": _masked_blend,
            "noncontiguous_store_scatter": _strided_scatter,
            "colliding_store_last_lane_wins": _colliding_store}


@pytest.mark.parametrize("name", sorted(VM_CASES))
def test_reference_vm_cases(name):
    (mem, state), cp = check_all_executors(*VM_CASES[name]())
    assert cp.mode == "vm"
    got = mem.numpy()
    if name == "predicated_load_ignores_tag":
        np.testing.assert_array_equal(state.regs[0][:8].numpy(),
                                      np.arange(100, 108))
    if name == "float_to_narrow_int_saturates":
        np.testing.assert_array_equal(state.regs[1][:4].numpy(),
                                      [0, 255, 255, 42])
        np.testing.assert_array_equal(state.regs[2][:4].numpy(),
                                      [-1, 32767, 300, 42])
    if name == "masked_store_blend":
        np.testing.assert_array_equal(got[40:48], 0)
        np.testing.assert_array_equal(got[48:56], np.arange(16, 24))
    if name == "noncontiguous_store_scatter":
        np.testing.assert_array_equal(got[64:96:2], np.arange(16) + 1)
        np.testing.assert_array_equal(got[65:96:2], 0)
    if name == "colliding_store_last_lane_wins":
        np.testing.assert_array_equal(got[32:36], np.arange(8, 12))


def test_nonfloat_memory_routes_to_fused():
    mem = np.zeros(64, dtype=np.int32)
    mem[:8] = (1 << 24) + 1          # not representable in float32
    prog = [I.vsetdimc(1), I.vsetdiml(0, 8), I.vsld(DType.DW, 0, 0, 1),
            I.vsst(DType.DW, 0, 16, 1)]
    cp = compile_program(convert.program_from_reference(prog), CFG,
                         mode="vm", device="cpu")
    assert cp.mode == "vm"
    assert not cp._use_vm(mem) and cp._use_vm(mem.astype(np.float64))
    got, _ = cp.run(mem)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[16:24].numpy(), (1 << 24) + 1)
    check_all_executors(prog, mem)


def test_fallback_too_many_registers():
    mem = np.zeros(32)
    mem[:8] = np.arange(8)
    prog = [I.vsetdimc(1), I.vsetdiml(0, 8)]
    prog += [I.vsetdup(DType.DW, r, r) for r in range(vm.N_REGS + 2)]
    before = cache_info().vm_fallbacks
    (_, _), cp = check_all_executors(prog, mem)
    assert cp.mode == "fused"
    assert cache_info().vm_fallbacks == before + 1
    # the fallback also answers an explicit mode="fused" request
    assert compile_program(cp.program, CFG, mode="fused",
                           device="cpu") is cp


def test_one_executor_for_the_whole_sweep():
    """Every pattern maps to one signature: the sweep adds at most 2
    executor builds (the reference's acceptance bound)."""
    before = cache_info()
    sigs = set()
    for name in sorted(PATTERNS):
        run = PATTERNS[name]()
        cp = compile_program(run.program, CFG, mode="vm", device="cpu")
        cp.run(run.memory)
        sigs.add(cp._vm._signature(run.memory.shape[0]))
    assert len(sigs) == 1
    assert cache_info().vm_xla_compiles - before.vm_xla_compiles <= 2


def test_spmm_variants_share_one_executor():
    base = PATTERNS["spmm"]()
    compile_program(base.program, CFG, mode="vm",
                    device="cpu").run(base.memory)
    before = cache_info().vm_xla_compiles
    for seed, density in ((3, 0.1), (4, 0.3), (5, 0.4)):
        run = PATTERNS["spmm"](seed=seed, density=density)
        assert run.program != base.program
        mem, state = compile_program(run.program, CFG, mode="vm",
                                     device="cpu").run(run.memory)
        run.check(mem.numpy(), state)
    assert cache_info().vm_xla_compiles == before


def test_warmup_marks_the_geometry_and_uploads_the_tables():
    run = PATTERNS["daxpy"]()
    cp = compile_program(run.program, CFG, mode="vm", device="cpu")
    vm.clear_executors()
    assert cp.warmup(run.memory.shape[0]) is cp
    assert torch.device("cpu") in cp._operands
    assert (vm.cache_info().signatures, vm.cache_info().executors) == (1, 1)
    mem, state = cp.run(run.memory)
    run.check(mem.numpy(), state)
    assert vm.cache_info().executors == 1      # the run found it warm
    cp.warmup(run.memory, batch=3)
    assert vm.cache_info().executors == 2      # + the batch executor


def test_batch_matches_per_image_runs():
    seeds = [0, 1, 2, 3]
    runs, mems = run_pattern_batch("daxpy", seeds, CFG, mode="vm",
                                   device="cpu")
    assert mems.shape[0] == len(seeds)
    for r, got in zip(runs, mems):
        mem_i, _ = PORT_ORACLE.run_stepwise(r.program, r.memory)
        np.testing.assert_array_equal(mem_i.numpy(), got)
        r.check(got, None)


@pytest.mark.parametrize("name", ["upsample", "transpose", "rgb2gray"])
def test_vm_batch_equals_fused_batch(name):
    """One ``run_batch`` through the VM == the fused batch, in memory,
    registers with their types, and Tag (``upsample``: pointer tables per
    image)."""
    seeds = [0, 1, 7]
    runs = [PATTERNS[name](seed=s) for s in seeds]
    images = np.stack([r.memory for r in runs])
    out = {mode: compile_program(runs[0].program, CFG, mode=mode,
                                 device="cpu").run_batch(images)
           for mode in ("vm", "fused")}
    (mv, rv, tv), (mf, rf, tf) = out["vm"], out["fused"]
    assert torch.equal(mv, mf) and torch.equal(tv, tf)
    assert set(rv) == set(rf)
    for k in rf:
        assert_bits_equal(rf[k].numpy(), rv[k].numpy(), f"v{k}")
    for b, r in enumerate(runs):
        r.check(mv[b].numpy(), None)


def test_async_split_group_key_and_fault_sites():
    run = PATTERNS["alpha_blend"]()
    cp = compile_program(run.program, CFG, mode="vm", device="cpu")
    sites = []
    prev = vm.set_fault_hook(lambda site, **ctx: sites.append(site))
    try:
        mem, st = cp.finalize_run(cp.run_async(run.memory))
    finally:
        vm.set_fault_hook(prev)
    run.check(mem.numpy(), st)
    assert sites == ["engine.dispatch", "vm.dispatch", "engine.finalize",
                     "vm.finalize"]
    key = cp.batch_group_key(run.memory)
    assert key[0] == "vm" and key[1] == vm.default_signature(CFG)
    assert cp.batch_group_key(run.memory.astype(np.int32))[0] == "fused"


def test_api_kept_from_the_reference():
    assert vm.restore_disk_cache(vm.enable_disk_cache()) is None
    assert vm.prewarm(CFG) is None and vm.prewarm(CFG, block=False) is None
    assert cache_info().vm_signatures >= 1
    assert cache_info().vm_xla_compiles == cache_info().vm_executors
    vm.clear_executors()
    info = vm.cache_info()
    assert (info.signatures, info.hits, info.xla_compiles) == (0, 0, 0)

