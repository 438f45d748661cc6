"""``repro_torch.core.engine``: port fused == port stepwise == reference
``run_stepwise`` — memory, registers, Tag bit-equal, traces equal — plus
batching, the compile cache, devices and the typed errors.
"""
import numpy as np
import pytest
import torch

from repro.core import compile_program as ref_compile
from repro.core import isa as ref_isa
from repro.core.isa import DType
from repro.core.patterns import PATTERNS as REF_PATTERNS

from repro_torch import convert
from repro_torch.core import MVEConfig, cache_info, compile_program, isa
from repro_torch.core import engine, vm
from repro_torch.core.patterns import (PATTERNS, run_pattern,
                                       run_pattern_batch, sweep)

from _torch_parity import (PORT_ORACLE, REF_ORACLE, TRAP_PROGRAMS,
                           assert_bits_equal, assert_state_equal,
                           check_program, random_program)

CFG = MVEConfig()


@pytest.mark.parametrize("name", sorted(REF_PATTERNS))
def test_engine_matches_both_oracles_on_patterns(name):
    run = REF_PATTERNS[name]()
    mem, state = check_program(run.program, run.memory)
    run.check(mem.numpy(), state)


@pytest.mark.parametrize("name", sorted(TRAP_PROGRAMS))
def test_engine_matches_both_oracles_on_trap_programs(name):
    make_program, make_image = TRAP_PROGRAMS[name]
    check_program(make_program(), make_image())


@pytest.mark.parametrize("seed", range(12, 24))
def test_engine_matches_both_oracles_on_random_programs(seed):
    check_program(*random_program(seed))


def test_masked_random_store_follows_the_reference_oracle():
    """Masked lanes of a random-base store write nowhere.  The reference's
    *fused* executor sends them to index -1, which wraps onto the image's
    last element; its stepwise oracle drops them.  The port's two
    executors follow the oracle."""
    i = ref_isa
    mem = np.zeros(64)
    mem[:16] = np.arange(16) + 1
    mem[32:36] = [40, 44, 48, 52]                 # row pointers
    mem[63] = 77.0                                # the image's last element
    prog = [i.vsetdimc(2), i.vsetdiml(0, 4), i.vsetdiml(1, 4),
            i.vsld(DType.F, 0, 0, 1, 2), i.vunsetmask(2),
            i.vrst(DType.F, 0, 32, 1, 0)]
    ref_mem, _ = REF_ORACLE.run_stepwise(prog, mem)
    got, _ = check_program(prog, mem)
    assert got[63] == 77 and np.asarray(ref_mem)[63] == 77
    np.testing.assert_array_equal(got[48:52].numpy(), 0)      # masked row
    np.testing.assert_array_equal(got[52:56].numpy(), [13, 14, 15, 16])
    faulty, _ = ref_compile(prog, mode="fused").run(mem)
    assert np.asarray(faulty)[63] != 77           # the fault, as logged


@pytest.mark.parametrize("name", ["daxpy", "upsample", "transpose",
                                  "rgb2gray"])
def test_run_batch_equals_per_image_runs(name):
    """One ``run_batch`` over stacked images == one ``run`` per image, in
    memory, registers and Tag (``upsample``: the pointer tables differ per
    image — random-base addresses are data)."""
    seeds = [0, 1, 7]
    runs = [PATTERNS[name](seed=s) for s in seeds]
    assert all(r.program == runs[0].program for r in runs)
    cp = compile_program(runs[0].program, CFG, device="cpu")
    mems, regs, tag = cp.run_batch(np.stack([r.memory for r in runs]))
    assert mems.shape == (len(seeds),) + runs[0].memory.shape
    for b, r in enumerate(runs):
        mem_1, st_1 = cp.run(r.memory)
        assert torch.equal(mems[b], mem_1)
        assert set(regs) == set(st_1.regs)
        for k, v in st_1.regs.items():
            assert regs[k].dtype == v.dtype and torch.equal(regs[k][b], v)
        assert torch.equal(tag[b], st_1.tag)
        r.check(mems[b].numpy(), None)
    _, batched = run_pattern_batch(name, seeds, CFG, device="cpu")
    np.testing.assert_array_equal(batched, mems.numpy())


def test_run_pattern_batch_falls_back_for_data_dependent_programs():
    runs, mems = run_pattern_batch("spmm", [0, 1], CFG, device="cpu")
    assert runs[0].program != runs[1].program
    for r, got in zip(runs, mems):
        r.check(np.asarray(got), None)


def test_batch_with_colliding_random_stores():
    """Per-image winners of a random-base store whose pointers collide
    differently in every image of the batch."""
    prog, mem = TRAP_PROGRAMS["random_base_duplicates"]
    prog, base = convert.program_from_reference(prog()), mem()
    images = np.stack([base, base, base])
    images[1, 600:608] = [2048] * 8
    images[2, 600:608] = [4095, 4094, 2048, 2049, 4095, 4094, 2048, 2049]
    cp = compile_program(prog, device="cpu")
    mems, _, _ = cp.run_batch(images)
    for b in range(3):
        assert_bits_equal(PORT_ORACLE.run_stepwise(prog, images[b])[0]
                          .numpy(), mems[b].numpy())


def test_compile_cache_returns_same_object():
    run = PATTERNS["daxpy"]()
    engine.clear_cache()
    a = compile_program(run.program, CFG, device="cpu")
    b = compile_program(list(run.program), CFG, device="cpu")
    assert a is b
    info = cache_info()
    assert (info.program_hits, info.program_misses, info.program_size) == \
        (1, 1, 1)
    engine.clear_cache()
    c = compile_program(run.program, CFG, device="cpu")
    assert c is not a and cache_info().program_misses == 1


def test_compile_cache_is_a_bounded_lru(monkeypatch):
    monkeypatch.setattr(engine, "_CACHE_CAPACITY", 2)
    engine.clear_cache()
    progs = [[isa.vsetdimc(1), isa.vsetdiml(0, n)] for n in (2, 3, 4)]
    first = compile_program(progs[0], device="cpu")
    compile_program(progs[1], device="cpu")
    compile_program(progs[2], device="cpu")
    info = cache_info()
    assert info.program_size == 2 and info.program_evictions == 1
    assert compile_program(progs[0], device="cpu") is not first
    engine.clear_cache()


def test_static_trace_exact_without_random_ops():
    run = PATTERNS["daxpy"]()
    cp = compile_program(run.program, CFG, device="cpu")
    _, st = cp.run(run.memory)
    assert len(cp.static_trace) == len(st.trace)
    for a, b in zip(cp.static_trace, st.trace):
        assert a.same_as(b) and a is not b
    assert cp.warmup(run.memory.shape[0], batch=4) is cp


def test_async_split_and_group_key():
    run = PATTERNS["alpha_blend"]()
    cp = compile_program(run.program, CFG, device="cpu")
    mem, st = cp.finalize_run(cp.run_async(run.memory))
    run.check(mem.numpy(), st)
    mems, _, _ = cp.finalize_batch(
        cp.run_batch_async(np.stack([run.memory, run.memory])))
    assert torch.equal(mems[0], mem) and torch.equal(mems[1], mem)
    key = cp.batch_group_key(run.memory)
    assert key == cp.batch_group_key(np.array(run.memory))
    assert key != cp.batch_group_key(run.memory[:-1])


def test_run_never_writes_the_callers_image():
    run = PATTERNS["memcpy"]()
    host = run.memory.astype(np.float32)
    tensor = torch.from_numpy(host.copy())
    cp = compile_program(run.program, CFG, device="cpu")
    out, _ = cp.run(tensor)
    assert out is not tensor and torch.equal(tensor, torch.from_numpy(host))
    assert not torch.equal(out, tensor)


def test_sweep_and_run_pattern():
    out = sweep(["daxpy", "png_up"], CFG, device="cpu")
    assert sorted(out) == ["daxpy", "png_up"]
    run = PATTERNS["alpha_blend"]()
    mem_c, st_c = run_pattern(run, CFG, compiled=True, device="cpu")
    mem_s, st_s = run_pattern(run, CFG, compiled=False, device="cpu")
    assert torch.equal(mem_c, mem_s) and len(st_c.trace) == len(st_s.trace)


def test_what_is_not_ported_yet_raises():
    prog = PATTERNS["daxpy"]().program
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_program(prog, CFG, mode="vm", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_program(prog, CFG, opt_level=2, device="cpu")
    with pytest.raises(ValueError, match="unknown engine mode"):
        compile_program(prog, CFG, mode="jit", device="cpu")


def test_cuda_is_the_default_and_never_falls_back():
    prog = PATTERNS["daxpy"]().program
    if torch.cuda.is_available():
        assert compile_program(prog, CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        compile_program(prog, CFG)
    cp = compile_program(prog, CFG, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        cp.run(PATTERNS["daxpy"]().memory, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        run_pattern(PATTERNS["daxpy"]())


def test_typed_errors_and_fault_hook():
    run = PATTERNS["daxpy"]()
    with pytest.raises(isa.ProgramError, match="dimension count"):
        compile_program([isa.Instr(isa.Op.SET_DIMC, imm=9)], device="cpu")
    cp = compile_program(run.program, CFG, device="cpu")
    with pytest.raises(TypeError, match="frontend kernel"):
        cp.run({"x": np.zeros(4)})
    with pytest.raises(ValueError, match="flat"):
        cp.run(np.zeros((2, 64)))
    with pytest.raises(ValueError, match="batch"):
        cp.run_batch(np.zeros(64))

    def hook(site, **ctx):
        if site == "engine.dispatch":
            raise OSError("injected")

    prev = vm.set_fault_hook(hook)
    try:
        with pytest.raises(OSError):
            cp.run(run.memory)
    finally:
        vm.set_fault_hook(prev)
    # an internal failure at a boundary comes out typed, cause chained
    broken = compile_program([isa.vsetdimc(1), isa.vsetdiml(0, 4),
                              isa.vsld(isa.DType.F, 0, 0, 1)], device="cpu")
    broken.steps[-1].mask_slot = 99          # IndexError inside the executor
    with pytest.raises(engine.DispatchError) as err:
        broken.run(np.zeros(8))
    assert isinstance(err.value, engine.ExecutorError)
    assert err.value.__cause__ is not None
    engine.clear_cache()
