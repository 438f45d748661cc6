"""``repro_torch.frontend`` and ``core.patterns`` vs the reference: every
pattern's emitted program is instruction-identical, packing agrees, and
``Kernel.run`` outputs by name are equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.frontend as ref_mve
from repro.core.isa import DType as RefDType
from repro.core.patterns import PATTERNS as REF_PATTERNS

import repro_torch.frontend as mve
from repro_torch import convert
from repro_torch.core import compile_program, isa
from repro_torch.core.isa import DType
from repro_torch.core.patterns import PATTERNS
from repro_torch.frontend import (BCAST, CR, DERIVED, SEQ, KernelBuilder,
                                  OperandError, RegisterPressureError,
                                  regalloc)

from _torch_parity import assert_bits_equal

NAMES = sorted(REF_PATTERNS)


@pytest.mark.parametrize("name", NAMES)
def test_pattern_program_is_instruction_identical(name):
    ref_run, run = REF_PATTERNS[name](), PATTERNS[name]()
    assert isinstance(run.program, isa.Program)
    assert run.program == convert.program_from_reference(ref_run.program)
    assert [dataclasses.astuple(i)[2:] for i in run.program] == \
        [dataclasses.astuple(i)[2:] for i in ref_run.program]
    assert run.program.dump() == ref_run.program.dump()
    assert_bits_equal(ref_run.memory, run.memory, "packed image")
    assert (run.library, run.dim, run.flops, run.copy_bytes) == \
        (ref_run.library, ref_run.dim, ref_run.flops, ref_run.copy_bytes)
    k, rk = run.kernel, ref_run.kernel
    assert (k.n_vregs, k.n_regs, k.max_live) == \
        (rk.n_vregs, rk.n_regs, rk.max_live)
    assert repr(k.plan) == repr(rk.plan)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_run_outputs_equal_by_name(name):
    ref_run, run = REF_PATTERNS[name](), PATTERNS[name]()
    want, _ = ref_run.kernel.run()
    got, state = run.kernel.run(device="cpu")
    assert sorted(got) == sorted(want)
    for operand in want:
        assert_bits_equal(want[operand], got[operand], operand)
        assert_bits_equal(got[operand], state.operands[operand], operand)
    assert_bits_equal(run.results(state.memory)[sorted(want)[0]],
                      got[sorted(want)[0]])


def _daxpy(front, dtype, n=256):
    b = front.KernelBuilder("daxpy_small")
    x = b.input("x", (n,), dtype)
    y = b.inout("y", (n,), dtype)
    b.width(32)
    with b.dims(n):
        vy = y.load(front.SEQ)
        vy += 2.0 * x.load(front.SEQ)
        y.store(vy, front.SEQ)
    return b.build()


def test_named_operands_through_the_stack():
    n = 256
    k, rk = _daxpy(mve, DType.F), _daxpy(ref_mve, RefDType.F)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    want, _ = rk.run({"x": x, "y": y})
    out, state = k.run({"x": x, "y": y}, device="cpu")
    assert_bits_equal(want["y"], out["y"])
    assert_bits_equal(out["y"], y + np.float32(2.0) * x)
    cp = compile_program(k, device="cpu")
    assert cp is k.compile(device="cpu")
    _, st2 = cp.run({"x": x, "y": y})
    assert_bits_equal(st2.operands["y"], out["y"])
    outs = k.run_batch({"x": np.stack([x, 2 * x]), "y": np.stack([y, y])},
                       device="cpu")
    want_b = rk.run_batch({"x": np.stack([x, 2 * x]),
                           "y": np.stack([y, y])})
    assert_bits_equal(want_b["y"], outs["y"])
    mems, _, _ = cp.run_batch({"x": np.stack([x, 2 * x]),
                               "y": np.stack([y, y])})
    assert_bits_equal(k.unpack(mems)["y"], outs["y"])


def test_kernel_decorator_and_dump():
    @mve.kernel
    def daxpy(b, n=64, alpha=1.5):
        x = b.input("x", (n,), DType.F)
        y = b.inout("y", (n,), DType.F)
        b.width(32)
        with b.dims(n):
            vy = y.load(SEQ)
            vy += alpha * x.load(SEQ)
            y.store(vy, SEQ)

    @ref_mve.kernel
    def ref_daxpy(b, n=64, alpha=1.5):
        x = b.input("x", (n,), RefDType.F)
        y = b.inout("y", (n,), RefDType.F)
        b.width(32)
        with b.dims(n):
            vy = y.load(ref_mve.SEQ)
            vy += alpha * x.load(ref_mve.SEQ)
            y.store(vy, ref_mve.SEQ)

    assert daxpy(n=32).dump() == ref_daxpy(n=32).dump()
    assert "vsld.f" in daxpy().dump()
    assert (SEQ, BCAST, DERIVED, CR) == (ref_mve.SEQ, ref_mve.BCAST,
                                         ref_mve.DERIVED, ref_mve.CR)


def test_comparisons_and_predication_match_reference():
    def build(front, dt):
        b = front.KernelBuilder("pred")
        x = b.input("x", (16,), dt)
        y = b.output("y", (16,), dt)
        b.width(32)
        with b.dims(16):
            vx = x.load(front.SEQ)
            thr = b.const(dt, 3)
            acc = b.const(dt, 0)
            vx.gt(thr)
            acc = b.add(acc, vx, predicated=True)
            y.store(acc, front.SEQ)
        return b.build()

    k = build(mve, DType.DW)
    rk = build(ref_mve, RefDType.DW)
    assert k.program == convert.program_from_reference(rk.program)
    xs = np.arange(16)
    want, _ = rk.run({"x": xs})
    got, _ = k.run({"x": xs}, device="cpu")
    assert_bits_equal(want["y"], got["y"])
    np.testing.assert_array_equal(got["y"][4:], xs[4:])


def test_distinct_kernels_sharing_program_text_are_not_aliased():
    def build(init, n=32):
        b = KernelBuilder("aliased")
        x = b.input("x", (n,), DType.F, init=init)
        y = b.output("y", (n,), DType.F)
        b.width(32)
        with b.dims(n):
            y.store(x.load(SEQ), SEQ)
        return b.build()

    k1, k2 = build(np.full(32, 1.0)), build(np.full(32, 2.0))
    assert tuple(k1.program) == tuple(k2.program)
    assert not k1.equivalent(k2)
    cp1 = compile_program(k1, device="cpu")
    assert cp1 is compile_program(k2, device="cpu")
    with pytest.raises(TypeError, match="multiple distinct kernels"):
        cp1.run({})
    np.testing.assert_array_equal(k1.run(device="cpu")[0]["y"],
                                  np.full(32, 1.0))
    np.testing.assert_array_equal(k2.run(device="cpu")[0]["y"],
                                  np.full(32, 2.0))


def test_operand_packing_round_trip():
    b = KernelBuilder("plan")
    b.input("a", (4, 8), DType.F)
    b.input("b", (32,), DType.W)
    b.scratch("tmp", (16,), DType.F)
    b.output("c", (2, 4, 4), DType.F)
    b.width(32)
    with b.dims(32):
        b.operand("c").store(b.operand("a").load(SEQ), SEQ)
    k = b.build()
    rng = np.random.default_rng(0)
    vals = {"a": rng.standard_normal((4, 8)), "b": rng.integers(0, 99, 32),
            "c": rng.standard_normal((2, 4, 4))}
    mem = k.pack(vals)
    assert mem.shape == (4 * 8 + 32 + 16 + 32,)
    for source in (mem, torch.from_numpy(mem)):       # host array or tensor
        out = k.unpack(source)
        assert "tmp" not in out
        for name in vals:
            np.testing.assert_allclose(out[name], vals[name])
    with pytest.raises(OperandError):
        k.pack({"nope": np.zeros(3)})


def test_regalloc_and_build_errors_carry_over():
    b = KernelBuilder("reuse")
    x = b.input("x", (64,), DType.F)
    y = b.output("y", (64,), DType.F)
    b.width(32)
    with b.dims(64):
        acc = b.const(DType.F, 0.0)
        for _ in range(20):
            acc += x.at(0).load(SEQ) * 0.5
        y.store(acc, SEQ)
    k = b.build()
    assert k.n_vregs == 1 + 3 * 20 and k.n_regs == 4
    assert regalloc.DEFAULT_MAX_REGS == ref_mve.DEFAULT_MAX_REGS
    b = KernelBuilder("pressure")
    x = b.input("x", (8,), DType.F)
    b.width(32)
    with b.dims(8):
        live = [x.load(SEQ) for _ in range(regalloc.DEFAULT_MAX_REGS + 1)]
        total = live[0]
        for v in live[1:]:
            total = total + v
        x.store(total, SEQ)
    with pytest.raises(RegisterPressureError, match="register pressure"):
        b.build()
    b = KernelBuilder("oops")
    b.input("x", (8,), DType.F)
    b.width(32)
    b.dims(8)
    b.operand("x").store(mve.VectorHandle(b, 42, DType.F), SEQ)
    with pytest.raises(isa.ProgramError, match="read before"):
        b.build()


def test_other_targets_wait_for_their_port():
    """Targets are ported (a kernel compiles and runs for any of them),
    and so is the optimizer (``opt_level=``)."""
    from repro_torch.targets import CompiledArtifact
    k = _daxpy(mve, DType.F, 32)
    art = k.compile(target="rvv-1d", device="cpu")
    assert isinstance(art, CompiledArtifact) and art.cp.device.type == "cpu"
    out, _ = k.run(target="neon", device="cpu")
    want, _ = k.run(device="cpu")
    for name in want:
        np.testing.assert_array_equal(out[name], want[name])
    cp = k.compile(opt_level=2, device="cpu")
    out, _ = cp.run(k.pack(None))
    want, _ = k.compile(device="cpu").run(k.pack(None))
    assert torch.equal(out, want)
