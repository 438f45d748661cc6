"""Quickstart on the PyTorch/CUDA port: the README's two examples.

First the ``daxpy`` kernel written against the tracing frontend (named
operands, a dimension scope, no register numbers), then the same kind of
program written by hand from ``isa`` intrinsics — both compiled by
``compile_program``, executed on a flat memory image, checked against the
step oracle and priced by the cost model.

    PYTHONPATH=src python examples/quickstart_torch.py              # cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On ``cuda`` every strided load and store runs through the hand-written
``mdgather`` / ``mdscatter`` kernels (built with ``nvcc`` at first use);
on ``cpu`` through their plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

import repro_torch.frontend as mve
from repro_torch.core import (MVEConfig, MVEInterpreter, cache_info,
                              compile_program, cost, isa)
from repro_torch.core.isa import DType
from repro_torch.frontend import SEQ

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
device = parser.parse_args().device


# -- 1. a frontend kernel -------------------------------------------------
@mve.kernel
def daxpy(b, n=8192, alpha=1.5):
    x = b.input("x", (n,), DType.F)
    y = b.inout("y", (n,), DType.F)
    b.width(32)
    with b.dims(n):
        vx = x.load(SEQ)
        vy = y.load(SEQ)
        vy += alpha * vx                   # vsetdup + vmul + vadd
        y.store(vy, SEQ)


k = daxpy()                                # trace -> regalloc -> validate
print("the built kernel (registers assigned by the allocator):")
print(k.dump())

rng = np.random.default_rng(0)
xs = rng.standard_normal(8192).astype(np.float32)
ys = rng.standard_normal(8192).astype(np.float32)
out, state = k.run({"x": xs, "y": ys}, device=device)   # named in, named out
np.testing.assert_array_equal(out["y"], ys + np.float32(1.5) * xs)
print(f"\ndaxpy on {state.memory.device}: y[:4] = {out['y'][:4]}")

cfg = MVEConfig()
tl = cost.simulate(state.trace, cfg)
energy = cost.mve_energy(tl, cfg, cost.data_bytes(state.trace))
print(f"modeled: {tl.total_cycles:.0f} cycles, "
      f"{energy.total_pj / 1e6:.3f} uJ on the bit-serial engine")

# -- 2. the same machine from raw intrinsics ------------------------------
prog = [isa.vsetwidth(32), isa.vsetdimc(1), isa.vsetdiml(0, 8192),
        isa.vsld(DType.F, 0, 0, 1),        # unit-stride load
        isa.vadd(DType.F, 0, 0, 0),
        isa.vsst(DType.F, 0, 8192, 1)]
memory = np.concatenate([xs, np.zeros(8192, np.float32)])
cp = compile_program(prog, cfg, device=device)
mem_after, state = cp.run(memory)          # state.trace feeds cost models
np.testing.assert_array_equal(mem_after[8192:].cpu().numpy(), xs + xs)

# the step oracle agrees bit for bit
mem_step, _ = MVEInterpreter(cfg, compiled=False,
                             device=device).run_stepwise(prog, memory)
assert torch.equal(mem_after, mem_step)

# one call over a batch of images
batch_out, regs, tag = cp.run_batch(np.stack([memory, 2 * memory]))
np.testing.assert_array_equal(batch_out[1, 8192:].cpu().numpy(), 4 * xs)
print(f"raw program: {len(state.trace)} trace events, batch result "
      f"{tuple(batch_out.shape)}, {cache_info()}")
