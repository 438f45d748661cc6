"""Section IV's data-parallel patterns, executed and priced on the
PyTorch/CUDA port: the twin of ``examples/mve_patterns.py``.

Runs every Swan-library pattern (all built with the tracing kernel
frontend) through the port's execution engine on ``--device`` (default
``cuda``: every strided load and store through the hand-written
``mdgather`` / ``mdscatter`` kernels), validates each against its NumPy
oracle, prices it on the bit-serial engine against the 1-D RVV lowering,
and ends with the same multi-dimensional access done by the two kernels
directly (gather + scatter = an 8x8 transpose).

    PYTHONPATH=src python examples/mve_patterns_torch.py            # cuda
    PYTHONPATH=src python examples/mve_patterns_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import MVEConfig, cache_info, cost, rvv
from repro_torch.core.machine import resolve_device, to_numpy
from repro_torch.core.patterns import PATTERNS, run_pattern
from repro_torch.kernels.mdgather import mdgather
from repro_torch.kernels.mdscatter import mdscatter


def main(device=None):
    dev = resolve_device(device)
    cfg = MVEConfig()
    print(f"{'pattern':14s} {'library':12s} {'dim':4s} "
          f"{'mve_us':>8s} {'rvv_us':>8s} {'speedup':>8s}")
    for name in sorted(PATTERNS):
        run = PATTERNS[name]()
        mem_after, state = run_pattern(run, cfg, device=dev)
        run.check(to_numpy(mem_after), state)        # always validate
        tl = cost.simulate(state.trace, cfg)
        trace_rvv, _ = rvv.compile_to_rvv(run.program)
        tl_rvv = cost.simulate(trace_rvv, cfg)
        print(f"{name:14s} {run.library:12s} {run.dim:4s} "
              f"{tl.us(2.8):8.2f} {tl_rvv.us(2.8):8.2f} "
              f"{tl_rvv.total_cycles / tl.total_cycles:7.2f}x")

    info = cache_info()
    print(f"\n{len(PATTERNS)} programs executed on {dev} through "
          f"{info.program_misses} compile walk(s)")

    print(f"\nhand-written kernels on {dev}: matrix transpose via "
          "mdgather + mdscatter")
    m = torch.arange(64.0, dtype=torch.float32, device=dev)
    cols = mdgather(m, dims=(8, 8), strides=(8, 1), base=0)
    out = mdscatter(torch.zeros_like(m), cols, dims=(8, 8),
                    strides=(1, 8), base=0)
    np.testing.assert_array_equal(to_numpy(out).reshape(8, 8),
                                  to_numpy(m).reshape(8, 8).T)
    print("  8x8 transpose through the TMU-analogue kernels: OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="where to run: cuda (default) or cpu")
    main(parser.parse_args().device)
