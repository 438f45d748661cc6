"""``repro_torch.targets``: one pluggable Target API for every ISA x
compute-scheme x cost-model combination.

The paper's headline results are *comparisons across targets*: the same
kernel driven through MVE vs. a 1D RVV-style vector ISA vs. Arm Neon,
over the BS/BP/BH/AC in-SRAM compute schemes of Section II-B (Figures
10/11/13: 2.9x performance, 8.8x energy vs. a commercial mobile SIMD
core).  This package is that comparison matrix as an API:

    import repro_torch.targets as targets

    art = targets.compile(kernel, target="rvv-1d")   # or any Target
    out, state = art.run({"x": xs, "y": ys})
    art.timeline(state).total_cycles                 # 1D-ISA cycles
    art.energy(state).total_pj                       # component model
    art.instruction_mix().vector                     # Figure 11 currency

Registered targets (``list_targets()``): ``mve-bs`` (default),
``mve-bp``, ``mve-bh``, ``mve-ac``, ``rvv-1d``, ``neon`` — each with a
pipeline-model twin (``mve-bs-timed``, ..., ``neon-timed``) that prices
the same trace through the cycle-accurate in-order model of
:mod:`repro_torch.timing` (per-cause ``timeline().stalls``, a verified
analytic envelope; docs/TIMING.md) — plus ``mve-bicameral``, the
split-cache demo of :mod:`repro_torch.targets.bicameral`, and anything
third-party code adds via ``register_target()``.  Every target executes through the same
functional engine, so a frontend ``@mve.kernel`` runs *unchanged* on
all of them and results are bit-exact across targets (the RVV path is
the same access, sliced — asserted in ``tests/test_targets.py`` /
``tests/test_conformance.py``).  What differs per target is pricing:
instruction issue, cycles, and energy.

Design note: docs/TARGETS.md.
"""
from .base import (CompiledArtifact, InstructionMix,  # noqa: F401
                   Target, compile, get_target, list_targets,
                   register_target)
from .builtin import (DEFAULT_TARGET, MVE_AC, MVE_BH,  # noqa: F401
                      MVE_BP, MVE_BS, NEON, RVV_1D, InCacheTarget,
                      NeonTarget, RVV1DTarget)
from .timed import (MVE_AC_TIMED, MVE_BH_TIMED,  # noqa: F401
                    MVE_BP_TIMED, MVE_BS_TIMED, NEON_TIMED,
                    RVV_1D_TIMED, TimedTarget, timed_variant)
from .bicameral import MVE_BICAMERAL, BicameralTarget  # noqa: F401


def smoke(pattern: str = "daxpy", verbose: bool = False,
          device=None) -> dict:
    """Compile + run one kernel on every registered target on ``device``
    (default ``cuda``) and assert cross-target bit-exactness.

    Returns ``{target_name: modeled_total_cycles}`` (also printed with
    ``verbose=True``); raises on any cross-target result mismatch.
    """
    import numpy as np

    from ..core.machine import to_numpy
    from ..core.patterns import PATTERNS

    run = PATTERNS[pattern]()
    reference = None
    cycles = {}
    for name in list_targets():
        art = compile(run.program, target=name, device=device)
        mem_after, state = art.run(run.memory)
        mem_after = to_numpy(mem_after)
        run.check(mem_after, state)
        if reference is None:
            reference = mem_after
        else:
            np.testing.assert_array_equal(
                mem_after, reference,
                err_msg=f"target {name!r} diverged from "
                        f"{list_targets()[0]!r} on {pattern!r}")
        cycles[name] = art.timeline(state).total_cycles
        if verbose:
            print(f"targets-smoke/{pattern}/{name}: "
                  f"{cycles[name]:.0f} cycles, bit-exact")
    return cycles
