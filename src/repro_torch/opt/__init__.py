"""``repro_torch.opt``: the differentially-tested optimizer pass pipeline.

Three passes over the straight-line MVE IR (:class:`repro_torch.core.isa.Program`),
each a pure ``Program -> Program`` function:

``dead-config``
    Collapse ``vsetdimc``/``vsetdiml``/``vset*str``/mask/width writes
    that re-establish control state already in effect (power-on defaults
    included) or are overwritten before anything observes them.
``cse``
    Address-pattern common-subexpression elimination: a load or splat
    whose full addressing context matches an available earlier instance
    is dropped (same destination) or becomes a register move — traces
    and instruction counts shrink at the IR level, not just in the VM's
    deduplicated pattern tables.
``schedule``
    A list scheduler that reorders independent loads ahead of compute
    under a dependence graph (Saturn-style, arXiv:2412.00997), with
    config instructions as barriers.

Entry points:

    repro_torch.opt.optimize(program, level=3)        # pipeline prefix
    repro_torch.opt.optimize(program, passes=("cse",))
    repro_torch.opt.tune(kernel, target="rvv-1d")     # cheapest schedule/target
    repro_torch.opt.verify_prefixes(program, memory)  # differential harness

or, threaded through the existing compile surfaces:

    kernel.compile(opt_level=3)
    repro_torch.targets.compile(kernel, target="mve-bs", opt_level=3)
    repro_torch.core.compile_program(program, cfg, opt_level=3)

The verification contract — bit-exact memory/registers/Tag against the
stepwise oracle, sub-multiset trace semantics, monotone instruction
count and register pressure, on every pipeline prefix and executor —
is documented in docs/OPTIMIZER.md and enforced by
:mod:`repro_torch.opt.verify`, ``tests/test_opt.py``, and the conformance
fuzzer (``tests/test_conformance.py``).
"""
from .passes import (SCHEDULE_PRIORITIES, cse, dead_config,  # noqa: F401
                     schedule)
from .pipeline import (DEFAULT_PIPELINE, MAX_OPT_LEVEL,  # noqa: F401
                       OPT_LEVELS, PASSES, OptResult, PassReport,
                       cache_clear, optimize, optimize_result,
                       pipeline_prefixes)
from .tune import TuneResult, tune  # noqa: F401
from .verify import (assert_states_equal,  # noqa: F401
                     assert_trace_semantics, verify_across_targets,
                     verify_optimized, verify_prefixes)
