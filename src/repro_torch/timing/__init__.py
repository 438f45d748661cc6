"""``repro_torch.timing``: a cycle-accurate in-order pipeline model.

The analytic timelines (:func:`repro_torch.core.cost.simulate`) are
single-number cycle counts; this package replays the same
:class:`~repro_torch.core.cost.TraceEvent` streams through a configurable
in-order machine — fetch/decode rates, an issue-width-limited in-order
front end, a scoreboard with RAW/WAR/WAW tracking, functional-unit
pipes with chaining, and memory-port conflicts — parameterized by
YAML-style uarch configs (:data:`UARCH_CONFIGS`: one mobile core, one
per in-cache scheme BS/BP/BH/AC).

Most users never import this directly: the ``*-timed`` targets
registered by :mod:`repro_torch.targets.timed` expose it through the uniform
artifact surface —

    art = repro_torch.targets.compile(kernel, target="mve-bs-timed")
    tl = art.timeline()
    tl.stalls                      # per-cause: dependency / structural /
                                   # memory-port / frontend
    tl.lower_bound, tl.upper_bound # the verified analytic envelope

Every timed total is contractually inside ``[lower_bound,
upper_bound]`` computed from the same ops (:func:`envelope`) — fuzzed
in ``tests/test_conformance.py``, pinned in
``tests/test_timing_goldens.py``.  Design note: docs/TIMING.md.
"""
from .model import (CHAINABLE_FUS, CTRL_REG, MEM_REG,  # noqa: F401
                    TAG_REG, Scoreboard, TimedOp, TimedTimeline,
                    build_timed_ops, envelope, simulate_pipeline)
from .uarch import (UARCH_CONFIGS, FUSpec, UarchConfig,  # noqa: F401
                    get_uarch, list_uarchs)
