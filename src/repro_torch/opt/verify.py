"""First-class differential verification for the optimizer.

The optimizer's contract is *checkable*, not aspirational: any program,
any pipeline prefix, any executor —

* **state exactness** — memory, the full register file (every lane,
  masked ones included) and the Tag latch after the optimized program
  equal the stepwise oracle's on the unoptimized program, bit for bit;
* **trace semantics** — the optimized program's static trace never
  invents work: its memory events and its config events are
  sub-multisets of the original's, and it is never longer (CSE may
  *substitute* a register move for a load; scheduling only permutes);
* **structure** — instruction count and register pressure never
  increase, and lenient validation keeps passing (the pipeline guard in
  :mod:`repro_torch.opt.pipeline` enforces this on every invocation too).

``tests/test_opt.py`` drives these checks over the pattern library and
hand-written pass unit cases; ``tests/test_conformance.py`` drives them
from the random-program fuzzer, so an optimizer bug surfaces as a
conformance failure rather than a silent miscompile.

The executors run on ``device`` (default ``cuda``, as every entry point
of the port; pass ``"cpu"`` on a machine without a card); states are
compared on the host, bit for bit.
"""
from __future__ import annotations

import collections
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..core import isa
from ..core.engine import compile_program
from ..core.interp import MVEInterpreter
from ..core.machine import MVEConfig, to_numpy
from .pipeline import optimize, pipeline_prefixes


def _bits(x) -> np.ndarray:
    """Host bits of a register, Tag or memory image (NaN payloads and
    signed zeros compared as they are)."""
    a = np.ascontiguousarray(to_numpy(x))
    if a.dtype.kind == "f":
        return a.view(f"u{a.dtype.itemsize}")
    return a


def assert_states_equal(oracle_state, oracle_memory, result) -> None:
    """Bit-exact memory + register-file + Tag comparison (the same
    contract ``tests/test_conformance.py`` applies across executors)."""
    np.testing.assert_array_equal(_bits(oracle_memory),
                                  _bits(result.memory))
    assert set(oracle_state.regs) == set(result.regs), \
        "optimizer changed the set of defined registers"
    for r in oracle_state.regs:
        np.testing.assert_array_equal(
            _bits(oracle_state.regs[r]), _bits(result.regs[r]),
            err_msg=f"register v{r} diverged")
    np.testing.assert_array_equal(_bits(oracle_state.tag),
                                  _bits(result.tag),
                                  err_msg="Tag latch diverged")


def _canon_event(ev) -> Tuple:
    cb_bits = int(sum(1 << i for i, b in enumerate(ev.cb_mask) if b))
    return (ev.op.value, ev.dtype.suffix if ev.dtype else None,
            int(ev.elements), int(ev.segments), int(ev.scalar_count),
            int(ev.contiguous_run), int(ev.unique_elements),
            int(ev.lines), cb_bits)


def _submultiset(part: Iterable[Tuple], whole: Iterable[Tuple],
                 what: str) -> None:
    extra = collections.Counter(part) - collections.Counter(whole)
    assert not extra, \
        f"optimized trace invents {what} events not in the original: " \
        f"{sorted(extra)[:4]}"


def assert_trace_semantics(base_trace, opt_trace) -> None:
    """The optimized trace does strictly less work of every observable
    kind: no new memory traffic, no new config writes, never longer."""
    assert len(opt_trace) <= len(base_trace), \
        "optimized trace is longer than the original"
    base = [_canon_event(ev) for ev in base_trace]
    opt = [_canon_event(ev) for ev in opt_trace]
    mem_ops = {o.value for o in isa.MEMORY_OPS}
    cfg_ops = {o.value for o in isa.CONFIG_OPS}
    _submultiset((r for r in opt if r[0] in mem_ops),
                 (r for r in base if r[0] in mem_ops), "memory")
    _submultiset((r for r in opt if r[0] in cfg_ops),
                 (r for r in base if r[0] in cfg_ops), "config")


def verify_optimized(program, memories, level: Optional[int] = None,
                     passes: Optional[Sequence[str]] = None,
                     cfg: Optional[MVEConfig] = None,
                     modes: Tuple[str, ...] = ("vm", "fused"),
                     oracle=None, device=None) -> isa.Program:
    """Differentially check one pipeline (prefix) on one program.

    Runs the stepwise oracle on the *unoptimized* program per memory
    image, then the optimized program through each compiled executor
    mode, asserting bit-exact state and trace semantics.  ``oracle`` can
    pass precomputed ``[(memory, state), ...]`` results to amortize the
    stepwise runs across prefixes.  Returns the optimized program.
    """
    cfg = cfg or MVEConfig()
    if isinstance(memories, (np.ndarray,)) or not \
            isinstance(memories, (list, tuple)):
        memories = [memories]
    base = isa.Program(getattr(program, "program", program))
    opt_prog = optimize(base, level=level, passes=passes)
    assert len(opt_prog) <= len(base)
    if oracle is None:
        stepper = MVEInterpreter(cfg, compiled=False, device=device)
        oracle = [stepper.run_stepwise(base, m) for m in memories]
    base_cp = compile_program(base, cfg, mode="vm", device=device)
    for mode in modes:
        cp = compile_program(opt_prog, cfg, mode=mode, device=device)
        assert_trace_semantics(base_cp.static_trace, cp.static_trace)
        for (mem_i, st_i), m in zip(oracle, memories):
            _, st_e = cp.run(m)
            assert_states_equal(st_i, mem_i, st_e)
    return opt_prog


def verify_prefixes(program, memories, cfg: Optional[MVEConfig] = None,
                    modes: Tuple[str, ...] = ("vm",), device=None) -> None:
    """Every pipeline prefix of one program, against one shared oracle."""
    cfg = cfg or MVEConfig()
    if isinstance(memories, (np.ndarray,)) or not \
            isinstance(memories, (list, tuple)):
        memories = [memories]
    base = isa.Program(getattr(program, "program", program))
    stepper = MVEInterpreter(cfg, compiled=False, device=device)
    oracle = [stepper.run_stepwise(base, m) for m in memories]
    for prefix in pipeline_prefixes():
        verify_optimized(base, memories, passes=prefix, cfg=cfg,
                         modes=modes, oracle=oracle, device=device)


def verify_across_targets(program, memory,
                          level: Optional[int] = None,
                          passes: Optional[Sequence[str]] = None,
                          target_names: Optional[Sequence[str]] = None,
                          device=None) -> None:
    """The optimized program stays bit-exact with the stepwise oracle on
    the *unoptimized* program across every registered target."""
    from .. import targets                  # late: targets imports engine

    base = isa.Program(getattr(program, "program", program))
    opt_prog = optimize(base, level=level, passes=passes)
    oracle_mem, oracle_state = MVEInterpreter(
        MVEConfig(), compiled=False, device=device).run_stepwise(base, memory)
    for tname in (target_names or targets.list_targets()):
        art = targets.compile(opt_prog, target=tname, device=device)
        _, st_t = art.run(memory)
        assert_states_equal(oracle_state, oracle_mem, st_t)
