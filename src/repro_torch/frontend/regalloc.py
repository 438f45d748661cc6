"""Liveness-based register allocation for traced kernels.

The builder emits instructions over an unbounded supply of *virtual*
registers (every produced value gets a fresh one; in-place updates reuse
their destination's).  This module maps them onto the machine's physical
register file with a linear-scan allocator over live intervals.

Traced programs are straight line (Python loops unroll at trace time),
so every virtual register has exactly one live interval
``[first_def, last_use]`` and linear scan is *optimal* for them: an
allocation exists iff the maximum number of simultaneously live virtual
registers never exceeds the physical register count — which is exactly
what the allocator guarantees (``tests/test_frontend.py`` fuzzes this
property).

Two policy details matter for matching hand-written register usage (the
equivalence suite checks frontend-built patterns against the legacy
hand-coded programs instruction by instruction):

* lowest-index-first — a freed physical register is reused as soon as a
  new value needs one, like hand code does;
* no same-instruction reuse — a register whose last use is instruction
  ``i`` is not reassigned to a value defined *by* instruction ``i``
  (source and destination of one instruction stay distinct, as on the
  real bit-serial datapath where the destination PR is written while the
  sources are read).

Masked-lane caveat: physical register reuse means a value's lanes
*outside* the dimension configuration active at its definition hold
whatever the register last contained — matching the hardware, where PRs
are raw SRAM.  Read a handle only under (a subset of) the dims it was
produced under; docs/FRONTEND.md discusses this.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..core import isa
from ..core.isa import Instr, Op

#: Default physical register budget.  Matches the program-as-data VM's
#: dense register file (``repro_torch.core.vm.N_REGS``) — staying at or under
#: it is what keeps frontend-built programs on the signature-shared VM
#: path instead of falling back to per-program fused compiles — and the
#: 256-wordline register file at the common 32-bit kernel width
#: (Section III-B: 256 / 32 = 8 live PRs).
DEFAULT_MAX_REGS = 8


class RegisterPressureError(RuntimeError):
    """No valid physical assignment exists at some program point."""

    def __init__(self, index: int, instr: Instr, live: Sequence[int],
                 max_regs: int):
        self.index = index
        self.live = tuple(live)
        self.max_regs = max_regs
        super().__init__(
            f"register pressure: {len(live) + 1} values live at "
            f"instruction {index} but the machine has {max_regs} "
            f"physical registers\n  at [{index:3d}] "
            f"{isa.disassemble(instr)}\n  live virtual registers: "
            f"{sorted(live)} — split the kernel or shorten value "
            f"lifetimes (store intermediates)")


def _defs_reg(instr: Instr) -> Optional[int]:
    """The virtual register this instruction writes, if any."""
    return isa.reg_defs(instr)


def _uses_regs(instr: Instr) -> List[int]:
    """The virtual registers this instruction reads."""
    return list(isa.reg_uses(instr))


@dataclasses.dataclass
class Allocation:
    """Result of :func:`allocate`."""

    program: List[Instr]          # instructions with physical registers
    mapping: Dict[int, int]       # virtual -> physical
    n_used: int                   # distinct physical registers used
    max_live: int                 # peak simultaneous liveness


def live_intervals(instrs: Sequence[Instr],
                   pinned: Sequence[int] = ()):
    """``vreg -> (first_def, last_event)`` over a straight-line program.

    A write to an already-live register (in-place update, or a partial
    write under a dimension mask) extends its interval like a use — the
    old contents are merged, so the register must stay allocated.
    ``pinned`` registers (:meth:`KernelBuilder.keep`) stay live to the
    end of the program.
    """
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for i, instr in enumerate(instrs):
        for r in _uses_regs(instrs[i]):
            first.setdefault(r, i)
            last[r] = i
        d = _defs_reg(instr)
        if d is not None:
            first.setdefault(d, i)
            last[d] = max(last.get(d, i), i)
    for r in pinned:
        if r in first and instrs:
            last[r] = len(instrs) - 1
    return {r: (first[r], last[r]) for r in first}


def max_pressure(instrs: Sequence[Instr]) -> int:
    """Peak simultaneous liveness — the minimum register file that can
    host the program (linear scan achieves it on straight-line code)."""
    iv = live_intervals(instrs)
    if not iv:
        return 0
    n = max(e for _, e in iv.values()) + 1
    live = [0] * (n + 1)
    for s, e in iv.values():
        live[s] += 1
        live[e + 1] -= 1
    peak = cur = 0
    for d in live:
        cur += d
        peak = max(peak, cur)
    return peak


def allocate(instrs: Sequence[Instr],
             max_regs: int = DEFAULT_MAX_REGS,
             pinned: Sequence[int] = ()) -> Allocation:
    """Linear-scan allocate virtual registers onto ``max_regs`` physical
    ones; raises :class:`RegisterPressureError` only when no valid
    assignment exists (peak liveness exceeds ``max_regs``)."""
    intervals = live_intervals(instrs, pinned)
    mapping: Dict[int, int] = {}
    free = list(range(max_regs))          # min-heap by construction
    expiry: List[tuple] = []              # (last_event, vreg) active list
    out: List[Instr] = []
    n_used = 0
    max_live = 0

    for i, instr in enumerate(instrs):
        # Expire strictly-before-i intervals: a register read for the
        # last time by instruction i-1 is reusable at i, but sources of
        # instruction i itself are not reusable as its destination.
        still = []
        for last_event, vreg in expiry:
            if last_event < i:
                free.append(mapping[vreg])
            else:
                still.append((last_event, vreg))
        expiry = still
        free.sort()

        for r in _uses_regs(instr):
            if r not in mapping:
                raise isa.ProgramError(
                    f"virtual register v{r} read before it is written",
                    i, instr)
        d = _defs_reg(instr)
        if d is not None and d not in mapping:
            if not free:
                raise RegisterPressureError(
                    i, instr, [v for _, v in expiry], max_regs)
            mapping[d] = free.pop(0)
            expiry.append((intervals[d][1], d))
            n_used = max(n_used, mapping[d] + 1)
        max_live = max(max_live, len(expiry))

        if instr.op in isa.VECTOR_OPS:
            out.append(dataclasses.replace(
                instr,
                vd=mapping.get(instr.vd) if instr.vd is not None else None,
                vs1=mapping.get(instr.vs1)
                if instr.vs1 is not None else None,
                vs2=mapping.get(instr.vs2)
                if instr.vs2 is not None else None))
        else:
            out.append(instr)

    return Allocation(program=out, mapping=mapping, n_used=n_used,
                      max_live=max_live)
