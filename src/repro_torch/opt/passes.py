"""The optimizer passes: dead-config elimination, address-pattern CSE,
and list scheduling over :class:`~repro_torch.core.isa.Program`.

Every pass is a pure function ``Program -> Program`` over the straight-
line MVE IR.  The soundness arguments live next to each pass; the
machine-checked version of those arguments is :mod:`repro_torch.opt.verify`,
which differentially executes every pass (and every pipeline prefix)
against the stepwise oracle — see docs/OPTIMIZER.md for the pass catalog
and the verification contract.

Design constraints shared by all passes:

* **Config trajectory preservation** — the control-register state seen
  by every retained vector instruction is identical before and after a
  pass, so addressing, lane masks and strict validation are unaffected.
* **Register-file exactness** — passes never change which registers a
  program defines or the bits they hold at exit (masked lanes of a
  physical register keep whatever they last held — the conformance
  suite compares the *whole* register file, so value-numbering style
  rewrites must be bit-exact in every lane, not just the active ones).
* **Monotonicity** — a pass never increases instruction count or
  register pressure (enforced again, defensively, by the pipeline).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import isa
from ..core.isa import Instr, Op, Program
from ..core.machine import (ControlState, apply_config, config_cell,
                            read_config_cell)

#: Cells every vector instruction observes (lane mask, register-file
#: shape, dtype legality).  Stride cells are observed by memory ops only.
_DIM_CELLS = tuple(("diml", d) for d in range(4))
_STRIDE_CELLS = tuple(("ldstr", d) for d in range(4)) + \
    tuple(("ststr", d) for d in range(4))


def _observed_cells(instr: Instr) -> Tuple[Tuple, ...]:
    """Config cells whose value this (non-config) instruction depends on.

    Conservative: every vector op observes the dimension configuration,
    the width and the whole dimension mask; memory ops additionally
    observe the stride CRs.  ``vsetmask``/``vunsetmask`` are handled by
    the caller — they *observe* the dim cells too (strict validation
    checks the mask bit against the current top-dimension length).
    """
    if instr.op is Op.SCALAR:
        return ()
    cells = (("dimc",), ("width",)) + _DIM_CELLS + (("mask", None),)
    if instr.op in isa.MEMORY_OPS:
        cells = cells + _STRIDE_CELLS
    return cells


def _cells_overlap(cell: Tuple, observed: Tuple) -> bool:
    if cell[0] != observed[0]:
        return False
    if cell[0] == "mask" and observed[1] is None:
        return True                      # wildcard: all mask bits observed
    return cell == observed


# ---------------------------------------------------------------------------
# Pass 1: dead-config elimination.
# ---------------------------------------------------------------------------

def _drop_noop_configs(instrs: Sequence[Instr]) -> List[Instr]:
    """Remove config writes that re-establish the value already in effect
    (including the power-on defaults: ``vsetwidth(32)`` or ``vsetdimc(1)``
    at program start are architectural no-ops)."""
    ctrl = ControlState()
    out: List[Instr] = []
    for instr in instrs:
        if instr.op in isa.CONFIG_OPS:
            cell = config_cell(instr)
            before = read_config_cell(ctrl, cell)
            apply_config(ctrl, instr)
            if read_config_cell(ctrl, cell) == before:
                continue
        out.append(instr)
    return out


def _drop_dead_config_stores(instrs: Sequence[Instr]) -> List[Instr]:
    """Remove config writes that are overwritten before any instruction
    observes them.

    A write at the program tail (no later write to its cell) is kept:
    the final control state is part of the execution result.  Mask
    config ops observe the dimension cells (strict validation reads the
    top-dimension length at each ``vsetmask``/``vunsetmask``).
    """
    n = len(instrs)
    dead = set()
    for i, instr in enumerate(instrs):
        if instr.op not in isa.CONFIG_OPS:
            continue
        cell = config_cell(instr)
        for j in range(i + 1, n):
            nxt = instrs[j]
            if nxt.op in isa.CONFIG_OPS:
                if nxt.op in (Op.SET_MASK, Op.UNSET_MASK) and \
                        cell[0] in ("dimc", "diml"):
                    break                            # observer: strict check
                if config_cell(nxt) == cell:
                    dead.add(i)                      # overwritten, unobserved
                    break
                continue
            if any(_cells_overlap(cell, oc)
                   for oc in _observed_cells(nxt)):
                break                                # observed: live
        # fell through: tail write, keep (final ctrl state preserved)
    return [ins for i, ins in enumerate(instrs) if i not in dead]


def dead_config(program: Sequence[Instr]) -> Program:
    """Collapse ``vsetdimc``/``vsetdiml``/``vset*str``/mask/width sequences
    that re-establish state already in effect, and config writes that are
    overwritten before any instruction can see them.

    Runs the two rules to a fixpoint (each rule can expose work for the
    other), so the pass is idempotent by construction.
    """
    instrs = list(program)
    while True:
        nxt = _drop_dead_config_stores(_drop_noop_configs(instrs))
        if len(nxt) == len(instrs):
            return Program(nxt)
        instrs = nxt


# ---------------------------------------------------------------------------
# Pass 2: address-pattern CSE.
# ---------------------------------------------------------------------------

def _ctrl_digest(ctrl: ControlState) -> Tuple:
    """Full config-state digest: two accesses under equal digests resolve
    identical addresses, lane masks and register-file shapes."""
    return (ctrl.dim_count, tuple(ctrl.dim_lens), tuple(ctrl.ld_strides),
            tuple(ctrl.st_strides), ctrl.kernel_width,
            ctrl.dim_mask.tobytes())


def cse(program: Sequence[Instr]) -> Program:
    """Address-pattern common-subexpression elimination at the IR level.

    Re-executions of a load (``vsld``/``vrld``) or splat (``vsetdup``)
    whose full addressing context — base, stride modes, config-state
    digest, and memory version for loads — matches an available earlier
    instance are rewritten:

    * same destination register → dropped outright (architectural
      no-op: the register already holds exactly those bits);
    * different destination → replaced by ``vcpy vd, r``, which writes
      the *same* lanes a re-execution would (masked write-back), so the
      register file stays bit-exact while the trace loses a memory
      access.

    Any store conservatively invalidates every available load (the
    memory version is part of the load key); a clobber of the holding
    register invalidates its expression.  Predicated producers and
    consumers are excluded — their write-back depends on the Tag latch.
    """
    ctrl = ControlState()
    mem_version = 0
    avail: Dict[Tuple, int] = {}          # expression key -> holding reg
    held: Dict[int, Tuple] = {}           # reg -> key it currently holds

    def kill(reg: Optional[int]) -> None:
        key = held.pop(reg, None)
        if key is not None and avail.get(key) == reg:
            del avail[key]

    out: List[Instr] = []
    for instr in program:
        op = instr.op
        if op in isa.CONFIG_OPS:
            apply_config(ctrl, instr)
            out.append(instr)
            continue
        if op is Op.SCALAR:
            out.append(instr)
            continue
        if op in (Op.SST, Op.RST):
            mem_version += 1
            out.append(instr)
            continue
        if op in (Op.SLD, Op.RLD, Op.SET_DUP) and not instr.predicated:
            if op is Op.SET_DUP:
                key = ("dup", instr.dtype, instr.imm, _ctrl_digest(ctrl))
            else:
                key = (op, instr.dtype, instr.base, tuple(instr.modes or ()),
                       _ctrl_digest(ctrl), mem_version)
            reg = avail.get(key)
            if reg is not None:
                if reg == instr.vd:
                    continue                        # exact re-execution
                kill(instr.vd)
                out.append(isa.vcpy(instr.dtype, instr.vd, reg))
                continue
            kill(instr.vd)
            avail[key] = instr.vd
            held[instr.vd] = key
            out.append(instr)
            continue
        kill(isa.reg_defs(instr))
        out.append(instr)
    return Program(out)


# ---------------------------------------------------------------------------
# Pass 3: list scheduling (Saturn-style loads-ahead-of-compute).
# ---------------------------------------------------------------------------

def _static_interval(ctrl: ControlState, instr: Instr
                     ) -> Optional[Tuple[int, int]]:
    """Inclusive element-address envelope of a *static* access, or ``None``
    when the footprint is data-dependent (random-base accesses)."""
    if instr.op in (Op.RLD, Op.RST):
        return None
    store = instr.op is Op.SST
    dims = ctrl.active_dims()
    strides = ctrl.resolve_strides(tuple(instr.modes or ()), store)
    lo = instr.base + sum(min(0, (ln - 1) * s)
                          for ln, s in zip(dims, strides))
    hi = instr.base + sum(max(0, (ln - 1) * s)
                          for ln, s in zip(dims, strides))
    return (lo, hi)


def _may_alias(a: Optional[Tuple[int, int]],
               b: Optional[Tuple[int, int]]) -> bool:
    if a is None or b is None:
        return True
    return a[0] <= b[1] and b[0] <= a[1]


@dataclasses.dataclass
class _Node:
    index: int
    instr: Instr
    succs: List[int] = dataclasses.field(default_factory=list)
    n_preds: int = 0


def _region_graph(region: Sequence[Instr], ctrl: ControlState
                  ) -> List[_Node]:
    """Dependence graph of one config-free region.

    Edges: register RAW/WAR/WAW, Tag latch (compares write it, predicated
    instructions read it), and memory (conservative interval-based alias
    analysis under the region's — constant — control state).  ``scalar``
    pseudo-instructions carry no dependences: they have no architectural
    effect, only a cost-model one.
    """
    nodes = [_Node(i, ins) for i, ins in enumerate(region)]
    intervals = [
        _static_interval(ctrl, ins) if ins.op in isa.MEMORY_OPS else None
        for ins in region]

    def add_edge(i: int, j: int) -> None:
        if j not in nodes[i].succs:
            nodes[i].succs.append(j)
            nodes[j].n_preds += 1

    for j, nj in enumerate(nodes):
        ins_j = nj.instr
        if ins_j.op is Op.SCALAR:
            continue
        defs_j = isa.reg_defs(ins_j)
        uses_j = set(isa.reg_uses(ins_j))
        writes_tag_j = ins_j.op in isa.COMPARE_OPS
        reads_tag_j = ins_j.predicated
        is_store_j = ins_j.op in (Op.SST, Op.RST)
        # a random-base access reads its pointer array (RLD) or scatters
        # to data-dependent addresses (RST): treat as aliasing everything
        is_mem_j = ins_j.op in isa.MEMORY_OPS
        for i in range(j):
            ins_i = nodes[i].instr
            if ins_i.op is Op.SCALAR:
                continue
            defs_i = isa.reg_defs(ins_i)
            uses_i = set(isa.reg_uses(ins_i))
            if defs_i is not None and (defs_i in uses_j or
                                       defs_i == defs_j):
                add_edge(i, j)           # RAW / WAW
                continue
            if defs_j is not None and defs_j in uses_i:
                add_edge(i, j)           # WAR
                continue
            writes_tag_i = ins_i.op in isa.COMPARE_OPS
            reads_tag_i = ins_i.predicated
            if (writes_tag_i and (reads_tag_j or writes_tag_j)) or \
                    (reads_tag_i and writes_tag_j):
                add_edge(i, j)
                continue
            is_store_i = ins_i.op in (Op.SST, Op.RST)
            is_mem_i = ins_i.op in isa.MEMORY_OPS
            if (is_store_i and is_mem_j) or (is_mem_i and is_store_j):
                if _may_alias(intervals[i], intervals[j]):
                    add_edge(i, j)
    return nodes


#: Scheduling heuristics ``tune()`` sweeps.  Each maps a ready node to a
#: sort key (lower schedules earlier); original index breaks ties so
#: every heuristic is deterministic.
SCHEDULE_PRIORITIES = {
    # keep the input order (the identity schedule)
    "source": lambda ins: 1,
    # issue independent loads as early as possible (Saturn-style: the
    # memory streams start while the scalar core is still busy)
    "loads-first": lambda ins: 0 if ins.op in (Op.SLD, Op.RLD) else 1,
    # start every memory access (loads and ready stores) early
    "memory-first": lambda ins: 0 if ins.op in isa.MEMORY_OPS else 1,
    # sink cost-model scalar blocks below ready vector work
    "scalar-last": lambda ins: 2 if ins.op is Op.SCALAR else 1,
}


def schedule(program: Sequence[Instr],
             priority: str = "loads-first") -> Program:
    """List-schedule each config-free region under the dependence graph.

    Config instructions are scheduling barriers (they redefine the
    addressing context); within a region, ready instructions are issued
    by the chosen priority heuristic (``SCHEDULE_PRIORITIES``), original
    program order breaking ties.  The instruction *multiset* is
    untouched — only the order changes.
    """
    if priority not in SCHEDULE_PRIORITIES:
        raise ValueError(
            f"unknown schedule priority {priority!r}; available: "
            f"{', '.join(sorted(SCHEDULE_PRIORITIES))}")
    rank = SCHEDULE_PRIORITIES[priority]
    ctrl = ControlState()
    out: List[Instr] = []
    region: List[Instr] = []

    def flush() -> None:
        if not region:
            return
        nodes = _region_graph(region, ctrl)
        ready = [n.index for n in nodes if n.n_preds == 0]
        scheduled: List[Instr] = []
        while ready:
            ready.sort(key=lambda i: (rank(nodes[i].instr), i))
            i = ready.pop(0)
            scheduled.append(nodes[i].instr)
            for j in nodes[i].succs:
                nodes[j].n_preds -= 1
                if nodes[j].n_preds == 0:
                    ready.append(j)
        assert len(scheduled) == len(region), "scheduler dropped work"
        out.extend(scheduled)
        region.clear()

    for instr in program:
        if instr.op in isa.CONFIG_OPS:
            flush()
            out.append(instr)
            apply_config(ctrl, instr)
        else:
            region.append(instr)
    flush()
    return Program(out)
