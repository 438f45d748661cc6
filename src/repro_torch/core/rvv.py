"""RISC-V RVV-style 1D long-vector baseline.

The paper's key ISA comparison (Sections VII-B, Figures 10/11/13) runs the
*same* bit-serial in-cache engine but drives it with a one-dimensional
vector ISA: every multi-dimensional access must be decomposed into

    #segments = ceil(active_lanes / len(inner 1D segment))

partial 1D strided accesses, each needing a mask/config instruction, the
partial access itself, and a move to pack the segment into the long vector
register — plus scalar address-generation instructions (Section III-C:
"RVV would employ 6 strided load instructions ... further scalar
instructions are needed to compute the mask").

This module *compiles* the MVE memory instructions of a program into that
1D form, producing a trace that runs through the same cost model.  Results
remain bit-exact with MVE (it is the same access, sliced) — a first-class
invariant asserted across executors in ``tests/test_conformance.py`` and
``tests/test_targets.py`` — while the dynamic instruction counts and
timeline differ.

This lowering is the performance adapter behind the ``rvv-1d`` target of
:mod:`repro_torch.targets` (docs/TARGETS.md): execution goes through the shared
functional engine, and :func:`compile_to_rvv` prices the same program as
a 1D ISA would issue it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from . import isa
from .isa import DType, Instr, Op
from .cost import TraceEvent
from .machine import (ControlState, MVEConfig, apply_config, cbs_touched,
                      lane_dim_mask)


@dataclasses.dataclass
class RVVStats:
    vector_instructions: int = 0
    mask_instructions: int = 0
    move_instructions: int = 0
    memory_instructions: int = 0
    scalar_instructions: int = 0
    config_instructions: int = 0
    # One entry per lowered memory instruction:
    # ``(segments, inner_len, active_lanes)`` — the Section III-C
    # decomposition ``segments = ceil(active_lanes / inner_len)`` (times
    # the pointer count for random-base accesses).  Tested as an exact
    # invariant against the emitted trace in ``tests/test_conformance.py``.
    segment_log: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)


def segments_for(ctrl: ControlState, instr: Instr, lanes: int
                 ) -> Tuple[int, int]:
    """(#partial accesses, 1D segment length) for one memory instruction.

    RVV has ONE flexible stride per access (Table I), so a competent 1D
    implementation picks the best vectorization axis:

      * a dense (mode-2) multi-dim access collapses to flat 1D loads;
      * any single strided dimension is loadable in one instruction
        (this is the paper's ``#lanes / len(1D segment)`` count, e.g.
        8192/3136 ~ 3 for the MobileNet GEMM);
      * short contiguous runs under a stride map to segment loads
        (vlsseg, <= 8 fields);
      * stride-0 replication and deeper stride levels must be unpacked
        segment by segment (mask + partial access + move each).
    """
    dims = ctrl.active_dims()
    store = instr.op in (Op.SST, Op.RST)
    random = instr.op in (Op.RLD, Op.RST)
    strides = ctrl.resolve_strides(instr.modes or (), store)
    use = list(zip(dims, strides))
    if random:
        use = use[:-1]                     # top dim is the random base set
    nz = sorted((s, ln) for ln, s in use if s != 0)
    run = 1
    for s, ln in nz:
        if s == run:
            run *= ln
        else:
            break
    best = run
    for s, ln in nz:
        if s != 0 and s > run - 1 and ln > 1 and s != 1:
            # one strided dim, possibly carrying a short dense chain
            best = max(best, ln * (run if run <= 8 else 1))
    seg_len = max(best, 1)
    inner_total = min(int(np.prod([ln for ln, _ in use])) if use else 1,
                      lanes)
    per_base = max(1, -(-inner_total // seg_len))
    tops = dims[-1] if random else 1
    return per_base * tops, min(seg_len, inner_total)


def compile_to_rvv(program: isa.Program, cfg: MVEConfig | None = None
                   ) -> Tuple[List[TraceEvent], RVVStats]:
    """Lower an MVE program to a 1D-ISA trace on the same engine.

    Non-memory vector ops translate 1:1 (the engine width is the same); the
    multi-dimensional loads/stores and the dimension-level mask ops expand
    as described above.
    """
    cfg = cfg or MVEConfig()
    ctrl = ControlState()
    trace: List[TraceEvent] = []
    stats = RVVStats()

    def emit_scalar(n: int):
        if n <= 0:
            return
        trace.append(TraceEvent(op=Op.SCALAR, dtype=None, elements=0,
                                cb_mask=np.zeros(cfg.num_cbs, dtype=bool),
                                scalar_count=n))
        stats.scalar_instructions += n

    for instr in program:
        op = instr.op
        if op is Op.SCALAR:
            emit_scalar(instr.scalar_count)
            continue
        if op in isa.CONFIG_OPS:
            if op in (Op.SET_MASK, Op.UNSET_MASK):
                # Dimension-level masking does not exist in a 1D ISA: the
                # mask must be materialized in memory by the scalar core and
                # loaded into a vector mask register (Section III-E).
                dims = ctrl.active_dims()
                seg = dims[0] if dims else 1
                emit_scalar(seg)                       # compute mask values
                trace.append(TraceEvent(op=Op.SLD, dtype=DType.B,
                                        elements=cfg.lanes,
                                        cb_mask=np.ones(cfg.num_cbs, bool),
                                        segments=1, contiguous_run=seg,
                                        unique_elements=seg,
                                        lines=max(1, seg // 64)))
                stats.vector_instructions += 1
                stats.mask_instructions += 1
            else:
                apply_config(ctrl, instr)
                trace.append(TraceEvent(op=op, dtype=None, elements=0,
                                        cb_mask=np.zeros(cfg.num_cbs, bool)))
                stats.config_instructions += 1
            continue

        dims = ctrl.active_dims()
        lm = lane_dim_mask(dims, ctrl.dim_mask, cfg.lanes)
        elements = int(lm.sum())
        cbm = cbs_touched(dims, ctrl.dim_mask, cfg)

        if op in isa.MEMORY_OPS:
            segments, inner = segments_for(ctrl, instr, cfg.lanes)
            stats.segment_log.append((segments, inner, elements))
            per_seg_elems = max(1, elements // max(segments, 1))
            for _ in range(segments):
                # scalar address computation for this segment's base
                emit_scalar(2)
                # vsetvl / predicate config targeting the segment window
                trace.append(TraceEvent(op=Op.SET_DIML, dtype=None,
                                        elements=0,
                                        cb_mask=np.zeros(cfg.num_cbs, bool)))
                stats.vector_instructions += 1
                stats.mask_instructions += 1
                # the partial 1D access itself (only `inner` lanes active)
                nb = instr.dtype.nbytes
                trace.append(TraceEvent(op=op, dtype=instr.dtype,
                                        elements=per_seg_elems,
                                        cb_mask=cbm, segments=1,
                                        contiguous_run=inner,
                                        unique_elements=per_seg_elems,
                                        lines=max(1, (inner * nb) // 64)))
                stats.vector_instructions += 1
                stats.memory_instructions += 1
                # pack/unpack move into the long register slice
                trace.append(TraceEvent(op=Op.CPY, dtype=instr.dtype,
                                        elements=per_seg_elems,
                                        cb_mask=cbm))
                stats.vector_instructions += 1
                stats.move_instructions += 1
            continue

        # arithmetic / move: 1:1
        trace.append(TraceEvent(op=op, dtype=instr.dtype, elements=elements,
                                cb_mask=cbm))
        stats.vector_instructions += 1
    return trace, stats


def mve_stats(program: isa.Program) -> RVVStats:
    """Dynamic instruction counts of the *MVE* encoding (for Figure 11)."""
    stats = RVVStats()
    for instr in program:
        if instr.op is Op.SCALAR:
            stats.scalar_instructions += instr.scalar_count
        elif instr.op in isa.CONFIG_OPS:
            stats.config_instructions += 1
            if instr.op in (Op.SET_MASK, Op.UNSET_MASK):
                stats.mask_instructions += 1
        else:
            stats.vector_instructions += 1
            if instr.op in isa.MEMORY_OPS:
                stats.memory_instructions += 1
            elif instr.op in isa.MOVE_OPS:
                stats.move_instructions += 1
    return stats
