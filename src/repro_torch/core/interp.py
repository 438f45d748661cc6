"""Functional executor for MVE programs.

This is the *semantic oracle* for the ISA: registers are tensors of shape
``(lanes,)``; memory is a flat tensor addressed in elements.  Multi-dim
strided loads implement Algorithm 1, random loads implement Equation 1, and
dimension-level masking follows Section III-E (masked lanes retain their old
destination value; masked stores are dropped).  The ISA semantics are
documented with worked examples in docs/ISA.md.

The interpreter also produces an execution *trace* consumed by the cost
models in :mod:`repro_torch.core.cost` — this mirrors the paper's
methodology of a trace-driven cycle-accurate simulator fed by a functional
intrinsic library (Section VI).

Execution is routed through the compiled engine by default
(:mod:`repro_torch.core.engine`): a whole-program compile pass resolves all
addressing statically and runs the data path as straight-line tensor code.
The per-instruction step loop is kept as
:meth:`MVEInterpreter.run_stepwise` — the independent cross-check the
engine is equivalence-tested against.  It resolves every address on the
host, one instruction at a time; strided loads and stores go through
:func:`repro_torch.kernels.ops.mdv_gather` / ``mdv_scatter_`` with the
step's resolved dims, strides and base, random-base accesses through tensor
indexing with collisions resolved on the host (highest lane wins).

Arithmetic keeps the reference's element-type rules, which PyTorch does not
share by default: see :func:`repro_torch.core.machine.convert` for
conversions and :func:`alu` for shifts, rotates, float32 denormals, and the
NaN and signed-zero bits of float arithmetic and ``vmax``/``vmin``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.float_ops import float_binary
from ..kernels.ops import mdv_gather, mdv_scatter_
from ..kernels.ref import flush_denormals, wrap_store_addresses
from . import isa
from .cost import TraceEvent  # noqa: F401  (re-exported; historical home)
from .isa import DType, Instr, Op
from .machine import (TORCH_DTYPE, ControlState, MVEConfig, apply_config,
                      as_memory, cbs_touched, convert, flatten_indices,
                      lane_dim_mask, resolve_device, stream_shape,
                      touched_lines)


@dataclasses.dataclass
class MachineState:
    memory: torch.Tensor
    regs: Dict[int, torch.Tensor]
    tag: torch.Tensor          # per-lane predicate latch (T)
    ctrl: ControlState
    trace: List[TraceEvent]


# ---------------------------------------------------------------------------
# Lane arithmetic shared by the step oracle and the compiled engine.
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF

_COMPARE = {Op.GT: torch.gt, Op.GTE: torch.ge, Op.LT: torch.lt,
            Op.LTE: torch.le, Op.EQ: torch.eq, Op.NEQ: torch.ne}


def _float_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` as XLA:CPU computes it, bits included: a NaN
    operand comes back with its own bits (``torch.maximum`` returns the
    canonical NaN); of two NaNs, ``a`` when its sign bit is set, else
    ``b``; ``max(+0, -0)`` is ``+0`` whatever the order."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    pick_a = torch.where(nan_a & nan_b, torch.signbit(a),
                         nan_a | (a > b) | ((a == b) & ~torch.signbit(a)))
    return torch.where(pick_a, a, b)


def _float_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` as XLA:CPU computes it (see :func:`_float_max`): of
    two NaNs, ``a`` when its sign bit is clear, else ``b``;
    ``min(+0, -0)`` is ``-0``."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    pick_a = torch.where(nan_a & nan_b, ~torch.signbit(a),
                         nan_a | (a < b) | ((a == b) & torch.signbit(a)))
    return torch.where(pick_a, a, b)


_BINARY = {Op.ADD: torch.add, Op.SUB: torch.sub, Op.MUL: torch.mul,
           Op.MIN: _float_min, Op.MAX: _float_max,
           Op.XOR: torch.bitwise_xor, Op.AND: torch.bitwise_and,
           Op.OR: torch.bitwise_or}
_FLOAT_BINARY = {Op.ADD: "add", Op.SUB: "sub", Op.MUL: "mul"}


def alu(instr: Instr, a: torch.Tensor,
        b: Optional[torch.Tensor]) -> torch.Tensor:
    """Result of one arithmetic or compare instruction on operands already
    held in the instruction's element type.  Compares return ``bool``;
    everything else is converted to the element type by the caller.

    Shift counts at or past the register width give 0 (or the sign fill
    for an arithmetic right shift) instead of PyTorch's undefined result;
    ``vroti`` rotates in an unsigned 32-bit window and ``vshr`` shifts in
    int32, as the reference does, both computed in int64 with masks.

    Float ``vadd``/``vsub``/``vmul`` go through
    :func:`~repro_torch.kernels.float_ops.float_binary` (x86's NaN bits,
    one rounding point, a kernel launch on the card).  float32 operands of
    ``vmin``/``vmax`` and compares are read with denormals as zeros of
    their sign, as XLA's CPU runtime reads them.
    """
    op = instr.op
    if a.is_floating_point():
        if op in _FLOAT_BINARY:
            return float_binary(_FLOAT_BINARY[op], a, b)
        a, b = flush_denormals(a), flush_denormals(b)
    if op in _BINARY:
        return _BINARY[op](a, b)
    if op in _COMPARE:
        return _COMPARE[op](a, b)
    if op is Op.SHI:
        if instr.dtype.is_float:
            raise ValueError("shift on float register")
        bits = torch.iinfo(a.dtype).bits
        amt = instr.imm
        if amt >= 0:
            return a << amt if amt < bits else torch.zeros_like(a)
        if a.dtype == torch.uint8:        # logical shift
            return a >> -amt if -amt < bits else torch.zeros_like(a)
        return a >> min(-amt, bits - 1)   # arithmetic: saturates at sign fill
    if op is Op.ROTI:
        bits = instr.dtype.bits
        amt = instr.imm % bits
        ua = a.to(torch.int64) & _U32
        left = (ua << amt) & _U32 if amt < 32 else torch.zeros_like(ua)
        right = ua >> (bits - amt) if bits - amt < 32 \
            else torch.zeros_like(ua)
        return left | right
    if op is Op.SHR:
        count = b.to(torch.int64)
        shifted = a.to(torch.int64) << count.clamp(0, 31)
        return torch.where((count >= 0) & (count < 32), shifted, 0)
    raise NotImplementedError(f"op {op}")


class MVEInterpreter:
    """Executes an MVE program on a software model of the in-cache engine.

    ``compiled=True`` (default) routes :meth:`run` through
    :func:`repro_torch.core.engine.compile_program`; ``compiled=False`` (or
    :meth:`run_stepwise`) uses the per-instruction loop.  ``mode`` picks
    the compiled executor (``None`` = engine default).  ``device`` is
    where memory and registers live: ``cuda`` unless the caller names
    another; without a card a CUDA request raises.
    """

    def __init__(self, config: MVEConfig | None = None,
                 compiled: bool = True, mode: str | None = None,
                 device=None):
        self.cfg = config or MVEConfig()
        self.compiled = compiled
        self.mode = mode
        self.device = resolve_device(device)

    # -- public API --------------------------------------------------------
    def run(self, program: isa.Program, memory,
            ) -> Tuple[torch.Tensor, MachineState]:
        if self.compiled:
            from .engine import compile_program
            return compile_program(program, self.cfg, mode=self.mode,
                                   device=self.device).run(memory)
        return self.run_stepwise(program, memory)

    def run_stepwise(self, program: isa.Program, memory,
                     ) -> Tuple[torch.Tensor, MachineState]:
        """The one-instruction-at-a-time oracle loop."""
        state = MachineState(
            memory=as_memory(memory, self.device),
            regs={},
            tag=torch.ones(self.cfg.lanes, dtype=torch.bool,
                           device=self.device),
            ctrl=ControlState(),
            trace=[],
        )
        for instr in program:
            self._step(instr, state)
        return state.memory, state

    # -- helpers -----------------------------------------------------------
    def _addresses(self, state: MachineState, modes: Tuple[int, ...],
                   base: int, store: bool, random_base: bool):
        """Per-lane element addresses (host) + active mask for a random-base
        access, and the stream metadata of any access.

        For random accesses (Eq. 1) the highest dimension indexes a pointer
        array at ``base``; lower dimensions use the resolved strides shifted
        down by one (the paper's S_[3:1] become the inner strides).
        """
        ctrl = state.ctrl
        dims = ctrl.active_dims()
        strides = ctrl.resolve_strides(modes, store)
        coords = flatten_indices(dims, self.cfg.lanes)
        mask = lane_dim_mask(dims, ctrl.dim_mask, self.cfg.lanes)

        if random_base:
            # Fetch base pointers from memory: one per highest-dim element.
            top_len = dims[-1]
            ptrs = convert(state.memory[base: base + top_len],
                           torch.int32).cpu().numpy().astype(np.int64)
            if ptrs.size == 0:
                raise ValueError(f"pointer array at {base} lies outside "
                                 "the memory image")
            top_idx = np.clip(coords[:, len(dims) - 1], 0, ptrs.size - 1)
            addr = ptrs[top_idx]
            n_inner = len(dims) - 1
        else:
            addr = np.full(self.cfg.lanes, base, dtype=np.int64)
            n_inner = len(dims)
        for d in range(n_inner):
            addr = addr + np.where(coords[:, d] >= 0,
                                   coords[:, d], 0) * strides[d]

        run, segments, unique = stream_shape(dims, strides, self.cfg.lanes)
        return addr, mask, dims, strides, run, segments, unique

    def _step(self, instr: Instr, state: MachineState) -> None:
        op = instr.op
        cfg = self.cfg
        ctrl = state.ctrl
        dev = self.device

        # ---- config ------------------------------------------------------
        if op in isa.CONFIG_OPS:
            apply_config(ctrl, instr)
            return self._trace_config(instr, state)
        if op is Op.SCALAR:
            state.trace.append(TraceEvent(
                op=op, dtype=None, elements=0,
                cb_mask=np.zeros(cfg.num_cbs, dtype=bool),
                scalar_count=instr.scalar_count))
            return None

        dims = ctrl.active_dims()
        mask = lane_dim_mask(dims, ctrl.dim_mask, cfg.lanes)
        tmask = torch.from_numpy(mask).to(dev)
        cbm = cbs_touched(dims, ctrl.dim_mask, cfg)
        elements = int(mask.sum())
        dt = TORCH_DTYPE.get(instr.dtype, torch.float32)

        def old(vd, dt=dt):
            v = state.regs.get(vd)
            if v is None:
                return torch.zeros(cfg.lanes, dtype=dt, device=dev)
            return convert(v, dt)

        # ---- memory ------------------------------------------------------
        if op in isa.MEMORY_OPS:
            store = op in (Op.SST, Op.RST)
            random = op in (Op.RLD, Op.RST)
            addr, amask, dims, strides, run, segs, uniq = self._addresses(
                state, instr.modes or (), instr.base, store, random)
            lines = touched_lines(addr, amask, instr.dtype.nbytes)
            n = state.memory.shape[0]
            if op is Op.SLD:
                gathered = mdv_gather(state.memory, dims, strides,
                                      instr.base, lanes=cfg.lanes)
            elif op is Op.RLD:
                idx = torch.from_numpy(np.clip(addr, 0, n - 1)).to(dev)
                gathered = state.memory[idx]
            if not store:
                state.regs[instr.vd] = torch.where(
                    tmask, convert(gathered, dt), old(instr.vd))
            else:
                # Masked lanes and out-of-range addresses write nowhere
                # (an address in [-n, 0) wraps to the image's end first);
                # later lanes win on address collisions (well-defined
                # scatter order, matches a sequential loop).
                src = convert(old(instr.vs1), state.memory.dtype)
                if op is Op.SST:
                    mdv_scatter_(state.memory, src, dims, strides,
                                 instr.base, tmask)
                else:
                    lanes_w, addr_w = _last_lane_wins(addr, amask, n)
                    state.memory[torch.from_numpy(addr_w).to(dev)] = \
                        src[torch.from_numpy(lanes_w).to(dev)]
            state.trace.append(TraceEvent(op, instr.dtype, elements, cbm,
                                          segments=segs,
                                          contiguous_run=run,
                                          unique_elements=uniq,
                                          lines=lines))
            return None

        # ---- moves & arithmetic -------------------------------------------
        def finish(result):
            keep = tmask
            if instr.predicated:
                keep = keep & state.tag
            state.regs[instr.vd] = torch.where(keep, convert(result, dt),
                                               old(instr.vd))
            state.trace.append(TraceEvent(op, instr.dtype, elements, cbm))

        if op is Op.SET_DUP:
            return finish(torch.full((cfg.lanes,), instr.imm, dtype=dt,
                                     device=dev))
        if op is Op.CPY:
            return finish(old(instr.vs1))
        if op is Op.CVT:
            # converted from the source's own element type, not via dt
            return finish(state.regs[instr.vs1] if instr.vs1 in state.regs
                          else old(instr.vs1))

        a = old(instr.vs1)
        b = old(instr.vs2) if instr.vs2 is not None else None
        result = alu(instr, a, b)
        if op in isa.COMPARE_OPS:
            state.tag = torch.where(tmask, result, state.tag)
            state.trace.append(TraceEvent(op, instr.dtype, elements, cbm))
            return None
        return finish(result)

    def _trace_config(self, instr: Instr, state: MachineState) -> None:
        state.trace.append(TraceEvent(
            op=instr.op, dtype=None, elements=0,
            cb_mask=np.zeros(self.cfg.num_cbs, dtype=bool)))


def _last_lane_wins(addr: np.ndarray, mask: np.ndarray, n: int):
    """Winning ``(lanes, addresses)`` of a store, resolved on the host:
    active lanes with an address inside ``[0, n)`` after the reference's
    wrap of ``[-n, 0)`` to ``[0, n)``, one per distinct address, the
    highest lane of each."""
    addr = wrap_store_addresses(addr, n)
    act = np.flatnonzero(mask & (addr >= 0) & (addr < n))
    order = np.argsort(addr[act], kind="stable")
    sorted_a = addr[act][order]
    last = np.ones(len(act), dtype=bool)
    last[:-1] = sorted_a[:-1] != sorted_a[1:]
    winners = act[order[last]]
    return winners, addr[winners]


def read_register(state: MachineState, reg: int, n: Optional[int] = None):
    """Test helper: dense values of the first ``n`` lanes of ``reg``."""
    v = state.regs[reg]
    return (v if n is None else v[:n]).cpu().numpy()
