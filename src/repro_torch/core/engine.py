"""Compiled MVE execution engine: whole-program compile + straight-line
execution.

The step interpreter (:class:`repro_torch.core.interp.MVEInterpreter`)
walks a program one instruction at a time, resolving addresses and masks on
the host at every step.  This module exploits a structural property of the
ISA: *all* addressing state lives in control registers written by config
instructions with immediate operands, so a single symbolic pass over the
program can resolve every access's dims/strides/base, lane mask, CB mask
and :class:`~repro_torch.core.cost.TraceEvent` ahead of time.  What remains
— the data path — runs as straight-line eager tensor code, one or a few
device operations per MVE instruction, on one memory image or on an
explicit leading batch axis of images, registers and Tag.

Static vs dynamic split:

  static  — control-register evolution, dims/strides/base of strided
            accesses, dimension/lane/CB masks, trace metadata;
  dynamic — register values, the Tag predicate latch, memory contents,
            and the addresses of random-base accesses (Eq. 1), whose
            pointer arrays are fetched from memory at run time.

Every strided load calls :func:`repro_torch.kernels.ops.mdv_gather` with
the step's resolved walk (the kernel computes the addresses in registers;
no address tensor is uploaded) and blends the result under the lane mask;
every strided store calls ``mdv_scatter_`` with the lane mask, so a masked
lane writes nowhere.  Random-base accesses are tensor indexing; their
stores resolve collisions on the device (highest lane wins) without a host
round trip.

Random-base accesses are also the one place the trace is data-dependent:
their exact cache-line count depends on the pointer values, so
:meth:`CompiledProgram.run` brings those address vectors to the host once
per run and fills the ``lines`` field.  ``run_batch`` produces no trace and
never synchronises.

Each MVE instruction is its own device operation, so every register
write-back is a rounding point, exactly as distinct in-cache instructions
are: the engine reproduces the step interpreter bit for bit.

Execution modes.  This package's executor is ``mode="fused"`` (the
default).  The program-as-data VM (``mode="vm"``) is still to be ported and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.ops import mdv_gather, mdv_scatter_
from ..kernels.ref import wrap_store_addresses
from . import isa
from .cost import TraceEvent
from .interp import alu
from .isa import Instr, Op
from .machine import (TORCH_DTYPE, ControlState, MVEConfig, apply_config,
                      as_memory, cbs_from_lane_mask, convert,
                      flatten_indices, lane_dim_mask, resolve_device,
                      stream_shape, touched_lines)
from .vm import VMUnsupported, fire_fault_hook
from .vm import set_fault_hook  # noqa: F401  (re-export: one hook registry)


class ExecutorError(RuntimeError):
    """Base of the typed executor failures.

    Each subclass names the boundary that failed; the original exception
    is chained as ``__cause__``.  User-input errors
    (:class:`~repro_torch.core.isa.ProgramError`, ``TypeError`` /
    ``ValueError`` from malformed arguments) are *not* wrapped: they mean
    "fix the request", not "the executor failed".
    """


class CompileError(ExecutorError):
    """Compiling/lowering a program to an executable failed."""


class DispatchError(ExecutorError):
    """Launching an execution (single or batched) failed."""


class FinalizeError(ExecutorError):
    """Materializing results of a dispatched execution failed."""


# exception types that pass through untyped (user errors / control flow)
_PASSTHROUGH = (isa.ProgramError, VMUnsupported, TypeError, ValueError,
                NotImplementedError, ExecutorError)


@dataclasses.dataclass
class _Step:
    """One vector/scalar instruction with its statically resolved context."""

    instr: Instr
    lane_mask: Optional[np.ndarray] = None   # per-lane dimension mask
    cb_mask: Optional[np.ndarray] = None
    event: Optional[TraceEvent] = None
    mask_slot: Optional[int] = None          # row in the device mask stack
    # strided accesses: the resolved walk handed to mdv_gather/mdv_scatter_
    dims: Optional[Tuple[int, ...]] = None
    strides: Optional[Tuple[int, ...]] = None
    # random-base (Eq. 1) accesses: pointer slice + static inner offsets
    ptr_base: Optional[int] = None
    top_len: Optional[int] = None
    top_idx: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    rand_slot: Optional[int] = None          # index into returned addresses


@dataclasses.dataclass
class _DeviceOperands:
    """Per-device constants of one compiled program, uploaded once."""

    masks: torch.Tensor                      # (n_masked, lanes) bool
    lane: torch.Tensor                       # (lanes,) int32 iota
    top_idx: Dict[int, torch.Tensor]         # rand_slot -> (lanes,) int64
    offsets: Dict[int, torch.Tensor]         # rand_slot -> (lanes,) int64


@dataclasses.dataclass
class ExecutionResult:
    """Duck-type compatible with
    :class:`repro_torch.core.interp.MachineState`.

    ``operands`` materialises named, shaped result views lazily when the
    program was compiled from a frontend kernel
    (:mod:`repro_torch.frontend`) — reading results by name costs nothing
    until accessed."""

    memory: torch.Tensor
    regs: Dict[int, torch.Tensor]
    tag: torch.Tensor
    ctrl: ControlState
    trace: List[TraceEvent]
    kernel: Optional[object] = None       # frontend Kernel, if any
    _operands: Optional[Dict[str, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    @property
    def operands(self) -> Optional[Dict[str, np.ndarray]]:
        """Results read back by operand name (``None`` for raw programs)."""
        if self._operands is None and self.kernel is not None:
            self._operands = self.kernel.unpack(self.memory)
        return self._operands


class CompiledProgram:
    """An MVE program lowered to a static step list + a static trace.

    Use :func:`compile_program` (cached) rather than constructing directly.
    The compiled object is memory-image independent: it executes any image
    (or a batch of them) without another compile walk.  ``device`` is where
    ``run``/``run_batch`` execute unless they are told otherwise.
    """

    def __init__(self, program: isa.Program, cfg: MVEConfig,
                 mode: str = "fused", device=None):
        self.cfg = cfg
        self.program = tuple(program)
        self.mode = mode
        self.device = resolve_device(device)
        self.kernel = None    # frontend Kernel when compiled from one
        self._kernels_seen = None      # WeakSet of accepted kernels
        self._kernel_conflict = False  # distinct kernels share this text
        self.steps: List[_Step] = []
        self.n_random = 0
        # Build-time checks (readable one-line errors) before the walk:
        # a malformed program fails here, not deep inside addressing
        # resolution.  Lenient mode — executors keep accepting programs
        # that deliberately rely on clip/drop semantics.
        isa.validate(self.program, wordlines=cfg.wordlines)
        self._compile_walk()
        self._operands: Dict[torch.device, _DeviceOperands] = {}

    # -- compilation -------------------------------------------------------
    def _compile_walk(self) -> None:
        """Symbolically execute config ops; resolve every access statically."""
        cfg = self.cfg
        ctrl = ControlState()
        n_masked = 0
        for instr in self.program:
            op = instr.op
            if op in isa.CONFIG_OPS:
                apply_config(ctrl, instr)
                self.steps.append(_Step(instr, event=TraceEvent(
                    op=op, dtype=None, elements=0,
                    cb_mask=np.zeros(cfg.num_cbs, dtype=bool))))
                continue
            if op is Op.SCALAR:
                self.steps.append(_Step(instr, event=TraceEvent(
                    op=op, dtype=None, elements=0,
                    cb_mask=np.zeros(cfg.num_cbs, dtype=bool),
                    scalar_count=instr.scalar_count)))
                continue

            dims = ctrl.active_dims()
            lane_mask = lane_dim_mask(dims, ctrl.dim_mask, cfg.lanes)
            cbm = cbs_from_lane_mask(lane_mask, cfg)
            elements = int(lane_mask.sum())
            step = _Step(instr, lane_mask=lane_mask, cb_mask=cbm,
                         mask_slot=n_masked)
            n_masked += 1

            if op in isa.MEMORY_OPS:
                store = op in (Op.SST, Op.RST)
                random = op in (Op.RLD, Op.RST)
                strides = ctrl.resolve_strides(instr.modes or (), store)
                run, segs, uniq = stream_shape(dims, strides, cfg.lanes)
                coords = flatten_indices(dims, cfg.lanes)
                if random:
                    top_len = dims[-1]
                    offsets = np.zeros(cfg.lanes, dtype=np.int64)
                    for d in range(len(dims) - 1):
                        offsets += np.where(coords[:, d] >= 0,
                                            coords[:, d], 0) * strides[d]
                    step.ptr_base = instr.base
                    step.top_len = top_len
                    step.top_idx = np.clip(coords[:, len(dims) - 1],
                                           0, top_len - 1)
                    step.offsets = offsets
                    step.rand_slot = self.n_random
                    self.n_random += 1
                    lines = 0          # filled from run-time addresses
                else:
                    addr = np.full(cfg.lanes, instr.base, dtype=np.int64)
                    for d in range(len(dims)):
                        addr += np.where(coords[:, d] >= 0,
                                         coords[:, d], 0) * strides[d]
                    step.dims, step.strides = dims, strides
                    lines = touched_lines(addr, lane_mask,
                                          instr.dtype.nbytes)
                step.event = TraceEvent(op, instr.dtype, elements, cbm,
                                        segments=segs, contiguous_run=run,
                                        unique_elements=uniq, lines=lines)
            else:
                step.event = TraceEvent(op, instr.dtype, elements, cbm)
            self.steps.append(step)
        self.final_ctrl = copy.deepcopy(ctrl)

    # -- straight-line data path -------------------------------------------
    def _execute(self, memory: torch.Tensor, ops: _DeviceOperands):
        """The whole program on ``memory`` — ``(N,)`` or ``(B, N)``, owned
        by this call and updated in place.

        Mirrors :meth:`MVEInterpreter._step` semantics exactly (the
        equivalence tests depend on it) with all addressing resolved at
        compile time.  Registers and Tag carry the same leading axes as
        ``memory``.  Enqueues device work only: nothing here waits for the
        device.
        """
        cfg = self.cfg
        shape = memory.shape[:-1] + (cfg.lanes,)
        dev = memory.device
        regs: Dict[int, torch.Tensor] = {}
        tag = torch.ones(shape, dtype=torch.bool, device=dev)
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        rand_addrs: List[torch.Tensor] = [None] * self.n_random
        n = memory.shape[-1]

        for step in self.steps:
            instr = step.instr
            op = instr.op
            if op in isa.CONFIG_OPS or op is Op.SCALAR:
                continue

            dt = TORCH_DTYPE.get(instr.dtype, torch.float32)
            mask = ops.masks[step.mask_slot]

            def old(vd, dt=dt):
                return convert(regs.get(vd, zeros), dt)

            if op in (Op.SLD, Op.RLD):
                if op is Op.SLD:
                    gathered = mdv_gather(memory, step.dims, step.strides,
                                          instr.base, lanes=cfg.lanes)
                else:
                    addr = self._random_addresses(step, memory, ops)
                    rand_addrs[step.rand_slot] = addr
                    gathered = torch.gather(memory, -1,
                                            addr.clamp(0, n - 1))
                regs[instr.vd] = torch.where(mask, convert(gathered, dt),
                                             old(instr.vd))
                continue
            if op is Op.SST:
                mdv_scatter_(memory, convert(old(instr.vs1), memory.dtype),
                             step.dims, step.strides, instr.base, mask)
                continue
            if op is Op.RST:
                addr = self._random_addresses(step, memory, ops)
                rand_addrs[step.rand_slot] = addr
                _scatter_last_lane_wins_(
                    memory, convert(old(instr.vs1), memory.dtype), addr,
                    mask, ops.lane)
                continue

            if op is Op.SET_DUP:
                result = torch.full(shape, instr.imm, dtype=dt, device=dev)
            elif op is Op.CPY:
                result = old(instr.vs1)
            elif op is Op.CVT:
                # converted from the source's own element type, not via dt
                result = regs.get(instr.vs1, zeros)
            else:
                a = old(instr.vs1)
                b = old(instr.vs2) if instr.vs2 is not None else None
                result = alu(instr, a, b)
                if op in isa.COMPARE_OPS:
                    tag = torch.where(mask, result, tag)
                    continue
            keep = mask & tag if instr.predicated else mask
            regs[instr.vd] = torch.where(keep, convert(result, dt),
                                         old(instr.vd))

        return memory, regs, tag, rand_addrs

    @staticmethod
    def _random_addresses(step: _Step, memory: torch.Tensor,
                          ops: _DeviceOperands) -> torch.Tensor:
        """Run-time element addresses of a random-base access (Eq. 1): the
        pointer array is part of the data.  int64, leading axes as
        ``memory``."""
        ptrs = memory[..., step.ptr_base: step.ptr_base + step.top_len]
        if ptrs.shape[-1] == 0:
            raise ValueError(f"pointer array at {step.ptr_base} lies "
                             "outside the memory image")
        ptrs = convert(ptrs, torch.int32).to(torch.int64)
        top_idx = ops.top_idx[step.rand_slot].clamp(max=ptrs.shape[-1] - 1)
        return ptrs[..., top_idx] + ops.offsets[step.rand_slot]

    # -- public API --------------------------------------------------------
    def _device_operands(self, dev: torch.device) -> _DeviceOperands:
        """Mask stack and random-base index tables on ``dev`` (plain data,
        uploaded at the first execution there and kept)."""
        ops = self._operands.get(dev)
        if ops is None:
            lanes = self.cfg.lanes
            masks = [s.lane_mask for s in self.steps
                     if s.mask_slot is not None]
            stack = np.stack(masks) if masks else \
                np.zeros((0, lanes), dtype=bool)
            rand = [s for s in self.steps if s.rand_slot is not None]
            ops = self._operands[dev] = _DeviceOperands(
                masks=torch.from_numpy(stack).to(dev),
                lane=torch.arange(lanes, dtype=torch.int32, device=dev),
                top_idx={s.rand_slot: torch.from_numpy(s.top_idx).to(dev)
                         for s in rand},
                offsets={s.rand_slot: torch.from_numpy(s.offsets).to(dev)
                         for s in rand})
        return ops

    def _run_device(self, device) -> torch.device:
        return self.device if device is None else resolve_device(device)

    def _bound_kernel(self):
        """The kernel whose plan names this program's operands; raises a
        readable error when there is none or when the binding is
        ambiguous (several non-equivalent kernels share the text)."""
        if self.kernel is None:
            if self._kernel_conflict:
                raise TypeError(
                    "this program text was compiled from multiple "
                    "distinct kernels (different operand plans or init "
                    "data) — pack explicitly with kernel.pack(...) or "
                    "execute via kernel.run()/kernel.run_batch()")
            raise TypeError(
                "named-operand execution needs a frontend kernel: "
                "compile with compile_program(kernel) or pass a flat "
                "memory image")
        return self.kernel

    def _dispatch(self, memory, dev: torch.device, batched: bool):
        """Pack (for named operands), place the image(s) on the device as
        an executor-owned copy, and enqueue the program."""
        if isinstance(memory, dict):
            kernel = self._bound_kernel()
            memory = kernel.pack_batch(memory) if batched \
                else kernel.pack(memory)
        mem = as_memory(memory, dev)
        if mem.dim() != (2 if batched else 1):
            raise ValueError(
                f"expected a {'(B, N) batch of images' if batched else 'flat (N,) image'}, "
                f"got shape {tuple(mem.shape)}")
        return self._execute(mem, self._device_operands(dev))

    def run_async(self, memory, device=None):
        """Dispatch one execution without blocking on host results.

        Returns an opaque pending handle for :meth:`finalize_run`.  On a
        CUDA device the work is only enqueued, so a serving loop pays one
        sync per drain cycle instead of one per request."""
        dev = self._run_device(device)
        fire_fault_hook("engine.dispatch", tier=self.mode)
        try:
            return self._dispatch(memory, dev, batched=False)
        except _PASSTHROUGH:
            raise
        except Exception as e:
            raise DispatchError(f"dispatch failed ({self.mode} mode): "
                                f"{type(e).__name__}: {e}") from e

    def finalize_run(self, pending) -> Tuple[torch.Tensor, ExecutionResult]:
        """Materialize a :meth:`run_async` dispatch into ``(mem, state)``."""
        fire_fault_hook("engine.finalize", tier=self.mode)
        try:
            mem, regs, tag, rand_addrs = pending
            trace = self._finalize_trace(rand_addrs)
        except _PASSTHROUGH:
            raise
        except Exception as e:
            raise FinalizeError(f"finalize failed ({self.mode} mode): "
                                f"{type(e).__name__}: {e}") from e
        # Fresh ctrl/trace objects per run: callers may mutate the returned
        # state (the stepwise oracle hands out fresh state too), and this
        # CompiledProgram is shared through the compile cache.
        state = ExecutionResult(memory=mem, regs=dict(regs), tag=tag,
                                ctrl=copy.deepcopy(self.final_ctrl),
                                trace=trace, kernel=self.kernel)
        return mem, state

    def run(self, memory, device=None
            ) -> Tuple[torch.Tensor, ExecutionResult]:
        """Execute on one memory image; returns ``(memory, state)`` exactly
        like :meth:`MVEInterpreter.run` (trace included)."""
        return self.finalize_run(self.run_async(memory, device))

    def run_batch(self, memories, device=None
                  ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor],
                             torch.Tensor]:
        """Evaluate the program over a leading batch of memory images.

        Returns ``(memories, regs, tag)`` with a leading batch axis on
        every tensor.  No trace is produced: the cost-model trace of a
        batched run is that of any single element (and for random-base
        programs each element may touch different cache lines — use
        :meth:`run` on a representative image to price it).
        """
        return self.finalize_batch(self.run_batch_async(memories, device))

    def run_batch_async(self, memories, device=None):
        """Dispatch a batched execution without blocking (see
        :meth:`run_async`); finalize with :meth:`finalize_batch`."""
        dev = self._run_device(device)
        fire_fault_hook("engine.dispatch", tier=self.mode)
        try:
            mem, regs, tag, _ = self._dispatch(memories, dev, batched=True)
            return mem, dict(regs), tag
        except _PASSTHROUGH:
            raise
        except Exception as e:
            raise DispatchError(f"batch dispatch failed ({self.mode} "
                                f"mode): {type(e).__name__}: {e}") from e

    def finalize_batch(self, pending):
        fire_fault_hook("engine.finalize", tier=self.mode)
        return pending

    def batch_group_key(self, memory) -> tuple:
        """Scheduling key: requests whose keys are equal can be stacked
        into one ``run_batch`` dispatch (batching stacks *memories* under
        one program, so the program's identity is part of the key)."""
        mem = np.asarray(memory) if not hasattr(memory, "shape") else memory
        size = int(mem.shape[-1])
        dtype = str(getattr(mem, "dtype", "float64"))
        return ("fused", id(self), size, dtype)

    def warmup(self, memory_size, batch: Optional[int] = None,
               dtype=torch.float32) -> "CompiledProgram":
        """Nothing to warm: execution is eager, there is no executable to
        compile ahead of time.  Kept, with the reference's signature, so
        call chains written against it carry over.  Returns ``self``."""
        return self

    def _finalize_trace(self, rand_addrs) -> List[TraceEvent]:
        """The run's trace; brings the random-base address vectors to the
        host in one transfer (the only device wait of a ``run``)."""
        host = torch.stack(rand_addrs).cpu().numpy() if rand_addrs else None
        trace: List[TraceEvent] = []
        for step in self.steps:
            ev = step.event
            if step.rand_slot is not None:
                ev = dataclasses.replace(ev, lines=touched_lines(
                    host[step.rand_slot], step.lane_mask,
                    step.instr.dtype.nbytes))
            else:
                ev = dataclasses.replace(ev)
            trace.append(ev)
        return trace

    @property
    def static_trace(self) -> List[TraceEvent]:
        """The compile-time trace; exact unless the program uses
        random-base accesses (then run() fills the ``lines`` fields)."""
        return [s.event for s in self.steps]


def _scatter_last_lane_wins_(memory: torch.Tensor, values: torch.Tensor,
                             addr: torch.Tensor, mask: torch.Tensor,
                             lane: torch.Tensor) -> None:
    """Random-base store into ``memory`` in place, per image.

    Addresses are data here, so winners are resolved at run time, on the
    device and without a host round trip: an owner table per image takes
    the maximum active lane id per address (order-independent, so the
    result is the same on every run), then every owned element takes its
    owner's value.  An address in ``[-n, 0)`` wraps to ``addr + n`` first,
    as in the reference; masked lanes and addresses still outside
    ``[0, n)`` own nothing.
    """
    n = memory.shape[-1]
    addr = wrap_store_addresses(addr, n)
    active = mask & (addr >= 0) & (addr < n)
    owner = torch.full(memory.shape, -1, dtype=torch.int32,
                       device=memory.device)
    owner.scatter_reduce_(-1, torch.where(active, addr, 0),
                          torch.where(active, lane, -1), "amax")
    picked = torch.gather(values, -1, owner.clamp(min=0).long())
    memory.copy_(torch.where(owner >= 0, picked, memory))


# ---------------------------------------------------------------------------
# Compile cache: programs are tuples of frozen Instr, so they hash.  Bounded
# LRU — data-dependent program streams (e.g. one program per sparsity
# pattern) would otherwise retain a compile walk per variant forever.
# ---------------------------------------------------------------------------

_CACHE: "OrderedDict[tuple, CompiledProgram]" = OrderedDict()
_CACHE_CAPACITY = 256
_CACHE_LOCK = threading.RLock()   # submit() may compile from many threads
_HITS = _MISSES = _EVICTIONS = 0

#: Default (and, until the VM is ported, only) execution mode.  The
#: stepwise interpreter remains the semantic oracle.
DEFAULT_MODE = "fused"


@dataclasses.dataclass(frozen=True)
class EngineCacheInfo:
    """Snapshot of the compile cache (see :func:`cache_info`)."""

    program_hits: int          # compile_program served from the LRU
    program_misses: int        # fresh compile walks
    program_evictions: int
    program_size: int


def cache_info() -> EngineCacheInfo:
    """Hit/miss/eviction counters of the program LRU."""
    with _CACHE_LOCK:
        return EngineCacheInfo(
            program_hits=_HITS, program_misses=_MISSES,
            program_evictions=_EVICTIONS, program_size=len(_CACHE))


def _attach_kernel(cp: CompiledProgram, kernel) -> CompiledProgram:
    """Bind a frontend kernel to a (shared, cached) compilation.

    Distinct kernels can emit identical program text with *different*
    operand plans or init data; serving the first kernel's data to the
    second would be silent corruption.  Equivalent kernels (same plan,
    same inits) share the binding; a non-equivalent one poisons it, so
    dict-of-operands execution on this object raises instead of packing
    the wrong kernel's data (``kernel.run()`` is never ambiguous — it
    packs with its own plan before dispatch).
    """
    if kernel is None or kernel is cp.kernel:
        return cp
    import weakref
    with _CACHE_LOCK:
        if cp._kernels_seen is None:
            cp._kernels_seen = weakref.WeakSet()
        if kernel in cp._kernels_seen:
            return cp
        if cp.kernel is None and not cp._kernel_conflict:
            cp.kernel = kernel
        elif cp.kernel is not None and not cp.kernel.equivalent(kernel):
            cp.kernel = None
            cp._kernel_conflict = True
        cp._kernels_seen.add(kernel)
    return cp


def compile_program(program: isa.Program,
                    cfg: MVEConfig | None = None,
                    mode: str | None = None,
                    opt_level: Optional[int] = None,
                    device=None) -> CompiledProgram:
    """Compile (with caching) an MVE program for the given machine config.

    Accepts a raw instruction sequence or a frontend
    :class:`~repro_torch.frontend.Kernel` — for kernels, ``run``/
    ``run_batch`` additionally accept a dict of named operand arrays and
    results are read back by name (``state.operands``).

    The returned :class:`CompiledProgram` is memory-image independent: the
    same object executes any number of images (or a batch) without another
    compile walk, and repeated calls with an equal program, config and
    device return the cached compilation.  ``device`` is where it executes
    (default ``cuda``; without a card that raises — pass ``"cpu"``).

    ``mode`` selects the executor: only ``"fused"`` exists in this package
    so far.  ``mode="vm"`` and ``opt_level=`` raise ``NotImplementedError``
    until the VM and the optimizer are ported (ROADMAP.md queue A).
    """
    global _HITS, _MISSES, _EVICTIONS
    cfg = cfg or MVEConfig()
    mode = mode or DEFAULT_MODE
    if mode == "vm":
        raise NotImplementedError(
            'mode="vm": the program-as-data VM is still to be ported '
            "(ROADMAP.md queue A: core/vm.py); use mode=\"fused\"")
    if mode != "fused":
        raise ValueError(f"unknown engine mode {mode!r}")
    if opt_level:
        raise NotImplementedError(
            "opt_level=: the optimizer pass pipeline is still to be ported "
            "(ROADMAP.md queue A: opt/); compile the program as written")
    dev = resolve_device(device)
    kernel = None
    if hasattr(program, "plan") and hasattr(program, "program"):
        kernel = program            # a frontend Kernel (duck-typed:
        program = kernel.program    # no core -> frontend import cycle)
    key = (tuple(program), cfg, mode, dev)
    with _CACHE_LOCK:
        cp = _CACHE.get(key)
        if cp is not None:
            _HITS += 1
            _CACHE.move_to_end(key)
            return _attach_kernel(cp, kernel)
    # Construct outside the lock: a multi-ms compile walk must not stall
    # concurrent lookups.  A racing duplicate construction is possible but
    # harmless — the first insertion wins below and the loser is dropped.
    fire_fault_hook("engine.compile", tier=mode)
    try:
        built = CompiledProgram(program, cfg, mode=mode, device=dev)
    except _PASSTHROUGH:
        raise
    except Exception as e:
        raise CompileError(f"compile walk failed ({mode} mode): "
                           f"{type(e).__name__}: {e}") from e
    with _CACHE_LOCK:
        cp = _CACHE.get(key)
        if cp is not None:
            _HITS += 1
            _CACHE.move_to_end(key)
            return _attach_kernel(cp, kernel)
        _MISSES += 1
        cp = _CACHE[key] = built
        _attach_kernel(cp, kernel)
        while len(_CACHE) > _CACHE_CAPACITY:
            _CACHE.popitem(last=False)
            _EVICTIONS += 1
    return cp


def clear_cache() -> None:
    """Drop all cached compilations and reset the LRU counters (tests /
    memory pressure)."""
    global _HITS, _MISSES, _EVICTIONS
    with _CACHE_LOCK:
        _CACHE.clear()
        _HITS = _MISSES = _EVICTIONS = 0
