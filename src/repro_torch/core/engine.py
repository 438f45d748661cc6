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

A write-back whose lane mask covers every lane and that does not read the
Tag skips the blend with the old register (decided on the host from the
step's mask): every lane takes the result.

Execution modes.  ``compile_program(..., mode=...)`` selects the executor:

  "fused" — (default) the straight-line step code above;
  "vm"    — the reference's program-as-data lowering
            (:mod:`repro_torch.core.vm`): the step list as dense tables,
            bucketed to a signature that groups programs for batching and
            counts executors as the reference does, run by the same
            straight-line code.  Programs it cannot host (more than
            ``vm.N_REGS`` live registers) fall back to fused
            (``cache_info().vm_fallbacks``), and memory images other than
            float32/float64 run fused.

Both modes run/run_batch/trace identically and are equivalence-tested
against the stepwise oracle.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels.ops import mdv_gather, mdv_scatter_
from ..kernels.ref import wrap_store_addresses
from . import isa
from .cost import TraceEvent
from .interp import alu
from .isa import Instr, Op
from .machine import (TORCH_DTYPE, ControlState, MVEConfig, apply_config,
                      as_memory, cbs_from_lane_mask, convert,
                      flatten_indices, lane_dim_mask, resolve_device,
                      store_layout, stream_shape, touched_lines)
from .vm import VMProgram, VMUnsupported, fire_fault_hook
from .vm import cache_info as _vm_cache_info
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
                ExecutorError)

# the span of each step of :meth:`CompiledProgram._execute`; the rest are
# ``engine.alu``
_STEP_SPANS = {Op.SLD: "engine.load", Op.RLD: "engine.load",
               Op.SST: "engine.store", Op.RST: "engine.store"}


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
    addr: Optional[np.ndarray] = None        # static element addresses
    store_layout: Optional[tuple] = None     # mode="vm": store_layout()
    whole: bool = False                      # lane mask covers every lane
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
        self._vm: Optional[VMProgram] = None
        if mode == "vm":
            try:
                self._vm = VMProgram(self.steps, cfg, self.n_random,
                                     self._execute_on)
            except VMUnsupported:
                global _VM_FALLBACKS
                _VM_FALLBACKS += 1
                self.mode = "fused"

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
                         mask_slot=n_masked, whole=bool(lane_mask.all()))
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
                    step.addr = addr
                    if store and self.mode == "vm":   # the VM's tables
                        step.store_layout = store_layout(addr, lane_mask)
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
        spans = obs.StepSpans(device=True) if obs.recording() else None

        for step in self.steps:
            instr = step.instr
            op = instr.op
            if op in isa.CONFIG_OPS or op is Op.SCALAR:
                continue
            if spans is not None:
                spans.step(_STEP_SPANS.get(op, "engine.alu"))

            dt = TORCH_DTYPE.get(instr.dtype, torch.float32)
            mask = ops.masks[step.mask_slot]

            def old(vd, dt=dt):
                return convert(regs.get(vd, zeros), dt)

            if op in (Op.SLD, Op.RLD):
                if op is Op.SLD:
                    gathered = mdv_gather(memory, step.dims, step.strides,
                                          instr.base, lanes=cfg.lanes)
                else:
                    addr = _step_random_addresses(step, memory, ops)
                    rand_addrs[step.rand_slot] = addr
                    gathered = torch.gather(memory, -1,
                                            addr.clamp(0, n - 1))
                gathered = convert(gathered, dt)
                regs[instr.vd] = gathered if step.whole else \
                    torch.where(mask, gathered, old(instr.vd))
                continue
            if op is Op.SST:
                mdv_scatter_(memory, convert(old(instr.vs1), memory.dtype),
                             step.dims, step.strides, instr.base, mask)
                continue
            if op is Op.RST:
                addr = _step_random_addresses(step, memory, ops)
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
            result = convert(result, dt)
            if step.whole and not instr.predicated:
                regs[instr.vd] = result
                continue
            keep = mask & tag if instr.predicated else mask
            regs[instr.vd] = torch.where(keep, result, old(instr.vd))

        if spans is not None:
            spans.close()
        return memory, regs, tag, rand_addrs

    def _execute_on(self, memory: torch.Tensor):
        """:meth:`_execute` with this program's operands on ``memory``'s
        device (the datapath ``mode="vm"`` runs)."""
        return self._execute(memory, self._device_operands(memory.device))

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
        an executor-owned copy, and enqueue the program through the VM
        (float32-canonical images under ``mode="vm"``) or directly.
        Returns ``(kind, pending)``."""
        with obs.span("engine.dispatch"):
            if isinstance(memory, dict):
                kernel = self._bound_kernel()
                memory = kernel.pack_batch(memory) if batched \
                    else kernel.pack(memory)
            mem = as_memory(memory, dev)
            if mem.dim() != (2 if batched else 1):
                raise ValueError(
                    f"expected a {'(B, N) batch of images' if batched else 'flat (N,) image'}, "
                    f"got shape {tuple(mem.shape)}")
            if self._use_vm(mem):
                vm = self._vm
                return "vm", (vm.run_batch_async(mem) if batched
                              else vm.run_async(mem))
            return "fused", self._execute(mem, self._device_operands(dev))

    @staticmethod
    def _vm_dtype(dtype) -> bool:
        """True for a float32-canonical memory type (float64 or float32 —
        what every pattern uses), as a torch or NumPy dtype."""
        if isinstance(dtype, torch.dtype):
            return dtype in (torch.float64, torch.float32)
        return np.dtype(dtype) in (np.float64, np.float32)

    def _use_vm(self, memory) -> bool:
        """Route through the VM unless the memory type needs the
        exact semantics of the fused executor; reads ``memory.dtype``
        without materializing the array."""
        dtype = getattr(memory, "dtype", None)
        if dtype is None:
            dtype = np.asarray(memory).dtype
        return self.mode == "vm" and self._vm_dtype(dtype)

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
            kind, out = pending
            if kind == "vm":
                out = self._vm.finalize(out)
            mem, regs, tag, rand_addrs = out
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
        like :meth:`MVEInterpreter.run` (trace included).  Dispatches to
        the VM or the fused executor per ``mode``."""
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
            return self._dispatch(memories, dev, batched=True)
        except _PASSTHROUGH:
            raise
        except Exception as e:
            raise DispatchError(f"batch dispatch failed ({self.mode} "
                                f"mode): {type(e).__name__}: {e}") from e

    def finalize_batch(self, pending):
        fire_fault_hook("engine.finalize", tier=self.mode)
        try:
            kind, out = pending
            if kind == "vm":
                return self._vm.finalize_batch(out)
            mem, regs, tag, _ = out
            return mem, dict(regs), tag
        except _PASSTHROUGH:
            raise
        except Exception as e:
            raise FinalizeError(f"batch finalize failed ({self.mode} "
                                f"mode): {type(e).__name__}: {e}") from e

    def batch_group_key(self, memory) -> tuple:
        """Scheduling key: requests whose keys are equal can be stacked
        into one ``run_batch`` dispatch.  The key is the VM signature for
        VM-routed requests (program identity rides along: batching stacks
        *memories* under one program) and the program itself for
        fused-routed ones."""
        mem = np.asarray(memory) if not hasattr(memory, "shape") else memory
        size = int(mem.shape[-1])
        dtype = str(getattr(mem, "dtype", "float64"))
        if self._use_vm(memory):
            return ("vm", self._vm._signature(size), size, dtype)
        return ("fused", id(self), size, dtype)

    def warmup(self, memory_size, batch: Optional[int] = None,
               dtype=torch.float32) -> "CompiledProgram":
        """Upload this program's masks and pointer tables to its device;
        under ``mode="vm"`` (float images) also record the signature's
        executor.  Nothing is compiled ahead of time.  ``memory_size`` is
        an element count (or an example image); returns ``self`` so calls
        chain with :func:`compile_program`."""
        if not isinstance(memory_size, int):
            memory_size = int(np.asarray(memory_size).shape[-1])
        self._device_operands(self.device)
        if self.mode == "vm" and self._vm_dtype(dtype):
            self._vm.warmup(memory_size, batch)
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


def random_addresses(memory: torch.Tensor, ptr_base: int, top_len: int,
                     top_idx: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """Run-time element addresses of a random-base access (Eq. 1): the
    pointer array at ``ptr_base`` is part of the data.  Lane ``l`` adds
    ``offsets[l]`` to pointer ``top_idx[l]``, saturated to int32 (NaN ->
    0), in int64.  Leading axes as ``memory``."""
    ptrs = memory[..., ptr_base: ptr_base + top_len]
    if ptrs.shape[-1] == 0:
        raise ValueError(f"pointer array at {ptr_base} lies outside the "
                         "memory image")
    ptrs = convert(ptrs, torch.int32).to(torch.int64)
    top_idx = top_idx.clamp(max=ptrs.shape[-1] - 1)
    return ptrs[..., top_idx] + offsets


def _step_random_addresses(step: _Step, memory: torch.Tensor,
                           ops: _DeviceOperands) -> torch.Tensor:
    return random_addresses(memory, step.ptr_base, step.top_len,
                            ops.top_idx[step.rand_slot],
                            ops.offsets[step.rand_slot])


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
_VM_FALLBACKS = 0
# Per-target LRU counters: cache_tag -> [hits, misses].  Tagged compiles
# (one tag per :mod:`repro_torch.targets` target) get their own key space,
# so an RVV or Neon compilation of a program never aliases — or evicts in
# place of — the MVE entry for the same text.
_TAG_COUNTS: Dict[str, List[int]] = {}

#: Default execution mode: ``"fused"`` (the reference defaults to ``"vm"``
#: to avoid an XLA compile per program, which this package never pays;
#: ``"vm"`` adds its lowering to each compile and runs the same datapath).
#: The stepwise interpreter remains the semantic oracle of both.
DEFAULT_MODE = "fused"


@dataclasses.dataclass(frozen=True)
class EngineCacheInfo:
    """Snapshot of the compile caches (see :func:`cache_info`)."""

    program_hits: int          # compile_program served from the LRU
    program_misses: int        # fresh compile walks (+ VM lowerings)
    program_evictions: int
    program_size: int
    vm_fallbacks: int          # vm-mode requests lowered to fused instead
    vm_signatures: int         # distinct VM signatures seen
    vm_hits: int               # VM dispatches of a known signature
    vm_executors: int          # (signature, single-or-batch) pairs seen
    # cache_tag -> {"hits": n, "misses": n} for target-tagged compiles;
    # untagged compiles count only in the totals above.
    per_target: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def vm_xla_compiles(self) -> int:
        """The reference's name for :attr:`vm_executors` (nothing is
        compiled here)."""
        return self.vm_executors


def cache_info() -> EngineCacheInfo:
    """Hit/miss/eviction counters of the program LRU plus the VM's
    signature counters.  ``per_target`` breaks the LRU
    counters down by compile tag, one per registered
    :mod:`repro_torch.targets` target that has compiled anything."""
    v = _vm_cache_info()
    with _CACHE_LOCK:
        per_target = {tag: {"hits": c[0], "misses": c[1]}
                      for tag, c in _TAG_COUNTS.items()}
        return EngineCacheInfo(
            program_hits=_HITS, program_misses=_MISSES,
            program_evictions=_EVICTIONS, program_size=len(_CACHE),
            vm_fallbacks=_VM_FALLBACKS, vm_signatures=v.signatures,
            vm_hits=v.hits, vm_executors=v.executors,
            per_target=per_target)


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


def _count_tag(tag: Optional[str], hit: bool) -> None:
    """Record a tagged LRU hit/miss (caller holds ``_CACHE_LOCK``)."""
    if tag is None:
        return
    counts = _TAG_COUNTS.setdefault(tag, [0, 0])
    counts[0 if hit else 1] += 1


def compile_program(program: isa.Program,
                    cfg: MVEConfig | None = None,
                    mode: str | None = None,
                    cache_tag: Optional[str] = None,
                    opt_level: Optional[int] = None,
                    device=None) -> CompiledProgram:
    """Compile (with caching) an MVE program for the given machine config.

    Accepts a raw instruction sequence or a frontend
    :class:`~repro_torch.frontend.Kernel` — for kernels, ``run``/
    ``run_batch`` additionally accept a dict of named operand arrays and
    results are read back by name (``state.operands``).

    The returned :class:`CompiledProgram` is memory-image independent: the
    same object executes any number of images (or a batch) without another
    compile walk, and repeated calls with an equal program, config, mode,
    tag and device return the cached compilation.  ``device`` is where it
    executes (default ``cuda``; without a card that raises — pass
    ``"cpu"``).

    ``mode`` selects the executor (default :data:`DEFAULT_MODE`):
    ``"fused"`` runs the step list as straight-line code, ``"vm"`` also
    lowers it to the reference's VM tables and signature and runs the same
    code.  Programs the VM cannot host fall back to fused
    (``cache_info().vm_fallbacks``).

    ``cache_tag`` namespaces the LRU key: compilations made on behalf of
    one :mod:`repro_torch.targets` target (the target's name) never alias
    another target's entries for the same program text, and
    ``cache_info().per_target`` reports hits/misses per tag.

    ``opt_level`` (default ``None`` = no optimization) runs the program
    through the :mod:`repro_torch.opt` pass pipeline before compilation —
    the optimized text is just another program, so caching, signatures and
    executors compose unchanged.
    """
    global _HITS, _MISSES, _EVICTIONS
    cfg = cfg or MVEConfig()
    mode = mode or DEFAULT_MODE
    if mode not in ("vm", "fused"):
        raise ValueError(f"unknown engine mode {mode!r}")
    dev = resolve_device(device)
    kernel = None
    if hasattr(program, "plan") and hasattr(program, "program"):
        kernel = program            # a frontend Kernel (duck-typed:
        program = kernel.program    # no core -> frontend import cycle)
    if opt_level:
        from .. import opt          # late: opt sits above core
        program = opt.optimize(program, level=opt_level)
    key = (tuple(program), cfg, mode, cache_tag, dev)
    with _CACHE_LOCK:
        cp = _CACHE.get(key)
        if cp is not None:
            _HITS += 1
            _count_tag(cache_tag, hit=True)
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
            _count_tag(cache_tag, hit=True)
            _CACHE.move_to_end(key)
            return _attach_kernel(cp, kernel)
        _MISSES += 1
        _count_tag(cache_tag, hit=False)
        cp = _CACHE[key] = built
        _attach_kernel(cp, kernel)
        if cp.mode != mode:
            # VM-unsupported fallback: alias the fused key too, so an
            # explicit mode="fused" request reuses this compilation.
            _CACHE.setdefault((key[0], key[1], cp.mode, cache_tag, dev), cp)
        while len(_CACHE) > _CACHE_CAPACITY:
            _CACHE.popitem(last=False)
            _EVICTIONS += 1
    return cp


def clear_cache() -> None:
    """Drop all cached compilations and reset the LRU counters (tests /
    memory pressure).  The VM's signature counters persist — clear them
    separately via :func:`repro_torch.core.vm.clear_executors`."""
    global _HITS, _MISSES, _EVICTIONS, _VM_FALLBACKS
    with _CACHE_LOCK:
        _CACHE.clear()
        _TAG_COUNTS.clear()
        _HITS = _MISSES = _EVICTIONS = 0
        _VM_FALLBACKS = 0
