"""Program-as-data MVE virtual machine: the program lowered to tables.

The reference lowers the engine's static step list to dense tables and runs
them with one XLA ``while_loop`` per *signature*, so that a data-dependent
program stream never recompiles.  This module keeps that lowering as the
NumPy it is:

* the static step list produced by the engine's compile walk becomes an
  opcode/subcode table, packed register operands and immediates, flag bits,
  and deduplicated address-pattern / mask / scatter-index tables referenced
  by per-slot row indices (``_lower``, ``_pad_tables``);
* the tables are bucketed to a *signature* — ``(lanes, n_regs, slot bucket,
  memory bucket, random bucket, pattern bucket, mask bucket, scatter
  bucket)`` — shared by every program of the same shape (all 14 patterns,
  every spmm sparsity variant, every seed).

Execution is the fused executor's datapath
(:meth:`repro_torch.core.engine.CompiledProgram._execute`, handed in by
the engine): eager torch compiles nothing per program, so the reason the
reference interprets its tables does not arise here, and one datapath
keeps one copy of the ISA's semantics.  Static loads and stores go through
``mdv_gather``/``mdv_scatter_`` there, random-base ones through
``torch.gather`` and the last-lane-wins owner table.  What the VM keeps is
the reference's observable contract: the same tables, the same signatures
(``batch_group_key`` groups requests by them), the same fallback
(:class:`VMUnsupported` past ``N_REGS`` live registers) and the same
counters (:func:`cache_info`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import isa
from .isa import DType, Op
from .machine import MVEConfig, OOB_BASE, next_pow2

# -- signature buckets ------------------------------------------------------
N_REGS = 8           # dense register-file slots (virtual regs are remapped)
MIN_SLOTS = 128      # instruction-slot bucket floor
MIN_MEM = 131072     # memory bucket floor (elements)
MIN_PATTERNS = 32    # address-pattern table floor (rows)
MIN_MASKS = 16       # mask table floor (rows)

# -- flag columns (bool table) ----------------------------------------------
F_WRITES_REG, F_WRITES_TAG, F_BLEND, F_SCATTER, F_RAND, F_PRED, \
    F_A_ISF, F_B_ISF, F_OLD_ISF, F_F16, F_FLOAT, F_SETDUP, F_LOAD = range(13)
N_FLAGS = 13

# -- int columns (int32 table) ----------------------------------------------
I_OPC, I_VD, I_VS1, I_VS2, I_SUB, I_SBASE, I_IMM, I_AMT, I_BMA, I_MASK, \
    I_SIGN, I_LO, I_HI, I_SROW, I_AROW, I_ABASE, I_PROW, I_PBASE, \
    I_MROW = range(19)
N_INTS = 19

# -- opcodes ----------------------------------------------------------------
(OPC_NOP, OPC_LOAD, OPC_STORE, OPC_INT, OPC_FLOAT, OPC_CMP) = range(6)

# subcodes
_INT_SUB = {Op.ADD: 0, Op.SUB: 1, Op.MUL: 2, Op.MIN: 3, Op.MAX: 4,
            Op.XOR: 5, Op.AND: 6, Op.OR: 7}
SUB_SHI, SUB_ROTI, SUB_SHR, SUB_MOVE_I = 8, 9, 10, 11
_FLT_SUB = {Op.ADD: 0, Op.SUB: 1, Op.MUL: 2, Op.MIN: 3, Op.MAX: 4}
SUB_MOVE_F = 5
_CMP_SUB = {Op.GT: 0, Op.GTE: 1, Op.LT: 2, Op.LTE: 3, Op.EQ: 4, Op.NEQ: 5}


class VMUnsupported(Exception):
    """Program cannot be lowered to the VM (e.g. too many live registers);
    :func:`repro_torch.core.engine.compile_program` falls back to the fused
    executor."""


# ---------------------------------------------------------------------------
# Executor-boundary fault hook (chaos engineering).
# ---------------------------------------------------------------------------

# One process-wide hook shared by the VM and the fused engine (engine.py
# imports these — vm is the lower layer, so the registry lives here).  A
# fault injector installs its hook to inject failures/latency at the real
# executor boundaries; ``None`` (the default) makes every site a no-op.
_FAULT_HOOK = None
_FAULT_HOOK_LOCK = threading.Lock()


def set_fault_hook(hook):
    """Install ``hook(site, **ctx)`` at the executor boundaries; returns
    the previous hook (restore it when done).  Sites fired here:
    ``vm.dispatch`` / ``vm.finalize``; :mod:`repro_torch.core.engine` adds
    ``engine.compile`` / ``engine.dispatch`` / ``engine.finalize``."""
    global _FAULT_HOOK
    with _FAULT_HOOK_LOCK:
        prev, _FAULT_HOOK = _FAULT_HOOK, hook
    return prev


def fire_fault_hook(site: str, **ctx) -> None:
    hook = _FAULT_HOOK
    if hook is not None:
        hook(site, **ctx)


def enable_disk_cache(path: Optional[str] = None):
    """The reference's API, a no-op: the reference persists its XLA
    datapath compile across processes; nothing is compiled here.  Returns
    the value :func:`restore_disk_cache` takes."""
    return None


def restore_disk_cache(prev) -> None:
    """Undo :func:`enable_disk_cache` (a no-op, as that is)."""


# ---------------------------------------------------------------------------
# The signature cache: which signatures ran, single-image or batched.
# ---------------------------------------------------------------------------

_EXECUTORS: Dict[Tuple[int, ...], Set[str]] = {}   # signature -> kinds
_EXECUTORS_LOCK = threading.Lock()
_HITS = 0


def _executor(sig: Tuple[int, ...], kind: str) -> None:
    """Record a dispatch or warm-up of ``kind`` (``"single"`` or
    ``"batch"``) under ``sig``; a known signature counts a hit."""
    global _HITS
    with _EXECUTORS_LOCK:
        kinds = _EXECUTORS.get(sig)
        if kinds is None:
            kinds = _EXECUTORS[sig] = set()
        else:
            _HITS += 1
        kinds.add(kind)


def default_signature(cfg: MVEConfig | None = None,
                      mem_size: int = MIN_MEM) -> Tuple[int, ...]:
    """The signature every bucket-floor program maps to — all 14 Section-IV
    patterns and their data-dependent variants share this one executor."""
    cfg = cfg or MVEConfig()
    bucket = next_pow2(max(mem_size, MIN_MEM))
    return (cfg.lanes, N_REGS, MIN_SLOTS, bucket, MIN_SLOTS, MIN_PATTERNS,
            MIN_MASKS, 1)


def prewarm(cfg: MVEConfig | None = None, mem_size: int = MIN_MEM,
            block: bool = True) -> None:
    """The reference's API: record the default signature's single-image
    executor.  The reference compiles it, on a thread when ``block`` is
    false; nothing is compiled here, so nothing runs in the background."""
    _executor(default_signature(cfg, mem_size), "single")


def clear_executors() -> None:
    """Forget every signature and reset the counters (tests)."""
    global _HITS
    with _EXECUTORS_LOCK:
        _EXECUTORS.clear()
        _HITS = 0


@dataclasses.dataclass(frozen=True)
class VMCacheInfo:
    signatures: int          # distinct signatures dispatched or warmed
    hits: int                # dispatches of an already known signature
    executors: int           # (signature, single-or-batch) pairs seen

    @property
    def xla_compiles(self) -> int:
        """The reference's name for :attr:`executors`: it compiles one XLA
        executable for each (per argument geometry); nothing is compiled
        here."""
        return self.executors


def cache_info() -> VMCacheInfo:
    with _EXECUTORS_LOCK:
        return VMCacheInfo(
            signatures=len(_EXECUTORS), hits=_HITS,
            executors=sum(len(k) for k in _EXECUTORS.values()))


# ---------------------------------------------------------------------------
# Lowering: engine steps -> dense tables.
# ---------------------------------------------------------------------------

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _dtype_fields(dt: DType) -> Tuple[int, int, int, int, bool, bool]:
    """(wrap_mask, sign_bit, clamp_lo, clamp_hi, is_float, is_f16) for the
    32-bit datapath.  QW runs as a 32-bit integer, as in the other
    executors.  clamp_lo/hi bound float->int reads so they saturate like
    the other executors' conversions."""
    if dt.is_float:
        return -1, 0, _I32_MIN, _I32_MAX, True, dt is DType.HF
    bits = min(dt.bits, 32)
    if bits >= 32:
        return -1, 0, _I32_MIN, _I32_MAX, False, False
    mask = (1 << bits) - 1
    if dt is DType.B:
        return mask, 0, 0, mask, False, False
    sign = 1 << (bits - 1)
    return mask, sign, -sign, sign - 1, False, False


def _wrap_host(value: int, mask: int, sign: int) -> int:
    if mask == -1:                   # full 32-bit register
        v = int(value) & 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v
    v = int(value) & mask
    if sign and v & sign:
        v -= sign << 1
    return v


class _RowInterner:
    """Deduplicate (lanes,) rows; returns stable row indices."""

    def __init__(self, first_row: np.ndarray):
        self.rows = [first_row]
        self._index = {first_row.tobytes(): 0}

    def add(self, row: np.ndarray) -> int:
        key = row.tobytes()
        idx = self._index.get(key)
        if idx is None:
            idx = self._index[key] = len(self.rows)
            self.rows.append(row)
        return idx


class VMProgram:
    """A program lowered to VM tables, run by the fused datapath.

    Built by :class:`repro_torch.core.engine.CompiledProgram` in
    ``mode="vm"``, which hands in ``execute``: its datapath on one image
    ``(N,)`` or a batch ``(B, N)`` (float32, executor-owned, updated in
    place), returning ``(mem, regs, tag, rand_addrs)``.  Raises
    :class:`VMUnsupported` when the program does not fit the fixed
    register file (more than ``N_REGS`` live registers).  ``tables`` holds
    the host (NumPy) tables, bucketed to the signature.
    """

    def __init__(self, steps, cfg: MVEConfig, n_random: int,
                 execute: Callable[[torch.Tensor], tuple]):
        self.cfg = cfg
        self.n_random = n_random
        self._execute = execute
        lanes = cfg.lanes
        self._lower(steps, lanes)
        self.slots_bucket = next_pow2(max(self.n_steps, MIN_SLOTS))
        self._pad_tables(lanes)

    # -- lowering ----------------------------------------------------------
    def _lower(self, steps, lanes: int) -> None:
        regmap: Dict[int, int] = {}
        stored_float: Dict[int, bool] = {}
        final_dtype: Dict[int, DType] = {}

        def slot_of(vreg: Optional[int]) -> int:
            if vreg is None:
                return 0
            if vreg not in regmap:
                if len(regmap) >= N_REGS:
                    raise VMUnsupported(
                        f"program uses more than {N_REGS} live registers")
                regmap[vreg] = len(regmap)
            return regmap[vreg]

        ints: List[np.ndarray] = []
        flags: List[np.ndarray] = []
        fimm: List[float] = []
        patterns = _RowInterner(np.zeros(lanes, dtype=np.int32))
        masks = _RowInterner(np.zeros(lanes, dtype=bool))
        self._scat_rows: List[np.ndarray] = []
        self._perm_rows: List[np.ndarray] = []
        self.rand_slot_to_step: List[int] = [0] * self.n_random
        self.max_blend_base = 0

        for step in steps:
            instr = step.instr
            op = instr.op
            if op in isa.CONFIG_OPS or op is Op.SCALAR:
                continue                       # pure no-ops in the datapath

            iv = np.zeros(N_INTS, dtype=np.int64)
            fl = np.zeros(N_FLAGS, dtype=bool)
            fv = 0.0
            dt = instr.dtype
            mask, sign, lo, hi, is_f, is_f16 = _dtype_fields(dt)
            iv[I_MASK], iv[I_SIGN] = mask, sign
            iv[I_LO], iv[I_HI] = lo, hi
            fl[F_FLOAT], fl[F_F16] = is_f, is_f16
            # The other executors honor the Tag latch only on compute
            # write-backs; memory ops use the lane mask alone.
            fl[F_PRED] = instr.predicated and op not in isa.MEMORY_OPS
            iv[I_MROW] = masks.add(step.lane_mask)

            def src(vreg, col, fl=fl):
                s = slot_of(vreg)
                fl[col] = stored_float.get(s, False)
                return s

            def dst(vreg, fl=fl, iv=iv):
                s = slot_of(vreg)
                iv[I_VD] = s
                fl[F_OLD_ISF] = stored_float.get(s, False)
                fl[F_WRITES_REG] = True
                return s

            def wrote(vreg, slot, is_float=is_f, dt=dt):
                stored_float[slot] = is_float
                final_dtype[vreg] = dt

            def static_addr(iv=iv, step=step):
                base = int(step.instr.base)
                iv[I_ABASE] = base
                iv[I_AROW] = patterns.add(
                    (step.addr - base).astype(np.int32))

            def rand_addr(iv=iv, fl=fl, step=step, at=len(ints)):
                fl[F_RAND] = True
                iv[I_AROW] = patterns.add(step.offsets.astype(np.int32))
                iv[I_PBASE] = int(step.ptr_base)
                iv[I_PROW] = patterns.add(step.top_idx.astype(np.int32))
                self.rand_slot_to_step[step.rand_slot] = at

            if op in (Op.SLD, Op.RLD):
                iv[I_OPC] = OPC_LOAD
                fl[F_LOAD] = True
                s = dst(instr.vd)
                if step.rand_slot is not None:
                    rand_addr()
                else:
                    static_addr()
                wrote(instr.vd, s)
            elif op in (Op.SST, Op.RST):
                iv[I_OPC] = OPC_STORE
                iv[I_VS1] = src(instr.vs1, F_A_ISF)
                if step.rand_slot is not None:
                    fl[F_SCATTER] = True
                    rand_addr()
                else:
                    layout = step.store_layout
                    if layout[0] == "contig":
                        fl[F_BLEND] = True
                        iv[I_SBASE] = layout[1]
                        self.max_blend_base = max(self.max_blend_base,
                                                  layout[1])
                    elif layout[0] == "scatter":
                        fl[F_SCATTER] = True
                        iv[I_SROW] = len(self._scat_rows) + 1  # row 0 shared
                        self._scat_rows.append(layout[1])
                        self._perm_rows.append(layout[2])
                    else:                      # fully masked store: no-op
                        continue
            elif op is Op.SET_DUP:
                iv[I_OPC] = OPC_FLOAT if is_f else OPC_INT
                iv[I_SUB] = SUB_MOVE_F if is_f else SUB_MOVE_I
                fl[F_SETDUP] = True
                s = dst(instr.vd)
                if is_f:
                    fv = float(np.float32(np.float16(instr.imm))) if is_f16 \
                        else float(np.float32(instr.imm))
                else:
                    iv[I_IMM] = _wrap_host(int(instr.imm), mask, sign)
                wrote(instr.vd, s)
            elif op in (Op.CPY, Op.CVT):
                iv[I_OPC] = OPC_FLOAT if is_f else OPC_INT
                iv[I_SUB] = SUB_MOVE_F if is_f else SUB_MOVE_I
                iv[I_VS1] = src(instr.vs1, F_A_ISF)
                s = dst(instr.vd)
                wrote(instr.vd, s)
            elif op in isa.COMPARE_OPS:
                iv[I_OPC] = OPC_CMP
                fl[F_WRITES_TAG] = True
                iv[I_SUB] = _CMP_SUB[op]
                iv[I_VS1] = src(instr.vs1, F_A_ISF)
                iv[I_VS2] = src(instr.vs2, F_B_ISF)
            elif op in (Op.SHI, Op.ROTI, Op.SHR):
                if is_f:
                    raise ValueError("shift on float register")
                iv[I_OPC] = OPC_INT
                iv[I_SUB] = {Op.SHI: SUB_SHI, Op.ROTI: SUB_ROTI,
                             Op.SHR: SUB_SHR}[op]
                if op is Op.SHI:
                    iv[I_AMT] = max(instr.imm, 0)
                    iv[I_BMA] = max(-instr.imm, 0)
                elif op is Op.ROTI:
                    # amt = imm % bits with the *declared* width; the
                    # unsigned 32-bit datapath then matches the other
                    # executors' rotate for every amount.
                    amt = instr.imm % dt.bits
                    iv[I_AMT], iv[I_BMA] = amt, dt.bits - amt
                iv[I_VS1] = src(instr.vs1, F_A_ISF)
                if instr.vs2 is not None:
                    iv[I_VS2] = src(instr.vs2, F_B_ISF)
                s = dst(instr.vd)
                wrote(instr.vd, s, is_float=False)
            else:
                table = _FLT_SUB if is_f else _INT_SUB
                if op not in table:
                    raise ValueError(f"op {op} on dtype {dt}")
                iv[I_OPC] = OPC_FLOAT if is_f else OPC_INT
                iv[I_SUB] = table[op]
                iv[I_VS1] = src(instr.vs1, F_A_ISF)
                iv[I_VS2] = src(instr.vs2, F_B_ISF)
                s = dst(instr.vd)
                wrote(instr.vd, s)

            ints.append(iv)
            flags.append(fl)
            fimm.append(fv)

        self.n_steps = len(ints)
        self._ints = ints
        self._flags = flags
        self._fimm = fimm
        self._patterns = patterns
        self._masks = masks
        self.final_dtype = final_dtype
        self.regmap = regmap

    def _pad_tables(self, lanes: int) -> None:
        slots = self.slots_bucket
        self.pat_bucket = next_pow2(max(len(self._patterns.rows),
                                        MIN_PATTERNS))
        self.mask_bucket = next_pow2(max(len(self._masks.rows), MIN_MASKS))
        self.scat_bucket = next_pow2(len(self._scat_rows) + 1)  # + row 0
        ints = np.zeros((slots, N_INTS), dtype=np.int32)
        flags = np.zeros((slots, N_FLAGS), dtype=bool)
        fimm = np.zeros(slots, dtype=np.float32)
        pat_t = np.zeros((self.pat_bucket, lanes), dtype=np.int32)
        mask_t = np.zeros((self.mask_bucket, lanes), dtype=bool)
        n = self.n_steps
        if n:
            ints[:n] = np.stack(self._ints).astype(np.int32)
            flags[:n] = np.stack(self._flags)
            fimm[:n] = np.asarray(self._fimm, dtype=np.float32)
        pat_t[:len(self._patterns.rows)] = np.stack(self._patterns.rows)
        mask_t[:len(self._masks.rows)] = np.stack(self._masks.rows)
        scat = np.zeros((self.scat_bucket, lanes), dtype=np.int64)
        perm = np.tile(np.arange(lanes, dtype=np.int32),
                       (self.scat_bucket, 1))
        scat[0] = OOB_BASE + np.arange(lanes, dtype=np.int64)
        for i, row in enumerate(self._scat_rows):
            scat[i + 1] = row
        for i, row in enumerate(self._perm_rows):
            perm[i + 1] = row
        scat_t = np.minimum(scat, np.iinfo(np.int32).max).astype(np.int32)
        self.tables = (ints, flags, fimm, pat_t, mask_t, scat_t, perm)
        # Observability: live row counts of the deduplicated tables
        # (before bucket padding).
        self.table_rows = {
            "steps": self.n_steps,
            "patterns": len(self._patterns.rows),
            "masks": len(self._masks.rows),
            "scatters": len(self._scat_rows),
        }
        del (self._ints, self._flags, self._fimm, self._patterns,
             self._masks, self._scat_rows, self._perm_rows)

    # -- execution ---------------------------------------------------------
    def _signature(self, mem_size: int) -> Tuple[int, ...]:
        bucket = next_pow2(max(mem_size, MIN_MEM, self.max_blend_base + 1))
        # Random-access bucket: one address row per slot, so programs with
        # and without random ops share one executor.
        return (self.cfg.lanes, N_REGS, self.slots_bucket, bucket,
                self.slots_bucket, self.pat_bucket, self.mask_bucket,
                self.scat_bucket)

    def _dispatch(self, memory: torch.Tensor, kind: str):
        fire_fault_hook("vm.dispatch", tier="vm")
        if memory.dtype != torch.float32:
            raise TypeError(f"the VM takes float32 images, got "
                            f"{memory.dtype}")
        _executor(self._signature(memory.shape[-1]), kind)
        return self._execute(memory)

    def run_async(self, memory: torch.Tensor):
        """Enqueue one float32 image ``(N,)`` (executor-owned, updated in
        place) without waiting; :meth:`finalize` materializes results."""
        return self._dispatch(memory, "single")

    def finalize(self, pending):
        """``(mem, regs, tag, rand_addrs)`` of a :meth:`run_async` call."""
        fire_fault_hook("vm.finalize", tier="vm")
        return pending

    def run(self, memory: torch.Tensor):
        """Execute one image; returns ``(mem, regs, tag, rand)`` with
        ``rand`` the per-random-op address vectors for the trace."""
        return self.finalize(self.run_async(memory))

    def run_batch_async(self, memories: torch.Tensor):
        """Batched :meth:`run_async` over a ``(B, N)`` float32 batch;
        finalize with :meth:`finalize_batch`."""
        return self._dispatch(memories, "batch")

    def finalize_batch(self, pending):
        fire_fault_hook("vm.finalize", tier="vm")
        mem, regs, tag, _ = pending
        return mem, regs, tag

    def run_batch(self, memories: torch.Tensor):
        return self.finalize_batch(self.run_batch_async(memories))

    def warmup(self, mem_size: int, batch: Optional[int] = None) -> None:
        """Record the signature's single-image (or batch) executor."""
        _executor(self._signature(mem_size),
                  "single" if batch is None else "batch")
