"""MVE machine geometry and controller state.

Models the cache architecture of Section V: a 256 KB L2 slice repurposed as
32 compute-capable 8 KB SRAM arrays.  Each array has 256 bitlines; data
elements are transposed onto bitlines (Neural Cache layout), so every bitline
is one SIMD lane:

    lanes = num_arrays * bitlines = 32 * 256 = 8192

Arrays are grouped 4-per-Control-Block (CB); each CB has one FSM and can be
masked off per-instruction by the dimension-level mask (Section V-B).

A physical register (PR) occupies ``width`` wordlines out of 256, so the
number of live PRs is ``wordlines // width`` (Section III-B: constant vector
length, *variable* register count).

The addressing semantics (stride modes, dimension flattening, masking) are
documented with worked examples in docs/ISA.md.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from .isa import MAX_DIMS, MAX_TOP_DIM, DType, Instr, Op, ProgramError

# Byte data in the mobile kernels (pixels, characters) is unsigned; wider
# integer types model the signed variants (the ISA has both, Section III-F).
# ``QW`` is held in 32 bits: the reference runs in 32-bit mode, where its
# 64-bit integer registers are int32 in practice, and the port matches it.
TORCH_DTYPE = {
    DType.B: torch.uint8,
    DType.W: torch.int16,
    DType.DW: torch.int32,
    DType.QW: torch.int32,
    DType.HF: torch.float16,
    DType.F: torch.float32,
}

# Canonical element types of memory images and registers: 64-bit inputs
# narrow to 32 bits, as they do in the reference's 32-bit mode.
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point allocates on: ``cuda`` unless the caller
    names another.  Asking for a CUDA device where there is none raises —
    execution never carries on on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Element-type conversion with the reference's semantics.

    float -> integer saturates at the target's bounds, truncates toward
    zero and maps NaN to 0 (``Tensor.to`` is undefined out of range and
    differs between CPU and CUDA); integer -> narrower integer wraps;
    everything else is PyTorch's own rounding conversion.  Every
    register read, load, ``vcvt`` and store in both executors goes
    through here.
    """
    if x.dtype == dtype:
        return x
    if x.dtype.is_floating_point and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        wide = torch.nan_to_num(x.to(torch.float64), nan=0.0)
        return wide.clamp(info.min, info.max).to(torch.int64).to(dtype)
    return x.to(dtype)


def as_memory(memory, device) -> torch.Tensor:
    """A fresh, executor-owned memory image on ``device`` in its canonical
    element type (float64 -> float32, int64 -> int32).  Always a copy: the
    executors store in place and must never write into the caller's
    buffer."""
    if isinstance(memory, torch.Tensor):
        mem = memory.detach()
    else:
        mem = torch.from_numpy(np.ascontiguousarray(memory))
    mem = mem.to(device=device, dtype=_CANONICAL.get(mem.dtype, mem.dtype),
                 copy=True)
    return mem.contiguous()


def to_numpy(x) -> np.ndarray:
    """Host NumPy view of a tensor on any device (arrays pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class MVEConfig:
    """Geometry + compute-scheme knobs (Table IV `MVE` row by default)."""

    num_arrays: int = 32          # 4 cache ways x 8 arrays
    bitlines: int = 256           # SIMD lanes per array
    wordlines: int = 256          # bits of register file per lane
    arrays_per_cb: int = 4        # Section V-B (Duality-Cache granularity)
    scheme: str = "bs"            # bs | bp | bh | ac
    bh_segment_bits: int = 4      # EVE segment width for the bh scheme
    freq_ghz: float = 2.8         # clocked with the core (Table IV)

    #: Compute schemes of Section II-B the cost models understand.
    KNOWN_SCHEMES = ("bs", "bp", "bh", "ac")

    def __post_init__(self) -> None:
        """Geometry sanity checks at construction time.

        A bad geometry (non-power-of-two array dimensions, an array count
        the CB grouping can't divide, an unknown scheme) used to flow
        silently into ``lanes``/``effective_lanes`` and produce nonsense
        lane counts far downstream; reject it here with a readable
        :class:`ProgramError` instead.
        """
        for field, value in (("num_arrays", self.num_arrays),
                             ("arrays_per_cb", self.arrays_per_cb)):
            if not (isinstance(value, int) and value > 0):
                raise ProgramError(
                    f"MVEConfig.{field} must be a positive int, "
                    f"got {value!r}")
        for field, value in (("bitlines", self.bitlines),
                             ("wordlines", self.wordlines),
                             ("bh_segment_bits", self.bh_segment_bits)):
            if not (isinstance(value, int) and value > 0
                    and value & (value - 1) == 0):
                raise ProgramError(
                    f"MVEConfig.{field} must be a positive power of two "
                    f"(the bitline/wordline decoders are binary trees), "
                    f"got {value!r}")
        if self.num_arrays % self.arrays_per_cb:
            raise ProgramError(
                f"MVEConfig.num_arrays={self.num_arrays} is not divisible "
                f"by arrays_per_cb={self.arrays_per_cb}; control blocks "
                f"must group whole arrays (Section V-B)")
        if self.scheme not in self.KNOWN_SCHEMES:
            raise ProgramError(
                f"unknown compute scheme {self.scheme!r}; known schemes: "
                f"{', '.join(self.KNOWN_SCHEMES)}")
        if self.freq_ghz <= 0:
            raise ProgramError(
                f"MVEConfig.freq_ghz must be positive, got {self.freq_ghz!r}")

    @property
    def lanes(self) -> int:
        return self.num_arrays * self.bitlines

    @property
    def num_cbs(self) -> int:
        return self.num_arrays // self.arrays_per_cb

    @property
    def lanes_per_cb(self) -> int:
        return self.bitlines * self.arrays_per_cb

    def num_physical_registers(self, width_bits: int) -> int:
        """Variable register count: 256 wordlines / live register width."""
        return self.wordlines // max(width_bits, 1)

    def effective_lanes(self, width_bits: int) -> int:
        """SIMD lanes available under each compute scheme (Section II-B).

        bs: every bitline is a lane.
        bp: n-bit data lies horizontally -> 8K/n lanes (VRAM).
        bh: p-bit segments lie horizontally -> 8K/p lanes (EVE).
        ac: bit-slices lie horizontally across arrays; lanes = wordlines x
            arrays/bits ~= 8K/ (bits/arrays)... CAPE keeps 8K-element tiles,
            we model the same lane count as bs (latency differs).
        """
        if self.scheme == "bs":
            return self.lanes
        if self.scheme == "bp":
            return self.lanes // max(width_bits, 1)
        if self.scheme == "bh":
            return self.lanes // max(self.bh_segment_bits, 1)
        if self.scheme == "ac":
            return self.lanes
        raise ValueError(f"unknown scheme {self.scheme!r}")


@dataclasses.dataclass
class ControlState:
    """The controller CRs (Section III-B / V-B)."""

    dim_count: int = 1
    dim_lens: List[int] = dataclasses.field(
        default_factory=lambda: [1] * MAX_DIMS)
    ld_strides: List[int] = dataclasses.field(
        default_factory=lambda: [0] * MAX_DIMS)
    st_strides: List[int] = dataclasses.field(
        default_factory=lambda: [0] * MAX_DIMS)
    # one mask bit per element of the highest dimension (max 256)
    dim_mask: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(MAX_TOP_DIM, dtype=bool))
    kernel_width: int = 32

    def active_dims(self) -> Tuple[int, ...]:
        return tuple(self.dim_lens[: self.dim_count])

    def active_elements(self) -> int:
        return int(np.prod(self.active_dims()))

    def resolve_strides(self, modes: Tuple[int, ...], store: bool
                        ) -> Tuple[int, ...]:
        """Resolve 2-bit stride modes to absolute strides (Section III-C).

        mode 2 derives S_i = S_{i-1} * L_{i-1} with S_{-1} = 1, which is the
        "dense row-major continuation" stride.
        """
        crs = self.st_strides if store else self.ld_strides
        strides = []
        prev = 1
        for d in range(self.dim_count):
            mode = modes[d] if d < len(modes) else 1
            if mode == 0:
                s = 0
            elif mode == 1:
                s = 1
            elif mode == 2:
                prev_len = self.dim_lens[d - 1] if d > 0 else 1
                s = (strides[d - 1] if d > 0 else 1) * prev_len
            elif mode == 3:
                s = crs[d]
            else:
                raise ValueError(f"bad stride mode {mode}")
            strides.append(s)
            prev = s
        return tuple(strides)


def flatten_indices(dims: Tuple[int, ...], lanes: int) -> np.ndarray:
    """Map lane id -> multi-dim logical index, x fastest (Figure 5).

    Returns an int array of shape (lanes, len(dims)); lanes beyond
    prod(dims) are marked inactive with -1 in every coordinate.
    Memoized: compile walks resolve the same (dims, lanes) pair for every
    instruction under one configuration, and the result is pure.  Treat
    the returned array as read-only.
    """
    return _flatten_indices_cached(tuple(dims), lanes)


@functools.lru_cache(maxsize=512)
def _flatten_indices_cached(dims: Tuple[int, ...], lanes: int) -> np.ndarray:
    total = int(np.prod(dims))
    lane = np.arange(lanes, dtype=np.int64)
    coords = np.full((lanes, len(dims)), -1, dtype=np.int64)
    active = lane < total
    rem = np.where(active, lane, 0)
    for d, length in enumerate(dims):       # d=0 is x (fastest)
        coords[:, d] = np.where(active, rem % length, -1)
        rem = rem // length
    coords.setflags(write=False)
    return coords


def lane_dim_mask(dims: Tuple[int, ...], dim_mask: np.ndarray,
                  lanes: int) -> np.ndarray:
    """Expand the highest-dimension mask CR to a per-lane boolean mask."""
    coords = flatten_indices(dims, lanes)
    top = coords[:, len(dims) - 1]
    active = top >= 0
    top_clipped = np.clip(top, 0, len(dim_mask) - 1)
    return active & dim_mask[top_clipped]


def apply_config(ctrl: ControlState, instr: Instr) -> None:
    """Apply one config instruction to the control registers.

    Shared by the step interpreter, the program compiler
    (:mod:`repro_torch.core.engine`), and the RVV lowering — the config ops are
    what both execution paths resolve *statically* (docs/ENGINE.md).
    """
    op = instr.op
    if op is Op.SET_DIMC:
        ctrl.dim_count = instr.imm
    elif op is Op.SET_DIML:
        # The mask CR only covers the first MAX_TOP_DIM elements of the
        # highest dimension (Section III-E); longer highest dims are
        # legal but can only be dimension-masked on that prefix.
        ctrl.dim_lens[instr.dim] = instr.length
    elif op is Op.SET_LDSTR:
        ctrl.ld_strides[instr.dim] = instr.stride
    elif op is Op.SET_STSTR:
        ctrl.st_strides[instr.dim] = instr.stride
    elif op is Op.SET_MASK:
        ctrl.dim_mask[instr.mask_index] = True
    elif op is Op.UNSET_MASK:
        ctrl.dim_mask[instr.mask_index] = False
    elif op is Op.SET_WIDTH:
        ctrl.kernel_width = instr.imm
    else:
        raise ValueError(f"not a config op: {op}")


def config_cell(instr: Instr) -> Tuple:
    """The control-register *cell* a config instruction writes.

    Cells are the unit of the optimizer's dead-config analysis and the
    frontend's duplicate-emission suppression: two writes touch the same
    architectural state iff they have the same cell.
    """
    op = instr.op
    if op is Op.SET_DIMC:
        return ("dimc",)
    if op is Op.SET_DIML:
        return ("diml", instr.dim)
    if op is Op.SET_LDSTR:
        return ("ldstr", instr.dim)
    if op is Op.SET_STSTR:
        return ("ststr", instr.dim)
    if op in (Op.SET_MASK, Op.UNSET_MASK):
        return ("mask", instr.mask_index)
    if op is Op.SET_WIDTH:
        return ("width",)
    raise ValueError(f"not a config op: {op}")


def read_config_cell(ctrl: ControlState, cell: Tuple):
    """Current value of one config cell (see :func:`config_cell`)."""
    kind = cell[0]
    if kind == "dimc":
        return ctrl.dim_count
    if kind == "diml":
        return ctrl.dim_lens[cell[1]]
    if kind == "ldstr":
        return ctrl.ld_strides[cell[1]]
    if kind == "ststr":
        return ctrl.st_strides[cell[1]]
    if kind == "mask":
        return bool(ctrl.dim_mask[cell[1]])
    if kind == "width":
        return ctrl.kernel_width
    raise ValueError(f"unknown config cell {cell!r}")


def stream_shape(dims: Tuple[int, ...], strides: Tuple[int, ...],
                 lanes: int) -> Tuple[int, int, int]:
    """(contiguous run, segments, unique elements) of a strided access.

    Cost-model metadata: stride-0 dims are replication (free through the
    TMU crossbar); among the rest, runs grow while each stride equals the
    current dense run size (mode-2 "derived" accesses collapse to a single
    contiguous run).
    """
    nz = sorted((s, ln) for ln, s in zip(dims, strides) if s != 0)
    run, segments, unique = 1, 1, 1
    for s, ln in nz:
        unique *= ln
        if s == run:
            run *= ln
        else:
            segments *= ln
    return run, segments, min(unique, lanes)


def touched_lines(addr: np.ndarray, mask: np.ndarray, nbytes: int) -> int:
    """Exact 64-byte cache lines covered by a masked address stream."""
    if not mask.any():
        return 0
    return int(np.unique((addr[mask] * nbytes) // 64).size)


def cbs_touched(dims: Tuple[int, ...], dim_mask: np.ndarray,
                cfg: MVEConfig) -> np.ndarray:
    """Which control blocks have at least one active lane (mask bit-vector

    the controller keeps per instruction, Section V-B)."""
    return cbs_from_lane_mask(lane_dim_mask(dims, dim_mask, cfg.lanes), cfg)


def cbs_from_lane_mask(lane_mask: np.ndarray, cfg: MVEConfig) -> np.ndarray:
    """CB participation derived from an already-expanded lane mask (the
    compile walks have one in hand; avoids re-expanding the dim mask)."""
    per_cb = lane_mask.reshape(cfg.num_cbs, cfg.lanes_per_cb)
    return per_cb.any(axis=1)
