"""Roofline terms of a step, and the cost counter that stands in for XLA's
analyses.

The reference reads a compiled program's per-device FLOPs and bytes from
XLA's ``cost_analysis`` and parses its collective traffic out of the HLO
text (:func:`collective_bytes`, carried over unchanged: it is pure text).
PyTorch runs eagerly and has no HLO, so the port counts what one rank
dispatches while it runs the step (:class:`CostCounter`, a
``TorchDispatchMode``), on the card or on ``meta`` tensors under a
``fake`` process group (``launch/dryrun.py``).  Both see the same
dispatches, so both give the same counts.

Collective traffic keeps the reference's rule: the bytes of each
collective's *result* on this rank, the data it materializes from the wire.

Hardware model, one NVIDIA H100 SXM (data sheet): 989 TFLOP/s bf16 dense
on the tensor cores, 3.35 TB/s HBM3, and NVLink at 450 GB/s a direction.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict, Iterable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores / card
HBM_BW = 3.35e12             # bytes/s per card
# One direction of one card's NVLink (900 GB/s both ways), which joins the
# 8 cards of a node all to all.  A 16-wide ``model`` axis spans two nodes:
# what crosses between them goes over the nodes' network, which is slower
# and is not modelled here.
NVLINK_BW = 450e9            # bytes/s per card, one direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_SHAPE_RE = re.compile(r"\b([a-z]+[0-9]*)\[([0-9,]*)\]")
_START_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.*)$")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective-kind result bytes in one device's module."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        kind = None
        for k in _COLLECTIVES:
            # match the op name, not fusion names: " all-reduce(" etc.
            if f" {k}(" in line or f" {k}-start(" in line:
                kind = k
                break
        if kind is None:
            continue
        m = _START_RE.match(line)
        if not m:
            continue
        rhs = m.group(1)
        # result type = shape tokens before the op name
        op_pos = rhs.find(kind)
        result_part = rhs[:op_pos]
        total = 0
        for dt, dims in _SHAPE_RE.findall(result_part):
            total += _shape_bytes(dt, dims)
        out[kind] += total
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops_total: float          # 6ND / 2ND convention

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is useful
        (catches remat/redundancy waste)."""
        per_dev = self.model_flops_total / self.chips
        return per_dev / max(self.flops_per_device, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization at the modelled bound: the fraction of
        peak the step achieves if it runs exactly at the dominant term."""
        per_dev_useful = self.model_flops_total / self.chips
        return per_dev_useful / (self.bound_s * PEAK_FLOPS)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, cell) -> float:
    """6*N*D train / 2*N*D inference convention; N_active for MoE."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * cell.global_batch


# ---------------------------------------------------------------------------
# The cost counter
# ---------------------------------------------------------------------------

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd")
# (name fragment, kind): c10d's and the functional collectives' op names
_COLLECTIVE_NAMES = (("all_gather", "all-gather"),
                     ("allgather", "all-gather"),
                     ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"),
                     ("recv", "collective-permute"),
                     ("send", "collective-permute"))
# ops that allocate and write nothing
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "new_empty",
                         "new_empty_strided", "empty_like"))


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _plain(t: torch.Tensor) -> bool:
    return type(t) in (torch.Tensor, torch.nn.Parameter)


def _collective_kind(func):
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    for fragment, kind in _COLLECTIVE_NAMES:
        if fragment in name:
            return kind
    return None


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its ``StorageImpl``)."""
    return t.untyped_storage()._cdata


def local_tensors(tree) -> list:
    """The plain tensors this rank holds of ``tree`` (a DTensor's local
    tensor)."""
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in _tensors(tree)]


def local_bytes(tree) -> int:
    return sum(map(_nbytes, local_tensors(tree)))


class CostCounter(TorchDispatchMode):
    """What this rank dispatches while the mode is on:

    * ``flops``: the flop formulas of ``torch.utils.flop_counter``'s
      registry (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, the
      flash kernels' ops) over the ops no ``DTensor`` enters.  A DTensor
      op is handed on to DTensor's dispatch, which runs its local ops on
      plain tensors: those are the rank's own work, and only they are
      counted.
    * ``bytes``: each such op's input and output tensor bytes (views and
      bare allocations move none).  This is eager PyTorch's traffic, op by
      op: no fusion keeps an intermediate out of device memory.
    * ``collectives``: result bytes of each collective on this rank, under
      the reference's five kinds and ``total``: all-gather, all-reduce,
      reduce-scatter and all-to-all of ``c10d`` and the functional
      collectives; send/recv as ``collective-permute``, counted where the
      data lands (``recv``).
    * ``peak_bytes``: the peak of the live bytes of the storages of plain
      tensors that ops made while the mode was on (not those of ``known``
      storages, e.g. the step's arguments).  A kernel's scratch, allocated
      inside an operator, is not seen.
    """

    def __init__(self, known: Iterable[int] = ()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak_bytes = 0
        self._known = set(known)
        self._storages: Dict[int, list] = {}    # key -> [bytes, tensors]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(x, DTensor) for x in leaves):
            # DTensor's own dispatch runs; its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if any(not _plain(x) for x in _tensors((leaves, out))):
            # not this rank's work: DTensor's sharding propagation makes
            # fake tensors of the global shapes and runs an op on them once
            # (and caches it)
            return out
        kind = _collective_kind(func)
        if kind is not None:
            if "send" not in func._schema.name:
                results = _tensors(out) or _tensors(args[0])
                self.collectives[kind] += sum(map(_nbytes, results))
        else:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if not func.is_view and \
                    func._schema.name.split("::")[-1] not in _NO_TRAFFIC:
                self.bytes += sum(map(_nbytes, _tensors((args, kwargs, out))))
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = storage_key(t)
        if key in self._known:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def counts(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {**self.collectives,
                                "total": sum(self.collectives.values())},
                "peak_bytes": self.peak_bytes}
