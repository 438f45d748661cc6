"""Fault-tolerant checkpoint store, in the reference's on-disk format.

A checkpoint is a directory ``step_<8 digits>`` holding one ``.npy`` per
leaf (file name: the leaf's path with ``/`` as ``__``) and a
``manifest.json`` (``step``, ``metadata``, and per leaf its ``key``,
``file``, ``shape`` and logical ``dtype``).  bfloat16 and float8 leaves,
which NumPy cannot name, are stored as their raw ``uint16`` / ``uint8``
bits under their logical type.  A checkpoint written by either package
loads in the other.

  * atomic commits (write to a tmp dir, fsync the manifest, rename): a
    preempted writer never corrupts the latest checkpoint;
  * async saves on a background thread (the tree is copied to the host
    first, so the train loop keeps stepping);
  * restore onto a device, and onto DTensor placements on a mesh (the
    reference's elastic restore: a checkpoint written on one mesh loads
    onto another); a DTensor leaf is saved whole (``full_tensor()``, which
    every rank of its mesh calls; one rank writes);
  * retention policy + emergency ("preemption") saves;
  * step/data-position metadata for exact training resume.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.machine import resolve_device
from ..parallel.axes import gather, place
from ..trees import tree_leaves, tree_map, tree_unflatten

_SEP = "/"                  # path separator of tree_leaves
# logical type -> (stored NumPy bits, torch type)
_RAW = {"bfloat16": (np.uint16, torch.bfloat16),
        "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
        "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_TORCH_NAMES = {t: name for name, (_, t) in _RAW.items()}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and its logical type's name."""
    if isinstance(leaf, torch.Tensor):
        t = gather(leaf.detach()).to("cpu")
        if t.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[t.dtype]
            bits = _RAW[name][0]
            view = torch.int16 if bits == np.uint16 else torch.uint8
            return t.contiguous().view(view).numpy().view(bits), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    metadata: Optional[Dict] = None) -> str:
    """Atomic synchronous save of a nested dict of tensors (or arrays);
    returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": []}
    # tree_leaves' paths are the reference's tree_flatten_with_path keys
    for key, leaf in tree_leaves(tree):
        arr, logical = _to_host(leaf)
        fname = key.replace(_SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _read_leaf(path: str, entry: Dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))   # C order, writable
    logical = entry["dtype"]
    if logical in _RAW:                     # raw bits of a NumPy-less type
        if arr.dtype == np.uint16:          # torch has no uint16 views
            arr = arr.view(np.int16)
        return torch.from_numpy(arr).view(_RAW[logical][1])
    return torch.from_numpy(arr)


def load_checkpoint(directory: str, template, step: Optional[int] = None,
                    device=None, shardings=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (a nested dict whose
    leaves have a ``shape``: tensors, arrays, ``ShapeDtype``s) on
    ``device`` (default ``cuda``).  Each leaf keeps the type it was saved
    in; a shape that differs from the template's raises ``ValueError``.

    ``shardings``: optional tree of
    :class:`~repro_torch.parallel.axes.NamedPlacement` (same structure);
    every rank of the mesh reads each leaf and keeps its own part as a
    DTensor, which is how a checkpoint written on one mesh restores onto
    another (or onto one device).  Returns (tree, metadata)."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {entry["key"]: entry for entry in manifest["leaves"]}
    where = dict(tree_leaves(shardings)) if shardings is not None else {}
    leaves = {}
    for key, tmpl in tree_leaves(template):
        leaf = _read_leaf(path, by_key[key])
        if tuple(leaf.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(leaf.shape)} vs template "
                             f"{tuple(tmpl.shape)}")
        leaf = leaf.to(dev)
        leaves[key] = place(leaf, where[key]) if key in where else leaf
    return tree_unflatten(template, leaves), manifest["metadata"]


def reshard_tree(tree, device):
    """A live tree moved to ``device`` (the single-device counterpart of
    the reference's re-``device_put`` onto new shardings)."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), tree)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return gather(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf)


class CheckpointManager:
    """Async saves + retention + emergency save hook.  On a mesh every rank
    makes one and calls its saves (a DTensor leaf is gathered whole, a
    collective); only the ``writer`` writes."""

    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.directory = directory
        self.keep = keep
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree, metadata=None) -> None:
        """Copy ``tree`` to the host now, write it on a background thread;
        a failure surfaces at the next :meth:`wait`."""
        self.wait()
        host_tree = tree_map(_host_copy, tree)
        if not self.writer:
            return

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, metadata)
                self._gc()
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_emergency(self, step: int, tree, metadata=None
                       ) -> Optional[str]:
        """Synchronous, used from preemption signal handlers."""
        self.wait()
        meta = dict(metadata or {})
        meta["emergency"] = True
        host_tree = tree_map(_host_copy, tree)
        if not self.writer:
            return None
        return save_checkpoint(self.directory, step, host_tree, meta)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
