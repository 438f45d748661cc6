"""Mesh construction over the ranks of the default process group.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the 'pod' axis is the
slow inter-pod dimension — only data parallelism (gradient all-reduce)
crosses it.

The process group is the caller's to start (``torchrun``, a test's
spawner, ``chip_smoke.py``): importing this module starts nothing.
"""
from __future__ import annotations

import math
from typing import Dict

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """``cuda`` where the group runs NCCL, ``cpu`` otherwise (gloo)."""
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: start the ranks "
                           "with torchrun (or init_process_group) first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world_size()
    if have < need:
        raise RuntimeError(
            f"need {need} ranks for mesh {shape}, the process group has "
            f"{have}; start {need} ranks (torchrun --nnodes ... "
            "--nproc-per-node ...) before building it")
    return make_mesh(dict(zip(axes, shape)))


def make_mesh(shape: Dict[str, int]) -> DeviceMesh:
    """A mesh of ``shape`` (axis name -> size, in mesh-dim order) over
    every rank, e.g. ``{'data': 2, 'model': 4}`` on 8 ranks, on the device
    type of the group's backend."""
    need = math.prod(shape.values())
    have = _world_size()
    if have < need:
        raise RuntimeError(f"need {need} devices, have {have}")
    if have > need:
        raise RuntimeError(f"mesh {shape} covers {need} of the group's "
                           f"{have} ranks; a mesh takes every rank")
    return init_device_mesh(_device_type(), tuple(shape.values()),
                            mesh_dim_names=tuple(shape))
