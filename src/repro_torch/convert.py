"""Carrying programs, geometry, machine state, model configs, model
parameters and optimizer states across from the reference package, so a test can hand both
packages the same inputs and compare what comes out.

Nothing here imports the reference: its objects are read by attribute name
(duck-typed), and arrays cross as NumPy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .configs.base import ModelConfig
from .core import isa
from .core.interp import MachineState
from .core.machine import (ControlState, MVEConfig, as_memory,
                           resolve_device, to_numpy)

_INSTR_FIELDS = tuple(f.name for f in dataclasses.fields(isa.Instr))
_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(MVEConfig))
_MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(ModelConfig))
# element types NumPy has no name of its own for (``ml_dtypes``): they cross
# as float32, which holds every value exactly, and are cast back
_VIA_FLOAT32 = {"bfloat16": torch.bfloat16, "float8_e4m3fn":
                torch.float8_e4m3fn}


def program_from_reference(instrs: Iterable) -> isa.Program:
    """This package's :class:`~repro_torch.core.isa.Program` for a sequence
    of the reference's instructions.  ``op`` and ``dtype`` are enums there
    too; they are matched by member name."""
    out = []
    for ins in instrs:
        kw = {name: getattr(ins, name) for name in _INSTR_FIELDS}
        kw["op"] = isa.Op[ins.op.name]
        kw["dtype"] = None if ins.dtype is None else isa.DType[ins.dtype.name]
        out.append(isa.Instr(**kw))
    return isa.Program(out)


def config_from_reference(cfg) -> MVEConfig:
    """This package's :class:`~repro_torch.core.machine.MVEConfig` with the
    reference config's geometry and scheme."""
    return MVEConfig(**{name: getattr(cfg, name) for name in _CONFIG_FIELDS})


def state_from_numpy(memory: np.ndarray,
                     regs: Optional[Dict[int, np.ndarray]] = None,
                     tag: Optional[np.ndarray] = None,
                     device=None) -> MachineState:
    """A machine state on ``device`` from host arrays (memory narrows to
    its canonical 32-bit element type; registers keep theirs; a missing Tag
    is the power-on latch, all ones)."""
    dev = resolve_device(device)
    if tag is None:
        tag = np.ones(MVEConfig().lanes, dtype=bool)
    return MachineState(
        memory=as_memory(memory, dev),
        regs={r: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for r, v in (regs or {}).items()},
        tag=torch.from_numpy(np.asarray(tag, dtype=bool)).to(dev),
        ctrl=ControlState(), trace=[])


def state_to_numpy(state) -> Dict[str, object]:
    """``{"memory", "regs", "tag"}`` of a machine state (or an engine
    ``ExecutionResult``) as host NumPy arrays."""
    return {"memory": to_numpy(state.memory),
            "regs": {r: to_numpy(v) for r, v in state.regs.items()},
            "tag": to_numpy(state.tag)}


def model_config_from_reference(cfg) -> ModelConfig:
    """This package's :class:`~repro_torch.configs.base.ModelConfig` with
    every field of the reference config but ``use_pallas``: the port has no
    such switch, and prefill attention takes the flash kernel wherever the
    reference's ``use_pallas=True`` route would (no segment ids, head dim
    64 or 128)."""
    return ModelConfig(**{name: getattr(cfg, name) for name in _MODEL_FIELDS})


def tensor_from_reference(array, device=None) -> torch.Tensor:
    """One array of the reference (a JAX or NumPy array) as a tensor of the
    same element type on ``device``; bfloat16 and float8 cross as float32
    (exact) and are cast back."""
    host = np.asarray(array)
    via = _VIA_FLOAT32.get(host.dtype.name)
    # np.array copies: the host view of a JAX array is read-only
    host = np.array(host, dtype=np.float32 if via is not None else None)
    t = torch.from_numpy(host).to(resolve_device(device))
    return t if via is None else t.to(via)


def params_from_reference(tree, device=None):
    """The reference's parameter tree (nested dicts of arrays, e.g. from
    ``LM.init_params``) as this package's tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return tensor_from_reference(tree, device)


def opt_state_from_reference(state, device=None):
    """The reference's AdamW state (``{"m", "v", "step"}``; fp32 moments,
    or int8 ``{"q", "s"}`` moment leaves) as this package's on ``device``,
    so that both packages take the same step from the same state."""
    return {"m": params_from_reference(state["m"], device),
            "v": params_from_reference(state["v"], device),
            "step": tensor_from_reference(state["step"], device)}
