"""Carrying programs, geometry and machine state across from the reference
package, so a test can hand both packages the same inputs and compare what
comes out.

Nothing here imports the reference: its objects are read by attribute name
(duck-typed), and arrays cross as NumPy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .core import isa
from .core.interp import MachineState
from .core.machine import (ControlState, MVEConfig, as_memory,
                           resolve_device, to_numpy)

_INSTR_FIELDS = tuple(f.name for f in dataclasses.fields(isa.Instr))
_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(MVEConfig))


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
