"""The MVE configuration's frozen programs and memory images.

``configs/<mve config>.json`` holds each pattern's program as data and its
image layout (operands: base, shape, type, and how the benchmark fills
them).  Programs are rebuilt with the port's ``isa`` API; images are drawn
on the device from the seed, in one call per operand and batch, with no
builder call per image.
"""
from __future__ import annotations

from typing import List

import torch


def program(pattern: dict):
    """The pattern's instruction list as an ``isa.Program``."""
    from repro_torch.core import isa
    instrs = []
    for ins in pattern["program"]:
        fields = dict(ins)
        fields["op"] = isa.Op(fields["op"])
        if "dtype" in fields:
            fields["dtype"] = isa.DType[fields["dtype"]]
        if "modes" in fields:
            fields["modes"] = tuple(fields["modes"])
        instrs.append(isa.Instr(**fields))
    return isa.Program(instrs)


def machine(config: dict):
    from repro_torch.core.machine import MVEConfig
    return MVEConfig(**config["machine"])


def operand_size(op: dict) -> int:
    size = 1
    for n in op["shape"]:
        size *= n
    return size


def images(pattern: dict, batch: int, generator: torch.Generator,
           device) -> torch.Tensor:
    """A ``(batch, N)`` float32 batch of the pattern's memory images:
    float operands standard normal, integer operands uniform in
    ``[0, 255)``, pointer tables as frozen, outputs and scratch zero."""
    out = torch.zeros(batch, pattern["memory_elements"], dtype=torch.float32,
                      device=device)
    for op in pattern["operands"]:
        lo, size = op["base"], operand_size(op)
        region = out[:, lo:lo + size]
        fill = op["fill"]
        if fill == "normal":
            region.copy_(torch.randn(batch, size, generator=generator,
                                     device=device, dtype=torch.float32))
        elif fill == "uint8":
            region.copy_(torch.randint(0, 255, (batch, size),
                                       generator=generator, device=device,
                                       dtype=torch.int32))
        elif fill == "fixed":
            region.copy_(torch.tensor(op["values"], dtype=torch.float32,
                                      device=device).expand(batch, size))
        elif fill != "zero":
            raise ValueError(f"unknown fill {fill!r} of {op['name']}")
    return out


def pattern_names(config: dict) -> List[str]:
    return sorted(config["patterns"])
