"""Which cells of the PyTorch port run on a ``model`` mesh axis of more
than one rank under the installed torch: every architecture's reduced
train, prefill and decode cells, on ``meta`` tensors, as rank 0 of a
``fake`` process group, at ``(data 2, model 4)`` and ``(data 1, model 4)``
(``repro_torch.launch.dryrun.count_cell``).  Host work: no card, no data
moved.  Prints one JSON object (each cell's flops on rank 0, or its error
and the port's frames where it failed) and exits 1 if a cell failed.

    PYTHONPATH=src python benchmarks/torch_model_axis_cells.py
"""
from __future__ import annotations

import json
import sys
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.axes import sharding_context

MESHES = ({"data": 2, "model": 4}, {"data": 1, "model": 4})
SEQ, ROWS, MOE_DECODE_ROWS = 64, 8, 128   # a MoE decode needs whole groups


def run_cells() -> dict:
    out = {"torch": torch.__version__, "cells": {}, "failed": {}}
    for shape in MESHES:
        dryrun.fake_group(shape["data"] * shape["model"])
        mesh = make_mesh(shape)
        for arch in ARCH_IDS:
            cfg = get_config(arch, reduced=True)
            for kind in ("train", "prefill", "decode"):
                rows = (MOE_DECODE_ROWS if cfg.family == "moe"
                        and kind == "decode" else ROWS)
                name = f"{arch} {kind} data {shape['data']} model " \
                       f"{shape['model']}"
                with sharding_context(mesh) as ctx:
                    try:
                        out["cells"][name] = dryrun.count_cell(
                            cfg, ShapeCell("t", SEQ, rows, kind),
                            ctx)["flops"]
                    except Exception as e:       # reported, not raised
                        out["failed"][name] = {
                            "error": f"{type(e).__name__}: {str(e)[:400]}",
                            "frames": [f"{f.filename.split('/src/')[-1]}:"
                                       f"{f.lineno} {f.name}" for f in
                                       traceback.extract_tb(e.__traceback__)
                                       if "repro_torch" in f.filename][-6:]}
    return out


def main() -> int:
    out = run_cells()
    print(json.dumps(out))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
