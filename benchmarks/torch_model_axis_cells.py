"""Which cells of the PyTorch port run on a ``model`` mesh axis of more
than one rank under the installed torch: every architecture's reduced
train, prefill and decode cells, on ``meta`` tensors, as rank 0 of a
``fake`` process group, at ``(data 2, model 4)`` and ``(data 1, model 4)``
(``repro_torch.launch.dryrun.count_cell``), and at ``(data 2, model 4)``
a MoE decode whose rows fill no group: its one group of 8 tokens spans
the two data ranks.  Host work: no card, no data
moved.  Prints one JSON object (each cell's flops on rank 0, or its error
and the port's frames where it failed) and exits 1 if a cell failed.

    PYTHONPATH=src python benchmarks/torch_model_axis_cells.py [--mesh 2x4]

``--mesh DxM`` (repeatable) runs the cells of those meshes alone, so that
the meshes can run in processes side by side.
"""
from __future__ import annotations

import argparse
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
# a MoE decode of 128 rows: each data rank's 64 tokens are a whole group
SEQ, ROWS, MOE_DECODE_ROWS = 64, 8, 128
# (arch, mesh): a MoE decode of ROWS rows, 4 tokens a data rank
SPANNING = ("llama4-scout-17b-a16e", {"data": 2, "model": 4})


def _count(out: dict, name: str, cfg, cell, mesh) -> None:
    """``cell``'s flops on rank 0 into ``out["cells"]``, or its error and
    the port's frames into ``out["failed"]``."""
    with sharding_context(mesh) as ctx:
        try:
            out["cells"][name] = dryrun.count_cell(cfg, cell, ctx)["flops"]
        except Exception as e:                   # reported, not raised
            out["failed"][name] = {
                "error": f"{type(e).__name__}: {str(e)[:400]}",
                "frames": [f"{f.filename.split('/src/')[-1]}:"
                           f"{f.lineno} {f.name}" for f in
                           traceback.extract_tb(e.__traceback__)
                           if "repro_torch" in f.filename][-6:]}


def run_cells(meshes=MESHES) -> dict:
    out = {"torch": torch.__version__, "cells": {}, "failed": {}}
    for shape in meshes:
        dryrun.fake_group(shape["data"] * shape["model"])
        mesh = make_mesh(shape)
        where = f"data {shape['data']} model {shape['model']}"
        for arch in ARCH_IDS:
            cfg = get_config(arch, reduced=True)
            for kind in ("train", "prefill", "decode"):
                rows = (MOE_DECODE_ROWS if cfg.family == "moe"
                        and kind == "decode" else ROWS)
                _count(out, f"{arch} {kind} {where}", cfg,
                       ShapeCell("t", SEQ, rows, kind), mesh)
        arch, at = SPANNING
        if shape == at:
            _count(out, f"{arch} decode spanning {where}",
                   get_config(arch, reduced=True),
                   ShapeCell("t", SEQ, ROWS, "decode"), mesh)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", action="append", choices=[
        f"{m['data']}x{m['model']}" for m in MESHES])
    picked = ap.parse_args().mesh
    out = run_cells([m for m in MESHES if picked is None
                     or f"{m['data']}x{m['model']}" in picked])
    print(json.dumps(out))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
