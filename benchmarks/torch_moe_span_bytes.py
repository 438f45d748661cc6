"""What the MoE route whose groups span ranks adds to a dry-run cell's
collective bytes.  Each MoE architecture's ``decode_32k`` cell (128 rows
on the 16 x 16 production mesh: 8 tokens a ``data`` rank, one group of
128 over all 16) runs at one layer as rank 0 of a ``fake`` group of 256
on ``meta`` tensors (``repro_torch.launch.dryrun.count_cell``), once as
it is and once with the rank's gather of its groups' tokens
(``models.moe.gather_batch_rows``) replaced by a stand-in that makes the
same tensor on the rank and moves nothing.  The difference of the
collective bytes the dry run's counter sees, kind by kind, is what the
gather adds per device per layer; the prediction is the group's tokens x
``d_model`` x 2 bytes of all-gather result.  Host work: no card, no data
moved.  Prints one JSON object and exits 1 where a difference is not the
prediction.

    PYTHONPATH=src python benchmarks/torch_moe_span_bytes.py [--arch A]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe
from repro_torch.parallel.axes import batch_rank, sharding_context

ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
SHAPE = "decode_32k"
DATA_RANKS = 16


def _in_place(x):
    """The gathered tensor's shape and placements, made on the rank: its
    own rows repeated once for every batch rank."""
    n = batch_rank()[1]
    if isinstance(x, DTensor):
        return DTensor.from_local(x.to_local().repeat(n, 1), x.device_mesh,
                                  x.placements, run_check=False)
    return x.repeat(n, 1)


def added_bytes(arch: str) -> dict:
    """The collective bytes per kind that the gather adds to one layer of
    ``arch``'s ``decode_32k`` step, and the prediction."""
    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    cell = SHAPES[SHAPE]
    dryrun.fake_group(256)
    counts = {}
    gather = moe.gather_batch_rows
    for name, fn in (("gathered", gather), ("in_place", _in_place)):
        moe.gather_batch_rows = fn
        try:
            with sharding_context(make_production_mesh()) as ctx:
                counts[name] = dryrun.count_cell(cfg, cell, ctx)[
                    "collectives"]
        finally:
            moe.gather_batch_rows = gather
    group = min(cfg.moe_group_size, cell.global_batch)
    return {"group_tokens": group,
            "tokens_a_rank": cell.global_batch // DATA_RANKS,
            "added": {k: counts["gathered"][k] - counts["in_place"][k]
                      for k in counts["gathered"]},
            "predicted_all_gather": group * cfg.d_model * 2,
            "collectives_one_layer": counts["gathered"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, action="append")
    archs = ap.parse_args().arch or ARCHS
    try:
        out = {arch: added_bytes(arch) for arch in archs}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out))
    return 0 if all(
        r["added"]["all-gather"] == r["predicted_all_gather"]
        and r["added"]["total"] == r["predicted_all_gather"]
        for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
