"""ROADMAP C15: the ``model`` axis under the view rule of torch releases
before 2.13.

ATen's matmul and einsum fold an activation's leading dims into one (and
unfold the result's gradient).  Where the sequence is split over the
``model`` axis, torch 2.13's DTensor folds it into a ``_StridedShard``;
2.11's refuses ("Attempted to flatten multiple dimensions, with dimension
1 being sharded").  The port's products go through ``axes.matmul`` and
``axes.einsum``, which never ask for that view; 2.11 has no DTensor rule
for ``flip`` (``cumsum``'s backward), so the SSD's cumulative sums go
through ``axes.cumsum``.  Here 2.11's view rule is put back on the
installed torch (a view that would make a ``_StridedShard`` raises) and
its rule for ``flip`` taken away, and every family's train, prefill and
decode cells (reduced) run on ``meta`` tensors at ``(data 2, model 4)``
of a ``fake`` group of 8, in a subprocess.  (2.11 also gives a slice's
gradient a wrong shape where a DTensor is padded and sliced back: the
causal conv shifts by a negative pad; the dry run on the card's host, in
``chip_smoke.py``'s ``dryrun`` phase, holds that.)
"""
import json

import pytest

from _torch_dist import run_script

FAMILIES = ("qwen2-0.5b", "mamba2-2.7b", "zamba2-2.7b",
            "llama4-scout-17b-a16e", "llama-3.2-vision-11b", "whisper-base")

_CELLS = """
import json, sys
import torch
import torch.distributed.tensor._ops._view_ops as view_ops
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.axes import sharding_context

rule = view_ops.propagate_shape_and_sharding


def refusing(placements, *args, **kwargs):
    got = rule(placements, *args, **kwargs)
    if any(isinstance(p, _StridedShard) for p in got[1]) and not any(
            isinstance(p, _StridedShard) for p in placements):
        raise RuntimeError("a split dim that is not the first is folded")
    return got


view_ops.propagate_shape_and_sharding = refusing
prop = DTensor._op_dispatcher.sharding_propagator      # 2.11 has no flip
for table in (prop.op_strategy_funcs, prop.op_single_dim_strategy_funcs,
              prop.op_to_schema_info_for_single_dim_strategy):
    table.pop(torch.ops.aten.flip.default, None)
dryrun.fake_group(8)
mesh = make_mesh({"data": 2, "model": 4})
out = {}
for arch in sys.argv[1].split(","):
    cfg = get_config(arch, reduced=True)
    for kind in ("train", "prefill", "decode"):
        rows = 128 if cfg.family == "moe" and kind == "decode" else 8
        with sharding_context(mesh) as ctx:
            try:
                got = dryrun.count_cell(cfg, ShapeCell("t", 64, rows, kind),
                                        ctx)
                out[f"{arch} {kind}"] = got["flops"]
            except RuntimeError as e:
                out[f"{arch} {kind}"] = str(e)[:300]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    return json.loads(run_script(_CELLS, [",".join(FAMILIES)],
                                 timeout=300).splitlines()[-1])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_c15_cells_run_without_folding_a_split_dim(cells, arch, kind):
    got = cells[f"{arch} {kind}"]
    assert isinstance(got, int) and got > 0, got
