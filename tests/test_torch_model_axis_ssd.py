"""ROADMAP C14: the SSD's training step on a ``model`` axis at the SSM
families' published widths.

On a ``model`` axis the causal conv leaves ``x``, ``b``, ``c`` split along
the batch and ``dt`` along the sequence; DTensor's einsum over the mixed
placements viewed a redistributed local tensor whose strides did not fit
(``RuntimeError: view size is not compatible``), first seen by the dry run
of mamba2-2.7b's and zamba2-2.7b's ``train_4k`` on the 16 x 16 mesh.
``ssd_chunked`` now places ``dt``, ``b``, ``c`` as ``x``.

* mamba2-2.7b and zamba2-2.7b (one unit of layers, published widths,
  2 x 512 tokens) counted on ``meta`` at ``(data 1, model 2)``: the step
  runs.
* mamba2-2.7b (one layer, published widths, a 1024-token vocabulary,
  float32) at ``(data 1, model 2)`` on 2 gloo ranks against one device:
  loss and grad norm within ``LOSS_RTOL``, every parameter after the step
  within ``PARAM_TOL`` (a float32 sum-order tolerance, ROADMAP trap 10).

Each process group runs in subprocesses under a timeout.
"""
import json

import pytest

from _torch_dist import run_ranks, run_script

LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5

_META = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.axes import sharding_context

dryrun.fake_group(2)
mesh = make_mesh({"data": 1, "model": 2})
cfg = get_config(sys.argv[1])
cfg = dataclasses.replace(cfg, **dryrun.layer_plan(cfg)[0])
with sharding_context(mesh) as ctx:
    got = dryrun.count_cell(cfg, ShapeCell("t", 512, 2, "train"), ctx)
print(json.dumps(got))
"""


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_c14_full_width_ssm_train_cell_runs_on_a_model_axis(arch):
    got = json.loads(run_script(_META, [arch], timeout=180).splitlines()[-1])
    assert got["flops"] > 0 and got["collectives"]["total"] > 0


_RANKS = """
import dataclasses, json
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import jitted_cell, make_train_step
from repro_torch.launch.steps import state_shardings
from repro_torch.models import LM
from repro_torch.trees import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.axes import gather, place, sharding_context

cfg = dataclasses.replace(get_config("mamba2-2.7b"), num_layers=1,
                          vocab_size=1024)
cell = ShapeCell("t", 512, 2, "train")
model = LM(cfg)
params = tree_map(lambda p: p.float(), model.init_params(
    torch.Generator().manual_seed(0), device="cpu"))
gen = torch.Generator().manual_seed(1)
tokens = torch.randint(0, cfg.vocab_size, (2, 513), generator=gen,
                       dtype=torch.int32)
batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
         "loss_mask": torch.ones(2, 512),
         "positions": torch.arange(512, dtype=torch.int32).repeat(2, 1),
         "segment_ids": torch.ones(2, 512, dtype=torch.int32)}
opt = AdamWConfig()
mesh = make_mesh({"data": 1, "model": 2})
with sharding_context(mesh) as ctx:
    step, _ = jitted_cell(cfg, cell, ctx, opt_cfg=opt)
    shard = state_shardings(model, opt, ctx)
new_p, _, m = step(tree_map(place, params, shard["params"]),
                   tree_map(place, adamw_init(params), shard["opt"]), batch)
one_p, _, one_m = make_train_step(model, opt)(params, adamw_init(params),
                                              batch)
one = dict(tree_leaves(one_p))
worst = max(float((gather(x) - one[k]).abs().max())     # every rank gathers
            for k, x in tree_leaves(new_p))
print(json.dumps({"metrics": {k: [float(m[k]), float(one_m[k])]
                              for k in ("loss", "grad_norm")},
                  "params": worst}))
"""


def test_c14_mamba2_train_step_on_a_model_axis_matches_one_device():
    got = json.loads(run_ranks(_RANKS, 2, timeout=300)[0].splitlines()[-1])
    for name, (mesh, one) in got["metrics"].items():
        assert abs(mesh - one) <= LOSS_RTOL * abs(one), (name, mesh, one)
    assert got["params"] <= PARAM_TOL
