"""The port's twin of the reference's
``tests/test_sharding.py::test_data_parallel_loss_matches_single_device``:
reduced qwen2, ``ShapeCell("t", 32, 8, "train")``, one step of
``jitted_cell`` on a ``(data 4, model 2)`` mesh of 8 gloo ranks.  Its loss
is held within ``1e-5`` relative of the port's ``(1, 1)`` step and within
``1e-4`` of the reference's own ``(data 4, model 2)`` step, run on 8 XLA
host devices in a subprocess; both packages take the same NumPy inputs
(the reference's parameters in float32, a batch drawn from a seed)."""
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config

from repro_torch.trees import tree_leaves
from _torch_dist import run_ranks, run_reference
from _torch_train import reference_params

B, S = 8, 32
PORT_RTOL, REF_RTOL = 1e-5, 1e-4

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch.mesh import make_mesh
from repro.launch.steps import jitted_cell
from repro.models import LM
from repro.optim import adamw_init
from repro.parallel.axes import sharding_context

data = np.load(sys.argv[1])
cfg = get_config("qwen2-0.5b", reduced=True)
model = LM(cfg)
flat, treedef = jax.tree_util.tree_flatten_with_path(model.abstract_params())
params = jax.tree_util.tree_unflatten(treedef, [
    jnp.asarray(data["p/" + "/".join(k.key for k in path)])
    for path, _ in flat])
batch = {k[2:]: jnp.asarray(v) for k, v in data.items() if k[:2] == "b/"}
losses = []
for shape in ({"data": 1, "model": 1}, {"data": 4, "model": 2}):
    with sharding_context(make_mesh(shape)) as ctx:
        step, _ = jitted_cell(cfg, ShapeCell("t", 32, 8, "train"), ctx)
        _, _, m = step(jax.tree.map(jnp.copy, params), adamw_init(params),
                       dict(batch))
        losses.append(float(m["loss"]))
print("LOSSES", *losses)
"""

_PORT = """
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import jitted_cell, make_train_step
from repro_torch.models import LM
from repro_torch.trees import tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.axes import sharding_context

cfg = get_config("qwen2-0.5b", reduced=True)
model = LM(cfg)
data = np.load(DATA)
params = tree_unflatten(model.abstract_params(), {
    k[2:]: torch.from_numpy(v) for k, v in data.items() if k[:2] == "p/"})
batch = {k[2:]: torch.from_numpy(v) for k, v in data.items()
         if k[:2] == "b/"}
cell = ShapeCell("t", 32, 8, "train")
with sharding_context(make_mesh({"data": 4, "model": 2})) as ctx:
    step, _ = jitted_cell(cfg, cell, ctx)
_, _, m = step(params, adamw_init(params), batch)
if RANK == 0:
    _, _, one = make_train_step(model, AdamWConfig())(
        params, adamw_init(params), batch)
    print("LOSSES", float(one["loss"]), float(m["loss"]))
"""


@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_ref")
    cfg = ref_get_config("qwen2-0.5b", reduced=True)
    rng = np.random.default_rng(0)
    data = {f"p/{k}": np.asarray(v)
            for k, v in tree_leaves(reference_params(cfg))}
    data.update({
        "b/tokens": rng.integers(1, 500, (B, S)).astype(np.int32),
        "b/targets": rng.integers(1, 500, (B, S)).astype(np.int32),
        "b/loss_mask": np.ones((B, S), np.float32),
        "b/positions": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
        "b/segment_ids": np.ones((B, S), np.int32)})
    path = str(tmp / "data.npz")
    np.savez(path, **data)
    ref = run_reference(_REFERENCE, 8, [path], timeout=300)
    port = run_ranks(f"DATA = {path!r}\n" + _PORT, 8, timeout=240)[0]

    def read(out):
        line = [x for x in out.splitlines() if x.startswith("LOSSES")][-1]
        return [float(x) for x in line.split()[1:]]
    return read(ref), read(port)


def test_data_4_model_2_loss_matches_the_port_on_one_device(losses):
    _, (one, mesh) = losses
    np.testing.assert_allclose(mesh, one, rtol=PORT_RTOL)


def test_data_4_model_2_loss_matches_the_reference_on_its_mesh(losses):
    (ref_one, ref_mesh), (_, mesh) = losses
    np.testing.assert_allclose(ref_mesh, ref_one, rtol=2e-2)
    np.testing.assert_allclose(mesh, ref_mesh, rtol=REF_RTOL)
