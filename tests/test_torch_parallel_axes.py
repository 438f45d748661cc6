"""``repro_torch.parallel.axes`` vs ``repro.parallel.axes``: ``spec_for`` on
every case of ``tests/test_sharding.py`` and on 500 seeded random cases
(``FakeMesh``, in process), and the part of a tensor each rank of a
(pod 2, data 2, model 2) mesh holds under ``placements_for`` against JAX's
``NamedSharding(mesh, spec).devices_indices_map`` at the same mesh position
(the reference on 8 XLA host devices, the port on the ``fake`` process
group, each in a subprocess)."""
import json
import threading

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.parallel import axes as ref_axes

from repro_torch.parallel import axes
from _torch_dist import run_reference, run_script


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESH = {"data": 16, "model": 16}
POD_MESH = {"pod": 2, "data": 16, "model": 16}
SMALL_MESH = {"pod": 2, "data": 2, "model": 2}

# every case of tests/test_sharding.py::test_spec_for_*
SHARDING_CASES = [
    (MESH, ("embed", "heads"), (8192, 8192)),
    (MESH, ("embed", "heads"), (896, 14 * 9)),
    (MESH, ("act_heads", "seq"), (64, 4096)),
    (MESH, ("act_heads", "seq"), (56, 4096)),
    (MESH, ("batch", None), (256, 128)),
    (POD_MESH, ("batch", None), (256, 128)),
]
NAMES = ["embed", "heads", "mlp", "vocab", "batch", "seq", None, "kv",
         "act_heads", "expert", "kv_seq", "act_vocab", "ssm_inner"]
SIZES = [1, 2, 8, 14, 16, 32, 56, 256, 4096]
N_RANDOM, CHUNKS = 500, 10


def random_cases(n=N_RANDOM, seed=0):
    """Seeded (mesh, names, sizes) draws, the property test's strategies
    widened (hypothesis is not installed here)."""
    rng = np.random.default_rng(seed)
    meshes = (MESH, POD_MESH, SMALL_MESH)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        out.append((meshes[int(rng.integers(3))],
                    tuple(NAMES[int(i)] for i in rng.integers(len(NAMES),
                                                               size=k)),
                    tuple(SIZES[int(i)] for i in rng.integers(len(SIZES),
                                                               size=k))))
    return out


def _ref_spec(mesh, names, sizes):
    return tuple(ref_axes.spec_for(names, sizes, FakeMesh(mesh),
                                   ref_axes.DEFAULT_RULES))


def _port_spec(mesh, names, sizes):
    return axes.spec_for(names, sizes, FakeMesh(mesh), axes.DEFAULT_RULES)


@pytest.mark.parametrize("case", range(len(SHARDING_CASES)))
def test_spec_for_matches_the_reference_on_the_sharding_cases(case):
    mesh, names, sizes = SHARDING_CASES[case]
    assert _port_spec(mesh, names, sizes) == _ref_spec(mesh, names, sizes)


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_spec_for_matches_the_reference_on_random_cases(chunk):
    cases = random_cases()
    size = N_RANDOM // CHUNKS
    for mesh, names, sizes in cases[chunk * size:(chunk + 1) * size]:
        got = _port_spec(mesh, names, sizes)
        assert got == _ref_spec(mesh, names, sizes), (mesh, names, sizes)
        used = []           # the property test's invariants
        for part, size in zip(got, sizes):
            if part is None:
                continue
            parts = (part,) if isinstance(part, str) else part
            assert not set(parts) & set(used)
            used += parts
            assert size % int(np.prod([mesh[a] for a in parts])) == 0


def test_sharding_context_is_per_thread_and_nests():
    mesh = FakeMesh(MESH)
    seen = []
    with axes.sharding_context(mesh) as ctx:
        assert axes.current_ctx() is ctx and ctx.rules == axes.DEFAULT_RULES
        with axes.sharding_context(mesh, {"embed": ("model",)}) as inner:
            assert axes.current_ctx() is inner
        assert axes.current_ctx() is ctx
        t = threading.Thread(target=lambda: seen.append(axes.current_ctx()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [None] and axes.current_ctx() is None


_CONSTRAIN_PLACES = """
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import axes
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_mesh({"data": 2, "model": 2})
x = torch.ones(4, 8)
with axes.sharding_context(mesh):
    y = axes.constrain(x, "batch", "mlp")
    assert isinstance(y, DTensor) and y.device_mesh.mesh_dim_names == (
        "model",) and y.placements == (Shard(1),) and y.shape == (4, 8)
    assert y.to_local().shape == (4, 4)
    z = axes.constrain(y, "batch", None)        # gathered back
    assert z.placements == (Replicate(),) and z.to_local().shape == (4, 8)
    w = axes.constrain(torch.ones(4, 7), "batch", "mlp")    # 7 stays whole
    assert w.placements == (Replicate(),)
dist.destroy_process_group()
print("OK")
"""


@pytest.mark.parametrize("case", ["outside", "placed"])
def test_constrain_is_a_no_op_without_a_model_axis(case):
    """Outside a context, and on a mesh without a ``model`` axis, the
    tensor itself; on a ``(data 2, model 2)`` mesh (the ``fake`` group) a
    DTensor on the ``model`` sub-mesh placed by the spec's ``model``
    entry."""
    x = torch.ones(4, 8)
    if case == "outside":
        assert axes.constrain(x, "batch", "embed") is x
        with axes.sharding_context(FakeMesh({"data": 4})):
            assert axes.constrain(x, "batch", "mlp") is x
    else:
        assert run_script(_CONSTRAIN_PLACES, timeout=120).strip() == "OK"


def test_placements_for_splits_a_dim_major_to_minor():
    mesh = FakeMesh(SMALL_MESH)
    assert axes.placements_for((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert axes.placements_for((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        axes.placements_for((("data", "pod"),), mesh)
    # one rank's part: pod splits first, then data
    bounds = axes.shard_bounds((8, 6), (2, 2, 2),
                               (Shard(0), Shard(0), Shard(1)), (1, 0, 1))
    assert bounds == ((4, 6), (3, 6))


def test_batch_sum_outside_a_reduction_is_the_identity():
    x = torch.arange(3.0)
    assert axes.batch_sum(x) is x and axes.batch_mean(x) is x


def test_batch_reduction_holds_on_every_thread():
    """Autograd runs a CUDA graph's backward, and so the recompute of a
    checkpointed layer, on a thread of its own: the reduction in force is
    the process's, not the calling thread's."""
    got = {}
    with axes.batch_reduction((), 2):    # no groups: this rank's term, / 2
        worker = threading.Thread(target=lambda: got.update(
            mean=axes.batch_mean(torch.tensor(4.0))))
        worker.start()
        worker.join()
    assert float(got["mean"]) == 2.0
    assert axes._BATCH is None


_PORT_SIDE = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor._utils import \\
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import axes

cases = json.load(open(sys.argv[1]))
out = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    mesh = make_mesh({"pod": 2, "data": 2, "model": 2})
    coord = mesh.get_coordinate()
    row = []
    for spec, shape in cases:
        spec = tuple(tuple(p) if isinstance(p, list) else p for p in spec)
        pl = axes.placements_for(spec, mesh)
        bounds = axes.shard_bounds(shape, mesh.shape, pl, coord)
        lshape, offset = compute_local_shape_and_global_offset(
            shape, mesh, pl)
        assert tuple(lshape) == tuple(hi - lo for lo, hi in bounds)
        assert tuple(offset) == tuple(lo for lo, _ in bounds)
        if 0 < torch.Size(shape).numel() <= 4096:
            full = torch.arange(torch.Size(shape).numel()).reshape(shape)
            dt = distribute_tensor(full, mesh, pl, src_data_rank=None)
            assert torch.equal(dt.to_local(),
                               axes.local_shard(full, mesh, pl))
        row.append(bounds)
    out.append({"coord": list(coord), "bounds": row})
    dist.destroy_process_group()
json.dump(out, open(sys.argv[2], "w"))
"""

_REF_SIDE = """
import json, sys
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh

cases = json.load(open(sys.argv[1]))
mesh = make_mesh({"pod": 2, "data": 2, "model": 2})
out = []
for pos, dev in enumerate(mesh.devices.flat):
    row = []
    for spec, shape in cases:
        spec = tuple(tuple(p) if isinstance(p, list) else p for p in spec)
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(
            tuple(shape))[dev]
        row.append([[s.start or 0, n if s.stop is None else s.stop]
                    for s, n in zip(idx, shape)])
    out.append({"coord": [int(c) for c in np.unravel_index(pos, (2, 2, 2))],
                "bounds": row})
json.dump(out, open(sys.argv[2], "w"))
"""


def test_each_ranks_part_matches_jax_devices_indices_map(tmp_path):
    """Every random spec (resolved on its own mesh and on the 8-rank mesh's
    sizes) on a (pod 2, data 2, model 2) mesh: the port's part at each
    mesh position == JAX's, and == DTensor's own arithmetic."""
    cases = []
    for mesh, names, sizes in random_cases():
        for m in (mesh, SMALL_MESH):
            cases.append([list(_port_spec(m, names, sizes)), list(sizes)])
    path = tmp_path / "cases.json"
    path.write_text(json.dumps(cases))
    run_script(_PORT_SIDE, (path, tmp_path / "port.json"))
    run_reference(_REF_SIDE, 8, (path, tmp_path / "ref.json"), timeout=120)
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    by_coord = {tuple(r["coord"]): r["bounds"] for r in want}
    assert len(got) == len(want) == 8
    for r in got:
        assert [[list(b) for b in row] for row in r["bounds"]] == \
            by_coord[tuple(r["coord"])], r["coord"]
