"""The MVE gather and scatter kernels on the card (skipped without one).

``csrc/mdgather.cu`` and ``csrc/mdscatter.cu`` held bit for bit against
their plain versions (``kernels.ref``) on the same card tensors, at 8192
lanes: 1-4 dims with a stride-0 dim, every load shape of the patterns,
colliding stores (the highest lane wins), contiguous runs whose tail runs
past the image or whose negative base wraps, a dimension mask, negative
addresses; fp32, int32, bf16, uint8 and int64; one image and a batch of
1024.  Between them the walks take each of the gather's three routes
(contiguous, walk, tiled) and of the scatter's three (contiguous,
distinct, colliding); a colliding store is the same run to run; and one
call of every gather route and of the scatter's contiguous and distinct
routes issues exactly one device kernel and no memset.

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_mdv_card.py
"""
import pytest
import torch

from benchmarks.torch_kernel_ab import (BATCH, GATHER_WALKS, IMAGE, LANES,
                                        SCATTER_WALKS, device_ops)
from repro_torch.kernels import ref
from repro_torch.kernels.mdgather import mdgather
from repro_torch.kernels.mdscatter import mdscatter_

from _torch_card import bits, card

pytestmark = pytest.mark.card

WALK_IMAGE = 1 << 16
# (dims, strides, base): the access shapes of the patterns at 8192 lanes —
# unit stride (daxpy), row replication (gemm), a transposing CR stride, a
# 3-D and a 4-D walk with a stride-0 dimension each, and a short vector
# (fewer active lanes than the register holds: a zero tail); then two walks
# that leave the image, past its end and before its start (loads clamp,
# stores drop); then the rest of the patterns' load shapes (gemm's column
# replication, intra_pred's, rgb2gray's stride 3) and a contiguous run
# whose tail clamps past the image.  Between them the loads take all three
# routes of mdgather (contiguous, walk, tiled).
WALKS = [
    ((8192,), (1,), 0),
    ((64, 128), (0, 16), 5),
    ((512, 16), (49, 1), 0),
    ((16, 8, 64), (1, 0, 16), 3),
    ((8, 4, 16, 16), (1, 8, 0, 32), 7),
    ((100, 3), (1, 100), 11),
    ((8192,), (9,), 100),
    ((64, 128), (-3, 1), 50),
    ((64, 128), (1, 0), 0),
    ((3, 3, 256), (1, 0, 3), 0),
    ((8192,), (3,), 0),
    ((8192,), (1,), WALK_IMAGE - 2536),
]
# store walks add collisions: a stride-0 dimension makes whole rows collide
# (the highest lane must win), and a partial overlap (2x + 3y); then a
# contiguous run whose negative base wraps to +N (the run whose tail
# leaves the image is in WALKS).  Between them they take all three routes
# of mdscatter_ (contiguous, distinct, colliding).
STORE_WALKS = WALKS + [((3, 2), (1, 0), 2), ((64, 128), (2, 3), 0),
                       ((8192,), (1,), 100 - WALK_IMAGE)]
DTYPES = [torch.float32, torch.int32, torch.bfloat16, torch.uint8,
          torch.int64]
BATCHES = [1, BATCH]


def random_tensor(shape, dtype, gen) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    hi = 255 if dtype == torch.uint8 else 1 << 20
    return torch.randint(0, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(dtype)


def _operands(batch, dtype, seed, n=WALK_IMAGE):
    """An image (or a batch of them), store values and a lane mask."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n,) if batch == 1 else (batch, n)
    src = random_tensor(shape, dtype, gen)
    vals = random_tensor(shape[:-1] + (LANES,), dtype, gen)
    mask = torch.rand(LANES, generator=gen, device="cuda") < 0.7
    return src, vals, mask


def _walk_id(walk):
    return "{}/{}/{}".format(*walk)


@pytest.mark.parametrize("walk", WALKS, ids=[_walk_id(w) for w in WALKS])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_mdgather_is_the_plain_version(card, batch, dtype, walk):
    src, _, _ = _operands(batch, dtype, seed=0)
    got = mdgather(src, *walk, lanes=LANES)
    want = ref.mdgather_ref(src, *walk, LANES)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("walk", STORE_WALKS,
                         ids=[_walk_id(w) for w in STORE_WALKS])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_mdscatter_is_the_plain_version(card, batch, dtype, walk, masked):
    dst, vals, mask = _operands(batch, dtype, seed=0)
    mask = mask if masked else None
    got = mdscatter_(dst.clone(), vals, *walk, mask)
    want = ref.mdscatter_ref(dst, vals, *walk, mask)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))


def test_the_walks_take_every_route(card):
    """Every route of ``mdgather`` and of ``mdscatter_`` runs at least once
    over the walks above, each dtype, one image and a batch."""
    gather, scatter = dict(mdgather.routes), dict(mdscatter_.routes)
    for batch in BATCHES:
        for dtype in DTYPES:
            src, vals, mask = _operands(batch, dtype, seed=0)
            for walk in WALKS:
                mdgather(src, *walk, lanes=LANES)
            for walk in STORE_WALKS:
                for m in (None, mask):
                    mdscatter_(src.clone(), vals, *walk, m)
    torch.cuda.synchronize()
    gather = {r: mdgather.routes[r] - gather[r] for r in gather}
    scatter = {r: mdscatter_.routes[r] - scatter[r] for r in scatter}
    assert all(gather.values()), gather
    assert all(scatter.values()), scatter


def test_the_colliding_store_is_the_same_run_to_run(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dst = torch.zeros(BATCH, 4096, device="cuda")
    vals = random_tensor((BATCH, LANES), torch.float32, gen)
    first = mdscatter_(dst.clone(), vals, (64, 128), (1, 0), 0)
    for _ in range(5):
        assert torch.equal(first, mdscatter_(dst.clone(), vals, (64, 128),
                                             (1, 0), 0))


@pytest.mark.parametrize("tag", GATHER_WALKS)
@pytest.mark.parametrize("batch", BATCHES)
def test_a_gather_is_one_kernel_and_no_memset(card, batch, tag):
    route, walk = GATHER_WALKS[tag]
    src, _, _ = _operands(batch, torch.float32, seed=8, n=IMAGE)
    mdgather(src, *walk, lanes=LANES)
    before = mdgather.routes[route]
    ops, calls = device_ops(lambda: mdgather(src, *walk, lanes=LANES))
    assert mdgather.routes[route] == before + calls, f"not the {route} route"
    assert sum(ops.values()) == 1, ops
    assert not any("emset" in k or "mdgather" not in k for k in ops), ops


@pytest.mark.parametrize("route", SCATTER_WALKS)
@pytest.mark.parametrize("batch", BATCHES)
def test_a_scatter_takes_its_route_in_one_kernel(card, batch, route):
    """The contiguous and the distinct route are one device kernel and
    nothing else (no memset); the colliding route's own operations are not
    held.  Each walk is called once before: its first call uploads the
    walk's lane order (the distinct and colliding routes' thread order),
    once per walk and device."""
    walk = SCATTER_WALKS[route]
    dst, vals, mask = _operands(batch, torch.float32, seed=7, n=IMAGE)
    mdscatter_(dst, vals, *walk, mask)
    before = mdscatter_.routes[route]
    ops, calls = device_ops(lambda: mdscatter_(dst, vals, *walk, mask))
    assert mdscatter_.routes[route] == before + calls, f"not the {route} route"
    if route != "colliding":
        assert sum(ops.values()) == 1, ops
        assert not any("emset" in k or "mdscatter" not in k for k in ops), ops
