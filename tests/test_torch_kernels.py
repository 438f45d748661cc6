"""``repro_torch.kernels``: plain PyTorch versions of ``mdgather`` /
``mdscatter`` vs the reference's oracles (``repro.kernels.ref``) and vs the
Pallas TPU kernels in interpret mode, bit for bit.

These run on the CPU, where the wrappers take the plain versions (a CUDA
kernel has no interpret mode); the CUDA kernels themselves are held against
the same plain versions on the card by ``tests/test_torch_mdv_card.py`` and
``tests/test_torch_gemm_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mdgather import mdgather as pallas_gather
from repro.kernels.mdscatter import mdscatter as pallas_scatter

from repro_torch.kernels import ops, ref
from repro_torch.kernels.mdgather import mdgather
from repro_torch.kernels.mdscatter import mdscatter, mdscatter_

from _torch_parity import assert_bits_equal

_NP = {"float32": np.float32, "int32": np.int32}
_JNP = {"float32": jnp.float32, "int32": jnp.int32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}


def _bits(x):
    """Host array of a tensor / JAX array; bfloat16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if x.dtype == jnp.bfloat16:
        return np.asarray(x).view(np.uint16)
    return np.asarray(x)


def _cases(n=12, seed=0):
    """Seeded sweep: 1-4 dims of length 1..6, strides from {0,1,2,3,7}."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ndim = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 7, ndim))
        strides = tuple(int(s) for s in rng.choice([0, 1, 2, 3, 7], ndim))
        out.append((dims, strides, int(rng.integers(0, 9))))
    return out


def _source(dims, strides, base, dtype, seed):
    span = base + sum((ln - 1) * s for ln, s in zip(dims, strides)) + 1
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        host = rng.standard_normal(span + 8).astype(np.float32)
    else:
        host = rng.integers(-1000, 1000, span + 8).astype(np.int32)
    return (torch.from_numpy(host).to(_TORCH[dtype]),
            jnp.asarray(host).astype(_JNP[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("case", _cases(), ids=str)
def test_mdgather_matches_reference_and_pallas(case, dtype):
    dims, strides, base = case
    src_t, src_j = _source(dims, strides, base, dtype, seed=1)
    got = _bits(ops.mdv_gather(src_t, dims, strides, base))
    assert_bits_equal(_bits(jref.mdgather_ref(src_j, dims, strides, base)),
                      got, "vs ref.py")
    assert_bits_equal(_bits(pallas_gather(src_j, dims, strides, base)),
                      got, "vs Pallas interpret")


# row-major continuations and a contiguous run: the stores the patterns
# issue (the CUDA wrapper's "contiguous" route)
CONTIGUOUS_STORES = [((100,), (1,), 3), ((16, 8), (1, 16), 2),
                     ((4, 4, 4), (1, 4, 16), 0), ((8, 8), (1, 8), 5)]


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("case", _cases(seed=2) + CONTIGUOUS_STORES, ids=str)
def test_mdscatter_matches_reference_and_pallas(case, dtype):
    dims, strides, base = case
    dst_t, dst_j = _source(dims, strides, base, dtype, seed=3)
    total = int(np.prod(dims))
    vals_t, vals_j = _source((total,), (1,), 0, dtype, seed=4)
    vals_t, vals_j = vals_t[:total], vals_j[:total]
    got = _bits(ops.mdv_scatter(dst_t, vals_t, dims, strides, base))
    assert_bits_equal(
        _bits(jref.mdscatter_ref(dst_j, vals_j, dims, strides, base)), got,
        "vs ref.py")
    assert_bits_equal(
        _bits(pallas_scatter(dst_j, vals_j, dims, strides, base)), got,
        "vs Pallas interpret")


def test_mdgather_full_lane_count():
    """The 8192-lane access of the Table IV geometry."""
    host = np.random.default_rng(0).standard_normal(1 << 15).astype(
        np.float32)
    dims, strides = (128, 64), (1, 128)
    got = mdgather(torch.from_numpy(host), dims, strides, 0)
    assert got.shape == (8192,)
    assert_bits_equal(pallas_gather(jnp.asarray(host), dims, strides, 0),
                      got.numpy())


def test_mdscatter_collision_last_lane_wins():
    """Stride-0 output dims collide; the highest lane's value lands."""
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    got = mdscatter(torch.zeros(8), torch.tensor(vals), (3, 2), (1, 0), 2)
    want = pallas_scatter(jnp.zeros(8, jnp.float32), jnp.asarray(vals),
                          dims=(3, 2), strides=(1, 0), base=2)
    assert_bits_equal(want, got.numpy())
    np.testing.assert_array_equal(got[2:5].numpy(), [4.0, 5.0, 6.0])


def test_gather_scatter_transpose_round_trip():
    """scatter(gather(x)) over the same bijective layout is the identity;
    storing with the transposed strides performs the transpose."""
    src = torch.from_numpy(
        np.random.default_rng(0).standard_normal(64).astype(np.float32))
    vals = mdgather(src, (8, 8), (8, 1), 0)
    same = mdscatter(torch.zeros_like(src), vals, (8, 8), (8, 1), 0)
    assert torch.equal(same, src)
    trans = mdscatter(torch.zeros_like(src), vals, (8, 8), (1, 8), 0)
    assert torch.equal(trans.reshape(8, 8), src.reshape(8, 8).T)


@pytest.mark.parametrize("case", _cases(8, seed=5), ids=str)
def test_batched_equals_per_image(case):
    """A ``(B, N)`` batch through one call equals image-by-image calls,
    with a per-lane mask and a padded lane count."""
    dims, strides, base = case
    rng = np.random.default_rng(6)
    span = base + sum((ln - 1) * s for ln, s in zip(dims, strides)) + 9
    total = int(np.prod(dims))
    lanes = total + 5
    src = torch.from_numpy(rng.standard_normal((3, span)).astype(np.float32))
    got = mdgather(src, dims, strides, base, lanes=lanes)
    assert got.shape == (3, lanes)
    for b in range(3):
        one = mdgather(src[b], dims, strides, base, lanes=lanes)
        assert torch.equal(got[b], one)
        assert torch.equal(one[:total],
                           mdgather(src[b], dims, strides, base))
        assert not one[total:].any()
    vals = torch.from_numpy(
        rng.standard_normal((3, lanes)).astype(np.float32))
    mask = torch.from_numpy(rng.random(lanes) < 0.7)
    out = mdscatter(src, vals, dims, strides, base, mask)
    for b in range(3):
        assert torch.equal(
            out[b], mdscatter(src[b], vals[b], dims, strides, base, mask))


def test_masked_and_out_of_range_lanes_write_nowhere():
    """A masked lane is dropped before it reaches an address (it must not
    beat an active lane there); addresses outside the image are dropped,
    not clamped; gather addresses are clamped."""
    dst = torch.arange(6, dtype=torch.float32)
    vals = torch.tensor([10.0, 11.0, 12.0, 13.0])
    # lanes 0..3 -> addresses 0,0,0,0: lane 3 masked, so lane 2 wins
    mask = torch.tensor([True, True, True, False])
    got = mdscatter(dst, vals, (4,), (0,), 0, mask)
    np.testing.assert_array_equal(got.numpy(), [12, 1, 2, 3, 4, 5])
    # stride 4 from base 1: addresses 1, 5, 9, 13 -> the last two drop
    got = mdscatter(dst, vals, (4,), (4,), 1)
    np.testing.assert_array_equal(got.numpy(), [0, 10, 2, 3, 4, 11])
    # in place vs functional
    assert dst[1] == 1 and mdscatter_(dst, vals, (4,), (4,), 1) is dst
    assert dst[1] == 10
    src = torch.arange(6, dtype=torch.float32)
    np.testing.assert_array_equal(
        mdgather(src, (4,), (4,), 1).numpy(), [1, 5, 5, 5])
    np.testing.assert_array_equal(
        mdgather(src, (3,), (-2,), 1).numpy(), [1, 0, 0])


def test_lane_addresses_match_reference():
    for dims, strides, base in _cases(12, seed=9):
        lanes = int(np.prod(dims))
        np.testing.assert_array_equal(
            ref.mdv_lane_addresses(dims, strides, base, lanes).numpy(),
            np.asarray(jref.mdv_lane_addresses(dims, strides, base, lanes)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    src = torch.zeros(8)
    with pytest.raises(ValueError):
        mdgather(src, (2, 2, 2, 2, 2), (1,) * 5)
    with pytest.raises(ValueError):
        mdgather(src, (2, 0), (1, 1))
    with pytest.raises(ValueError):
        mdgather(torch.zeros(2, 2, 2), (2,), (1,))
    with pytest.raises(TypeError):
        mdscatter_(src, torch.zeros(4, dtype=torch.int32), (4,), (1,))
    with pytest.raises(ValueError):
        mdscatter_(src, torch.zeros(4), (4,), (1,), 0,
                   torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        mdscatter_(torch.zeros(2, 8), torch.zeros(4), (4,), (1,))


def test_cpu_tensors_launch_no_kernel():
    """The launch counters count kernel launches only: the plain version
    on a CPU tensor leaves them alone (and needs no compiler)."""
    before = (mdgather.launches, mdscatter_.launches)
    mdscatter(torch.zeros(8), mdgather(torch.arange(8.0), (4,), (2,)),
              (4,), (1,))
    assert (mdgather.launches, mdscatter_.launches) == before
