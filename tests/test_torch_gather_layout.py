"""``repro_torch.kernels.mdgather.load_plan``: the host-side routing of the
``vsld`` kernel, and each route's index arithmetic held against the plain
version and the reference.

The wrapper classifies a load's walk once, on the host, as
``"contiguous"`` (lane ``l`` reads ``base + l``, all inside the image),
``"tiled"`` (dimension 0 strides over the image, another dimension has
stride ±1) or ``"walk"``.  The CUDA routes cannot run here; what each
kernel thread computes (the 16-byte units of the copy and its zero tail,
the 32-bit lane walk and its clamp, the tile's block and thread mapping
through shared memory) is emulated in NumPy below and held bit for bit
against :func:`repro_torch.kernels.ref.mdgather_ref` and the Pallas kernel
``repro.kernels.mdgather.mdgather`` in interpret mode.

The Pallas kernel in interpret mode (like the reference's ``ref.py``)
indexes a negative address Python-style, from the image's end; the
reference's executors, the port's plain version and the CUDA kernel clamp
it to 0 (ROADMAP queue C, C5).  Walks with a negative address are held
against the executors' ``np.clip`` instead.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mdgather import mdgather as pallas_gather

from repro_torch.core import MVEConfig, compile_program
from repro_torch.core.isa import Op
from repro_torch.core.machine import as_memory
from repro_torch.core.patterns import PATTERNS
from repro_torch.kernels import ref
from repro_torch.kernels.mdgather import (MAX_LANES, _call, load_addresses,
                                          load_plan, mdgather)

from _torch_parity import assert_bits_equal, lane_addresses32

LANES = 8192
IMAGE = 1 << 16

# routes of the static loads (vsld) of each Section-IV pattern at its
# default size and MVEConfig(), in program order
C, W, T = "contiguous", "walk", "tiled"
PATTERN_LOADS = {
    "alpha_blend": [C] * 2, "audio_mix": [C] * 2, "daxpy": [C] * 2,
    "fir": [C] * 16, "gemm": [W] * 32, "intra_pred": [W] * 2,
    "memcpy": [C], "png_up": [], "reduction": [C] * 6, "rgb2gray": [W] * 3,
    "spmm": [W] * 9, "transpose": [T] * 3 + [W], "upsample": [],
    "xor_cipher": [C, W],
}

# (dims, strides, base, n, lanes, route): tests/test_torch_mdv_card.py's
# gather walks over its image, then the edges
LOAD_WALKS = [
    ((8192,), (1,), 0, IMAGE, LANES, C),
    ((64, 128), (0, 16), 5, IMAGE, LANES, W),
    ((512, 16), (49, 1), 0, IMAGE, LANES, T),
    ((16, 8, 64), (1, 0, 16), 3, IMAGE, LANES, W),
    ((8, 4, 16, 16), (1, 8, 0, 32), 7, IMAGE, LANES, W),
    ((100, 3), (1, 100), 11, IMAGE, LANES, C),      # zero tail of 7892
    ((8192,), (9,), 100, IMAGE, LANES, W),           # clamps past the end
    ((64, 128), (-3, 1), 50, IMAGE, LANES, T),       # clamps before start
    ((64, 128), (1, 0), 0, IMAGE, LANES, W),
    ((3, 3, 256), (1, 0, 3), 0, IMAGE, LANES, W),
    ((8192,), (3,), 0, IMAGE, LANES, W),
    ((8192,), (1,), IMAGE - 2536, IMAGE, LANES, W),  # contiguous, tail clamps
]
EDGE_WALKS = [
    ((4096,), (1,), 8192, 12544, LANES, C),         # reduction: zero tail
    ((8192,), (1,), 0, IMAGE, 1000, C),              # lanes below prod(dims)
    ((100, 3), (1, 100), 11, IMAGE, 250, C),
    ((5,), (1,), 3, 10, 1, C),                       # one lane
    ((8192,), (1,), 0, 5000, LANES, W),              # image shorter
    ((8192,), (1,), -3, IMAGE, LANES, W),            # base before the start
    ((2, 2, 2), (1, 2, 4), 0, 5, 9, W),
    ((2, 2, 2), (1, 2, 4), 0, 8, 9, C),              # row-major, 1 zero lane
    ((100,), (-1,), 99, 200, 128, W),                # negative stride
    ((3,), (-2,), 1, 6, 3, W),                       # clamps before start
    ((8192,), (0,), 7, 64, LANES, W),                # stride 0: one element
    ((512, 16), (49, 1), 0, 50176, 4096, W),         # lanes below prod(dims)
    ((512, 16), (49, 1), 0, 50176, 9000, T),         # tiled, zero tail
    ((512, 16), (49, 1), 16, 1000, LANES, T),        # image shorter
    ((512, 1), (49, 1), 48, 50176, LANES, W),        # unit dim of length 1
    ((8, 4, 16, 16), (40, 3, 0, 1), 7, IMAGE, LANES, T),  # unit dim 3
    ((33, 5, 70), (-100, 1, 9), 5000, 6000, 12000, T),    # ragged tiles
    ((40, 3), (5, -1), 2, 100, 128, T),              # stride -1, clamps
    ((70, 40), (-1, 70), 69, 2800, LANES, W),        # dim 0 stride -1
    ((3, 2**40), (1, 2**20), -9, 300, 64, W),        # a dim past 2**32
]


def _random_walks(n=40, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ndim = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 40, ndim))
        strides = tuple(int(s) for s in rng.choice(
            [-9, -1, 0, 1, 2, 3, 7, 64], ndim))
        total = math.prod(dims)
        span = int(rng.integers(16, 3000))
        lanes = int(rng.integers(1, 2 * total + 2))
        out.append((dims, strides, int(rng.integers(-span, span)), span,
                    lanes, None))
    return out


ALL_WALKS = LOAD_WALKS + EDGE_WALKS + _random_walks()


# ---------------------------------------------------------------------------
# the routes, emulated as their kernels execute them: each gives, per
# output lane, the source address it moves (>= 0) or -1 for a 0
# ---------------------------------------------------------------------------

def contiguous_sources(plan, base, n, lanes, vec):
    """``mdgather_contig_kernel<T, vec>``: one thread per ``vec`` lanes; a
    whole unit is copied (below ``count``) or zeroed (at or past it), the
    unit that straddles ``count`` or the register's end goes element by
    element.  The run never leaves the image, so nothing is clamped."""
    count = plan.active
    lane = np.arange(lanes)
    first = lane - lane % vec                       # the thread's unit
    whole = (vec > 1) & (first + vec <= lanes) & (
        (first + vec <= count) | (first >= count))
    copied = np.where(whole, first < count, lane < count)
    srcs = np.where(copied, base + lane, -1)
    moved = srcs[srcs >= 0]
    assert ((moved >= 0) & (moved < n)).all()        # no clamp needed
    return srcs


def _clamp(addr, n):
    return np.minimum(np.maximum(addr, 0), n - 1)


def walk_sources(dims, strides, base, n, lanes, active):
    """``mdgather_walk_kernel``: each lane's address peeled once in 32 bits
    and clamped (a thread takes 16 bytes of lanes, or one lane; either way
    each lane is its own gather); lanes at or past ``active`` are 0."""
    srcs = np.full(lanes, -1, np.int64)
    srcs[:active] = _clamp(lane_addresses32(dims, strides, base, active), n)
    return srcs


THREADS, ELEMS, MIN_TC = 256, 1024, 4    # MDV_THREADS, MDV_TILE_ELEMS, ...


def tiled_sources(dims, strides, base, n, lanes, plan):
    """``mdgather_tiled_kernel``: block ``x < tiles`` takes a tile of
    ``ta`` rows along dimension 0 by ``tc`` columns along dimension
    ``unit`` (``tc`` the power of 2 from 4 to 32 that covers it, ``ta =
    1024 / tc``) at one index of the dimensions between (``lo``) and after
    (``hi``).  Element ``e = tid + 256 r`` is read at (row ``e // tc``,
    column ``e % tc``) and written at (row ``e % ta``, column ``e // ta``),
    through shared memory rows of ``tc + 1``.  Blocks past ``tiles`` zero
    the lanes ``[active, lanes)``."""
    k, active = plan.unit, plan.active
    d0, dk = dims[0], dims[k]
    p = math.prod(dims[1:k])
    h = math.prod(dims[k + 1:])
    tc = MIN_TC
    while tc < 32 and tc < dk:
        tc *= 2
    ta = ELEMS // tc
    n0, nk = -(-d0 // ta), -(-dk // tc)
    tiles = n0 * nk * p * h
    tail_blocks = -(-(lanes - active) // THREADS)
    srcs = np.full(lanes, -2, np.int64)
    tid = np.arange(THREADS)
    addr_of = _clamp(lane_addresses32(dims, strides, base, active), n)

    def lane_of(a, c, lo, hi):
        ok = (a < d0) & (c < dk)
        lane = np.where(ok, a + d0 * (lo + p * (c + dk * hi)), 0)
        return lane, ok & (lane < active)

    for block in range(tiles + tail_blocks):
        if block >= tiles:
            lane = active + (block - tiles) * THREADS + tid
            lane = lane[lane < lanes]
            assert (srcs[lane] == -2).all()
            srcs[lane] = -1
            continue
        rest = block
        a0 = rest % n0 * ta
        rest //= n0
        c0 = rest % nk * tc
        rest //= nk
        lo, hi = rest % p, rest // p
        tile = np.full(ELEMS + ELEMS // MIN_TC, -3, np.int64)  # shared
        slots = []
        for r in range(ELEMS // THREADS):
            e = tid + r * THREADS
            lane, live = lane_of(a0 + e // tc, c0 + e % tc, lo, hi)
            slot = e // tc * (tc + 1) + e % tc
            tile[slot] = np.where(live, addr_of[np.where(live, lane, 0)], -1)
            slots.append(slot)
        assert np.unique(np.concatenate(slots)).size == ELEMS
        assert np.concatenate(slots).max() < tile.size
        for r in range(ELEMS // THREADS):
            e = tid + r * THREADS
            lane, live = lane_of(a0 + e % ta, c0 + e // ta, lo, hi)
            got = tile[e % ta * (tc + 1) + e // ta]
            assert (got[live] >= 0).all()      # read by the same block
            assert (srcs[lane[live]] == -2).all()           # written once
            srcs[lane[live]] = got[live]
    assert (srcs >= -1).all()                       # every lane written
    return srcs


def route_sources(dims, strides, base, n, lanes, vec=4):
    plan = load_plan(dims, strides, base, n, lanes)
    if plan.route == "contiguous":
        return contiguous_sources(plan, base, n, lanes, vec), plan
    if plan.route == "tiled":
        return tiled_sources(dims, strides, base, n, lanes, plan), plan
    return walk_sources(dims, strides, base, n, lanes, plan.active), plan


def gather(src, srcs):
    """Apply per-lane sources to a ``(B, N)`` NumPy batch."""
    out = src[:, np.maximum(srcs, 0)]
    out[:, srcs < 0] = 0
    return out


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_pattern_loads_take_their_routes(name):
    """Every static load of the 14 patterns, compiled by the port on the
    CPU, takes the route the table says; each route's emulation on the
    pattern's own image equals the plain version."""
    cfg = MVEConfig()
    run = PATTERNS[name]()
    cp = compile_program(run.program, cfg, device="cpu")
    image = as_memory(run.memory, "cpu")
    n = image.shape[-1]
    loads = [s for s in cp.steps if s.instr.op is Op.SLD]
    routes = []
    for step in loads:
        walk = (tuple(step.dims), tuple(step.strides), int(step.instr.base))
        srcs, plan = route_sources(*walk, n, cfg.lanes)
        routes.append(plan.route)
        want = ref.mdgather_ref(image[None], *walk, cfg.lanes)
        assert_bits_equal(want.numpy(), gather(image[None].numpy(), srcs),
                          (name, walk))
    assert routes == PATTERN_LOADS[name]


@pytest.mark.parametrize("walk", ALL_WALKS, ids=str)
def test_plan(walk):
    """The route follows the walk alone: contiguous exactly when the
    reading lanes read ``base + l`` inside the image; tiled only for a
    strided dimension 0 beside a unit-stride one, with every tuple a
    lane."""
    dims, strides, base, n, lanes, route = walk
    plan = load_plan(dims, strides, base, n, lanes)
    if route is not None:
        assert plan.route == route
    active = min(lanes, math.prod(dims))
    assert plan.active == active
    addr = load_addresses(dims, strides, base, lanes)
    np.testing.assert_array_equal(
        addr, ref.mdv_lane_addresses(dims, strides, base, active).numpy())
    run = base + np.arange(active)
    assert (plan.route == "contiguous") == bool(
        (addr == run).all() and (run >= 0).all() and (run < n).all())
    if plan.route == "tiled":
        assert math.prod(dims) <= lanes
        assert strides[0] not in (-1, 0, 1) and dims[0] > 1
        assert strides[plan.unit] in (-1, 1) and dims[plan.unit] > 1
        assert plan.unit == min(k for k in range(1, len(dims))
                                if dims[k] > 1 and strides[k] in (-1, 1))


@pytest.mark.parametrize("walk", ALL_WALKS, ids=str)
def test_emulated_route_equals_the_plain_version(walk):
    dims, strides, base, n, lanes, _ = walk
    rng = np.random.default_rng(5)
    src = rng.standard_normal((2, n)).astype(np.float32)
    srcs, plan = route_sources(dims, strides, base, n, lanes)
    want = ref.mdgather_ref(torch.from_numpy(src), dims, strides, base,
                            lanes)
    assert_bits_equal(want.numpy(), gather(src, srcs), plan.route)
    one = mdgather(torch.from_numpy(src[1]), dims, strides, base, lanes)
    assert_bits_equal(one.numpy(), gather(src, srcs)[1], "one image")


@pytest.mark.parametrize("walk", [w for w in ALL_WALKS
                                  if math.prod(w[0]) <= 1 << 16], ids=str)
def test_emulated_route_equals_the_pallas_kernel(walk):
    """The reading lanes against the Pallas kernel in interpret mode on the
    same NumPy image (int32, so every bit pattern survives; the kernel
    gathers all prod(dims) lanes, so walks longer than 2**16 are left
    out); a walk with a negative address against the reference executors'
    clamp."""
    dims, strides, base, n, lanes, _ = walk
    src = np.random.default_rng(6).integers(
        -2**31, 2**31 - 1, (1, n)).astype(np.int32)
    srcs, plan = route_sources(dims, strides, base, n, lanes)
    got = gather(src, srcs)[0]
    active = plan.active
    assert not got[active:].any()
    addr = load_addresses(dims, strides, base, lanes)
    if (addr < 0).any():
        assert_bits_equal(src[0, np.clip(addr, 0, n - 1)], got[:active])
        return
    want = np.asarray(pallas_gather(jnp.asarray(src[0]), dims, strides,
                                    base))
    assert_bits_equal(want[:active], got[:active], plan.route)


@pytest.mark.parametrize("vec", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("walk", [w for w in ALL_WALKS
                                  if load_plan(*w[:5]).route == "contiguous"],
                         ids=str)
def test_contiguous_units_of_every_element_size(walk, vec):
    """The copy's two instances: 16-byte units of 16 / elem lanes (elem =
    1, 2, 4, 8) where both sides are aligned, single lanes elsewhere; a
    unit is copied whole, zeroed whole, or (straddling the run's end or
    the register's) lane by lane."""
    dims, strides, base, n, lanes, _ = walk
    plan = load_plan(dims, strides, base, n, lanes)
    srcs = contiguous_sources(plan, base, n, lanes, vec)
    want = np.where(np.arange(lanes) < plan.active,
                    base + np.arange(lanes), -1)
    np.testing.assert_array_equal(srcs, want)


def test_lane_walk_in_32_bits_equals_the_64_bit_walk():
    """A dimension longer than 2**32 - 1 peels a lane id below 2**31 as its
    clamped length does."""
    for dims, strides, base in [((512, 16), (49, 1), 0),
                                ((7, 5, 3, 2), (-11, 3, 1000, -2**33), 5),
                                ((3, 2**40), (1, 2**20), -9)]:
        active = min(LANES, math.prod(dims))
        np.testing.assert_array_equal(
            lane_addresses32(dims, strides, base, active),
            ref.mdv_lane_addresses(dims, strides, base, active).numpy())


def test_plan_and_call_are_cached_per_walk():
    load_plan.cache_clear()
    walk = ((512, 16), (49, 1), 0, 50176, LANES)
    first = load_plan(*walk)
    assert load_plan(*walk) is first
    assert load_plan.cache_info().hits == 1
    lanes, plan, packed = _call((512, 16), (49, 1), 0, 50176, None)
    assert (lanes, plan) == (LANES, first)
    assert (packed.src_len, packed.lanes, packed.base) == (50176, LANES, 0)
    assert list(packed.dims) == [512, 16, 1, 1]
    assert list(packed.strides) == [49, 1, 0, 0]
    assert (packed.route, packed.ndims, packed.unit) == (2, 2, 1)
    assert _call((512, 16), (49, 1), 0, 50176, None)[2] is packed


def test_call_rejects_more_lanes_than_32_bits_peel():
    with pytest.raises(ValueError):
        _call((8,), (1,), 0, 64, MAX_LANES + 1)
    with pytest.raises(ValueError):
        _call((2, 0), (1, 1), 0, 64, None)


def test_routes_are_counted_by_name():
    assert set(mdgather.routes) == {"contiguous", "walk", "tiled"}


def test_c5_negative_load_addresses_clamp_like_the_reference_executors():
    """ROADMAP C5: the reference's executors clip a load address into the
    image (``repro/core/interp.py``, ``np.clip(addr, 0, N - 1)``); its
    Pallas gather in interpret mode, like its ``ref.py``, wraps a negative
    one from the image's end.  The port, plain version and every kernel
    route, clamps as the executors do."""
    src = np.arange(20, dtype=np.float32)
    dims, strides, base = (6,), (-4,), 3
    addr = load_addresses(dims, strides, base, 6)
    np.testing.assert_array_equal(addr, [3, -1, -5, -9, -13, -17])
    got = mdgather(torch.from_numpy(src), dims, strides, base).numpy()
    np.testing.assert_array_equal(got, src[np.clip(addr, 0, 19)])
    np.testing.assert_array_equal(got, [3, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(
        np.asarray(pallas_gather(jnp.asarray(src), dims, strides, base)),
        [3, 19, 15, 11, 7, 3])
    srcs, _ = route_sources(dims, strides, base, 20, 6)
    np.testing.assert_array_equal(gather(src[None], srcs)[0], got)
