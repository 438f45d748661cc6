"""``repro_torch.kernels.mdscatter.store_plan``: the host-side routing of
the ``vsst`` kernel, held against the reference's own store classifier
(``repro.core.machine.store_layout``) and, route by route, against the
plain version.

The wrapper classifies a store's walk once, on the host, as
``"contiguous"`` (lane ``l`` lands on ``l + shift`` over one run of lanes),
``"distinct"`` (no two lanes share an address) or ``"colliding"`` — over
the lanes below ``prod(dims)`` whose address, after ``[-N, 0)`` wraps to
``+N``, lies in ``[0, N)``.  The CUDA routes cannot run here; their
arithmetic is emulated in NumPy below (the contiguous copy of a lane run,
the 32-bit lane walk, the ``atomicMax`` owner table) and held against
:func:`repro_torch.kernels.ref.mdscatter_ref` and the reference's oracle.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.machine import OOB_BASE, store_layout
from repro.kernels import ref as jref

from repro_torch.core import MVEConfig, compile_program
from repro_torch.core.isa import Op
from repro_torch.core.machine import as_memory
from repro_torch.core.patterns import PATTERNS
from repro_torch.kernels import ref
from repro_torch.kernels.mdscatter import (lane_order, store_addresses,
                                           store_plan)

from _torch_parity import assert_bits_equal, lane_addresses32

LANES = 8192
IMAGE = 1 << 16

# static stores (vsst) of each Section-IV pattern at its default size
PATTERN_STORES = {
    "alpha_blend": 1, "audio_mix": 1, "daxpy": 1, "fir": 1, "gemm": 1,
    "intra_pred": 1, "memcpy": 1, "png_up": 1, "reduction": 6,
    "rgb2gray": 1, "spmm": 9, "transpose": 4, "upsample": 0,
    "xor_cipher": 1,
}

# (dims, strides, base, n): tests/test_torch_mdv_card.py's STORE_WALKS
# over its image, then walks that leave the image or fold onto themselves
STORE_WALKS = [
    ((8192,), (1,), 0, IMAGE),
    ((64, 128), (0, 16), 5, IMAGE),
    ((512, 16), (49, 1), 0, IMAGE),
    ((16, 8, 64), (1, 0, 16), 3, IMAGE),
    ((8, 4, 16, 16), (1, 8, 0, 32), 7, IMAGE),
    ((100, 3), (1, 100), 11, IMAGE),
    ((8192,), (9,), 100, IMAGE),
    ((64, 128), (-3, 1), 50, IMAGE),
    ((3, 2), (1, 0), 2, IMAGE),
    ((64, 128), (2, 3), 0, IMAGE),
]
EDGE_WALKS = [
    ((512, 16), (1, 512), 0, 50176),          # the transpose's store
    ((8192,), (1,), 4000, 6000),              # contiguous tail past N
    ((4000,), (1,), -5000, 6000),             # negative base, all wrap
    ((8192,), (1,), -6000, 6000),             # wraps onto itself
    ((16, 16), (1, 16), -100, 300),           # wraps, then lands in place
    ((100,), (1,), -5, 50),                   # wraps onto its own tail
    ((100,), (-1,), 99, 200),                 # negative stride
    ((32, 8), (-8, 1), 300, 512),             # negative row stride
    ((16, 16), (-1, -16), -1, 256),           # both negative, all wrap
    ((8192,), (0,), 7, 64),                   # stride 0: every lane collides
    ((64, 64), (1, 0), 0, 100),               # stride-0 rows
    ((2, 2, 2), (1, 9, 4), 0, 6),             # contig, lanes 2-3/6-7 outside
    ((8192,), (1,), 70000, IMAGE),            # entirely outside
]


def _random_walks(n=40, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ndim = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 9, ndim))
        strides = tuple(int(s) for s in rng.choice(
            [-9, -1, 0, 1, 2, 3, 7, 64], ndim))
        span = int(rng.integers(16, 400))
        out.append((dims, strides, int(rng.integers(-span, span)), span))
    return out


ALL_WALKS = STORE_WALKS + EDGE_WALKS + _random_walks()


def _reference_view(dims, strides, base, n, lane_mask=None):
    """Wrapped addresses and in-range mask over LANES lanes, the reference's
    ``store_layout`` of them, and its winner count."""
    total = math.prod(dims)
    addr = ref.wrap_store_addresses(
        ref.mdv_lane_addresses(dims, strides, base, LANES).numpy(), n)
    mask = (np.arange(LANES) < total) & (addr >= 0) & (addr < n)
    if lane_mask is not None:
        mask &= lane_mask
    layout = store_layout(addr, mask)
    if layout[0] == "scatter":
        winners = int((layout[1] < OOB_BASE).sum())
    else:
        winners = int(mask.sum())
    return addr, mask, layout, winners


def _one_run(mask):
    lanes = np.flatnonzero(mask)
    return lanes.size > 0 and lanes[-1] - lanes[0] + 1 == lanes.size


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_pattern_stores_take_the_contiguous_route(name):
    """Every static store of the 14 patterns, compiled by the port on the
    CPU, is "contiguous" to the wrapper and "contig" to the reference on
    the same wrapped addresses and dimension mask."""
    cfg = MVEConfig()
    run = PATTERNS[name]()
    cp = compile_program(run.program, cfg, device="cpu")
    n = as_memory(run.memory, "cpu").shape[-1]
    stores = [s for s in cp.steps if s.instr.op is Op.SST]
    assert len(stores) == PATTERN_STORES[name]
    for step in stores:
        plan = store_plan(tuple(step.dims), tuple(step.strides),
                          int(step.instr.base), n, cfg.lanes)
        assert plan.route == "contiguous", (name, step.dims, step.strides)
        _, _, layout, _ = _reference_view(step.dims, step.strides,
                                          step.instr.base, n, step.lane_mask)
        assert layout[0] == "contig", (name, layout[0])
        assert layout[1] == plan.shift


@pytest.mark.parametrize("walk", ALL_WALKS, ids=str)
def test_plan_agrees_with_reference_store_layout(walk):
    """"contiguous" is the reference's "contig" over one run of lanes, and
    a walk is collision-free ("contiguous"/"distinct"/"none") exactly when
    the reference keeps every in-range lane as a winner — with no mask and
    under random masks, which only remove writers."""
    dims, strides, base, n = walk
    plan = store_plan(dims, strides, base, n, LANES)
    _, mask, layout, winners = _reference_view(dims, strides, base, n)
    contig = layout[0] == "contig"
    assert (plan.route == "contiguous") == (contig and _one_run(mask))
    if plan.route == "contiguous":
        assert layout[1] == plan.shift
        assert (plan.lo, plan.hi) == (np.flatnonzero(mask)[0],
                                      np.flatnonzero(mask)[-1] + 1)
    assert (plan.route == "none") == (layout[0] == "none")
    free = plan.route in ("contiguous", "distinct", "none")
    assert free == (winners == int(mask.sum()))
    rng = np.random.default_rng(len(str(walk)))
    for keep in (0.3, 0.9):
        lane_mask = rng.random(LANES) < keep
        _, m, _, w = _reference_view(dims, strides, base, n, lane_mask)
        if free:
            assert w == int(m.sum())


def test_contiguous_lanes_with_a_gap_take_the_distinct_route():
    """The reference calls a walk "contig" whose in-range lanes all land on
    lane + shift even when out-of-range lanes sit between them; one copy of
    a lane run would write those lanes' slots, so the wrapper sends such a
    walk down the distinct route (still one kernel, no table)."""
    dims, strides, base, n = (2, 2, 2), (1, 9, 4), 0, 6
    _, mask, layout, _ = _reference_view(dims, strides, base, n)
    assert layout[0] == "contig"
    assert list(np.flatnonzero(mask)) == [0, 1, 4, 5]
    assert store_plan(dims, strides, base, n, LANES).route == "distinct"


def test_plan_is_cached_per_walk():
    store_plan.cache_clear()
    walk = ((512, 16), (1, 512), 0, 50176, LANES)
    first = store_plan(*walk)
    assert store_plan(*walk) is first
    assert store_plan.cache_info().hits == 1


# ---------------------------------------------------------------------------
# the routes, emulated as their kernels execute them
# ---------------------------------------------------------------------------

def emulate_routes(dst, values, dims, strides, base, mask):
    """``mdscatter_`` on ``(B, N)`` NumPy arrays as the CUDA routes do it."""
    out = dst.copy()
    n = dst.shape[1]
    lanes = values.shape[1]
    on = np.ones(lanes, bool) if mask is None else mask
    plan = store_plan(dims, strides, base, n, lanes)
    if plan.route == "none":
        return out, plan
    if plan.route == "contiguous":
        run = np.arange(plan.lo, plan.hi)
        run = run[on[run]]
        out[:, run + plan.shift] = values[:, run]
        return out, plan
    active = min(lanes, math.prod(dims))

    def target(lane):          # scatter_target: the wrapped address or -1
        addr = lane_addresses32(dims, strides, base, active)[lane]
        addr = np.where(addr < 0, addr + n, addr)
        return np.where(on[lane] & (addr >= 0) & (addr < n), addr, -1)

    owner = None
    if plan.route == "colliding":
        every = np.arange(active)                   # owner pass: lane order
        addr = target(every)
        owner = np.full(n, -1, np.int64)                   # the memset
        np.maximum.at(owner, addr[addr >= 0], every[addr >= 0])  # atomicMax
    lane = lane_order(dims, strides, base, n, lanes)  # store pass threads
    addr = target(lane)
    stores = addr >= 0
    if owner is not None:
        stores &= owner[np.where(stores, addr, 0)] == lane
    out[:, addr[stores]] = values[:, lane[stores]]
    return out, plan


@pytest.mark.parametrize("walk", ALL_WALKS, ids=str)
def test_lane_order_is_the_landing_lanes_by_address(walk):
    """The store pass's thread order: exactly the lanes that land in the
    image, addresses non-decreasing, equal addresses in lane order."""
    dims, strides, base, n = walk
    order = lane_order(dims, strides, base, n, LANES)
    lane, addr = store_addresses(dims, strides, base, n, LANES)
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), lane)
    by_lane = dict(zip(lane.tolist(), addr.tolist()))
    got = np.array([by_lane[int(l)] for l in order], np.int64)
    assert (np.diff(got) >= 0).all()
    ties = np.diff(got) == 0
    assert (np.diff(order)[ties] > 0).all()


@pytest.mark.parametrize("walk", STORE_WALKS + EDGE_WALKS, ids=str)
@pytest.mark.parametrize("masked", [False, True])
def test_emulated_routes_equal_the_plain_version(walk, masked):
    dims, strides, base, n = walk
    rng = np.random.default_rng(3)
    dst = rng.standard_normal((3, n)).astype(np.float32)
    vals = rng.standard_normal((3, LANES)).astype(np.float32)
    mask = rng.random(LANES) < 0.7 if masked else None
    got, plan = emulate_routes(dst, vals, dims, strides, base, mask)
    want = ref.mdscatter_ref(
        torch.from_numpy(dst), torch.from_numpy(vals), dims, strides, base,
        None if mask is None else torch.from_numpy(mask))
    assert_bits_equal(want.numpy(), got, plan.route)


@pytest.mark.parametrize("walk", [
    ((512, 16), (1, 512), 0, 50176), ((100,), (1,), 3, 120),
    ((16, 8), (1, 16), 2, 140), ((512, 16), (49, 1), 0, 50176),
    ((3, 2), (1, 0), 2, 8)], ids=str)
def test_emulated_routes_equal_the_reference_oracle(walk):
    """Without a mask, walks that stay inside the image: the reference's
    own scatter (the last lane wins) on every image."""
    dims, strides, base, n = walk
    total = math.prod(dims)
    rng = np.random.default_rng(4)
    dst = rng.integers(-1000, 1000, (2, n)).astype(np.int32)
    vals = rng.integers(-1000, 1000, (2, total)).astype(np.int32)
    got, _ = emulate_routes(dst, vals, dims, strides, base, None)
    for b in range(2):
        want = jref.mdscatter_ref(jnp.asarray(dst[b]), jnp.asarray(vals[b]),
                                  dims, strides, base)
        assert_bits_equal(np.asarray(want), got[b])


def test_lane_walk_in_32_bits_equals_the_64_bit_walk():
    """A dimension longer than 2**32 - 1 peels a lane id below 2**31 as
    its clamped length does."""
    for dims, strides, base in [((512, 16), (49, 1), 0),
                                ((7, 5, 3, 2), (-11, 3, 1000, -2**33), 5),
                                ((3, 2**40), (1, 2**20), -9)]:
        active = min(LANES, math.prod(dims))
        want = ref.mdv_lane_addresses(dims, strides, base, active).numpy()
        np.testing.assert_array_equal(
            lane_addresses32(dims, strides, base, active), want)


def test_store_addresses_are_the_lanes_that_store():
    lane, addr = store_addresses((100,), (1,), -5, 50, 128)
    np.testing.assert_array_equal(lane, np.arange(55))
    np.testing.assert_array_equal(addr[:5], np.arange(45, 50))
    np.testing.assert_array_equal(addr[5:], np.arange(50))
