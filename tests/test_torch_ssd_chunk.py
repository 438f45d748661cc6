"""The SSD scan's intra-chunk term as the hand-written kernel computes it
(``kernels/ssd_chunk.py``, ``csrc/ssd_chunk.cu``), on the CPU:

* the plain versions ``ref.ssd_chunk_ref`` / ``ssd_chunk_bwd_ref`` (the
  kernel's forward and its hand-derived backward) in float64 against the
  einsum route's term and its autograd gradients, at chunks 16 and 256,
  ngroups 1 and 2, d_state 64 and 128, with and without runs (documents
  shorter than a chunk and spanning several, ids that come back, padding);
* ``ssd_chunked`` through the kernel's route (its operators take the plain
  versions on the CPU) against the einsum route and ``ssd_naive``, with S
  not a multiple of the chunk, and restarted at each document;
* all-equal runs equal to no runs, bit for bit;
* the route rule: CPU and ``DTensor`` calls, and sizes the kernel does not
  take, keep the einsums; ``ssd_chunked.kernel`` counts the others, remat's
  recompute again;
* the three kernels' loops emulated lane by lane in NumPy (fragments of
  ``mma.sync`` m16n8k8, the fragment-order cache, the cp.async stages, the
  run skips and masks) against the plain versions, in float64.

The card's tests are in ``tests/test_torch_ssd_chunk_card.py``.
"""
from __future__ import annotations

import dataclasses
import math
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import zamba2_7b
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as sk
from repro_torch.models import ssm

F64 = torch.float64


def _run_ids(s: int, kind: str) -> torch.Tensor:
    """(2, s) segment ids: ``short`` documents under a chunk, ``long`` ones
    spanning several chunks, ``back`` ids that come back, ``pad`` a padded
    tail (id 0)."""
    rng = np.random.default_rng(len(kind) + s)
    rows = []
    for r in range(2):
        if kind == "short":
            lens = rng.integers(3, 40, size=s)
        elif kind == "long":
            lens = rng.integers(150, 400, size=s)
        else:
            lens = rng.integers(10, 120, size=s)
        ids = np.repeat(np.arange(1, len(lens) + 1), lens)[:s]
        if kind == "back":
            ids = np.where(ids % 3 == 0, 1, ids)     # id 1 again and again
        if kind == "pad":
            ids[s - s // 5 - r:] = 0
        rows.append(ids)
    return torch.tensor(np.stack(rows), dtype=torch.int32)


def _term_inputs(bsz, nc, cs, g, hg, p, n, seed, dtype=F64):
    """The term's operands as ``ssd_chunked`` forms them: ``da`` <= 0 a
    position (dt * A), its cumulative sum within each chunk."""
    gen = torch.Generator().manual_seed(seed)
    cc = torch.randn(bsz, nc, cs, g, n, generator=gen, dtype=dtype)
    bc = torch.randn(bsz, nc, cs, g, n, generator=gen, dtype=dtype)
    xf = torch.randn(bsz, nc, cs, g, hg, p, generator=gen, dtype=dtype)
    da = -torch.rand(bsz, nc, cs, g, hg, generator=gen, dtype=dtype) * 0.3
    return cc, bc, xf, da


def _chunk_runs(ids: torch.Tensor, nc: int, cs: int) -> torch.Tensor:
    runs = ssm.document_runs(ids)
    pad = nc * cs - runs.shape[1]
    if pad:
        runs = torch.cat([runs, runs[:, -1:].expand(-1, pad)], dim=1)
    return runs.view(-1, nc, cs)


CASES = [(16, 1, 64, None), (16, 2, 128, "short"), (256, 2, 64, "long"),
         (256, 1, 128, "back"), (256, 2, 64, "pad"), (256, 2, 64, None)]


@pytest.mark.parametrize("cs,g,n,kind", CASES)
def test_plain_versions_are_the_einsum_route_float64(cs, g, n, kind):
    """The forward equal to the einsum route's term, the hand-derived
    backward equal to autograd through it (dda_cum's gradient reaches the
    log decay as a reversed cumulative sum), float64 sum order only."""
    bsz, s, hg, p = 2, 600, 3, 8
    nc = -(-s // cs)
    cc, bc, xf, da = _term_inputs(bsz, nc, cs, g, hg, p, n, seed=cs + n)
    runs = None if kind is None else _chunk_runs(_run_ids(s, kind), nc, cs)
    leaves = [t.clone().requires_grad_() for t in (da, cc, bc, xf)]
    want = ssm._diag_einsum(*leaves, runs)
    got = ref.ssd_chunk_ref(cc, bc, xf, torch.cumsum(da, 2), runs)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)

    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(5),
                     dtype=F64)
    gda, gcc, gbc, gxf = torch.autograd.grad(want, leaves, dy)
    dcc, dbc, dxf, dda_cum = ref.ssd_chunk_bwd_ref(
        cc, bc, xf, torch.cumsum(da, 2), dy, runs)
    dda = dda_cum.flip(2).cumsum(2).flip(2)         # through the cumsum
    for mine, auto in ((dcc, gcc), (dbc, gbc), (dxf, gxf), (dda, gda)):
        torch.testing.assert_close(mine, auto, rtol=1e-10,
                                   atol=1e-10 * auto.abs().max().item())


def _scan_inputs(bsz, s, h, g, n, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(bsz, s, h, 64, generator=gen, dtype=dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, s, h, generator=gen, dtype=dtype) - 1)
    a_log = torch.randn(h, generator=gen, dtype=dtype) * 0.3
    b = torch.randn(bsz, s, g, n, generator=gen, dtype=dtype) * 0.5
    c = torch.randn(bsz, s, g, n, generator=gen, dtype=dtype) * 0.5
    return x, dt, a_log, b, c


def _kernel_route():
    """The kernel's route for every call (its operators take the plain
    versions on the CPU)."""
    return mock.patch.object(ssm, "_takes_kernel", lambda *a: True)


@pytest.mark.parametrize("cs,g,n,kind", [(16, 2, 64, "short"),
                                         (256, 1, 128, None),
                                         (256, 2, 64, "pad"),
                                         (256, 2, 64, "back")])
def test_kernel_route_is_the_einsum_route(cs, g, n, kind):
    """``ssd_chunked`` on the kernel's route against the einsum route (S =
    300, not a multiple of the chunk), output, final state and every
    gradient, float32 sum order (2e-5 of the largest entry)."""
    ids = None if kind is None else _run_ids(300, kind)
    args = [t.requires_grad_() for t in _scan_inputs(2, 300, 4, g, n, 7)]
    out = []
    for route in (mock.patch.object(ssm, "_takes_kernel", lambda *a: False),
                  _kernel_route()):
        with route:
            y, state = ssm.ssd_chunked(*args, cs, segment_ids=ids)
        loss = (y * torch.cos(y)).sum() + state.sum()
        out.append((y, state, torch.autograd.grad(loss, args)))
    (y0, st0, g0), (y1, st1, g1) = out
    for got, want in [(y1, y0), (st1, st0), *zip(g1, g0)]:
        torch.testing.assert_close(got, want, rtol=2e-5,
                                   atol=2e-5 * want.abs().max().item())


@pytest.mark.parametrize("kind", [None, "short", "long", "pad"])
def test_kernel_route_is_the_naive_scan(kind):
    """Against the step-by-step recurrence, restarted at each run (fp32 sum
    order: 2e-5)."""
    s = 700
    ids = None if kind is None else _run_ids(s, kind)
    x, dt, a_log, b, c = _scan_inputs(2, s, 4, 2, 64, 11)
    with _kernel_route():
        y, _ = ssm.ssd_chunked(x, dt, a_log, b, c, 256, segment_ids=ids)
    runs = (torch.zeros(2, s, dtype=torch.int32) if ids is None
            else ssm.document_runs(ids))
    for r in range(2):
        edges = [0] + (torch.nonzero(runs[r, 1:] != runs[r, :-1])[:, 0] + 1
                       ).tolist() + [s]
        for s0, s1 in zip(edges, edges[1:]):
            part = (t[r:r + 1, s0:s1] for t in (x, dt, b, c))
            xs, dts, bs, cs = part
            naive, _ = ssm.ssd_naive(xs, dts, a_log, bs, cs)
            torch.testing.assert_close(y[r:r + 1, s0:s1], naive, rtol=2e-5,
                                       atol=2e-5)


def test_all_equal_runs_are_no_runs_bit_for_bit():
    cc, bc, xf, da = _term_inputs(2, 2, 256, 2, 3, 8, 64, seed=3,
                                  dtype=torch.float32)
    da_cum = torch.cumsum(da, 2)
    same = torch.full((2, 2, 256), 4, dtype=torch.int32)
    assert torch.equal(ref.ssd_chunk_ref(cc, bc, xf, da_cum, same),
                       ref.ssd_chunk_ref(cc, bc, xf, da_cum))
    dy = torch.randn(xf.shape)
    for a, b in zip(ref.ssd_chunk_bwd_ref(cc, bc, xf, da_cum, dy, same),
                    ref.ssd_chunk_bwd_ref(cc, bc, xf, da_cum, dy)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

def test_cpu_calls_keep_the_einsums():
    before = ssm.ssd_chunked.kernel
    x, dt, a_log, b, c = _scan_inputs(1, 64, 2, 1, 64, 1)
    ssm.ssd_chunked(x, dt, a_log, b, c, 256)
    assert not ssm._takes_kernel(x, b, c, 256)
    assert ssm.ssd_chunked.kernel == before


@pytest.mark.parametrize("p,n,cs,takes", [
    (64, 64, 256, True), (64, 128, 256, True), (64, 64, 64, True),
    (64, 64, 128, True), (64, 64, 192, True), (32, 64, 256, False),
    (64, 16, 256, False), (64, 256, 256, False), (64, 64, 16, False),
    (64, 64, 100, False), (64, 64, 512, False)])
def test_route_follows_the_sizes(p, n, cs, takes):
    """On the card (mocked) the kernel takes head dim 64, states 64 and
    128, chunks of whole 64-row tiles up to 256; the einsums the rest."""
    x = torch.zeros(1, 8, 2, p)
    b = torch.zeros(1, 8, 1, n)
    with mock.patch.object(ssm, "_on_card", lambda t: True):
        assert ssm._takes_kernel(x, b, b, cs) is takes
    assert not ssm._takes_kernel(x, b, b, cs)


def test_dtensor_calls_keep_the_einsums():
    x = torch.zeros(1, 8, 2, 64)
    b = torch.zeros(1, 8, 1, 64)
    dx = mock.MagicMock(spec=DTensor)
    with mock.patch.object(ssm, "_on_card", lambda t: True):
        assert ssm._takes_kernel(x, b, b, 256)
        assert not ssm._takes_kernel(dx, b, b, 256)
        assert not ssm._takes_kernel(x, dx, b, 256)
        assert not ssm._takes_kernel(x, b, dx, 256)


def test_counter_counts_each_call_and_the_recompute():
    """``mamba_mixer`` at a reduced Zamba2 (ngroups 2) with the state and
    head dim the kernel takes, on the card (mocked): a forward counts one,
    a checkpointed forward and backward two, a call the kernel does not
    take none."""
    cfg = dataclasses.replace(zamba2_7b.reduced(), ssm_state=64,
                              ssm_headdim=64, ssm_chunk=64)
    gen = torch.Generator().manual_seed(0)
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_ngroups * cfg.ssm_state

    def w(*shape):
        return torch.randn(*shape, generator=gen) * 0.1

    params = dict(w_zx=w(d, 2 * din), w_bc=w(d, 2 * gn), w_dt=w(d, h),
                  dt_bias=w(h), conv_w=w(cfg.ssm_conv, din + 2 * gn),
                  conv_b=w(din + 2 * gn), a_log=w(h), d_skip=w(h),
                  gate_norm=1 + w(din), w_out=w(din, d))
    hidden = torch.randn(2, 100, cfg.d_model, requires_grad=True)
    ids = _run_ids(100, "short")
    with mock.patch.object(ssm, "_on_card", lambda t: True):
        before = ssm.ssd_chunked.kernel
        ssm.mamba_mixer(params, hidden, cfg, segment_ids=ids)
        assert ssm.ssd_chunked.kernel == before + 1
        out = checkpoint(lambda h: ssm.mamba_mixer(params, h, cfg,
                                                   segment_ids=ids)[0],
                         hidden, use_reentrant=False)
        out.sum().backward()
        assert ssm.ssd_chunked.kernel == before + 3
        odd = dataclasses.replace(cfg, ssm_chunk=48)
        ssm.mamba_mixer(params, hidden, odd, segment_ids=ids)
        assert ssm.ssd_chunked.kernel == before + 3


def test_operators_have_shapes_and_flop_formulas():
    cc, bc, xf, da = _term_inputs(1, 2, 64, 2, 3, 64, 64, seed=0,
                                  dtype=torch.float32)
    meta = [t.to("meta") for t in (cc, bc, xf, da)]
    assert sk.ssd_chunk_fwd(*meta).shape == xf.shape
    shapes = [t.shape for t in sk.ssd_chunk_bwd(*meta, meta[2])]
    assert shapes == [cc.shape, bc.shape, xf.shape, da.shape]
    wm = torch.zeros(1, 2, 2, 3, 64, 64)
    assert sk.ssd_gather(meta[2], meta[1], meta[3]).shape == wm.shape
    assert sk.ssd_apply(meta[0], wm.to("meta"), meta[3]).shape == xf.shape
    assert [t.shape for t in sk.ssd_cross(meta[2], wm.to("meta"), meta[0],
                                          meta[3])] == [cc.shape, da.shape]
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        sk.ssd_chunk_fwd(cc, bc, xf, da)
    unit = 2 * 1 * 2 * 2 * 64 * 64                  # 2 L^2 a block
    assert fc.get_total_flops() == unit * (64 + 3 * 64)
    with FlopCounterMode(display=False) as fc:
        sk.ssd_gather(xf, bc, da)
        sk.ssd_apply(cc, wm, da)
        sk.ssd_cross(xf, wm, cc, da)
    rows = 1 * 2 * 64 * 2 * 3                       # (row, head) pairs
    assert fc.get_total_flops() == 3 * 2 * rows * 64 * 64


# ---------------------------------------------------------------------------
# the kernels' loops, lane by lane
# ---------------------------------------------------------------------------

LANE = np.arange(32)
GR, TH = LANE >> 2, LANE & 3           # g = lane / 4, t = lane % 4
TILE, HB = 64, 8


def a_frag(tile, r0, c0):
    """tf32_a_frag: rows r0 + g, + 8, columns c0 + t, + 4."""
    return np.stack([tile[r0 + GR, c0 + TH], tile[r0 + GR + 8, c0 + TH],
                     tile[r0 + GR, c0 + TH + 4],
                     tile[r0 + GR + 8, c0 + TH + 4]])


def b_rows(tile, n0, k0):
    """tf32_b_frag_rows: the n index over the tile's rows."""
    return np.stack([tile[n0 + GR, k0 + TH], tile[n0 + GR, k0 + TH + 4]])


def b_perm(tile, k0, n0):
    """tf32_b_frag_perm: rows k0 + 2t, + 1, column n0 + g."""
    return np.stack([tile[k0 + 2 * TH, n0 + GR],
                     tile[k0 + 2 * TH + 1, n0 + GR]])


def a_from_c(c):
    return c[[0, 2, 1, 3]]


def mma(c, a, b):
    """mma.sync m16n8k8 (the three TF32 products' sum, in float64)."""
    am = np.zeros((16, 8))
    am[GR, TH], am[GR + 8, TH] = a[0], a[1]
    am[GR, TH + 4], am[GR + 8, TH + 4] = a[2], a[3]
    bm = np.zeros((8, 8))
    bm[TH, GR], bm[TH + 4, GR] = b[0], b[1]
    d = am @ bm
    return c + np.stack([d[GR, 2 * TH], d[GR, 2 * TH + 1],
                         d[GR + 8, 2 * TH], d[GR + 8, 2 * TH + 1]])


def run_groups(runs):
    g16 = runs.reshape(-1, 16)
    return np.stack([g16.min(1), g16.max(1)], 1)


def meet(rng, w, tile):
    wlo, whi = rng[w]
    tlo, thi = rng[4 * tile:4 * tile + 4, 0].min(), \
        rng[4 * tile:4 * tile + 4, 1].max()
    return wlo <= thi and tlo <= whi, wlo == whi and tlo == thi and wlo == tlo


def s_phase(cache, f, u, fixed, first, count):
    """sc_s_phase: quad q, warp wq: the fixed tile's rows wq*16 .. against
    tile u's columns 32q .. 32q + 31, into cache[u - first]."""
    n_state = f.shape[1]
    f_t = f[fixed * TILE:(fixed + 1) * TILE]
    for k in range(count):
        u_t = u[(first + k) * TILE:(first + k + 1) * TILE]
        for quad in range(2):
            for wq in range(4):
                sc = np.zeros((4, 4, 32))
                for kk in range(n_state // 8):
                    a = a_frag(f_t, wq * 16, kk * 8)
                    for n in range(4):
                        sc[n] = mma(sc[n], a, b_rows(u_t, quad * 32 + n * 8,
                                                     kk * 8))
                for n in range(4):
                    cache[k, quad * 4 + n, :, wq * 32 + LANE] = sc[n].T


def _masked(v, edge, row, col, runs, causal_ok):
    if not edge:
        return v
    valid = causal_ok(col, row)
    if runs is not None:
        valid = valid & (runs[row] == runs[col])
    return np.where(valid, v, 0.0)


def emulate_fwd(cc, bc, xf, da, runs):
    """ssd_fwd_kernel over its whole grid."""
    nch, cs, g, n_state = cc.shape
    h = xf.shape[3]
    nt = cs // TILE
    y = np.full(xf.shape, np.nan)
    for ch in range(nch):
        for grp in range(g):
            rs = None if runs is None else runs[ch]
            rng = None if runs is None else run_groups(rs)
            for by in range(nt):
                for bz in range(-(-h // HB)):
                    i, h0 = nt - 1 - by, bz * HB
                    nh = min(HB, h - h0)
                    a_s = da[ch, :, grp, h0:h0 + nh].T
                    cache = np.zeros((4, 8, 4, 128))
                    s_phase(cache, cc[ch, :, grp], bc[ch, :, grp], i, 0,
                            i + 1)
                    steps = (nh + 1) // 2 * (i + 1)
                    ring = {}

                    def stage(k, quad):
                        hn, jn = 2 * (k // (i + 1)) + quad, k % (i + 1)
                        if hn < nh:
                            ring[k & 1, quad] = xf[
                                ch, jn * TILE:(jn + 1) * TILE, grp, h0 + hn]

                    for quad in range(2):
                        stage(0, quad)
                    acc = {}
                    for k in range(steps):
                        for quad in range(2):
                            if k + 1 < steps:
                                stage(k + 1, quad)
                        for quad in range(2):
                            hl, j = 2 * (k // (i + 1)) + quad, k % (i + 1)
                            if hl >= nh:
                                continue
                            for wq in range(4):
                                _fwd_warp(acc, quad, wq, hl, i, j, a_s,
                                          cache, ring[k & 1, quad], rs, rng)
                                if j == i:
                                    row0 = i * TILE + wq * 16
                                    for r in range(2):
                                        for dn in range(8):
                                            for e in range(2):
                                                y[ch, row0 + GR + 8 * r, grp,
                                                  h0 + hl,
                                                  dn * 8 + 2 * TH + e] = \
                                                    acc[quad, wq][dn][2 * r + e]
    return y


def _fwd_warp(acc, quad, wq, hl, i, j, a_s, cache, xs, rs, rng):
    if j == 0:
        acc[quad, wq] = np.zeros((8, 4, 32))
    skip, edge = False, j == i
    if rs is not None:
        m_, single = meet(rng, i * 4 + wq, j)
        skip, edge = not m_, edge or not single
    if skip:
        return
    arow = a_s[hl]
    row0 = i * TILE + wq * 16
    al = (arow[row0 + GR], arow[row0 + GR + 8])
    for kk in range(8):
        col = j * TILE + kk * 8 + 2 * TH
        m = []
        for e in range(4):
            sv = cache[j, kk, e, wq * 32 + LANE]
            v = sv * np.exp(al[e >> 1] - arow[col + (e & 1)])
            m.append(_masked(v, edge, row0 + GR + 8 * (e >> 1),
                             col + (e & 1), rs, lambda c, r: c <= r))
        a = a_from_c(np.stack(m))
        for dn in range(8):
            acc[quad, wq][dn] = mma(acc[quad, wq][dn], a,
                                    b_perm(xs, kk * 8, dn * 8))


def emulate_bwd_dx(cc, bc, xf, da, dy, runs):
    """ssd_bwd_dx_kernel over its whole grid: dX and the column half of
    dA."""
    nch, cs, g, n_state = cc.shape
    h = xf.shape[3]
    nt = cs // TILE
    dx = np.full(xf.shape, np.nan)
    cols = np.full(da.shape, np.nan)
    for ch in range(nch):
        for grp in range(g):
            rs = None if runs is None else runs[ch]
            rng = None if runs is None else run_groups(rs)
            for j in range(nt):
                for bz in range(-(-h // HB)):
                    h0 = bz * HB
                    nh, ni = min(HB, h - h0), nt - j
                    a_s = da[ch, :, grp, h0:h0 + nh].T
                    cache = np.zeros((4, 8, 4, 128))
                    s_phase(cache, bc[ch, :, grp], cc[ch, :, grp], j, j, ni)
                    steps = (nh + 1) // 2 * ni
                    ring = {}

                    def stage(k, quad):
                        hn, i_n = 2 * (k // ni) + quad, j + k % ni
                        if hn < nh:
                            ring[k & 1, quad] = dy[
                                ch, i_n * TILE:(i_n + 1) * TILE, grp, h0 + hn]

                    for quad in range(2):
                        stage(0, quad)
                    regs = {}
                    for k in range(steps):
                        for quad in range(2):
                            if k + 1 < steps:
                                stage(k + 1, quad)
                        for quad in range(2):
                            hl, i = 2 * (k // ni) + quad, j + k % ni
                            if hl >= nh:
                                continue
                            for wq in range(4):
                                srow0 = j * TILE + wq * 16
                                if i == j:
                                    xt = xf[ch, :, grp, h0 + hl]
                                    regs[quad, wq] = (
                                        [a_frag(xt, srow0, kk * 8)
                                         for kk in range(8)],
                                        np.zeros((8, 4, 32)),
                                        np.zeros((2, 32)))
                                _dx_warp(regs[quad, wq], wq, hl, i, j, a_s,
                                         cache, ring[k & 1, quad], rs, rng)
                                if i == nt - 1:
                                    _, acc, dacc = regs[quad, wq]
                                    for r in range(2):
                                        row = srow0 + GR + 8 * r
                                        cols[ch, row, grp, h0 + hl] = \
                                            -dacc[r].reshape(8, 4).sum(1)[GR]
                                        for dn in range(8):
                                            for e in range(2):
                                                dx[ch, row, grp, h0 + hl,
                                                   dn * 8 + 2 * TH + e] = \
                                                    acc[dn][2 * r + e]
    return dx, cols


def _dx_warp(regs, wq, hl, i, j, a_s, cache, ys, rs, rng):
    xa, acc, dacc = regs
    skip, edge = False, i == j
    if rs is not None:
        m_, single = meet(rng, j * 4 + wq, i)
        skip, edge = not m_, edge or not single
    if skip:
        return
    dm = np.zeros((8, 4, 32))
    for kk in range(8):
        for n in range(8):
            dm[n] = mma(dm[n], xa[kk], b_rows(ys, n * 8, kk * 8))
    arow = a_s[hl]
    srow0 = j * TILE + wq * 16
    as_ = (arow[srow0 + GR], arow[srow0 + GR + 8])
    for kk in range(8):
        col = i * TILE + kk * 8 + 2 * TH
        m = []
        for e in range(4):
            sv = cache[i - j, kk, e, wq * 32 + LANE]
            v = sv * np.exp(arow[col + (e & 1)] - as_[e >> 1])
            v = _masked(v, edge, srow0 + GR + 8 * (e >> 1), col + (e & 1),
                        rs, lambda c, r: c >= r)
            m.append(v)
            dacc[e >> 1] += dm[kk][e] * v
        a = a_from_c(np.stack(m))
        for dn in range(8):
            acc[dn] = mma(acc[dn], a, b_perm(ys, kk * 8, dn * 8))


def emulate_bwd_ds(cc, bc, xf, da, dy, runs):
    """ssd_bwd_ds_kernel over its whole grid: dS's tiles on and below the
    diagonal and the row half of dA, slot by slot."""
    nch, cs, g, n_state = cc.shape
    h = xf.shape[3]
    nt = cs // TILE
    ds = np.zeros((nch, g, cs, cs))
    rows = np.zeros((nt,) + da.shape)
    for ch in range(nch):
        for grp in range(g):
            rs = None if runs is None else runs[ch]
            rng = None if runs is None else run_groups(rs)
            for pair in range(nt * (nt + 1) // 2):
                i, j = 0, pair
                while j > i:
                    i += 1
                    j -= i
                if rs is not None and not any(
                        meet(rng, i * 4 + w, j)[0] for w in range(4)):
                    continue
                c_t = cc[ch, i * TILE:(i + 1) * TILE, grp]
                b_t = bc[ch, j * TILE:(j + 1) * TILE, grp]
                for wq in range(4):
                    sv = np.zeros((8, 4, 32))
                    for kk in range(n_state // 8):
                        a = a_frag(c_t, wq * 16, kk * 8)
                        for n in range(8):
                            sv[n] = mma(sv[n], a, b_rows(b_t, n * 8, kk * 8))
                    skip, edge = False, i == j
                    if rs is not None:
                        m_, single = meet(rng, i * 4 + wq, j)
                        skip, edge = not m_, edge or not single
                    if skip:
                        continue
                    row0 = i * TILE + wq * 16
                    dsum = np.zeros((8, 4, 32))
                    for hh in range(h):
                        y_t = dy[ch, i * TILE:(i + 1) * TILE, grp, hh]
                        x_t = xf[ch, j * TILE:(j + 1) * TILE, grp, hh]
                        dm = np.zeros((8, 4, 32))
                        for kk in range(8):
                            a = a_frag(y_t, wq * 16, kk * 8)
                            for n in range(8):
                                dm[n] = mma(dm[n], a, b_rows(x_t, n * 8,
                                                             kk * 8))
                        al = (da[ch, row0 + GR, grp, hh],
                              da[ch, row0 + GR + 8, grp, hh])
                        rsum = np.zeros((2, 32))
                        for n in range(8):
                            for e in range(4):
                                col = j * TILE + n * 8 + 2 * TH + (e & 1)
                                lv = np.exp(al[e >> 1] - da[ch, col, grp, hh])
                                lv = _masked(lv, edge, row0 + GR + 8 * (e >> 1),
                                             col, rs, lambda c, r: c <= r)
                                dsum[n][e] += dm[n][e] * lv
                                rsum[e >> 1] += dm[n][e] * (sv[n][e] * lv)
                        for r in range(2):
                            rows[j, ch, row0 + GR + 8 * r, grp, hh] = \
                                rsum[r].reshape(8, 4).sum(1)[GR]
                    for r in range(2):
                        for n in range(8):
                            for e in range(2):
                                ds[ch, grp, row0 + GR + 8 * r,
                                   j * TILE + n * 8 + 2 * TH + e] = \
                                    dsum[n][2 * r + e]
    return ds, rows


@pytest.mark.parametrize("cs,g,h,n,kind", [(128, 1, 11, 64, None),
                                           (192, 2, 3, 128, "short"),
                                           (256, 1, 2, 64, "back")])
def test_kernel_loops_emulated_are_the_plain_versions(cs, g, h, n, kind):
    """The three kernels' loops (two head blocks and a ragged one at 11
    heads; every other head to each quad; skipped tiles and pairs on
    packed runs) give the plain versions' forward and backward, float64
    (sum order only)."""
    bsz, nc = 1, 2
    cc, bc, xf, da = _term_inputs(bsz, nc, cs, g, h, 64, n, seed=cs)
    da_cum = torch.cumsum(da, 2)
    runs = (None if kind is None
            else _chunk_runs(_run_ids(nc * cs, kind)[:1], nc, cs))
    dy = torch.randn(xf.shape, generator=torch.Generator().manual_seed(9),
                     dtype=F64)
    flat = [t.flatten(0, 1).numpy() for t in (cc, bc, xf, da_cum, dy)]
    rf = None if runs is None else runs.flatten(0, 1).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        y = emulate_fwd(*flat[:4], rf)
        dx, cols = emulate_bwd_dx(*flat, rf)
        ds, rows = emulate_bwd_ds(*flat, rf)
    want = ref.ssd_chunk_ref(cc, bc, xf, da_cum, runs).flatten(0, 1)
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-10, atol=1e-10)
    dcc, dbc, dxf, dda = (t.flatten(0, 1).numpy() for t in
                          ref.ssd_chunk_bwd_ref(cc, bc, xf, da_cum, dy, runs))
    ccn, bcn = flat[0], flat[1]
    # the wrapper's two products and sum
    got_dcc = np.einsum("cgls,csgn->clgn", ds, bcn)
    got_dbc = np.einsum("cgls,clgn->csgn", ds, ccn)
    scale = max(1.0, np.abs(dda).max())
    np.testing.assert_allclose(dx, dxf, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got_dcc, dcc, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(got_dbc, dbc, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(rows.sum(0) + cols, dda, rtol=1e-10,
                               atol=1e-10 * scale)
    assert math.isfinite(float(np.abs(y).max()))


def b_krows(tile, k0, n0):
    """The B fragment down a tile's rows k0 + t, + 4 at column n0 + g."""
    return np.stack([tile[k0 + TH, n0 + GR], tile[k0 + TH + 4, n0 + GR]])


def emulate_gather(u, v, w):
    """ssd_gather_kernel: R_h = sum_l w U_h^T V, rows p by warp."""
    nch, cs, g, h, p = u.shape
    n_state = v.shape[3]
    r = np.full((nch, g, h, p, n_state), np.nan)
    for ch in range(nch):
        for grp in range(g):
            for hh in range(h):
                for wq in range(4):
                    acc = np.zeros((n_state // 8, 4, 32))
                    for k in range(cs // TILE):
                        ut = u[ch, k * TILE:(k + 1) * TILE, grp, hh]
                        vt = v[ch, k * TILE:(k + 1) * TILE, grp]
                        ws = w[ch, k * TILE:(k + 1) * TILE, grp, hh]
                        for kk in range(8):
                            ka, kb = kk * 8 + TH, kk * 8 + TH + 4
                            a = np.stack([ut[ka, wq * 16 + GR] * ws[ka],
                                          ut[ka, wq * 16 + GR + 8] * ws[ka],
                                          ut[kb, wq * 16 + GR] * ws[kb],
                                          ut[kb, wq * 16 + GR + 8] * ws[kb]])
                            for dn in range(n_state // 8):
                                acc[dn] = mma(acc[dn], a,
                                              b_krows(vt, kk * 8, dn * 8))
                    for i in range(2):
                        for dn in range(n_state // 8):
                            for e in range(2):
                                r[ch, grp, hh, wq * 16 + GR + 8 * i,
                                  dn * 8 + 2 * TH + e] = acc[dn][2 * i + e]
    return r


def emulate_apply(v, wm, w, base):
    """ssd_apply_kernel: base + w V W_h^T, rows l by warp."""
    nch, cs, g, n_state = v.shape
    h = w.shape[3]
    out = np.full(w.shape + (64,), np.nan)
    for ch in range(nch):
        for grp in range(g):
            for i in range(cs // TILE):
                vt = v[ch, i * TILE:(i + 1) * TILE, grp]
                for hh in range(h):
                    for wq in range(4):
                        rows = i * TILE + wq * 16 + GR
                        wl0, wl1 = w[ch, rows, grp, hh], \
                            w[ch, rows + 8, grp, hh]
                        acc = np.zeros((8, 4, 32))
                        for kk in range(n_state // 8):
                            raw = a_frag(vt, wq * 16, kk * 8)
                            a = raw * np.stack([wl0, wl1, wl0, wl1])
                            for dn in range(8):
                                acc[dn] = mma(acc[dn], a,
                                              b_rows(wm[ch, grp, hh], dn * 8,
                                                     kk * 8))
                        for r in range(2):
                            for dn in range(8):
                                for e in range(2):
                                    at = (ch, rows + 8 * r, grp, hh,
                                          dn * 8 + 2 * TH + e)
                                    out[at] = acc[dn][2 * r + e] + (
                                        0 if base is None else base[at])
    return out


def emulate_cross(u, wm, v, w):
    """ssd_cross_kernel: Z_h = U_h W_h, dV = sum_h w Z_h, dw = V . Z_h."""
    nch, cs, g, h, p = u.shape
    n_state = v.shape[3]
    dv = np.full(v.shape, np.nan)
    dw = np.full(w.shape, np.nan)
    for ch in range(nch):
        for grp in range(g):
            for i in range(cs // TILE):
                vt = v[ch, i * TILE:(i + 1) * TILE, grp]
                for wq in range(4):
                    rows = i * TILE + wq * 16 + GR
                    dvacc = np.zeros((n_state // 8, 4, 32))
                    for hh in range(h):
                        ut = u[ch, i * TILE:(i + 1) * TILE, grp, hh]
                        z = np.zeros((n_state // 8, 4, 32))
                        for kk in range(8):
                            a = a_frag(ut, wq * 16, kk * 8)
                            for dn in range(n_state // 8):
                                z[dn] = mma(z[dn], a,
                                            b_krows(wm[ch, grp, hh], kk * 8,
                                                    dn * 8))
                        wl = (w[ch, rows, grp, hh], w[ch, rows + 8, grp, hh])
                        dsum = np.zeros((2, 32))
                        for dn in range(n_state // 8):
                            for r in range(2):
                                for e in range(2):
                                    dvacc[dn][2 * r + e] += wl[r] * \
                                        z[dn][2 * r + e]
                                    dsum[r] += vt[wq * 16 + GR + 8 * r,
                                                  dn * 8 + 2 * TH + e] * \
                                        z[dn][2 * r + e]
                        for r in range(2):
                            dw[ch, rows + 8 * r, grp, hh] = \
                                dsum[r].reshape(8, 4).sum(1)[GR]
                    for r in range(2):
                        for dn in range(n_state // 8):
                            for e in range(2):
                                dv[ch, rows + 8 * r, grp,
                                   dn * 8 + 2 * TH + e] = dvacc[dn][2 * r + e]
    return dv, dw


@pytest.mark.parametrize("cs,g,h,n", [(128, 2, 3, 64), (64, 1, 2, 128)])
def test_state_kernels_emulated_are_the_plain_versions(cs, g, h, n):
    """gather, apply (with and without a base) and cross, lane by lane,
    against ``ref.ssd_gather_ref`` / ``ssd_apply_ref`` / ``ssd_cross_ref``
    in float64."""
    gen = torch.Generator().manual_seed(cs + n)
    u = torch.randn(1, 2, cs, g, h, 64, generator=gen, dtype=F64)
    v = torch.randn(1, 2, cs, g, n, generator=gen, dtype=F64)
    w = torch.rand(1, 2, cs, g, h, generator=gen, dtype=F64)
    wm = torch.randn(1, 2, g, h, 64, n, generator=gen, dtype=F64)
    base = torch.randn(u.shape, generator=gen, dtype=F64)

    def flat(t):
        return t.flatten(0, 1).numpy()

    np.testing.assert_allclose(emulate_gather(flat(u), flat(v), flat(w)),
                               flat(ref.ssd_gather_ref(u, v, w)),
                               rtol=1e-10, atol=1e-10)
    for b in (None, base):
        np.testing.assert_allclose(
            emulate_apply(flat(v), flat(wm), flat(w),
                          None if b is None else flat(b)),
            flat(ref.ssd_apply_ref(v, wm, w, b)), rtol=1e-10, atol=1e-10)
    for got, want in zip(emulate_cross(flat(u), flat(wm), flat(v), flat(w)),
                         ref.ssd_cross_ref(u, wm, v, w)):
        np.testing.assert_allclose(got, flat(want), rtol=1e-10, atol=1e-9)
