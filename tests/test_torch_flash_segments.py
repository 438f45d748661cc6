"""Segment ids in the flash route, on the CPU.

Packed batches carry ``segment_ids``; the port's flash kernels take them
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), where the
reference's attention turns plain.  Here:

* the plain versions with ids (``kernels.ref.flash_attention_ref`` /
  ``_lse_ref`` / ``_bwd_ref``, what the flash route runs on a CPU tensor)
  equal the plain chunked route (``models.attention._attend_chunk``),
  forward and gradient, in float32 and in float64 (``gradcheck`` of
  ``FlashAttentionFn``): causal and not, GQA groups 1 and 7, contiguous
  runs with a one-token document, documents across the 64-row tile edges
  and a pad tail of 0, and ids in no order;
* the segment pre-pass: its plain version's ranges hold every visible pair
  for any ids, and on packed documents are the span of each tile's own
  documents; the pre-pass kernel's two phases, transcribed line by line,
  give the plain version's records;
* the forward kernels' tile loops emulated in NumPy (fp32 arithmetic): the
  range from the pre-pass inside the causal bound, kv tiles of 64 rows
  (bf16) and 32 (fp32 at D = 128), a warp skipping a tile whose id
  interval misses its rows', the per-pair test of the ids only on a tile
  that is not one segment on both sides; a wrong rule is caught (the
  backward kernels' loops are emulated with ids in
  ``tests/test_torch_flash_bwd_mma.py``);
* the route: ids with head dim 64 / 128 take flash, head dim 80 and kv ids
  of another length stay plain; a packed qwen2 loss runs no plain chunk.

The kernels themselves are held against the plain versions on the card in
``tests/test_torch_flash_segments_card.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import attention

from _torch_segments import IDS, packed_ids, unordered_ids

TILE = ref.SEG_TILE
WARP = 16
NEG_INF = np.float32(-1e30)


def _qkv(b, s, h, hk, d, dtype=torch.float32, seed=0):
    """q (B, S, H, D), k, v (B, S, Hkv, D): the model's layout."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, d, generator=gen, dtype=dtype),
            torch.randn(b, s, hk, d, generator=gen, dtype=dtype),
            torch.randn(b, s, hk, d, generator=gen, dtype=dtype))


def _plain_route(q, k, v, causal, ids):
    """The plain chunked route's one chunk over the whole sequence."""
    g = q.shape[2] // k.shape[2]
    kr, vr = (x.repeat_interleave(g, dim=2) for x in (k, v))
    return attention._attend_chunk(q, kr, vr, 0, ids, ids, causal, 0,
                                   1.0 / math.sqrt(q.shape[3]), q.dtype)


ROUTE_CASES = [(kind, causal, h, hk) for kind in IDS
               for causal in (True, False) for h, hk in ((7, 1), (2, 2))]


@pytest.mark.parametrize("kind,causal,h,hk", ROUTE_CASES)
def test_plain_versions_with_ids_equal_the_plain_route(kind, causal, h, hk):
    """float32, at S = 150 (three 64-row tiles, the last ragged): the flash
    route's output and its gradients (the plain versions with ids) equal
    the plain route's within float32 rounding of the same sums."""
    b, s, d = 2, 150, 64
    ids = torch.from_numpy(IDS[kind](b, s))
    q, k, v = (x.requires_grad_() for x in _qkv(b, s, h, hk, d))
    got = attention.chunked_attention(q, k, v, causal=causal,
                                      segment_ids=ids)
    want = _plain_route(q, k, v, causal, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    dout = torch.randn_like(got)
    for g, w, name in zip(torch.autograd.grad(got, (q, k, v), dout),
                          torch.autograd.grad(want, (q, k, v), dout),
                          "qkv"):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=f"d{name}")


@pytest.mark.parametrize("kind,causal", [("packed", True),
                                         ("unordered", False),
                                         ("repeated", True)])
def test_flash_function_with_ids_gradcheck_float64(kind, causal):
    """``FlashAttentionFn`` with ids in float64 (its saved ids, the GQA
    sum): ``gradcheck``, and its values equal to the plain route's (whose
    logits are float32 whatever the inputs)."""
    b, s, h, hk, d = 1, 70, 2, 1, 64
    ids = torch.from_numpy(IDS[kind](b, s))
    q, k, v = (x.transpose(1, 2).contiguous().requires_grad_()
               for x in _qkv(b, s, h, hk, d, torch.float64, seed=3))

    def fn(q, k, v):
        return fa.FlashAttentionFn.apply(q, k, v, causal, 0.125, ids, ids)

    assert torch.autograd.gradcheck(fn, (q, k, v), fast_mode=True)
    want = _plain_route(*(x.transpose(1, 2) for x in (q, k, v)), causal,
                        ids).transpose(1, 2)
    torch.testing.assert_close(fn(q, k, v), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the segment pre-pass
# ---------------------------------------------------------------------------

def _visible(seg_q, seg_k, causal):
    """(B, Sq, Sk) bool: the pairs the plain route lets through."""
    sq, sk = seg_q.shape[1], seg_k.shape[1]
    vis = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        vis &= (np.arange(sq)[:, None] + sk - sq
                >= np.arange(sk)[None, :])[None]
    return vis


TILE_CASES = [("packed", 150, 150), ("unordered", 150, 150),
              ("repeated", 300, 300), ("unordered", 100, 200),
              ("repeated", 200, 70), ("packed", 1, 150)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind,sq,sk", TILE_CASES)
def test_segment_tiles_hold_every_visible_pair(kind, sq, sk, causal):
    """Every visible pair (i, j) lies in q tile i // 64's range of keys and
    in K tile j // 64's range of q rows, and each record's bounds and
    count are its tile's."""
    seg_q = IDS[kind](2, sq)
    seg_k = IDS[kind](2, sk) if kind != "unordered" else unordered_ids(
        2, sk, seed=1)
    tiles = ref.flash_segment_tiles_ref(torch.from_numpy(seg_q),
                                        torch.from_numpy(seg_k),
                                        causal).numpy()
    nq = -(-sq // TILE)
    for bb, i, j in zip(*np.nonzero(_visible(seg_q, seg_k, causal))):
        lo, hi = tiles[bb, i // TILE, 2:4]
        assert lo <= j < hi, (bb, i, j, lo, hi)
        lo, hi = tiles[bb, nq + j // TILE, 2:4]
        assert lo <= i < hi, (bb, i, j, lo, hi)
    for side, ids, first in ((seg_q, seg_q, 0), (seg_k, seg_k, nq)):
        for t in range(-(-ids.shape[1] // TILE)):
            part = ids[:, t * TILE:(t + 1) * TILE]
            rec = tiles[:, first + t]
            np.testing.assert_array_equal(rec[:, 0], part.min(1))
            np.testing.assert_array_equal(rec[:, 1], part.max(1))
            count = [len(np.unique(r)) for r in part]
            np.testing.assert_array_equal(rec[:, 7], np.minimum(count, 4))
            assert all(r[2] % TILE == 0 for r in rec), rec


def _documents(b, s, seed, min_len=40):
    """Packed rows of documents (Poisson lengths, at least ``min_len``:
    at most three ids in a 64-row tile), each row ending in pads."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        pos, doc = 0, 1
        while True:
            n = max(min_len, int(rng.poisson(100)))
            if pos + n > s - 30:
                break
            out[i, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return out


@pytest.mark.parametrize("causal", [True, False])
def test_segment_tiles_span_the_documents_on_packed_rows(causal):
    """Packed documents, at most three ids a tile: each q tile's range is
    exactly the tiles that hold a visible pair of it (its documents' keys
    up to its diagonal), and each K tile's the q tiles that see it."""
    ids = _documents(3, 1000, seed=4)
    tiles = ref.flash_segment_tiles_ref(*(torch.from_numpy(ids),) * 2,
                                        causal).numpy()
    vis = _visible(ids, ids, causal)
    n = -(-1000 // TILE)
    for bb in range(3):
        for side in range(2):
            for t in range(n):
                part = (vis[bb, t * TILE:(t + 1) * TILE] if side == 0 else
                        vis[bb, :, t * TILE:(t + 1) * TILE].T)
                other = np.nonzero(part.any(0))[0]
                lo = other.min() // TILE * TILE
                hi = min(-(-(other.max() + 1) // TILE) * TILE, 1000)
                assert tuple(tiles[bb, side * n + t, 2:4]) == (lo, hi)


def transcribed_pre_pass(seg_q: np.ndarray, seg_k: np.ndarray,
                         causal: bool) -> np.ndarray:
    """``flash_seg_tiles_kernel``'s two phases, line by line (each tile's
    ids in order, the slots as first seen, then sorted)."""
    b, sq = seg_q.shape
    sk = seg_k.shape[1]
    nq, nk = -(-sq // TILE), -(-sk // TILE)
    rec = np.zeros((b, nq + nk, 8), np.int64)
    for bb in range(b):
        for t in range(nq + nk):
            is_q = t < nq
            ids = seg_q[bb] if is_q else seg_k[bb]
            r0 = (t if is_q else t - nq) * TILE
            r1 = min(r0 + TILE, len(ids))
            lo = hi = int(ids[r0])
            slot, count = [lo] * 3, 1
            for r in range(r0 + 1, r1):
                x = int(ids[r])
                lo, hi = min(lo, x), max(hi, x)
                seen = any(i < count and slot[i] == x for i in range(3))
                if not seen and count <= 3:
                    if count < 3:
                        slot[count] = x
                    count += 1
            if count > 3:
                slot = [lo] * 3
            else:
                for _ in range(3):
                    for j in range(2):
                        if j + 1 < count and slot[j] > slot[j + 1]:
                            slot[j], slot[j + 1] = slot[j + 1], slot[j]
                slot = [slot[i] if i < count else slot[0] for i in range(3)]
            rec[bb, t, [0, 1, 4, 5, 6, 7]] = [lo, hi, *slot, count]
        for t in range(nq + nk):
            is_q = t < nq
            me = rec[bb, t]
            first_other, n_other = (nq, nk) if is_q else (0, nq)
            first = last = -1
            for u in range(n_other):
                if causal:
                    tq, tk = (t, u) if is_q else (u, t - nq)
                    row = min((tq + 1) * TILE, sq) - 1
                    if tk * TILE > row + (sk - sq):
                        if is_q:
                            break
                        continue
                o = rec[bb, first_other + u]
                if me[7] <= 3 and o[7] <= 3:
                    meet = bool(set(o[4:7]) & set(me[4:7]))
                else:
                    meet = me[0] <= o[1] and o[0] <= me[1]
                if meet:
                    first = u if first < 0 else first
                    last = u
            rows = sk if is_q else sq
            rec[bb, t, 2] = 0 if first < 0 else first * TILE
            rec[bb, t, 3] = 0 if first < 0 else min((last + 1) * TILE, rows)
    return rec


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind,sq,sk", TILE_CASES)
def test_pre_pass_kernel_transcribed_equals_the_plain_version(kind, sq, sk,
                                                              causal):
    seg_q = IDS[kind](2, sq)
    seg_k = IDS[kind](2, sk) if kind != "unordered" else unordered_ids(
        2, sk, seed=1)
    want = ref.flash_segment_tiles_ref(torch.from_numpy(seg_q),
                                       torch.from_numpy(seg_k), causal)
    np.testing.assert_array_equal(transcribed_pre_pass(seg_q, seg_k, causal),
                                  want.numpy())


# ---------------------------------------------------------------------------
# the forward kernels' tile loops
# ---------------------------------------------------------------------------

def _warp_bounds(ids: np.ndarray):
    """(least, largest) id of a warp's valid rows; (big, small) for none."""
    if ids.size == 0:
        return 2 ** 31 - 1, -2 ** 31
    return int(ids.min()), int(ids.max())


def emulate_forward(q, k, v, causal, seg_q, seg_k, tiles, bk, split_rule=True):
    """The segmented forward kernels' loops in fp32 on ``(B, H, S, D)``
    arrays: per 64-row q tile, the kv tiles ``[lower, upper)`` of ``bk``
    rows (the pre-pass's range inside the causal bound); per warp of 16
    rows, a tile whose id interval misses the rows' is skipped, and the
    mask (causal, Sk, ids) applies only to an edge tile.  Returns the
    output (0 on rows that see no key) and lse."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group, off = h // hk, sk - sq
    scale = np.float32(1.0 / math.sqrt(d))
    out = np.zeros_like(q)
    lse = np.full((b, h, sq), -np.inf, np.float32)
    nq, nk = -(-sq // TILE), -(-sk // bk)
    for bb in range(b):
        for hh in range(h):
            for qt in range(nq):
                q0 = qt * TILE
                upper = nk
                if causal:
                    last = min(q0 + TILE, sq) - 1 + off
                    upper = 0 if last < 0 else min(last // bk + 1, nk)
                rec = tiles[bb, qt]
                lower = rec[2] // bk
                upper = min(upper, -(-rec[3] // bk))
                for w in range(TILE // WARP):
                    qw0 = q0 + WARP * w
                    rows = np.arange(qw0, min(qw0 + WARP, sq))
                    if rows.size == 0:
                        continue
                    w_lo, w_hi = _warp_bounds(seg_q[bb, rows])
                    m = np.full(rows.size, NEG_INF, np.float32)
                    l = np.zeros(rows.size, np.float32)
                    acc = np.zeros((rows.size, d), np.float32)
                    for j in range(lower, upper):
                        k0 = j * bk
                        kr = tiles[bb, nq + k0 // TILE]
                        if causal and k0 > qw0 + 15 + off:
                            continue
                        if not (w_lo <= kr[1] and kr[0] <= w_hi):
                            continue
                        split = not (w_lo == w_hi and kr[0] == kr[1]
                                     and w_lo == kr[0])
                        edge = ((causal and k0 + bk - 1 > qw0 + off)
                                or k0 + bk > sk or (split and split_rule))
                        keys = np.arange(k0, k0 + bk)
                        kt = np.zeros((bk, d), np.float32)
                        vt = np.zeros((bk, d), np.float32)
                        inside = keys[keys < sk]
                        kt[:inside.size] = k[bb, hh // group, inside]
                        vt[:inside.size] = v[bb, hh // group, inside]
                        s = (q[bb, hh, rows] @ kt.T) * scale
                        if edge:
                            safe = np.minimum(keys, sk - 1)
                            valid = ((keys[None, :] < sk)
                                     & (seg_k[bb, safe][None, :]
                                        == seg_q[bb, rows][:, None]))
                            if causal:
                                valid &= rows[:, None] + off >= keys[None, :]
                            s = np.where(valid, s, NEG_INF)
                        m_new = np.maximum(m, s.max(1))
                        alpha = np.exp(m - m_new)
                        p = np.where(s > NEG_INF / 2,
                                     np.exp(s - m_new[:, None]), 0)
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ vt
                        m = m_new
                    seen = l > 0
                    lse[bb, hh, rows[seen]] = m[seen] + np.log(l[seen])
                    out[bb, hh, rows] = acc / np.where(seen, l, 1)[:, None]
    return out, lse


FWD_CASES = [("packed", True, 64), ("packed", False, 64),
             ("repeated", True, 64), ("unordered", True, 64),
             ("unordered", False, 32), ("packed", True, 32)]


@pytest.mark.parametrize("kind,causal,bk", FWD_CASES)
def test_forward_tile_loops_with_ids_emulated(kind, causal, bk):
    """The loops (bf16 kernel: kv tiles of 64; fp32 at D = 128: 32) give
    the plain version's output and lse on every row that sees a key."""
    b, s, h, hk, d = 2, 150, 4, 2, 64
    seg = IDS[kind](b, s)
    q, k, v = (x.transpose(1, 2).contiguous().numpy()
               for x in _qkv(b, s, h, hk, d, seed=5))
    tiles = ref.flash_segment_tiles_ref(*(torch.from_numpy(seg),) * 2,
                                        causal).numpy()
    got, got_lse = emulate_forward(q, k, v, causal, seg, seg, tiles, bk)
    want, want_lse = ref.flash_attention_lse_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse, want_lse.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_a_missing_segment_edge_is_caught():
    """With the segment edge left out of the mask test (a tile across a
    document boundary taken as interior), the emulation leaves the plain
    version: the emulation would catch a kernel that did so."""
    b, s, h, hk, d = 2, 150, 2, 1, 64
    seg = packed_ids(b, s)
    q, k, v = (x.transpose(1, 2).contiguous().numpy()
               for x in _qkv(b, s, h, hk, d, seed=6))
    tiles = ref.flash_segment_tiles_ref(*(torch.from_numpy(seg),) * 2,
                                        False).numpy()
    got, _ = emulate_forward(q, k, v, False, seg, seg, tiles, 64,
                             split_rule=False)
    want = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=False,
                                   segment_ids=torch.from_numpy(seg))
    assert np.abs(got - want.numpy()).max() > 1e-2


def test_all_equal_ids_visit_the_unsegmented_tiles():
    """One id everywhere: each q tile's range is the whole causal row and
    no tile is a segment edge, so the segmented loops are the unsegmented
    ones (the card holds the two calls bit-equal)."""
    s = 300
    ones = torch.ones(2, s, dtype=torch.int32)
    for causal in (True, False):
        tiles = ref.flash_segment_tiles_ref(ones, ones, causal).numpy()
        n = -(-s // TILE)
        for t in range(n):
            end = min((t + 1) * TILE, s) if causal else s
            assert tuple(tiles[0, t, :4]) == (1, 1, 0, end)
            first = t * TILE if causal else 0
            assert tuple(tiles[0, n + t, :4]) == (1, 1, first, s)


# ---------------------------------------------------------------------------
# the route and its counters
# ---------------------------------------------------------------------------

def _counting(monkeypatch):
    calls = []
    fwd = kops.flash_attention

    def counting(*args, **kwargs):
        calls.append(kwargs.get("segment_ids") is not None)
        return fwd(*args, **kwargs)

    monkeypatch.setattr(kops, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("d,kv_len,route", [(64, 40, "flash"),
                                            (128, 40, "flash"),
                                            (80, 40, "plain"),
                                            (64, 1, "plain")])
def test_the_route_follows_the_head_dim_and_the_kv_ids(monkeypatch, d,
                                                       kv_len, route):
    """Ids with head dim 64 / 128 take flash with the ids; head dim 80, or
    kv ids of another length than Sk (here one id a row, which the plain
    route broadcasts), stay plain, one count a chunk."""
    calls = _counting(monkeypatch)
    q, k, v = _qkv(2, 40, 4, 2, d, seed=2)
    seg = torch.from_numpy(packed_ids(2, 40))
    kv = seg if kv_len == 40 else torch.full((2, 1), 3, dtype=torch.int32)
    before = attention.chunked_attention.plain_chunks
    got = attention.chunked_attention(q, k, v, segment_ids=seg,
                                      kv_segment_ids=kv, chunk=16)
    chunks = attention.chunked_attention.plain_chunks - before
    assert (calls, chunks) == (([True], 0) if route == "flash" else
                               ([], 3)), (calls, chunks)
    if kv_len == 1:
        want = attention.plain_chunked_attention(
            q, k, v, segment_ids=seg, kv_segment_ids=kv.expand(2, 40))
        torch.testing.assert_close(got, want)


def test_a_packed_qwen2_loss_runs_no_plain_chunk(monkeypatch):
    """A qwen2 layer at head dim 64 on a packed batch: its self attention
    takes the flash route with its ids (forward, remat recompute), and the
    plain route counts no chunk."""
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.models import LM
    from repro_torch.trees import tree_leaves

    cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              head_dim=64, num_layers=1)
    model = LM(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    leaves = [x.requires_grad_() for _, x in tree_leaves(params)]
    batch = next(make_train_batches(DataConfig(
        cfg.vocab_size, 64, 2, seed=2, mean_doc_len=12, min_doc_len=4)))
    assert batch["segment_ids"].max() > 1          # rows of several documents
    calls = _counting(monkeypatch)
    before = attention.chunked_attention.plain_chunks
    loss, _ = model.loss(params, {k: torch.from_numpy(x)
                                  for k, x in batch.items()
                                  if k != "next_doc"})
    loss.backward()
    assert attention.chunked_attention.plain_chunks == before
    assert calls == [True] * (2 * cfg.num_layers)
    assert torch.isfinite(loss) and all(
        torch.isfinite(x.grad).all() for x in leaves)


def test_the_kernel_wrapper_refuses_ids_that_do_not_fit():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, segment_ids=torch.ones(1, 9,
                                                           dtype=torch.int32))
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, segment_ids=torch.ones(1, 8))
    ok = fa.flash_attention(q, q, q,
                            segment_ids=torch.ones(1, 8, dtype=torch.int64))
    assert ok.shape == q.shape
