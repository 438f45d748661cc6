"""The bf16 flash backward's tensor-core kernels, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs bfloat16 through
``flash_bwd_dkdv_mma_kernel`` and ``flash_bwd_dq_mma_kernel`` (``mma.sync``,
fp32 sums) and, with the GQA split, ``flash_bwd_gqa_sum_kernel``.  They run
only on the card; here their blocks are emulated in NumPy, block by block:

* the tiles (64 K rows a dK/dV block, 64 q rows a dQ block, 64-row staged
  tiles zero-filled past Sq / Sk, their lse and D 0 there), the loop
  bounds (dK/dV from the causal diagonal's q tile on, over the q heads in
  order; dQ up to the diagonal's K tile), and per warp of 16 rows the skip
  of a tile it sees no pair of and the mask only on tiles the kernel calls
  an edge (an interior tile is taken unmasked, as the kernel takes it);
* P and dS rounded to bf16 before their products, the results rounded to
  bf16 once;
* the GQA sum inside the block, or the split: one q head a block, fp32
  partials (dK times the scale), summed in head order, rounded once.

With segment ids (the segmented instantiations) the blocks take their
loop bounds from the segment pre-pass's plain version
(``ref.flash_segment_tiles_ref``: a dK/dV block's range of q rows, a dQ
block's range of keys, each inside the causal bound), a warp skips a tile
whose id interval misses its own rows' (keys' in dK/dV), and the per-pair
test of the ids joins the mask only on a tile that is not one segment on
both sides.

The emulation is held against the plain ``flash_attention_bwd_ref``
within ``FLASH_BWD_BF16_TOL`` (``tests/_torch_card.py``) at
``FLASH_BWD_SWEEP``, at one reduced case of each of ``TRAIN_SHAPES`` and at
a ragged causal case whose first rows see no key, both ways of the GQA
sum; with segment ids on packed documents, on ids in no order and on ids
whose runs come back; and, with P and dS kept in fp32, within
``FLASH_BWD_FP32_TOL`` of the plain version in fp32: the rounding is the
only difference.  ``tests/test_torch_flash_card.py`` holds the kernels
themselves against the plain version on the card.
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

from benchmarks.torch_kernel_ab import TRAIN_SHAPES
from _torch_card import FLASH_BWD_BF16_TOL, FLASH_BWD_FP32_TOL, FLASH_BWD_SWEEP
from _torch_segments import IDS

ROWS = 64           # FBM_ROWS: K rows a dK/dV block, q rows a dQ block
WARP_ROWS = 16
LOG2E = np.float32(1.4426950408889634)
# (B, H, Hkv, Sq, Sk, D, causal): one reduced case of each TRAIN_SHAPES
# entry (whisper's encoder and cross attention, the vision cross attention
# with GQA 4, qwen2's causal self attention with GQA 7), and Sq > Sk causal
# whose first 60 rows see no key
REDUCED_TRAIN = {"whisper_encoder": (1, 2, 2, 150, 150, 64, False),
                 "whisper_cross": (1, 2, 2, 40, 150, 64, False),
                 "vision_cross": (1, 8, 2, 100, 96, 128, False),
                 "qwen2_causal": (1, 7, 1, 130, 130, 64, True)}
RAGGED = (1, 4, 2, 150, 90, 64, True)
CASES = ([(f"sweep {s}", s) for s in FLASH_BWD_SWEEP]
         + list(REDUCED_TRAIN.items()) + [("ragged", RAGGED)])


def _bf16(x: np.ndarray) -> np.ndarray:
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _tile(x: np.ndarray, row0: int) -> np.ndarray:
    """Rows row0 .. row0 + 63 of ``x`` (rows, D), zero past its end."""
    out = np.zeros((ROWS, x.shape[1]), np.float32)
    part = x[row0:row0 + ROWS]
    out[:len(part)] = part
    return out


def _rows(x: np.ndarray, row0: int) -> np.ndarray:
    """The 64 entries of a staged lse / D row, 0 past the end."""
    out = np.zeros(ROWS, np.float32)
    part = x[row0:row0 + ROWS]
    out[:len(part)] = part
    return out


def _p(s, lse, scale, keep):
    """exp2f((S * scale - lse) * log2 e) in fp32, 0 where not kept."""
    with np.errstate(over="ignore", invalid="ignore"):
        p = np.exp2((s * np.float32(scale) - lse) * LOG2E)
    return np.where(keep, p, np.float32(0)).astype(np.float32)


def dkdv_edge(causal, i0, kw0, sq, sk, offset):
    """The dK/dV kernel's mask test for q tile i0 and the warp's keys
    kw0 .. kw0 + 15: a pair past the diagonal, a row past Sq or a key
    past Sk."""
    return ((causal and i0 + offset < kw0 + 15) or i0 + ROWS > sq
            or kw0 + WARP_ROWS > sk)


def dq_edge(causal, k0, qw0, sq, sk, offset):
    """The dQ kernel's mask test for K tile k0 and the warp's q rows
    qw0 .. qw0 + 15."""
    return ((causal and k0 + ROWS - 1 > qw0 + offset) or k0 + ROWS > sk
            or qw0 + WARP_ROWS > sq)


def _bounds(ids):
    """(least, largest) of a warp's valid ids; (big, small) for none."""
    return (int(ids.min()), int(ids.max())) if ids.size else (2 ** 31 - 1,
                                                              -2 ** 31)


def _seg_warp(seg_ids, first, n, rec):
    """A warp of ``seg`` ids ``first .. first + 15`` (those below ``n``)
    against a tile's record: (sees, one segment) by the kernels' rules."""
    lo, hi = _bounds(seg_ids[first:min(first + WARP_ROWS, n)])
    return (lo <= rec[1] and rec[0] <= hi,
            lo == hi and rec[0] == rec[1] and lo == rec[0])


def _dkdv_block(q, k, v, do, lse, delta, b, heads, hk, k0, sh, scale,
                rounding, seg=None):
    """One ``flash_bwd_dkdv_mma_kernel`` block: dK (times the scale) and dV
    of keys k0 .. k0 + 63 summed over ``heads``, fp32 (64, D) each.  With
    ``seg`` (row b's q ids, kv ids and pre-pass records) the segmented
    instantiation."""
    sq, sk, causal, offset = sh
    keys = k0 + np.arange(ROWS)
    kt, vt = _tile(k[b, hk], k0), _tile(v[b, hk], k0)
    first = 0
    if causal and k0 - offset > 0:
        first = (k0 - offset) // ROWS * ROWS
    end = sq
    if seg is not None:
        seg_q, seg_k, tiles = seg
        nq = -(-sq // ROWS)
        rec = tiles[nq + k0 // ROWS]
        first, end = max(first, rec[2]), rec[3]
    dk = np.zeros_like(kt)
    dv = np.zeros_like(vt)
    for h in heads:
        for i0 in range(first, end, ROWS):
            rows = i0 + np.arange(ROWS)
            qt, dot = _tile(q[b, h], i0), _tile(do[b, h], i0)
            lse_t, dl_t = _rows(lse[b, h], i0), _rows(delta[b, h], i0)
            valid = ((keys[:, None] < sk) & (rows[None, :] < sq)
                     & ((not causal)
                        | (rows[None, :] + offset >= keys[:, None])))
            if seg is not None:
                valid &= (seg_k[np.minimum(keys, sk - 1)][:, None]
                          == seg_q[np.minimum(rows, sq - 1)][None, :])
            keep = np.zeros((ROWS, ROWS), bool)
            for w in range(ROWS // WARP_ROWS):
                kw0 = k0 + WARP_ROWS * w
                if causal and i0 + ROWS - 1 + offset < kw0:
                    continue                    # the warp skips the tile
                edge = dkdv_edge(causal, i0, kw0, sq, sk, offset)
                if seg is not None:
                    sees, one = _seg_warp(seg_k, kw0, sk, tiles[i0 // ROWS])
                    if not sees:
                        continue
                    edge = edge or not one
                part = slice(WARP_ROWS * w, WARP_ROWS * (w + 1))
                keep[part] = valid[part] if edge else True
            p = _p(kt @ qt.T, lse_t[None, :], scale, keep)
            ds = (p * (vt @ dot.T - dl_t[None, :])).astype(np.float32)
            if rounding:
                p, ds = _bf16(p), _bf16(ds)
            dv += p @ dot
            dk += ds @ qt
    return dk * np.float32(scale), dv


def _dq_block(q, k, v, do, lse, delta, b, h, hk, q0, sh, scale, rounding,
              seg=None):
    """One ``flash_bwd_dq_mma_kernel`` block: dQ (times the scale) of q
    rows q0 .. q0 + 63, fp32 (64, D); with ``seg`` as ``_dkdv_block``."""
    sq, sk, causal, offset = sh
    rows = q0 + np.arange(ROWS)
    qt, dot = _tile(q[b, h], q0), _tile(do[b, h], q0)
    lse_r, dl_r = _rows(lse[b, h], q0), _rows(delta[b, h], q0)
    nk = -(-sk // ROWS)
    upper = nk
    if causal:
        last = min(q0 + ROWS, sq) - 1 + offset
        upper = 0 if last < 0 else min(last // ROWS + 1, nk)
    lower = 0
    if seg is not None:
        seg_q, seg_k, tiles = seg
        nq = -(-sq // ROWS)
        rec = tiles[q0 // ROWS]
        lower, upper = rec[2] // ROWS, min(upper, -(-rec[3] // ROWS))
    dq = np.zeros_like(qt)
    for j in range(lower, upper):
        k0 = j * ROWS
        keys = k0 + np.arange(ROWS)
        kt, vt = _tile(k[b, hk], k0), _tile(v[b, hk], k0)
        valid = ((keys[None, :] < sk) & (rows[:, None] < sq)
                 & ((not causal) | (rows[:, None] + offset >= keys[None, :]))
                 )
        if seg is not None:
            valid &= (seg_q[np.minimum(rows, sq - 1)][:, None]
                      == seg_k[np.minimum(keys, sk - 1)][None, :])
        keep = np.zeros((ROWS, ROWS), bool)
        for w in range(ROWS // WARP_ROWS):
            qw0 = q0 + WARP_ROWS * w
            if causal and k0 > qw0 + 15 + offset:
                continue
            edge = dq_edge(causal, k0, qw0, sq, sk, offset)
            if seg is not None:
                sees, one = _seg_warp(seg_q, qw0, sq, tiles[nq + k0 // ROWS])
                if not sees:
                    continue
                edge = edge or not one
            part = slice(WARP_ROWS * w, WARP_ROWS * (w + 1))
            keep[part] = valid[part] if edge else True
        p = _p(qt @ kt.T, lse_r[:, None], scale, keep)
        ds = (p * (dot @ vt.T - dl_r[:, None])).astype(np.float32)
        if rounding:
            ds = _bf16(ds)
        dq += ds @ kt
    return dq * np.float32(scale)


def emulate_backward_mma(q, k, v, o, lse, do, causal, scale, split,
                         rounding=True, seg=None):
    """The bf16 kernels on float32 arrays holding bf16 values: ``(dq, dk,
    dv)`` as float32 arrays, rounded to bf16 when ``rounding`` (which also
    rounds P and dS before their products).  ``seg``: ``(q ids, kv ids,
    pre-pass records)``, each indexed by the batch row first."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    sh = (sq, sk, causal, sk - sq)

    def row(bb):
        return None if seg is None else tuple(x[bb] for x in seg)

    delta = (do * o).sum(-1, dtype=np.float32)
    out = _bf16 if rounding else (lambda x: x)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bb in range(b):
        for kh in range(hk):
            for k0 in range(0, sk, ROWS):
                n = min(ROWS, sk - k0)
                if split:               # fp32 partials, summed in order
                    parts = [_dkdv_block(q, k, v, do, lse, delta, bb, [hh],
                                         kh, k0, sh, scale, rounding,
                                         row(bb))
                             for hh in range(kh * group, (kh + 1) * group)]
                    bk, bv = parts[0]
                    for pk, pv in parts[1:]:
                        bk, bv = bk + pk, bv + pv
                else:
                    bk, bv = _dkdv_block(
                        q, k, v, do, lse, delta, bb,
                        range(kh * group, (kh + 1) * group), kh, k0, sh,
                        scale, rounding, row(bb))
                dk[bb, kh, k0:k0 + n] = out(bk[:n])
                dv[bb, kh, k0:k0 + n] = out(bv[:n])
    dq = np.zeros_like(q)
    for bb in range(b):
        for hh in range(h):
            for q0 in range(0, sq, ROWS):
                n = min(ROWS, sq - q0)
                dq[bb, hh, q0:q0 + n] = out(_dq_block(
                    q, k, v, do, lse, delta, bb, hh, hh // group, q0, sh,
                    scale, rounding, row(bb))[:n])
    return dq, dk, dv


def _inputs(shape, seed, ids=None):
    """bf16 q, k, v, dO (as float32 arrays), the plain forward's o in bf16
    (0 on rows that see no key, as the forward kernel gives) and lse."""
    b, h, hk, sq, sk, d, causal = shape
    rng = np.random.default_rng(seed)
    q, do = (_bf16(rng.standard_normal((b, h, sq, d)).astype(np.float32))
             for _ in range(2))
    k, v = (_bf16(rng.standard_normal((b, hk, sk, d)).astype(np.float32))
            for _ in range(2))
    o, lse = ref.flash_attention_lse_ref(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=causal,
        segment_ids=None if ids is None else torch.from_numpy(ids))
    o = torch.nan_to_num(o.float(), nan=0.0).numpy()
    return q, k, v, o, lse.numpy(), do


def _plain(q, k, v, o, lse, do, causal, dtype, ids=None):
    return [g.float().numpy() for g in ref.flash_attention_bwd_ref(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v, o)),
        torch.from_numpy(lse), torch.from_numpy(do).to(dtype),
        causal=causal,
        segment_ids=None if ids is None else torch.from_numpy(ids))]


def _assert_within(got, want, tol, what):
    """``tests/_torch_card.py::assert_within``'s comparison: rtol and a
    share of the largest entry."""
    rtol, step = tol
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=rtol, atol=step * scale,
                                   err_msg=f"{name} at {what}")


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
def test_mma_backward_emulated_holds_the_card_limit(name, shape, split):
    causal, d = shape[6], shape[5]
    q, k, v, o, lse, do = _inputs(shape, seed=sum(shape[:6]))
    scale = 1.0 / math.sqrt(d)
    got = emulate_backward_mma(q, k, v, o, lse, do, causal, scale, split)
    want = _plain(q, k, v, o, lse, do, causal, torch.bfloat16)
    _assert_within(got, want, FLASH_BWD_BF16_TOL, name)
    # P and dS kept in fp32, nothing rounded: the plain version in fp32
    exact = emulate_backward_mma(q, k, v, o, lse, do, causal, scale, split,
                                 rounding=False)
    want32 = _plain(q, k, v, o, lse, do, causal, torch.float32)
    _assert_within(exact, want32, FLASH_BWD_FP32_TOL, name)


SEG_CASES = [("packed", True), ("packed", False), ("unordered", True),
             ("repeated", True)]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("kind,causal", SEG_CASES)
def test_mma_backward_with_segment_ids_emulated_holds_the_card_limit(
        kind, causal, split):
    """The segmented blocks (7 q heads over one kv head, three 64-row tiles
    of ids) against the plain backward with the same ids, in bf16 within
    the card's limit and, nothing rounded, in fp32."""
    shape = (2, 7, 1, 150, 150, 64, causal)
    ids = IDS[kind](2, 150)
    q, k, v, o, lse, do = _inputs(shape, seed=21, ids=ids)
    tiles = ref.flash_segment_tiles_ref(*(torch.from_numpy(ids),) * 2,
                                        causal).numpy()
    seg = (ids, ids, tiles)
    want = _plain(q, k, v, o, lse, do, causal, torch.bfloat16, ids)
    got = emulate_backward_mma(q, k, v, o, lse, do, causal, 0.125, split,
                               seg=seg)
    _assert_within(got, want, FLASH_BWD_BF16_TOL, kind)
    exact = emulate_backward_mma(q, k, v, o, lse, do, causal, 0.125, split,
                                 rounding=False, seg=seg)
    want32 = _plain(q, k, v, o, lse, do, causal, torch.float32, ids)
    _assert_within(exact, want32, FLASH_BWD_FP32_TOL, kind)


def test_a_missing_segment_edge_is_caught(monkeypatch):
    """With every tile taken as one segment (no per-pair test of the ids),
    the segmented blocks leave the limit."""
    shape = (1, 2, 1, 150, 150, 64, True)
    ids = IDS["packed"](1, 150)
    q, k, v, o, lse, do = _inputs(shape, seed=8, ids=ids)
    tiles = ref.flash_segment_tiles_ref(*(torch.from_numpy(ids),) * 2,
                                        True).numpy()
    want = _plain(q, k, v, o, lse, do, True, torch.bfloat16, ids)
    rule = _seg_warp
    monkeypatch.setitem(globals(), "_seg_warp",
                        lambda *a: (rule(*a)[0], True))
    got = emulate_backward_mma(q, k, v, o, lse, do, True, 0.125, False,
                               seg=(ids, ids, tiles))
    with pytest.raises(AssertionError):
        _assert_within(got, want, FLASH_BWD_BF16_TOL, "segments")


def test_rows_that_see_no_key_get_no_gradient():
    """Causal Sq > Sk: the first Sq - Sk rows (lse -inf) get dQ 0, and add
    nothing to dK and dV: the emulation over the rows that see a key alone
    gives the same dK, dV."""
    b, h, hk, sq, sk, d, causal = RAGGED
    q, k, v, o, lse, do = _inputs(RAGGED, seed=11)
    first = sq - sk
    assert np.isneginf(lse[:, :, :first]).all()
    scale = 1.0 / math.sqrt(d)
    dq, dk, dv = emulate_backward_mma(q, k, v, o, lse, do, causal, scale,
                                      split=False)
    assert not dq[:, :, :first].any()
    cut = emulate_backward_mma(
        *(x[:, :, first:] for x in (q,)), k, v, o[:, :, first:],
        lse[:, :, first:], do[:, :, first:], causal, scale, split=False)
    _assert_within((dk, dv), cut[1:], FLASH_BWD_FP32_TOL,
                   "rows with a key")


@pytest.mark.parametrize("wrong", ["dkdv_edge", "dq_edge"])
def test_a_wrong_edge_rule_is_caught(wrong, monkeypatch):
    """The emulation takes interior tiles unmasked, as the kernels do, so
    a tile wrongly called interior shows: with either kernel's causal test
    left out (only the Sq / Sk edges masked) the result leaves the
    limit."""
    shape = (1, 2, 1, 130, 130, 64, True)
    q, k, v, o, lse, do = _inputs(shape, seed=5)
    want = _plain(q, k, v, o, lse, do, True, torch.bfloat16)
    rule = globals()[wrong]
    monkeypatch.setitem(globals(), wrong, lambda causal, *a: rule(False, *a))
    got = emulate_backward_mma(q, k, v, o, lse, do, True, 0.125, False)
    with pytest.raises(AssertionError):
        _assert_within(got, want, FLASH_BWD_BF16_TOL, wrong)


@pytest.mark.parametrize("name,split", [
    ("whisper_encoder", False), ("whisper_cross", False),
    ("vision_cross", False), ("qwen2_causal", True)])
def test_gqa_split_rule_at_the_training_shapes(name, split):
    """On an H100 (132 SMs): qwen2's 4 x 2 x 16 = 128 in-block-sum blocks
    are under two a SM and split its 7 q heads; whisper (G = 1) and the
    vision cross attention (512 blocks) keep the sum inside the block."""
    b, h, hk, sq, sk, d, causal = TRAIN_SHAPES[name]
    assert fa.gqa_split(b, hk, sk, h // hk, 132) == split


def test_gqa_split_rule_bounds():
    assert not fa.gqa_split(1, 1, 64, 1, 132)         # G = 1: nothing to split
    assert fa.gqa_split(1, 1, 64, 2, 132)
    assert fa.gqa_split(2, 2, 64 * 65, 4, 132)         # 260 < 264
    assert not fa.gqa_split(2, 2, 64 * 66, 4, 132)     # 264
