"""The segmented flash kernels on the card (skipped without one).

``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` with
segment ids, held against the plain versions with the same ids
(``kernels.ref``, which the CPU tests hold equal to the model's plain
chunked route), within the limits of the unsegmented kernels
(``tests/_torch_card.py``; ``tests/test_torch_flash_card.py``):

* at the packed training cell's shape (``SEG_SHAPE``), q ``(4, 28, 4096,
  128)`` over 4 kv heads, ids from ``pack_documents`` on Poisson documents
  of mean 512 (at least 16), bf16 and fp32, forward (output and lse) and
  backward, the GQA sum in the block and split;
* at ragged small shapes: ids in no order, runs that come back, Sq != Sk
  with kv ids of their own (rows that see no key: 0 from the kernel, NaN
  from the plain version, lse -inf in both);
* a segmented call whose ids are all equal is bit-equal to the unsegmented
  call, forward and backward;
* the pre-pass kernel's records equal its plain version's;
* ``flash_attention.launches_segmented`` counts a segmented launch, and
  the model's route runs no plain chunk.

Run on a machine with the card, from the root of the checkout::

    PYTHONPATH=src python -m pytest -q -m card \\
        tests/test_torch_flash_segments_card.py
"""
from unittest import mock

import numpy as np
import pytest
import torch

from benchmarks.torch_kernel_ab import SEG_SHAPE, packed_ids
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention

from _torch_card import (FLASH_BF16_TOL, FLASH_BWD_BF16_TOL,
                         FLASH_BWD_FP32_TOL, FLASH_FP32_PATH_TOL, LSE_TOL,
                         assert_within, bits, by_row, card)

pytestmark = pytest.mark.card

FWD_TOL = {torch.bfloat16: FLASH_BF16_TOL,
           torch.float32: FLASH_FP32_PATH_TOL}        # long fp32 sums
BWD_TOL = {torch.bfloat16: FLASH_BWD_BF16_TOL,
           torch.float32: FLASH_BWD_FP32_TOL}
DTYPES = [torch.bfloat16, torch.float32]


def _draw(shape, dtype, device, seed):
    b, h, hk, sq, sk, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=device)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=device)
            .to(dtype) for _ in range(2))
    return q, k, v, do


def _check_forward(q, k, v, causal, seg_q, seg_k):
    out, lse = fa._forward(q, k, v, causal, q.shape[-1] ** -0.5, True,
                           seg_q, seg_k)
    want, want_lse = by_row(
        lambda q, k, v, sq_, sk_: ref.flash_attention_lse_ref(
            q, k, v, causal=causal, segment_ids=sq_, kv_segment_ids=sk_),
        q, k, v, seg_q, seg_k)
    seen = torch.isfinite(want_lse)
    assert out.dtype == q.dtype
    assert torch.equal(torch.isneginf(lse), ~seen)
    assert not out[~seen].any()                 # the kernel gives 0 there
    assert float((lse - want_lse)[seen].abs().max()) <= LSE_TOL
    torch.testing.assert_close(out[seen].float(), want[seen].float(),
                               **FWD_TOL[q.dtype])
    return out, lse


def _check_backward(q, k, v, o, lse, do, causal, seg_q, seg_k, splits):
    want = by_row(
        lambda *t: ref.flash_attention_bwd_ref(
            *t[:6], causal=causal, segment_ids=t[6], kv_segment_ids=t[7]),
        q, k, v, o, lse, do, seg_q, seg_k)
    for split in splits:
        with mock.patch.object(fa, "gqa_split", lambda *a: split):
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=seg_q,
                                         kv_segment_ids=seg_k)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert_within(g, w, BWD_TOL[q.dtype], f"{name} (split {split})")


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernels_at_the_packed_cell_shape(card, dtype):
    b, h, hk, s, d = SEG_SHAPE
    ids = packed_ids(b, s, seed=1)
    q, k, v, do = _draw((b, h, hk, s, s, d), dtype, card, seed=2)
    o, lse = _check_forward(q, k, v, True, ids, ids)
    _check_backward(q, k, v, o, lse, do, True, ids, ids, (False, True))


SMALL = [  # (B, H, Hkv, Sq, Sk, D), causal, ids
    ((2, 6, 2, 150, 150, 64), True, "unordered"),
    ((2, 6, 2, 150, 150, 64), False, "repeated"),
    ((1, 7, 1, 300, 300, 128), True, "repeated"),
    ((2, 4, 1, 200, 70, 128), True, "own kv ids"),
    ((2, 4, 4, 33, 130, 64), False, "own kv ids"),
]


def _small_ids(kind, b, sq, sk, seed):
    rng = np.random.default_rng(seed)
    if kind == "unordered":
        q = rng.integers(0, 5, (b, sq))
        return q, q
    if kind == "unordered kv":
        return rng.integers(0, 5, (b, sq)), rng.integers(0, 5, (b, sk))
    if kind == "repeated":
        row = np.resize(np.repeat([1, 2, 0, 1, 3, 2], [40, 50, 5, 30, 10, 30]),
                        sq)
        q = np.tile(row, (b, 1))
        return q, q
    return rng.integers(0, 3, (b, sq)), rng.integers(0, 3, (b, sk))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,causal,kind", SMALL)
def test_segmented_kernels_at_ragged_shapes(card, dtype, shape, causal,
                                            kind):
    b, h, hk, sq, sk, d = shape
    seg_q, seg_k = (torch.from_numpy(x.astype(np.int32)).to(card)
                    for x in _small_ids(kind, b, sq, sk, seed=sq + sk))
    q, k, v, do = _draw(shape, dtype, card, seed=3)
    o, lse = _check_forward(q, k, v, causal, seg_q, seg_k)
    splits = (False, True) if h > hk else (False,)
    _check_backward(q, k, v, o, lse, do, causal, seg_q, seg_k, splits)


@pytest.mark.parametrize("dtype", DTYPES)
def test_equal_ids_are_bit_equal_to_the_unsegmented_call(card, dtype):
    b, h, hk, s, d = SEG_SHAPE
    q, k, v, do = _draw((b, h, hk, s, s, d), dtype, card, seed=4)
    ones = torch.ones(b, s, dtype=torch.int32, device=card)
    scale = d ** -0.5
    plain = fa._forward(q, k, v, True, scale, True)
    seg = fa._forward(q, k, v, True, scale, True, ones, ones)
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(plain, seg))
    o, lse = plain
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, segment_ids=ones)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


# (name, the ids' kind, B, Sq, Sk)
PRE_PASS = [("packed cell", "packed", 4, 4096, 4096),
            ("unordered", "unordered", 3, 300, 300),
            ("unordered, kv ids of their own", "unordered kv", 3, 300, 70),
            ("own kv ids 200 / 70", "own kv ids", 2, 200, 70),
            ("own kv ids 33 / 130", "own kv ids", 2, 33, 130)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,kind,b,sq,sk", PRE_PASS,
                         ids=[case[0] for case in PRE_PASS])
def test_the_pre_pass_kernel_equals_its_plain_version(card, name, kind, b,
                                                      sq, sk, causal):
    if kind == "packed":
        seg_q = seg_k = packed_ids(b, sq, seed=5)
    else:
        seg_q, seg_k = (torch.from_numpy(x.astype(np.int32)).to(card)
                        for x in _small_ids(kind, b, sq, sk, seed=sq + sk))
    got = fa._segment_tiles(seg_q, seg_k, causal)
    want = ref.flash_segment_tiles_ref(seg_q.cpu(), seg_k.cpu(), causal)
    assert torch.equal(got.cpu(), want)


def test_segmented_launches_are_counted_and_the_route_runs_no_plain_chunk(
        card):
    b, h, hk, s, d = 2, 8, 2, 512, 128
    ids = packed_ids(b, s, seed=9)
    q, k, v, _ = _draw((b, h, hk, s, s, d), torch.bfloat16, card, seed=10)
    before = (fa.flash_attention.launches,
              fa.flash_attention.launches_segmented,
              attention.chunked_attention.plain_chunks)
    out = attention.chunked_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                      segment_ids=ids)
    torch.cuda.synchronize()
    after = (fa.flash_attention.launches,
             fa.flash_attention.launches_segmented,
             attention.chunked_attention.plain_chunks)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
    want = ref.flash_attention_ref(q, k, v, segment_ids=ids)
    torch.testing.assert_close(out.transpose(1, 2).float(), want.float(),
                               **FWD_TOL[torch.bfloat16])
