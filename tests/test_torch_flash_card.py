"""The flash attention kernels on the card (skipped without one).

``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` held
against their plain versions (``kernels.ref``) on the same card tensors:

* the forward on the reference's test shapes (``FLASH_SWEEP``, fp32 and
  bf16), a bf16 call at (1, 2, 96, 64), a bf16 view that is not 16-byte
  aligned, qwen2-0.5b's prefill (4 x 14 q heads over 2 kv heads, S = 1024
  and 1025, D = 64 in fp32 and bf16, D = 128 in bf16) and the vlm and
  encdec families' ``FAMILY_SHAPES``: fp32 within ``FLASH_FP32_TOL`` on
  the test shapes and ``FLASH_FP32_PATH_TOL`` on the others, bf16 within
  ``FLASH_BF16_TOL``;
* the forward kernel's ``lse`` within ``LSE_TOL`` on rows that see a key
  (-inf on the others, as the plain version's), and the backward's dq, dk,
  dv within ``FLASH_BWD_*_TOL`` on the same q, k, v, o, lse, dO, fp32 and
  bf16, at ``FLASH_BWD_SWEEP`` and ``TRAIN_SHAPES``, the GQA sum in the
  dK/dV block and split over blocks (``gqa_split`` forced each way; a
  shape whose q heads do not share a kv head has one way).

Rows that see no key (causal, Sq > Sk) are left out of the forward
shapes: there the plain version is NaN and the kernel 0, as the
reference's two versions are.  The segmented instantiations are
``tests/test_torch_flash_segments_card.py``'s.

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_flash_card.py
"""
from unittest import mock

import pytest
import torch

from benchmarks.torch_kernel_ab import (FAMILY_SHAPES, HEAD_DIM, KV_HEADS,
                                        LM_BATCH, LM_SEQ, Q_HEADS,
                                        TRAIN_SHAPES, bwd_inputs)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

from _torch_card import (FLASH_BF16_TOL, FLASH_BWD_BF16_TOL,
                         FLASH_BWD_FP32_TOL, FLASH_BWD_SWEEP,
                         FLASH_FP32_PATH_TOL, FLASH_FP32_TOL, LSE_TOL,
                         assert_within, card)

pytestmark = pytest.mark.card

# the reference's test shapes, (Sq, Sk, causal, D) of q (2, 3, Sq, D)
FLASH_SWEEP = [(128, 128, True, 64), (1, 128, True, 64), (77, 200, True, 64),
               (64, 64, False, 128), (128, 128, True, 128),
               (33, 95, False, 64)]
# (name, (B, H, Hkv, Sq, Sk, D), causal, dtype, limits)
FORWARD = (
    [(f"test {sq} {sk} {causal} {d} fp32", (2, 3, 3, sq, sk, d), causal,
      torch.float32, FLASH_FP32_TOL) for sq, sk, causal, d in FLASH_SWEEP]
    + [(f"test {sq} {sk} {causal} {d} bf16", (2, 3, 3, sq, sk, d), causal,
        torch.bfloat16, FLASH_BF16_TOL) for sq, sk, causal, d in FLASH_SWEEP]
    + [("bf16 (1, 2, 96, 64)", (1, 2, 2, 96, 96, 64), True, torch.bfloat16,
        FLASH_BF16_TOL)]
    + [(f"qwen2-0.5b {name} S={s}",
        (LM_BATCH, Q_HEADS, KV_HEADS, s, s, d), True, dtype, tol)
       for s in (LM_SEQ, LM_SEQ + 1)
       for name, d, dtype, tol in (
           ("fp32", HEAD_DIM, torch.float32, FLASH_FP32_PATH_TOL),
           ("bf16", HEAD_DIM, torch.bfloat16, FLASH_BF16_TOL),
           ("heads, D=128, bf16", 128, torch.bfloat16, FLASH_BF16_TOL))]
    + [(f"{name} {label}", shape[:6], shape[6], dtype, tol)
       for name, shape in FAMILY_SHAPES.items()
       for label, dtype, tol in (("fp32", torch.float32, FLASH_FP32_PATH_TOL),
                                 ("bf16", torch.bfloat16, FLASH_BF16_TOL))])
BACKWARD_SHAPES = [(f"test {s}", s) for s in FLASH_BWD_SWEEP] + list(
    TRAIN_SHAPES.items())
DTYPES = {"fp32": (torch.float32, FLASH_BWD_FP32_TOL),
          "bf16": (torch.bfloat16, FLASH_BWD_BF16_TOL)}
BACKWARD = [(name, shape, label, split)
            for name, shape in BACKWARD_SHAPES for label in DTYPES
            for split in ((None,) if shape[1] == shape[2] else (False, True))]


def _check_forward(q, k, v, causal, tol):
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("name,shape,causal,dtype,tol", FORWARD,
                         ids=[case[0] for case in FORWARD])
def test_forward_is_the_plain_version(card, name, shape, causal, dtype, tol):
    b, h, hk, sq, sk, d = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    q = torch.randn(b, h, sq, d, generator=gen, device=card)
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=card)
            for _ in range(2))
    _check_forward(*(x.to(dtype) for x in (q, k, v)), causal, tol)


def test_forward_copies_a_view_that_is_not_16_byte_aligned(card):
    gen = torch.Generator(device=card).manual_seed(2)
    flat = torch.randn(2 * 3 * 80 * 64 + 1, generator=gen, device=card)
    odd = flat.to(torch.bfloat16)[1:].view(2, 3, 80, 64)
    _check_forward(odd, odd, odd, True, FLASH_BF16_TOL)


@pytest.mark.parametrize("label", DTYPES)
@pytest.mark.parametrize("name,shape", BACKWARD_SHAPES,
                         ids=[case[0] for case in BACKWARD_SHAPES])
def test_forward_lse_is_the_plain_version(card, name, shape, label):
    dtype = DTYPES[label][0]
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v, _, lse, _ = bwd_inputs(shape, dtype, gen)
    _, want = ref.flash_attention_lse_ref(q, k, v, causal=shape[6])
    seen = torch.isfinite(want)
    assert torch.equal(torch.isneginf(lse), ~seen)
    assert float((lse - want)[seen].abs().max()) <= LSE_TOL


@pytest.mark.parametrize("name,shape,label,split", BACKWARD,
                         ids=[f"{c[0]} {c[2]} split {c[3]}" for c in BACKWARD])
def test_backward_is_the_plain_version(card, name, shape, label, split):
    dtype, tol = DTYPES[label]
    causal = shape[6]
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v, o, lse, do = bwd_inputs(shape, dtype, gen)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    rule = fa.gqa_split if split is None else (lambda *a: split)
    with mock.patch.object(fa, "gqa_split", rule):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_within(g, w, tol, what)
