"""The int8 and bit-plane products on the card (skipped without one).

``csrc/bitplane_gemm.cu`` (``int8_matmul``: the int8 tensor cores;
``bitplane_matmul``: the planes of the weight) held bit for bit against
their plain versions (``kernels.ref``) on the same card tensors: on the
reference's test shapes, qwen2-0.5b's MLP shape (x 4096x896 @ w 896x4864)
and ``WRAP_SHAPE``, with 8 planes, 4-bit weights and 4 planes; every plane
count 1..8 on a shape that ``cp.async`` stages (K, N multiples of 16) and
on one it does not; and sums that wrap in int32.

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_gemm_card.py
"""
import pytest
import torch

from benchmarks.torch_kernel_ab import MLP_SHAPE, randint8
from repro_torch.kernels import ref
from repro_torch.kernels.bitplane_gemm import bitplane_matmul, int8_matmul

from _torch_card import card

pytestmark = pytest.mark.card

GEMM_SHAPES = [(8, 16, 8), (128, 128, 128), (100, 60, 200), (130, 96, 257)]
WRAP_SHAPE = (16, 131104, 16)       # 16384 * K > 2**31: int32 sums wrap
# (kernel, plain version) of each case, given x, w and w4 (4-bit weights)
CASES = {
    "int8": (lambda x, w, w4: int8_matmul(x, w),
             lambda x, w, w4: ref.int8_matmul_ref(x, w)),
    "bitplane 8": (lambda x, w, w4: bitplane_matmul(x, w),
                   lambda x, w, w4: ref.int8_matmul_ref(x, w)),
    "4-bit weights": (lambda x, w, w4: bitplane_matmul(x, w4, 4),
                      lambda x, w, w4: ref.int8_matmul_ref(x, w4)),
    "4 planes": (lambda x, w, w4: bitplane_matmul(x, w, 4),
                 lambda x, w, w4: ref.bitplane_matmul_ref(x, w, 4)),
}


def _assert_equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", GEMM_SHAPES + [MLP_SHAPE, WRAP_SHAPE])
def test_products_are_the_plain_versions(card, shape, case):
    m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(2)
    x, w = randint8((m, k), gen), randint8((k, n), gen)
    w4 = randint8((k, n), gen, -8, 8)
    kernel, plain = CASES[case]
    _assert_equal(kernel(x, w, w4), plain(x, w, w4))


@pytest.mark.parametrize("nbits", range(1, 9))
@pytest.mark.parametrize("shape", [(256, 320, 384), GEMM_SHAPES[-1]])
def test_every_plane_count_is_the_plain_version(card, shape, nbits):
    m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(nbits)
    x, w = randint8((m, k), gen), randint8((k, n), gen)
    _assert_equal(bitplane_matmul(x, w, nbits),
                  ref.bitplane_matmul_ref(x, w, nbits))


@pytest.mark.parametrize("case", ["int8", "bitplane 8", "4 planes"])
def test_int32_sums_wrap_as_the_plain_version(card, case):
    """16384 * K > 2**31, so every sum of x = w = -128 wraps in the plain
    version; the tensor cores' s32 accumulators (no ``.satfinite``) must
    wrap alike, not saturate."""
    m, k, n = WRAP_SHAPE
    x, w = (torch.full(shape, -128, dtype=torch.int8, device=card)
            for shape in ((m, k), (k, n)))
    assert int(ref.int8_matmul_ref(x, w)[0, 0]) == 16384 * k - 2**32
    kernel, plain = CASES[case]
    _assert_equal(kernel(x, w, None), plain(x, w, None))
