"""What the ``card`` tests share: the ``card`` fixture, the comparisons,
the limits each kernel is held to against its plain version, and the float
ops' NaN and denormal operands.

The ``card`` tests (``tests/test_torch_*_card.py``, marker ``card``) run
the hand-written kernels on the card and skip without one; the shapes they
share with the timing tool (``benchmarks/torch_kernel_ab.py``) live there.
Run them on a machine with the card, from the root of the checkout::

    PYTHONPATH=src python -m pytest -q -m card \\
        tests/test_torch_<module>_card.py
"""
import pytest
import torch

# Both sides of the flash forward accumulate in fp32 and differ only in the
# order of their sums (and, in bf16, in which way the output rounds), so
# the limits sit a few times over that, far under a typical output value.
FLASH_FP32_TOL = dict(rtol=3e-5, atol=3e-5)     # tests/test_kernels.py, fp32
FLASH_FP32_PATH_TOL = dict(rtol=1e-4, atol=1e-4)  # 1024-long fp32 sums
# one bf16 step of the output is at most 2**-7 of it: rtol covers a step the
# other way, atol the same near 0
FLASH_BF16_TOL = dict(rtol=1e-2, atol=8e-3)
# dq, dk, dv against the plain backward on the same q, k, v, o, lse, dO:
# both sum in fp32 and differ in the order of their sums (a few 1e-6 of the
# largest entry measured in fp32), and in bf16 each side rounds its result
# once, so within (rtol, a share of the gradient's largest entry): fp32
# 1e-4 of it; bf16 one bf16 step of each entry (rtol 1e-2) and 8e-3 of the
# largest (the forward's bf16 limits, scaled to the gradient)
FLASH_BWD_FP32_TOL = (1e-4, 1e-4)
FLASH_BWD_BF16_TOL = (1e-2, 8e-3)
LSE_TOL = 1e-4                  # |lse - plain lse| on rows that see a key
# (rtol, share of the largest entry) of the SSD kernels: float32 sums of up
# to 256 terms (and dS's of 56 heads), each product three TF32 ones (2^-22
# of a product left out), against the plain versions in float32, TF32 off
SSD_TOL = (1e-4, 1e-5)

# the flash backward's test shapes, (B, H, Hkv, Sq, Sk, D, causal): GQA,
# ragged Sq != Sk both ways, rows that see no key
FLASH_BWD_SWEEP = [(2, 4, 2, 40, 40, 64, True), (1, 6, 2, 17, 70, 64, True),
                   (1, 6, 3, 33, 95, 128, False), (2, 2, 1, 70, 33, 64, True),
                   (1, 4, 1, 65, 129, 128, True),
                   (2, 3, 1, 200, 130, 128, True)]

# x86's NaN and denormal cases as float32 bit patterns (a, b), for the float
# ops on the card and on the CPU (tests/test_torch_float_ops.py).
# NaN operands with payloads and both signs, quiet and signalling; the
# pairs cover NaN in a only, in b only, in both, and invalid operations.
QA, QB = 0x7FC12345, 0xFFC54321          # quiet, + and -
SA, SB = 0x7F812345, 0xFF854321          # signalling, + and -
PA = 0x7FE00000                          # quiet, payload above bit 13
ONE, TWO, INF, NINF, ZERO = 0x3F800000, 0x40000000, 0x7F800000, \
    0xFF800000, 0x0
NAN_PAIRS = [(QA, ONE), (ONE, QB), (QA, QB), (QB, QA), (SA, TWO),
             (TWO, SB), (SA, SB), (SB, QA), (QA, SB), (INF, INF),
             (ZERO, INF), (INF, ZERO), (NINF, NINF), (INF, NINF), (PA, ONE),
             (ONE, PA), (PA, SB), (0x80000000, INF), (NINF, 0x80000000)]
# float32 denormals against zeros, normals and each other
DENORMAL_PAIRS = [(0x0054B477, ZERO), (0x80000001, ZERO), (0x00800000,
                  0x80000000), (0x00400000, 0x00000001), (ONE, 0x00000001),
                  (0x891FDE68, 0x0054B477), (0x00800001, 0x80800000),
                  (0x20506A6A, 0x93BB0106), (0x00FFFFFF, 0x3F000000),
                  (0x807FFFFF, 0x00000001), (0x00000001, 0x80000001),
                  (0x3F3C9172, 0x00ADC5D1), (0xBF60A954, 0x0091DAE3)]


def require_card() -> torch.device:
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only on one")
    return torch.device("cuda")


@pytest.fixture
def card():
    """The card, with TF32 off for PyTorch's own float32 products (the
    plain versions') and restored after."""
    device = require_card()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield device
    torch.backends.cuda.matmul.allow_tf32 = tf32


def bits(x: torch.Tensor) -> torch.Tensor:
    """Integer view of a tensor, for bit-for-bit comparison."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.contiguous().view(view[x.element_size()])


def assert_within(got: torch.Tensor, want: torch.Tensor, tol, what: str):
    """``got`` of ``want``'s dtype and shape, within ``tol`` = (rtol, a
    share of ``want``'s largest entry) of it."""
    rtol, step = tol
    assert got.dtype == want.dtype and got.shape == want.shape, what
    top = float(want.float().abs().max())
    torch.testing.assert_close(
        got.float(), want.float(), rtol=rtol, atol=step * top,
        msg=lambda m: f"{what} (largest entry {top}): {m}")


def by_row(fn, *tensors) -> tuple:
    """``fn`` over one batch row at a time (the plain versions' fp32
    logits, or decay blocks, of a whole cell would take tens of GB), the
    results joined on dim 0."""
    outs = [fn(*(t[i:i + 1] for t in tensors))
            for i in range(tensors[0].shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*outs))
