"""The MVE float kernels on the card (skipped without one).

``csrc/float_ops.cu`` (``float_binary``: add/sub/mul of float32 and
float16 with x86's NaN and denormal bits; ``float_convert``: float32 <->
float16, ROADMAP C7) held bit for bit against its plain version
(``kernels.ref``) on the same card tensors and against the plain version
on the CPU (the reference's bits): random bit patterns (NaNs with
payloads, signalling, infinities, denormals) with every NaN and denormal
pair of the trap programs at the front, one image (8192 lanes) and a batch
of 1024 images; every float16 value widened.

    PYTHONPATH=src python -m pytest -q -m card \\
        tests/test_torch_float_ops_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.float_ops import float_binary, float_convert

from _torch_card import DENORMAL_PAIRS, NAN_PAIRS, bits, card

pytestmark = pytest.mark.card

LANES, BATCH = 8192, 1024
DTYPES = {"float32": np.float32, "float16": np.float16}
SHAPES = {"one image": (LANES,), "1024 images": (BATCH, LANES)}
WHERE = ["plain on the card", "plain on the cpu"]


def float_operands(np_dtype, shape, rng) -> torch.Tensor:
    """Random bit patterns of ``np_dtype``: a quarter NaN or infinite (some
    signalling), for float32 a sixteenth denormal, the rest anything; the
    NaN and denormal pairs of the trap programs at the front."""
    nbits = 8 * np.dtype(np_dtype).itemsize
    ut = np.uint32 if nbits == 32 else np.uint16
    n = int(np.prod(shape))
    u = rng.integers(0, 2 ** nbits, n, dtype=np.uint64).astype(ut)
    q = n // 16
    u[:4 * q] |= ut(0x7F800000 if nbits == 32 else 0x7C00)
    u[:q] &= ut(~(0x00400000 if nbits == 32 else 0x0200) & (2 ** nbits - 1))
    if nbits == 32:
        u[4 * q:5 * q] &= ut(0x807FFFFF)
    u = u[rng.permutation(n)]
    return torch.from_numpy(u.view(np_dtype).reshape(shape).copy())


def _operands(dtype, shape, seed):
    """a and b on the CPU, the special pairs at the front."""
    np_dtype = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    a, b = (float_operands(np_dtype, SHAPES[shape], rng) for _ in range(2))
    special = (np.array(col, np.uint32).view(np.float32)
               for col in zip(*(NAN_PAIRS + DENORMAL_PAIRS)))
    for x, s in zip((a, b), special):
        x.view(-1)[:len(s)] = torch.from_numpy(s.astype(np_dtype))
    return a, b


def _plain(where, fn, *cpu_args):
    if where == "plain on the cpu":
        return fn(*cpu_args).cuda()
    return fn(*(x.cuda() if isinstance(x, torch.Tensor) else x
                for x in cpu_args))


@pytest.mark.parametrize("where", WHERE)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_float_binary_is_the_plain_version(card, dtype, shape, op, where):
    a, b = _operands(dtype, shape, seed=7)
    got = float_binary(op, a.cuda(), b.cuda())
    want = _plain(where, ref.float_binary_ref, op, a, b)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("where", WHERE)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_float_convert_is_the_plain_version(card, dtype, shape, where):
    a, _ = _operands(dtype, shape, seed=8)
    dst = torch.float16 if dtype == "float32" else torch.float32
    got = float_convert(a.cuda(), dst)
    want = _plain(where, ref.float_convert_ref, a, dst)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))


def test_every_float16_widens_as_the_plain_version(card):
    every_half = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.float16)
    got = float_convert(every_half.cuda(), torch.float32)
    assert torch.equal(bits(got.cpu()), bits(ref.float_convert_ref(
        every_half, torch.float32)))
