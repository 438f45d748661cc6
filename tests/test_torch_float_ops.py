"""Float arithmetic and float32 <-> float16 conversions with the
reference's bits (``repro_torch.kernels.float_ops`` and its plain versions
in ``kernels/ref.py``).

The reference computes float ``vadd``/``vsub``/``vmul`` and conversions
with XLA on an x86 host: a NaN result is the first NaN operand quieted,
else the second, else the default NaN ``0xFFC00000``; a conversion keeps a
NaN's sign and payload as F16C does; float32 denormals, operands and
results, are read and written as zeros (DAZ/FTZ).  The plain versions
write those rules out on bit views, and the tests pin them against
``jax.numpy`` on the same bits, then against the reference's executors on
programs: NaN in ``a`` only, in ``b`` only, in both (payloads and signs
differing), ``inf - inf``, ``0 * inf``, signalling payloads, float16 round
trips, float16 memory, and denormals through every float operation.
On the CPU the wrappers take the plain versions and launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as I
from repro.core.isa import DType

from repro_torch.kernels import float_ops
from repro_torch.kernels.ref import (float_binary_ref, float_convert_ref,
                                     flush_denormals)

from _torch_card import (DENORMAL_PAIRS, INF, NAN_PAIRS, NINF, ONE, PA,
                         QA, QB, SA, SB)
from _torch_parity import check_all_executors

_JNP = {"add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply}
_UINT = {np.float32: np.uint32, np.float16: np.uint16}


def _f32(*bits):
    return np.array(bits, dtype=np.uint32).view(np.float32)


def _bits(x):
    x = np.asarray(x)
    return x.view(_UINT[x.dtype.type])


def _random_bits(rng, n, bits):
    """``n`` random patterns of ``bits`` bits, a quarter of them NaN or
    infinite (the exponent forced to all ones), some with the quiet bit
    clear (signalling)."""
    ut = np.uint32 if bits == 32 else np.uint16
    u = rng.integers(0, 2**bits, n, dtype=np.uint64).astype(ut)
    expo = ut(0x7F800000 if bits == 32 else 0x7C00)
    quiet = ut(0x00400000 if bits == 32 else 0x0200)
    u[: n // 4] |= expo
    u[: n // 16] &= ~quiet
    return u


# ---------------------------------------------------------------------------
# The plain versions against jax.numpy on the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_float_binary_ref_matches_xla(op, dtype):
    rng = np.random.default_rng(17)
    nbits = 8 * np.dtype(dtype).itemsize
    a = _random_bits(rng, 60000, nbits).view(dtype)
    b = _random_bits(rng, 60000, nbits).view(dtype)
    b[::3] = a[::3]                                 # equal operands too
    a, b = np.roll(a, 7), b                         # NaN in one operand only
    if dtype is np.float32:                         # denormals and near them
        a[:2000] = _f32(*rng.integers(0, 0x01000000, 2000))
        b[1000:3000] = _f32(*rng.integers(0x80000000, 0x81000000, 2000))
    want = _bits(_JNP[op](jnp.asarray(a), jnp.asarray(b)))
    got = float_binary_ref(op, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got.numpy()), want)


def test_float_binary_ref_tininess_after_rounding():
    """Products just below and above the least normal float32: x86 flushes
    a product that is tiny after rounding to 24 bits with an unbounded
    exponent, and keeps one whose exact value is tiny but rounds up to
    ``2**-126``; rounding to the denormal grid first would differ."""
    rng = np.random.default_rng(23)
    ma = rng.integers(2**23, 2**24, 40000, dtype=np.int64)
    mb = (2**47 // ma + rng.integers(-2, 3, ma.size)).clip(2**23, 2**24 - 1)
    a = ((126 << 23) | (ma - 2**23)).astype(np.uint32).view(np.float32)
    b = ((1 << 23) | (mb - 2**23)).astype(np.uint32)
    b[::2] |= np.uint32(0x80000000)
    b = b.view(np.float32)
    want = _bits(jnp.multiply(jnp.asarray(a), jnp.asarray(b)))
    assert 0 < np.count_nonzero((want & 0x7FFFFFFF) == 0) < want.size
    got = float_binary_ref("mul", torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got.numpy()), want)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_float_binary_ref_special_pairs(op):
    a, b = (_f32(*col) for col in zip(*(NAN_PAIRS + DENORMAL_PAIRS)))
    want = _bits(_JNP[op](jnp.asarray(a), jnp.asarray(b)))
    got = float_binary_ref(op, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    h = a.astype(np.float16), b.astype(np.float16)
    want = _bits(_JNP[op](jnp.asarray(h[0]), jnp.asarray(h[1])))
    got = float_binary_ref(op, *(torch.from_numpy(x) for x in h))
    np.testing.assert_array_equal(_bits(got.numpy()), want)


def test_float_convert_ref_every_half_and_random_floats():
    halves = np.arange(2**16, dtype=np.uint32).astype(np.uint16)
    h = halves.view(np.float16)
    want = _bits(jnp.asarray(h).astype(jnp.float32))
    got = float_convert_ref(torch.from_numpy(h), torch.float32)
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    f = _random_bits(np.random.default_rng(5), 400000, 32).view(np.float32)
    f[:3] = _f32(SA, QB, PA)
    want = _bits(jnp.asarray(f).astype(jnp.float16))
    got = float_convert_ref(torch.from_numpy(f), torch.float16)
    np.testing.assert_array_equal(_bits(got.numpy()), want)


def test_plain_versions_write_the_rule_out():
    """The NaN bits come from the rule, not from the host's arithmetic:
    the default NaN has its sign set and a quiet NaN keeps its payload,
    which IEEE 754 leaves open."""
    a = torch.from_numpy(_f32(INF, SA, ONE))
    b = torch.from_numpy(_f32(NINF, ONE, SB))
    got = _bits(float_binary_ref("add", a, b).numpy())
    np.testing.assert_array_equal(got, [0xFFC00000, 0x7FC12345, 0xFFC54321])
    half = float_convert_ref(torch.from_numpy(_f32(SB)), torch.float16)
    assert _bits(half.numpy())[0] == 0xFE2A
    back = float_convert_ref(half, torch.float32)
    assert _bits(back.numpy())[0] == 0xFFC54000
    x = torch.from_numpy(_f32(0x00000001, 0x807FFFFF, 0x00800000))
    np.testing.assert_array_equal(_bits(flush_denormals(x).numpy()),
                                  [0x0, 0x80000000, 0x00800000])


def test_wrappers_take_the_plain_version_on_the_cpu():
    a = torch.from_numpy(_f32(QA, ONE, INF))
    b = torch.from_numpy(_f32(ONE, QB, NINF))
    before = float_ops.float_binary.launches, float_ops.float_convert.launches
    for op in ("add", "sub", "mul"):
        assert torch.equal(float_ops.float_binary(op, a, b).view(torch.int32),
                           float_binary_ref(op, a, b).view(torch.int32))
    h = float_ops.float_convert(a, torch.float16)
    assert torch.equal(h.view(torch.int16),
                       float_convert_ref(a, torch.float16).view(torch.int16))
    assert (float_ops.float_binary.launches,
            float_ops.float_convert.launches) == before
    with pytest.raises(TypeError):
        float_ops.float_binary("add", a, h)
    with pytest.raises(ValueError):
        float_ops.float_binary("add", a, a[:2])
    with pytest.raises(ValueError):
        float_ops.float_binary("div", a, b)
    with pytest.raises(TypeError):
        float_ops.float_convert(a, torch.bfloat16)


# ---------------------------------------------------------------------------
# Programs: the reference's executors vs the port's, bit for bit
# ---------------------------------------------------------------------------

def _pair_image(pairs):
    mem = np.zeros(4096, np.float32)
    a, b = zip(*pairs)
    mem[:len(a)] = _f32(*a)
    mem[64:64 + len(b)] = _f32(*b)
    return mem


def _arith(dt):
    """add, sub and mul of ``a`` (at 0) and ``b`` (at 64); each ``b op b``
    too.  (``b op a`` after ``a op b`` is where the reference's executors
    disagree: :func:`test_c8_reference_fused_commutes_operands`.)"""
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
         I.vsld(dt, 0, 0, 1), I.vsld(dt, 1, 64, 1)]
    for k, f in enumerate([I.vadd, I.vsub, I.vmul]):
        p += [f(dt, 2 + k, 0, 1), I.vsst(dt, 2 + k, 1024 + 64 * k, 1),
              f(dt, 5 + k, 1, 1)]
    # a result NaN fed on: its bits are the next operand's
    p += [I.vadd(dt, 8, 2, 3), I.vmul(dt, 9, 8, 1),
          I.vsst(dt, 9, 2048, 1)]
    return p


def _conversions():
    """float32 -> float16 -> float32 round trips of the NaN operands,
    through ``vcvt``, loads and stores of both widths."""
    return [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
            I.vsld(DType.F, 0, 0, 1), I.vcvt(DType.HF, 1, 0),
            I.vcvt(DType.F, 2, 1), I.vsst(DType.F, 2, 1024, 1),
            I.vsld(DType.HF, 3, 64, 1), I.vsst(DType.HF, 3, 2048, 1),
            I.vsld(DType.F, 4, 2048, 1), I.vcvt(DType.HF, 5, 4),
            I.vadd(DType.HF, 6, 1, 3), I.vsst(DType.HF, 6, 3072, 1)]


def _half_memory_image():
    """A float16 image: signalling and quiet NaNs with payloads, both
    signs, infinities, subnormals, and the extremes."""
    h = np.zeros(4096, np.uint16)
    h[:16] = [0x7C01, 0xFC01, 0x7D55, 0xFE2A, 0x7E00, 0x7C00, 0xFC00,
              0x0001, 0x8001, 0x03FF, 0x7BFF, 0xFBFF, 0x3C00, 0x0000,
              0x8000, 0x7FFF]
    h[64:80] = [0x3C00, 0x7C01, 0xFD00, 0x7C00, 0xFC00, 0x0001, 0x8000,
                0x7E01, 0x0400, 0x7BFF, 0x7BFF, 0x3C00, 0xFC01, 0x7C00,
                0x0000, 0x0001]
    return h.view(np.float16)


def _half_memory():
    p = _arith(DType.HF)
    p += [I.vcvt(DType.F, 10, 0), I.vcvt(DType.F, 11, 1),
          I.vadd(DType.F, 12, 10, 11), I.vsst(DType.F, 12, 3072, 1),
          I.vcvt(DType.HF, 13, 12)]
    return p


def _denormal_ops():
    """float32 denormals through every float operation: add, sub, mul,
    min, max, the six compares (into the Tag latch) and a predicated add
    after each compare."""
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
         I.vsld(DType.F, 0, 0, 1), I.vsld(DType.F, 1, 64, 1)]
    for k, f in enumerate([I.vadd, I.vsub, I.vmul, I.vmin, I.vmax]):
        p += [f(DType.F, 2 + k, 0, 1), I.vsst(DType.F, 2 + k, 1024 + 64 * k,
                                               1)]
    for k, op in enumerate([I.Op.GT, I.Op.GTE, I.Op.LT, I.Op.LTE, I.Op.EQ,
                            I.Op.NEQ]):
        p += [I.vcmp(op, DType.F, 0, 1),
              I.vadd(DType.F, 8, 0, 1, predicated=True),
              I.vsst(DType.F, 8, 2048 + 64 * k, 1)]
    return p


PROGRAMS = {
    "nan_arith_f": (lambda: _arith(DType.F), lambda: _pair_image(NAN_PAIRS)),
    "nan_arith_hf": (lambda: _arith(DType.HF),
                     lambda: _pair_image(NAN_PAIRS)),
    "conversions": (_conversions, lambda: _pair_image(NAN_PAIRS)),
    "half_memory": (_half_memory, _half_memory_image),
    "denormals": (_denormal_ops, lambda: _pair_image(DENORMAL_PAIRS)),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_match_the_reference(name):
    """port VM == fused == stepwise == reference stepwise == reference VM,
    NaN bits, denormal flushes and the Tag latch included."""
    make_program, make_image = PROGRAMS[name]
    check_all_executors(make_program(), make_image())


@pytest.mark.parametrize("dt", [DType.F, DType.HF])
def test_c8_reference_fused_commutes_operands(dt):
    """ROADMAP C8, a fault of the reference, not copied: its fused
    executor computes ``vadd v5, v1, v0`` after ``vadd v2, v0, v1`` as
    the earlier sum (XLA merges the commuted pair), so where both operands
    are NaN it returns ``v0``'s bits; its step oracle returns ``v1``'s, as
    x86 does for ``v1 + v0``.  The port's three executors follow the step
    oracle.  float32 and float16 memory alike."""
    from repro.core import compile_program as ref_compile
    from repro.core.interp import MVEInterpreter as RefInterpreter
    from repro_torch import convert
    from repro_torch.core.engine import compile_program
    from repro_torch.core.interp import MVEInterpreter

    if dt is DType.F:
        image = np.zeros(4096, np.float32)
        image[:4] = _f32(QA, QB, SA, SB)
        image[64:68] = _f32(QB, SA, SB, QA)
        step = [QB, SA | 0x400000, SB | 0x400000, QA]          # v1 quieted
        fused = [QA, QB, SA | 0x400000, SB | 0x400000]         # v0 quieted
    else:
        half = np.zeros(4096, np.uint16)
        half[:4] = [0xFC01, 0x7C01, 0xFE01, 0x7E05]
        half[64:68] = [0x7C01, 0xFC01, 0x7E05, 0xFE01]
        image = half.view(np.float16)
        step = [0x7E01, 0xFE01, 0x7E05, 0xFE01]
        fused = [0xFE01, 0x7E01, 0xFE01, 0x7E05]
    prog = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
            I.vsld(dt, 0, 0, 1), I.vsld(dt, 1, 64, 1),
            I.vadd(dt, 2, 0, 1), I.vadd(dt, 5, 1, 0)]
    ref_step = RefInterpreter(compiled=False).run_stepwise(prog, image)[1]
    ref_fused = ref_compile(prog, mode="fused").run(image)[1]
    np.testing.assert_array_equal(_bits(ref_step.regs[5])[:4], step)
    np.testing.assert_array_equal(_bits(ref_fused.regs[5])[:4], fused)
    program = convert.program_from_reference(prog)
    for mode in ("vm", "fused"):
        _, state = compile_program(program, mode=mode,
                                   device="cpu").run(image)
        np.testing.assert_array_equal(
            _bits(state.regs[5].numpy())[:4], step, err_msg=mode)
    _, state = MVEInterpreter(compiled=False,
                              device="cpu").run_stepwise(program, image)
    np.testing.assert_array_equal(_bits(state.regs[5].numpy())[:4], step)
