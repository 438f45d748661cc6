"""``repro_torch.kernels``: the plain versions of the flash-attention and
int8 / bit-plane GEMM kernels vs the reference's oracles
(``repro.kernels.ref``) and vs its Pallas kernels in interpret mode.

These run on the CPU, where the wrappers take the plain versions (a CUDA
kernel has no interpret mode); the CUDA kernels are held against the same
plain versions on the card by ``tests/test_torch_flash_card.py`` and
``tests/test_torch_gemm_card.py``.  Tolerances are the
reference's own (``tests/test_kernels.py``): attention 3e-5 in fp32 and
0.06 in bf16, the integer products bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitplane_gemm import bitplane_matmul as pallas_bitplane
from repro.kernels.bitplane_gemm import int8_matmul as pallas_int8
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitplane_gemm import bitplane_matmul, int8_matmul
from repro_torch.kernels.flash_attention import (_kernel_operand,
                                                 flash_attention)
from repro_torch.models.attention import (chunked_attention,
                                         plain_chunked_attention)

from _torch_parity import assert_bits_equal


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

SWEEP = [(128, 128, True, 64), (1, 128, True, 64), (77, 200, True, 64),
         (64, 64, False, 128), (128, 128, True, 128), (33, 95, False, 64)]


@pytest.mark.parametrize("sq,sk,causal,d", SWEEP)
def test_flash_plain_matches_pallas_and_oracle(sq, sk, causal, d):
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = (_normal(rng, (2, 3, n, d)) for n in (sq, sk, sk))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want_pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=64,
                               block_k=64)
    want_ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=3e-5, atol=3e-5)


def test_flash_plain_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, (1, 2, 96, 64)) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = pallas_flash(jq, jk, jv, causal=True, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=0.06, atol=0.06)


def test_rows_with_no_visible_key():
    """Causal with Sq > Sk: the first Sq - Sk rows see no key.  The
    reference's oracle (and the plain version) give NaN there, its Pallas
    kernel (and the CUDA kernel) give 0; every other row agrees."""
    rng = np.random.default_rng(2)
    q, k, v = _normal(rng, (1, 2, 24, 64)), *(_normal(rng, (1, 2, 16, 64))
                                               for _ in range(2))
    got = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    kernel = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_q=8, block_k=8))
    assert np.isnan(oracle[:, :, :8]).all() and np.isnan(got[:, :, :8]).all()
    assert (kernel[:, :, :8] == 0).all()
    np.testing.assert_allclose(got[:, :, 8:], kernel[:, :, 8:], rtol=3e-5,
                               atol=3e-5)


def test_grouped_kv_heads_equal_repeated_heads():
    """Fewer kv heads than q heads: head h reads kv head h // group, the
    same as ``jnp.repeat`` of the kv heads (what the model does first)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, (2, 6, 40, 64)))
    k, v = (torch.from_numpy(_normal(rng, (2, 2, 40, 64))) for _ in range(2))
    got = flash_attention(q, k, v)
    want = pallas_flash(jnp.asarray(q.numpy()),
                        jnp.repeat(jnp.asarray(k.numpy()), 3, axis=1),
                        jnp.repeat(jnp.asarray(v.numpy()), 3, axis=1),
                        block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_flash_route_matches_chunked_route():
    """The model's plain chunked attention and the flash route agree (the
    reference's test_flash_matches_chunked_model_path)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_normal(rng, (2, 64, 8, 64)))
    k, v = (torch.from_numpy(_normal(rng, (2, 64, 2, 64))) for _ in range(2))
    ones = torch.ones(2, 64, dtype=torch.int32)
    plain = plain_chunked_attention(q, k, v, segment_ids=ones, chunk=16)
    flash = chunked_attention(q, k, v)
    np.testing.assert_allclose(plain.numpy(), flash.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 8, 32), *(torch.zeros(1, 2, 8, 32),
                                                     ) * 2)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 3, 8, 64), x, x)      # 3 % 2 != 0
    with pytest.raises(ValueError):
        flash_attention(x, torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 9, 64))
    with pytest.raises(ValueError):
        flash_attention(x[0], x[0], x[0])
    with pytest.raises(TypeError):
        flash_attention(x, x.double(), x)
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half())


def test_bf16_operands_are_copied_only_when_rows_are_unaligned():
    """The kernels stage 16-byte rows with cp.async (bf16 and, since its
    kernels moved to the tensor cores, fp32): a view whose base or strides
    are not 16-byte aligned is handed over as a contiguous copy; aligned
    strided views (the model's transposes) are not."""
    n = 2 * 80 * 3 * 64
    x = torch.arange(n + 8, dtype=torch.float32).bfloat16()
    view = x[:n].view(2, 80, 3, 64).transpose(1, 2)
    assert _kernel_operand(view) is view
    for t in (x[1:1 + n].view(2, 3, 80, 64),           # base 2 bytes off
              x[:n].view(2, 80, 3, 64)[..., 1:57],    # the same, strided
              x[:26112].view(2, 3, 64, 68)[..., :64]):  # rows 136 bytes apart
        got = _kernel_operand(t)
        assert got is not t and torch.equal(got, t)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    narrow = x[:n].view(2, 80, 3, 64)[..., :56]       # 16-byte rows
    assert _kernel_operand(narrow) is narrow
    x32 = x.float()
    view32 = x32[:n].view(2, 80, 3, 64).transpose(1, 2)
    assert _kernel_operand(view32) is view32
    for t in (x32[1:1 + n].view(2, 3, 80, 64),         # base 4 bytes off
              x32[:25344].view(2, 3, 64, 66)[..., :64],  # 264-byte rows
              x32[:n].view(2, 80, 3, 64)[..., 2:58]):  # base 8 bytes off
        got = _kernel_operand(t)
        assert got is not t and torch.equal(got, t)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    rows32 = x32[:26112].view(2, 3, 64, 68)[..., 4:68]  # 272-byte rows, 16 off
    assert _kernel_operand(rows32) is rows32
    assert _kernel_operand(x[:n].view(2, 3, 80, 64)[..., ::2]).stride(-1) == 1


# ---------------------------------------------------------------------------
# int8 / bit-plane GEMM
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(8, 16, 8), (128, 128, 128), (100, 60, 200), (130, 96, 257)]


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_int8_and_bitplane_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want = np.asarray(pallas_int8(jx, jw))
    assert_bits_equal(want, np.asarray(jref.int8_matmul_ref(jx, jw)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert_bits_equal(want, int8_matmul(tx, tw).numpy(), "int8")
    assert_bits_equal(np.asarray(pallas_bitplane(jx, jw)),
                      bitplane_matmul(tx, tw).numpy(), "bitplane")
    assert_bits_equal(np.asarray(jref.bitplane_matmul_ref(jx, jw)),
                      ref.bitplane_matmul_ref(tx, tw).numpy(), "oracle")


def test_bitplane_nbits4():
    """4-bit weights use 4 planes; values in [-8, 7]."""
    rng = np.random.default_rng(5)
    x, w4 = _int8(rng, (32, 32)), _int8(rng, (32, 32), -8, 8)
    got = bitplane_matmul(torch.from_numpy(x), torch.from_numpy(w4), nbits=4)
    assert_bits_equal(np.asarray(pallas_bitplane(jnp.asarray(x),
                                                 jnp.asarray(w4), nbits=4)),
                      got.numpy())
    assert_bits_equal(np.asarray(jref.int8_matmul_ref(jnp.asarray(x),
                                                      jnp.asarray(w4))),
                      got.numpy())


def test_int32_wraparound_matches_the_reference():
    """Products past int32 wrap in the reference's arithmetic; the plain
    versions wrap the same way (K large enough for 127*127*K > 2**31)."""
    x = np.full((2, 140_000), 127, np.int8)
    w = np.full((140_000, 3), 127, np.int8)
    want = np.asarray(jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    assert want.min() < 0                      # it did wrap
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert_bits_equal(want, ref.int8_matmul_ref(tx, tw).numpy())
    assert_bits_equal(want, ref.bitplane_matmul_ref(tx, tw).numpy())


@pytest.mark.parametrize("bitserial", [False, True])
def test_quantized_matmul_bit_equal(bitserial):
    rng = np.random.default_rng(6)
    x = _normal(rng, (64, 96))
    w = _normal(rng, (96, 32))
    jwq, jws = jref.quantize_rowwise_ref(jnp.asarray(w.T))
    wq, ws = ref.quantize_rowwise_ref(torch.from_numpy(w.T.copy()))
    assert_bits_equal(np.asarray(jwq), wq.numpy(), "wq")
    assert_bits_equal(np.asarray(jws), ws.numpy(), "scale")
    jxq, jxs = jref.quantize_rowwise_ref(jnp.asarray(x))
    xq, xs = ref.quantize_rowwise_ref(torch.from_numpy(x))
    assert_bits_equal(np.asarray(jxq), xq.numpy(), "xq")
    assert_bits_equal(np.asarray(jxs), xs.numpy(), "xs")
    want = jops.quantized_matmul(jnp.asarray(x), jwq.T, jws[:, 0],
                                 bitserial=bitserial, force_pallas=True)
    got = ops.quantized_matmul(torch.from_numpy(x), wq.T, ws[:, 0],
                               bitserial=bitserial)
    assert_bits_equal(np.asarray(want), got.numpy())


def test_quantize_zero_row():
    q, s = ref.quantize_rowwise_ref(torch.zeros(2, 8))
    assert (s == 1).all() and (q == 0).all()


def test_gemm_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_matmul(a, torch.zeros(4, 8, dtype=torch.int8))
    with pytest.raises(TypeError):
        int8_matmul(a.float(), torch.zeros(8, 4))
    with pytest.raises(ValueError):
        int8_matmul(a[0], torch.zeros(8, dtype=torch.int8))
    for nbits in (0, 9):
        with pytest.raises(ValueError):
            bitplane_matmul(a, torch.zeros(8, 4, dtype=torch.int8), nbits)


def test_cpu_tensors_launch_no_kernel():
    before = (flash_attention.launches, int8_matmul.launches,
              bitplane_matmul.launches)
    x = torch.zeros(1, 1, 4, 64)
    flash_attention(x, x, x)
    a = torch.ones(4, 4, dtype=torch.int8)
    int8_matmul(a, a)
    bitplane_matmul(a, a, 3)
    assert (flash_attention.launches, int8_matmul.launches,
            bitplane_matmul.launches) == before
