"""The arithmetic of the port's tensor-core kernels, emulated on the CPU.

The CUDA kernels cannot run here, so their rounding points and operand
identities are emulated in plain PyTorch / NumPy (in this file, not in the
package) and held against the reference's Pallas kernels in interpret mode:

* the bf16 flash-attention kernel (``csrc/flash_attention.cu``,
  ``flash_fwd_mma_kernel``): bf16 products summed in fp32, the softmax
  scale on the fp32 logits, ``-1e30`` masking and the ``> -1e30/2`` guard,
  ``p`` rounded to bf16 before ``P V``, ``l`` summed from the fp32 ``p``;
  it must stay within the card's limit ``FLASH_BF16_TOL`` (rtol 1e-2,
  atol 8e-3, ``tests/_torch_card.py``) of the reference;
* the bit-plane GEMM kernel (``csrc/bitplane_gemm.cu``,
  ``bitplane_gemm_kernel``): plane ``b``'s s8 operand is a 32-bit word of
  four weight bytes masked with ``0x01010101 << b`` (bytes 0 or ``2**b``,
  ``0x80 = -128`` on plane 7), negated byte by byte on a top plane below 7;
  summing ``x @ op_b`` over the planes in wrapping int32 must equal the
  reference bit for bit;
* the int8 instance of the same kernel (``bitplane_gemm_kernel<true>``,
  ``int8_matmul``): one s8 product per 32 bytes of K on the raw packed
  words, no plane masks, accumulated in wrapping int32 step by step, must
  equal the reference's ``_int8_kernel`` bit for bit.

The plain versions in ``repro_torch.kernels.ref`` stay the oracles the
kernels are held against on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitplane_gemm import bitplane_matmul as pallas_bitplane
from repro.kernels.bitplane_gemm import int8_matmul as pallas_int8
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import ref

from _torch_card import FLASH_BF16_TOL
from _torch_parity import assert_bits_equal

NEG_INF = -1e30
KV_TILE = 64                                   # kv rows per kernel tile


# ---------------------------------------------------------------------------
# (a) flash attention, bf16 on the tensor cores
# ---------------------------------------------------------------------------

def emulate_flash_mma(q, k, v, causal):
    """The bf16 kernel's arithmetic on bf16 ``(B, H, S, D)`` CPU tensors
    (kv heads shared by ``H / Hkv`` q heads), tile by tile of 64 keys."""
    group = q.shape[1] // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(sq) + (sk - sq)
    m = torch.full(q.shape[:-1], NEG_INF)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, sk, KV_TILE):
        kt, vt = kf[..., k0:k0 + KV_TILE, :], vf[..., k0:k0 + KV_TILE, :]
        # bf16 x bf16 products are exact in fp32; the sums are fp32; the
        # scale multiplies the fp32 logits
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            key = torch.arange(k0, k0 + kt.shape[-2])
            s = torch.where(pos[:, None] >= key[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(dim=-1)                 # from the fp32 p
        pv = p.bfloat16().float() @ vt                # p rounded to bf16
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).bfloat16()


FLASH_CASES = [  # (heads, kv heads, sq, sk, causal, d)
    (14, 2, 256, 256, True, 64), (14, 2, 256, 256, False, 64),
    (14, 2, 256, 256, True, 128), (14, 2, 256, 256, False, 128),
    (4, 2, 77, 200, True, 64), (4, 4, 33, 95, False, 128),
    (2, 1, 1, 128, True, 64),
]


def _bf16_inputs(seed, h, hk, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (1, n, s, d)).astype(np.float32)).bfloat16()
        for n, s in ((h, sq), (hk, sk), (hk, sk)))


@pytest.mark.parametrize("h,hk,sq,sk,causal,d", FLASH_CASES)
def test_flash_mma_rounding_holds_the_card_limit(h, hk, sq, sk, causal, d):
    """The kernel's rounding points against the reference's Pallas kernel
    in interpret mode (q in fp32, P V in fp32) and against the port's plain
    version, within the limit the card holds the kernel to."""
    q, k, v = _bf16_inputs(sq * 7 + sk + d, h, hk, sq, sk, d)
    got = emulate_flash_mma(q, k, v, causal).float().numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    want = pallas_flash(jq, jnp.repeat(jk, h // hk, axis=1),
                        jnp.repeat(jv, h // hk, axis=1), causal=causal,
                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **FLASH_BF16_TOL)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got, plain.float().numpy(), **FLASH_BF16_TOL)


def test_flash_mma_rows_with_no_key_come_out_zero():
    """Causal with Sq > Sk: the kernel's -1e30 / guard arithmetic gives 0
    on rows that see no key, as the reference's Pallas kernel does."""
    q, k, v = _bf16_inputs(9, 2, 2, 24, 16, 64)
    got = emulate_flash_mma(q, k, v, True).float().numpy()
    want = np.asarray(pallas_flash(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), block_q=8, block_k=8), np.float32)
    assert (got[:, :, :8] == 0).all() and (want[:, :, :8] == 0).all()
    np.testing.assert_allclose(got, want, **FLASH_BF16_TOL)


def test_scaling_q_in_bf16_would_round_it():
    """Why the kernel scales the fp32 logits and not q: at D = 128 the
    scale is not a power of two, and q * scale rounded to bf16 loses bits
    the reference (q scaled in fp32) keeps; at D = 64 (scale 1/8) nothing
    is lost."""
    q = _bf16_inputs(3, 1, 1, 64, 1, 128)[0].float()
    for d, lossy in ((128, True), (64, False)):
        scaled = q * (1.0 / math.sqrt(d))
        assert (not torch.equal(scaled.bfloat16().float(), scaled)) == lossy


# ---------------------------------------------------------------------------
# (b) bit-plane GEMM, int8 on the tensor cores
# ---------------------------------------------------------------------------

def _words(w):
    """The kernel's B registers: four consecutive k of one column of
    ``w (K, N)`` int8 per uint32 word (k zero-padded to a multiple of 4),
    as ``(N, ceil(K / 4))``."""
    k, n = w.shape
    col = np.zeros((n, -(-k // 4) * 4), np.uint8)
    col[:, :k] = w.view(np.uint8).T
    return col.view(np.uint32)


def _vneg4(words):
    """``__vneg4``: each byte negated mod 256."""
    b = words.view(np.uint8).astype(np.int16)
    return ((-b) & 0xFF).astype(np.uint8).view(np.uint32)


def emulate_bitplane_mma(x, w, nbits):
    """Sum over planes of ``x @ op_b`` with the kernel's plane operands, in
    wrapping int32 -> int32 ``(M, N)``."""
    m, k = x.shape
    words = _words(w)
    xw = np.zeros((m, words.shape[1] * 4), np.int64)
    xw[:, :k] = x
    acc = np.zeros((m, w.shape[1]), np.int64)
    for b in range(nbits):
        op = words & np.uint32(0x01010101 << b)   # bytes 0 or 2**b as s8
        if b == nbits - 1 and b < 7:
            op = _vneg4(op)
        acc += xw @ op.view(np.int8).astype(np.int64).T
    return ((acc + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("nbits", range(1, 9))
def test_bitplane_operands_equal_the_reference(nbits):
    """Random int8 x and w (K not a multiple of 4): bit for bit equal to
    the reference's Pallas kernel in interpret mode and to the port's plain
    version, for every plane count."""
    rng = np.random.default_rng(nbits)
    x = rng.integers(-128, 128, (40, 101)).astype(np.int8)
    w = rng.integers(-128, 128, (101, 24)).astype(np.int8)
    got = emulate_bitplane_mma(x, w, nbits)
    want = pallas_bitplane(jnp.asarray(x), jnp.asarray(w), nbits=nbits,
                           interpret=True)
    assert_bits_equal(np.asarray(want), got, f"pallas nbits={nbits}")
    plain = ref.bitplane_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    nbits)
    assert_bits_equal(plain.numpy(), got, f"plain nbits={nbits}")


def test_bitplane_top_plane_is_the_negative_power():
    """Plane 7's mask gives 0x80 = -128 as s8 without a negation; a top
    plane below 7 is negated (values in [-2**(n-1), 2**(n-1)) for n
    planes)."""
    w = np.array([[-128, 127, -1, 0]], np.int8)
    op7 = (_words(w) & np.uint32(0x80808080)).view(np.int8)
    np.testing.assert_array_equal(op7[:, 0], [-128, 0, -128, 0])
    w4 = np.arange(-8, 8, dtype=np.int8)[:, None]           # every 4-bit value
    x = np.eye(16, dtype=np.int8)
    assert_bits_equal(w4.astype(np.int32), emulate_bitplane_mma(x, w4, 4))


def test_bitplane_operands_wrap_as_int32():
    """x = w = -128 with 16384 * K > 2**31: every int32 sum wraps, in the
    reference's Pallas kernel and in the plane operands alike."""
    k = 131104
    x = np.full((16, k), -128, np.int8)
    w = np.full((k, 16), -128, np.int8)
    got = emulate_bitplane_mma(x, w, 8)
    assert got[0, 0] == 16384 * k - 2**32                 # it wrapped
    want = pallas_bitplane(jnp.asarray(x), jnp.asarray(w), nbits=8,
                           interpret=True)
    assert_bits_equal(np.asarray(want), got)


# ---------------------------------------------------------------------------
# (c) the int8 product on the same tensor cores: full bytes, one mma per step
# ---------------------------------------------------------------------------

MMA_K = 32                                     # K bytes of one m16n8k32


def _wrap32(a):
    return (a + 2**31) % 2**32 - 2**31


def emulate_int8_mma(x, w):
    """``x @ w`` as the int8 instance multiplies it: the B registers are the
    raw packed weight words (no plane mask), one s8 product per 32 bytes of
    K (zero-filled past K), each added into int32 accumulators that wrap."""
    m, k = x.shape
    words = _words(w)
    kp = -(-k // MMA_K) * MMA_K
    xw = np.zeros((m, kp), np.int64)
    xw[:, :k] = x
    op = np.zeros((w.shape[1], kp), np.int64)
    op[:, :words.shape[1] * 4] = words.view(np.int8)
    acc = np.zeros((m, w.shape[1]), np.int64)
    for k0 in range(0, kp, MMA_K):
        acc = _wrap32(acc + xw[:, k0:k0 + MMA_K] @ op[:, k0:k0 + MMA_K].T)
    return acc.astype(np.int32)


@pytest.mark.parametrize("m, k, n", [(40, 101, 24), (130, 257, 96),
                                     (8, 16, 8), (1, 3, 5)])
def test_int8_operands_equal_the_reference(m, k, n):
    """Random int8 x and w, K not a multiple of 4 and M, N ragged against
    the 128x128 tile: bit for bit equal to the reference's ``_int8_kernel``
    in interpret mode and to the port's plain version."""
    rng = np.random.default_rng(m * k * n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = emulate_int8_mma(x, w)
    want = pallas_int8(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert_bits_equal(np.asarray(want), got, "pallas")
    plain = ref.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert_bits_equal(plain.numpy(), got, "plain")


def test_int8_operands_wrap_as_int32():
    """x = w = -128 with 16384 * K > 2**31: the step-by-step int32 sums
    wrap to the reference's -2,146,959,360, as the s32 accumulators without
    ``.satfinite`` do."""
    k = 131104
    x = np.full((16, k), -128, np.int8)
    w = np.full((k, 16), -128, np.int8)
    got = emulate_int8_mma(x, w)
    assert got[0, 0] == 16384 * k - 2**32 == -2146959360
    want = pallas_int8(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert_bits_equal(np.asarray(want), got)
