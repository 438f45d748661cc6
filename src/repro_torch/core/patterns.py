"""Common data-parallel patterns of Section IV, as frontend-built kernels.

Each pattern models one representative kernel of the 12 Swan libraries
(Table III).  A pattern supplies:

  * an MVE program built with the *kernel frontend*
    (:mod:`repro_torch.frontend`, docs/FRONTEND.md): named tensor operands,
    dimension scopes and operator-overloaded vector handles instead of
    hand-assigned register numbers and raw base offsets.  The emitted
    programs are instruction-for-instruction equivalent (modulo the
    register renaming chosen by the allocator) to the original
    hand-coded instruction lists, which live on as equivalence
    references in ``tests/legacy_patterns.py``;
  * an initial flat memory image and a correctness check (numpy oracle)
    that reads results back *by operand name*;
  * an analytic workload descriptor for the packed-SIMD (Neon) and GPU
    baseline cost models of Figure 7/8/9.

The RVV baseline trace for the same pattern is obtained by lowering the
MVE program with :func:`repro_torch.core.rvv.compile_to_rvv`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from . import isa
from .isa import DType
from .machine import MVEConfig, to_numpy
from ..frontend import BCAST, CR, DERIVED, SEQ, Kernel, KernelBuilder

LANES = MVEConfig().lanes  # 8192


@dataclasses.dataclass
class NeonWork:
    vector_ops: float      # SIMD ops per element
    elements: float        # total elements processed
    bits: int
    mem_bytes: float


@dataclasses.dataclass
class PatternRun:
    name: str
    library: str
    dim: str                                  # "1D" / "2D" / "3D" / "4D"
    program: isa.Program
    memory: np.ndarray
    check: Callable[[np.ndarray, object], None]
    neon: NeonWork
    flops: float = 0.0                        # for the GPU model
    copy_bytes: float = 0.0
    kernel: Optional[Kernel] = None           # the frontend build

    def results(self, mem_after) -> Dict[str, np.ndarray]:
        """Named result tensors of an executed memory image."""
        return self.kernel.unpack(mem_after)


def _pattern(kernel: Kernel, library: str, dim: str,
             check: Callable[[np.ndarray, object], None], neon: NeonWork,
             flops: float = 0.0, copy_bytes: float = 0.0,
             memory: Optional[np.ndarray] = None) -> PatternRun:
    """Shared PatternRun construction: program + packed memory from one
    built kernel (``memory`` overrides for pointer tables that need the
    planner's layout — see ``upsample``)."""
    return PatternRun(kernel.name, library, dim, kernel.program,
                      kernel.pack() if memory is None else memory,
                      check, neon, flops, copy_bytes, kernel=kernel)


# ---------------------------------------------------------------------------
# 1. Linpack: daxpy (1D)                        y[i] += alpha * x[i]
# ---------------------------------------------------------------------------

def daxpy(n: int = LANES, seed: int = 0) -> PatternRun:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    alpha = 1.5
    expected = y + np.float32(alpha) * x

    b = KernelBuilder("daxpy")
    xo = b.input("x", (n,), DType.F, init=x)
    yo = b.inout("y", (n,), DType.F, init=y)
    b.width(32)
    with b.dims(n):
        b.scalar(4)
        vx = xo.load(SEQ)
        vy = yo.load(SEQ)
        vy += alpha * vx
        yo.store(vy, SEQ)
    k = b.build()

    def check(mem_after, state):
        np.testing.assert_allclose(k.unpack(mem_after)["y"], expected,
                                   rtol=1e-5)

    return _pattern(k, "Linpack", "1D", check,
                    NeonWork(vector_ops=2, elements=n, bits=32,
                             mem_bytes=3 * 4 * n),
                    flops=2 * n, copy_bytes=8 * n)


# ---------------------------------------------------------------------------
# 2. XNNPACK: row-wise GEMM with multi-dimensional replication (Section IV)
# ---------------------------------------------------------------------------

def gemm(n_rows: int = 128, k: int = 16, m: int = 64, seed: int = 1,
         lanes: int = LANES, dtype: DType = DType.F) -> PatternRun:
    """C[N,M] = A[N,K] @ B[K,M] with input/weight replication (2D).

    ``dtype=DType.W`` gives the quantized-CNN (int16) variant used for
    the Figure 9 GPU-crossover sweep."""
    rng = np.random.default_rng(seed)
    if dtype is DType.W:
        a = rng.integers(-8, 8, (n_rows, k)).astype(np.float32)
        w = rng.integers(-8, 8, (k, m)).astype(np.float32)
    else:
        a = rng.standard_normal((n_rows, k)).astype(np.float32)
        w = rng.standard_normal((k, m)).astype(np.float32)
    rows_per_iter = min(lanes // m, n_rows, 256)
    expected = (a @ w).astype(np.float32)

    b = KernelBuilder("gemm")
    ao = b.input("a", (n_rows, k), dtype, init=a)
    wo = b.input("b", (k, m), dtype, init=w)
    co = b.output("c", (n_rows, m), dtype)
    b.width(dtype.bits)
    # input column stride (CR d1) = K; output row stride (CR d1) = M
    with b.dims(m, rows_per_iter, ld_strides={1: k}, st_strides={1: m}):
        for n0 in range(0, n_rows, rows_per_iter):
            b.scalar(6)                       # loop + addressing
            acc = b.const(dtype, 0)
            for kk in range(k):
                b.scalar(4)
                # input column A[n0:n0+R, kk] replicated horizontally
                col = ao.at(n0, kk).load(BCAST, CR)
                # weight row B[kk, :] replicated vertically
                row = wo.at(kk, 0).load(SEQ, BCAST)
                acc += col * row
            # store R output rows sequentially (S0=1, S1=M via mode 2)
            co.at(n0, 0).store(acc, SEQ, DERIVED)
    kern = b.build()

    def check(mem_after, state):
        got = kern.unpack(mem_after)["c"]
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)

    flops = 2.0 * n_rows * k * m
    return _pattern(kern, "XNNPACK", "2D", check,
                    NeonWork(vector_ops=2 * k, elements=n_rows * m, bits=32,
                             mem_bytes=4.0 * (n_rows * k + k * m +
                                              n_rows * m)),
                    flops=flops,
                    copy_bytes=4.0 * (n_rows * k + k * m + n_rows * m))


# ---------------------------------------------------------------------------
# 3. XNNPACK: SpMM — CSR sparse inputs, random weight-row loads (Section IV)
# ---------------------------------------------------------------------------

def spmm(rows: int = 64, cols: int = 64, m: int = 64, density: float = 0.25,
         seed: int = 2, lanes: int = LANES) -> PatternRun:
    """out[r,:] = sum_nz A[r,c] * W[c,:] using random-base loads."""
    rng = np.random.default_rng(seed)
    a = (rng.random((rows, cols)) < density) * \
        rng.standard_normal((rows, cols))
    a = a.astype(np.float32)
    w = rng.standard_normal((cols, m)).astype(np.float32)
    expected = (a @ w).astype(np.float32)

    nnz_r, nnz_c = np.nonzero(a)
    nnz_v = a[nnz_r, nnz_c]
    group = min(lanes // m, 256)

    b = KernelBuilder("spmm")
    wo = b.input("w", (cols, m), DType.F, init=w)
    vo = b.input("values", (len(nnz_v),), DType.F, init=nnz_v)
    # "Core computes the weight row addresses corresponding to non-zero
    # input cells" — the pointer array the random load walks.
    po = b.input("row_ptrs", (len(nnz_v),), DType.F,
                 init=wo.addr(nnz_c * m))
    oo = b.output("partial", (len(nnz_v), m), DType.F)
    b.width(32)
    i = 0
    while i < len(nnz_v):
        g = min(group, len(nnz_v) - i)
        b.scalar(8)
        b.dims(m, g)
        # nnz values replicated horizontally from a strided load
        val = vo.at(i).load(BCAST, SEQ)
        # weight rows from random base pointers, sequential inner dim
        wrow = po.at(i).rload(SEQ)
        prod = val * wrow
        # store partial products; combined on the scalar core per-row
        oo.at(i, 0).store(prod, SEQ, DERIVED)
        b.scalar(2 * g)
        i += g
    kern = b.build()

    def check(mem_after, state):
        partial = kern.unpack(mem_after)["partial"]
        got = np.zeros((rows, m), dtype=np.float32)
        for j, r in enumerate(nnz_r):
            got[r] += partial[j].astype(np.float32)
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)

    flops = 2.0 * len(nnz_v) * m
    return _pattern(kern, "XNNPACK", "2D", check,
                    NeonWork(vector_ops=2 * density * cols,
                             elements=rows * m, bits=32,
                             mem_bytes=4.0 * (len(nnz_v) * (m + 2) +
                                              rows * m)),
                    flops=flops,
                    copy_bytes=4.0 * (cols * m + 2 * len(nnz_v)))


# ---------------------------------------------------------------------------
# 4. CMSIS-DSP: FIR filter (1D, multiple shifted loads)
# ---------------------------------------------------------------------------

def fir(n: int = LANES, taps: int = 16, seed: int = 3) -> PatternRun:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n + taps).astype(np.float32)
    h = rng.standard_normal(taps).astype(np.float32)
    expected = np.stack([x[t:t + n] for t in range(taps)], 0).T @ h

    b = KernelBuilder("fir")
    xo = b.input("x", (n + taps,), DType.F, init=x)
    yo = b.output("y", (n + taps,), DType.F)
    b.width(32)
    with b.dims(n):
        acc = b.const(DType.F, 0.0)
        for t in range(taps):
            b.scalar(3)
            acc += xo.at(t).load(SEQ) * float(h[t])
        yo.store(acc, SEQ)
    k = b.build()

    def check(mem_after, state):
        np.testing.assert_allclose(k.unpack(mem_after)["y"][:n],
                                   expected, rtol=1e-4, atol=1e-4)

    return _pattern(k, "CMSIS-DSP", "1D", check,
                    NeonWork(vector_ops=2 * taps, elements=n, bits=32,
                             mem_bytes=4.0 * (taps * n / 4 + 2 * n)),
                    flops=2.0 * taps * n, copy_bytes=8.0 * n)


# ---------------------------------------------------------------------------
# 5. Kvazaar: intra-picture prediction (3D strided load, Figure 3)
# ---------------------------------------------------------------------------

def intra_pred(blocks: int = 256, seed: int = 4) -> PatternRun:
    """3D load with S=(1,0,3): each 3-pel reference row is replicated down
    a 3x3 predicted block (Figure 3), then averaged with a second ref."""
    bs = 3
    refs = np.random.default_rng(seed).integers(
        0, 255, size=(blocks, bs)).astype(np.int32)
    refs2 = np.random.default_rng(seed + 1).integers(
        0, 255, size=(blocks, bs)).astype(np.int32)
    # predicted[b, y, x] = (ref1[b, x] + ref2[b, y]) >> 1  (planar-ish)
    expected = (refs[:, None, :] + refs2[:, :, None]) >> 1

    b = KernelBuilder("intra_pred")
    r1 = b.input("ref1", (blocks, bs), DType.W, init=refs)
    r2 = b.input("ref2", (blocks, bs), DType.W, init=refs2)
    out = b.output("pred", (blocks, bs, bs), DType.W)
    b.width(32)
    with b.dims(bs, bs, blocks, ld_strides={2: bs}):
        b.scalar(6)
        # ref row replicated down the column dim: S = (1, 0, 3)
        row = r1.load(SEQ, BCAST, CR)
        # ref col replicated across the row dim: S = (0, 1, 3)
        col = r2.load(BCAST, SEQ, CR)
        pred = row + col
        pred >>= 1
        out.store(pred, SEQ, DERIVED, DERIVED)
    k = b.build()

    def check(mem_after, state):
        got = k.unpack(mem_after)["pred"].astype(np.int64)
        np.testing.assert_array_equal(got, expected)

    n = blocks * bs * bs
    return _pattern(k, "Kvazaar", "3D", check,
                    NeonWork(vector_ops=3, elements=n, bits=16,
                             mem_bytes=4.0 * (2 * blocks * bs + n)),
                    flops=2.0 * n, copy_bytes=4.0 * n)


# ---------------------------------------------------------------------------
# 6. libjpeg: h2v2 upsample (random base + replication, Figure 4)
# ---------------------------------------------------------------------------

def upsample(rows: int = 32, m: int = 128, seed: int = 5) -> PatternRun:
    """Each pixel replicated 2x horizontally; vertical replication via
    duplicated row pointers (the paper's 4th random dimension)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, size=(rows, m)).astype(np.int32)
    # rows live at "random" (shuffled) locations, like libjpeg row pointers
    row_order = rng.permutation(rows)
    mem_rows = np.zeros(rows * m)
    slot_of = np.zeros(rows, dtype=np.int64)
    for slot, r in enumerate(row_order):
        mem_rows[slot * m:(slot + 1) * m] = img[r]
        slot_of[r] = slot * m
    expected = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)

    group = max(1, min(LANES // (2 * m), 2 * rows, 256))
    b = KernelBuilder("upsample")
    ro = b.input("rows", (rows, m), DType.B, init=mem_rows)
    # input pointer per *output* row (each input row appears twice);
    # pointer operands carry the dtype of the data they point at
    ip = b.input("in_ptrs", (2 * rows,), DType.B,
                 init=ro.addr(np.repeat(slot_of, 2)))
    op_ = b.input("out_ptrs", (2 * rows,), DType.B)
    out = b.output("out", (2 * rows, 2 * m), DType.B)
    b.width(32)
    for n0 in range(0, 2 * rows, group):
        g = min(group, 2 * rows - n0)
        b.scalar(6)
        b.dims(2, m, g)
        # load: replicate 2x (S0=0), pixels sequential (S1=1),
        # random row base from the pointer array
        px = ip.at(n0).rload(BCAST, SEQ)
        # store: sequential (S0=1), row-major (S1=2 -> derived 2),
        # random output row base
        op_.at(n0).rstore(px, SEQ, DERIVED)
    k = b.build()
    # the output-row pointer table points into the planner-assigned
    # "out" region — fill it through pack() overrides
    memory = k.pack({"out_ptrs": out.addr(np.arange(2 * rows) * (2 * m))})

    def check(mem_after, state):
        got = k.unpack(mem_after)["out"].astype(np.int64)
        np.testing.assert_array_equal(got, expected)

    n = rows * m
    return _pattern(k, "libjpeg", "4D", check,
                    NeonWork(vector_ops=3, elements=4 * n, bits=8,
                             mem_bytes=5.0 * n),
                    flops=4.0 * n, copy_bytes=5.0 * n, memory=memory)


# ---------------------------------------------------------------------------
# 7. libpng: "up" defilter — rows at random pointers (2D random)
# ---------------------------------------------------------------------------

def png_up(rows: int = 64, width: int = 128, seed: int = 6) -> PatternRun:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 255, size=(rows, width)).astype(np.int32)
    prior = rng.integers(0, 255, size=(rows, width)).astype(np.int32)
    expected = (raw + prior) & 0xFF

    group = max(1, min(LANES // width, rows, 256))
    b = KernelBuilder("png_up")
    ro = b.input("raw", (rows, width), DType.B, init=raw)
    po = b.input("prior", (rows, width), DType.B, init=prior)
    rp = b.input("raw_ptrs", (rows,), DType.B,
                 init=ro.addr(np.arange(rows) * width))
    pp = b.input("prior_ptrs", (rows,), DType.B,
                 init=po.addr(np.arange(rows) * width))
    out = b.output("out", (rows, width), DType.B)
    b.width(32)
    for r0 in range(0, rows, group):
        g = min(group, rows - r0)
        b.scalar(5)
        b.dims(width, g)
        vr = rp.at(r0).rload(SEQ)
        vp = pp.at(r0).rload(SEQ)
        s = vr + vp                        # uint8 wrap == & 0xFF
        out.at(r0, 0).store(s, SEQ, DERIVED)
    k = b.build()

    def check(mem_after, state):
        got = k.unpack(mem_after)["out"].astype(np.int64)
        np.testing.assert_array_equal(got, expected)

    n = rows * width
    return _pattern(k, "libpng", "2D", check,
                    NeonWork(vector_ops=3, elements=n, bits=8,
                             mem_bytes=3.0 * n),
                    flops=float(n), copy_bytes=3.0 * n)


# ---------------------------------------------------------------------------
# 8. libwebp: RGB -> gray (strided channel loads)
# ---------------------------------------------------------------------------

def rgb2gray(pixels: int = LANES, seed: int = 7) -> PatternRun:
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 255, size=(pixels, 3)).astype(np.int32)
    expected = (5 * rgb[:, 0] + 9 * rgb[:, 1] + 2 * rgb[:, 2]) >> 4

    b = KernelBuilder("rgb2gray")
    px = b.input("rgb", (pixels, 3), DType.W, init=rgb)
    out = b.output("gray", (pixels,), DType.W)
    b.width(16)
    with b.dims(pixels, ld_strides={0: 3}):
        b.scalar(4)
        r = px.at(0, 0).load(CR)           # R, stride 3
        g = px.at(0, 1).load(CR)           # G
        bl = px.at(0, 2).load(CR)          # B
        r *= 5
        g *= 9
        bl *= 2
        r += g
        r += bl
        r >>= 4
        out.store(r, SEQ)
    k = b.build()

    def check(mem_after, state):
        got = k.unpack(mem_after)["gray"].astype(np.int64)
        np.testing.assert_array_equal(got, expected)

    return _pattern(k, "libwebp", "1D", check,
                    NeonWork(vector_ops=10, elements=pixels, bits=16,
                             mem_bytes=4.0 * pixels),
                    flops=6.0 * pixels, copy_bytes=4.0 * pixels)


# ---------------------------------------------------------------------------
# 9. Skia: alpha blend (8-bit pixels, 2D rows)
# ---------------------------------------------------------------------------

def alpha_blend(rows: int = 64, width: int = 128, seed: int = 8
                ) -> PatternRun:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 255, size=(rows, width)).astype(np.int32)
    dst = rng.integers(0, 255, size=(rows, width)).astype(np.int32)
    alpha = 6                        # 4-bit alpha: 6/16 src + 10/16 dst
    expected = (src * alpha + dst * (16 - alpha)) >> 4

    b = KernelBuilder("alpha_blend")
    so = b.input("src", (rows, width), DType.W, init=src)
    do = b.inout("dst", (rows, width), DType.W, init=dst)
    b.width(32)
    with b.dims(width, rows):
        b.scalar(4)
        s = so.load(SEQ, DERIVED)
        d = do.load(SEQ, DERIVED)
        s *= alpha
        d *= 16 - alpha
        s += d
        s >>= 4
        do.store(s, SEQ, DERIVED)
    k = b.build()

    n = rows * width

    def check(mem_after, state):
        got = k.unpack(mem_after)["dst"].astype(np.int64)
        np.testing.assert_array_equal(got, expected)

    return _pattern(k, "Skia", "2D", check,
                    NeonWork(vector_ops=8, elements=n, bits=8,
                             mem_bytes=3.0 * n),
                    flops=4.0 * n, copy_bytes=3.0 * n)


# ---------------------------------------------------------------------------
# 10. webaudio: multi-channel chunk mixing (3D)
# ---------------------------------------------------------------------------

def audio_mix(chunks: int = 16, channels: int = 4, samples: int = 128,
              seed: int = 9) -> PatternRun:
    """Processes multiple 128-sample chunks at once — the paper's flagship
    example of limited 1D DLP (Section I: webaudio exposes only 128)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((chunks, channels, samples)).astype(np.float32)
    c = rng.standard_normal((chunks, channels, samples)).astype(np.float32)
    gain = 0.7
    expected = (a + c) * np.float32(gain)

    b = KernelBuilder("audio_mix")
    ao = b.input("a", (chunks, channels, samples), DType.F, init=a)
    bo = b.input("b", (chunks, channels, samples), DType.F, init=c)
    out = b.output("out", (chunks, channels, samples), DType.F)
    b.width(32)
    with b.dims(samples, channels, chunks):
        b.scalar(5)
        va = ao.load(SEQ, DERIVED, DERIVED)
        vb = bo.load(SEQ, DERIVED, DERIVED)
        va += vb
        b.keep(vb)          # the mixer holds the second input resident
        va *= gain
        out.store(va, SEQ, DERIVED, DERIVED)
    k = b.build()

    def check(mem_after, state):
        got = k.unpack(mem_after)["out"]
        np.testing.assert_allclose(got, expected, rtol=1e-5)

    n = chunks * channels * samples
    return _pattern(k, "webaudio", "3D", check,
                    NeonWork(vector_ops=2, elements=n, bits=32,
                             mem_bytes=12.0 * n),
                    flops=2.0 * n, copy_bytes=12.0 * n)


# ---------------------------------------------------------------------------
# 11. zlib: adler32-style reduction (dimension-level masked tree, Section IV)
# ---------------------------------------------------------------------------

def reduction(n: int = LANES, seed: int = 10, floor: int = 256
              ) -> PatternRun:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 255, size=n).astype(np.int64)
    expected_sum = int(x.sum())

    b = KernelBuilder("reduction")
    xo = b.input("x", (n,), DType.DW, init=x)
    tmp = b.scratch("tmp", (n // 2,), DType.DW)
    out = b.output("partial", (floor,), DType.DW)
    b.width(32)
    b.dims(n)
    b.scalar(3)
    acc = xo.load(SEQ)
    m = n
    while m > floor:
        half = m // 2
        b.scalar(4)
        # Split M lanes into 2 halves along a fresh highest dim and
        # mask off the first one (Section IV reduction snippet): the
        # unmasked half lands at the start of the scratch region.
        b.dims(half, 2)
        with b.masked_off(0):
            xo.at(n - half).store(acc, SEQ, DERIVED)
        b.dims(half)
        acc += tmp.load(SEQ)
        m = half
    b.dims(floor)
    out.store(acc, SEQ)
    b.scalar(floor)          # final scalar-core reduction
    k = b.build()

    def check(mem_after, state):
        got = int(k.unpack(mem_after)["partial"].sum())
        assert got == expected_sum, (got, expected_sum)

    return _pattern(k, "zlib", "1D", check,
                    NeonWork(vector_ops=2, elements=n, bits=32,
                             mem_bytes=4.0 * n),
                    flops=float(n), copy_bytes=4.0 * n)


# ---------------------------------------------------------------------------
# 12. boringssl: XOR stream cipher with key replication (2D)
# ---------------------------------------------------------------------------

def xor_cipher(blocks: int = 256, key_len: int = 32, seed: int = 11
               ) -> PatternRun:
    rng = np.random.default_rng(seed)
    pt = rng.integers(0, 255, size=(blocks, key_len)).astype(np.int64)
    key = rng.integers(0, 255, size=key_len).astype(np.int64)
    expected = pt ^ key[None, :]

    b = KernelBuilder("xor_cipher")
    po = b.input("plaintext", (blocks, key_len), DType.B, init=pt)
    ko = b.input("key", (key_len,), DType.B, init=key)
    co = b.output("ciphertext", (blocks, key_len), DType.B)
    b.width(8)
    with b.dims(key_len, blocks):
        b.scalar(4)
        vp = po.load(SEQ, DERIVED)
        vk = ko.load(SEQ, BCAST)          # key replicated (S1=0)
        co.store(vp ^ vk, SEQ, DERIVED)
    k = b.build()

    n = blocks * key_len

    def check(mem_after, state):
        got = k.unpack(mem_after)["ciphertext"].astype(np.int64)
        np.testing.assert_array_equal(got & 0xFF, expected)

    return _pattern(k, "boringssl", "2D", check,
                    NeonWork(vector_ops=1, elements=n, bits=8,
                             mem_bytes=2.0 * n),
                    flops=float(n), copy_bytes=2.0 * n)


# ---------------------------------------------------------------------------
# 13. Arm optimized routines: memcpy (1D bytes)
# ---------------------------------------------------------------------------

def memcpy(n: int = LANES, seed: int = 12) -> PatternRun:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 255, size=n).astype(np.int64)

    b = KernelBuilder("memcpy")
    so = b.input("src", (n,), DType.B, init=src)
    do = b.output("dst", (n,), DType.B)
    b.width(8)
    with b.dims(n):
        b.scalar(2)
        do.store(so.load(SEQ), SEQ)
    k = b.build()

    def check(mem_after, state):
        got = k.unpack(mem_after)["dst"].astype(np.int64)
        np.testing.assert_array_equal(got & 0xFF, src)

    return _pattern(k, "ArmRoutines", "1D", check,
                    NeonWork(vector_ops=0.5, elements=n, bits=8,
                             mem_bytes=2.0 * n),
                    flops=0.0, copy_bytes=2.0 * n)


# ---------------------------------------------------------------------------
# 14. Matrix transpose (Section IV; XNNPACK 512x49 MobileNet-V1 case)
# ---------------------------------------------------------------------------

def transpose(m: int = 512, n: int = 49, seed: int = 13) -> PatternRun:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)).astype(np.float32)
    expected = a.T.copy()

    cols_per_iter = max(1, min(LANES // m, 256))
    b = KernelBuilder("transpose")
    ao = b.input("a", (m, n), DType.F, init=a)
    out = b.output("out", (n, m), DType.F)
    b.width(32)
    with b.dims(m, cols_per_iter, ld_strides={0: n}, st_strides={1: m}):
        for i in range(0, n, cols_per_iter):
            c = min(cols_per_iter, n - i)
            if c != cols_per_iter:
                b.dim_length(1, c)
            b.scalar(4)
            # load c columns: element (y,x) <- input[x, i+y]
            v = ao.at(0, i).load(CR, SEQ)
            # store c rows of output: element (y,x) -> output[i+y, x]
            out.at(i, 0).store(v, SEQ, CR)
    k = b.build()

    def check(mem_after, state):
        got = k.unpack(mem_after)["out"]
        np.testing.assert_allclose(got, expected, rtol=1e-6)

    return _pattern(k, "XNNPACK", "2D", check,
                    NeonWork(vector_ops=1.5, elements=m * n, bits=32,
                             mem_bytes=8.0 * m * n),
                    flops=0.0, copy_bytes=8.0 * m * n)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

PATTERNS: Dict[str, Callable[..., PatternRun]] = {
    "daxpy": daxpy,
    "gemm": gemm,
    "spmm": spmm,
    "fir": fir,
    "intra_pred": intra_pred,
    "upsample": upsample,
    "png_up": png_up,
    "rgb2gray": rgb2gray,
    "alpha_blend": alpha_blend,
    "audio_mix": audio_mix,
    "reduction": reduction,
    "xor_cipher": xor_cipher,
    "memcpy": memcpy,
    "transpose": transpose,
}

# Kernels used for the detailed RVV comparison (Figure 10/11 selects kernels
# "with various dimensions and data-parallel patterns").
RVV_COMPARISON_SET = ["daxpy", "reduction", "fir", "xor_cipher", "png_up",
                      "alpha_blend", "gemm", "transpose", "audio_mix",
                      "intra_pred", "upsample"]


# ---------------------------------------------------------------------------
# Execution entry points (compiled engine by default; docs/ENGINE.md)
# ---------------------------------------------------------------------------

def run_pattern(run: PatternRun, cfg: MVEConfig | None = None,
                compiled: bool = True, mode: str | None = None,
                device=None):
    """Execute one pattern; returns ``(mem_after, state)``.

    ``compiled=True`` goes through
    :func:`repro_torch.core.engine.compile_program` (cached);
    ``compiled=False`` uses the step-interpreter oracle.  Both return
    interchangeable state objects carrying the cost-model trace.  ``mode``
    selects the compiled executor (``None`` = engine default); ``device``
    is where it runs (default ``cuda``).
    """
    cfg = cfg or MVEConfig()
    if compiled:
        from .engine import compile_program
        return compile_program(run.program, cfg, mode=mode,
                               device=device).run(run.memory)
    from .interp import MVEInterpreter
    return MVEInterpreter(cfg, compiled=False, device=device).run_stepwise(
        run.program, run.memory)


def sweep(names: Optional[Sequence[str]] = None,
          cfg: MVEConfig | None = None, compiled: bool = True,
          validate: bool = True, mode: str | None = None, device=None,
          ) -> Dict[str, Tuple[PatternRun, object]]:
    """Run every named pattern (default: all) and return name -> (run,
    state), checking each result against the pattern's own NumPy
    reference when ``validate`` is set."""
    out: Dict[str, Tuple[PatternRun, object]] = {}
    for name in (names if names is not None else sorted(PATTERNS)):
        run = PATTERNS[name]()
        mem_after, state = run_pattern(run, cfg, compiled=compiled,
                                       mode=mode, device=device)
        if validate:
            run.check(to_numpy(mem_after), state)
        out[name] = (run, state)
    return out


def run_pattern_batch(name: str, seeds: Sequence[int],
                      cfg: MVEConfig | None = None,
                      mode: str | None = None, device=None, **kw):
    """Evaluate one pattern across many input images in a single batched
    call.

    Builds the pattern for each seed; when every seed produces the same
    program (true for the purely strided kernels — the program depends
    only on sizes), the memory images are stacked and executed by one
    ``run_batch`` over the leading axis.  Data-dependent programs (e.g.
    ``spmm``, whose instruction stream follows the sparsity pattern) fall
    back to per-image runs.

    Returns ``(runs, mem_after)`` where ``mem_after`` is a NumPy array
    with a leading seed axis aligned with ``runs`` (a list of per-seed
    arrays when the fallback produces ragged memory sizes).
    """
    cfg = cfg or MVEConfig()
    from .engine import compile_program
    runs = [PATTERNS[name](seed=s, **kw) for s in seeds]
    same_prog = all(tuple(r.program) == tuple(runs[0].program)
                    for r in runs[1:])
    same_size = all(r.memory.shape == runs[0].memory.shape
                    for r in runs[1:])
    if same_prog and same_size:
        cp = compile_program(runs[0].program, cfg, mode=mode, device=device)
        mems = np.stack([r.memory for r in runs])
        mem_after, _, _ = cp.run_batch(mems)
        return runs, to_numpy(mem_after)
    outs = [to_numpy(
        compile_program(r.program, cfg, mode=mode,
                        device=device).run(r.memory)[0])
        for r in runs]
    if all(o.shape == outs[0].shape for o in outs[1:]):
        return runs, np.stack(outs)
    return runs, outs
