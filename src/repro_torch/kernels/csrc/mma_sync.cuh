// Warp-level tensor-core building blocks shared by the flash-attention
// (forward and backward) and bit-plane GEMM kernels: 16-byte cp.async
// staging into shared memory, ldmatrix fragment loads, the mma.sync shapes
// they use, packing an fp32 C fragment into a bf16 A fragment, and the
// 3xTF32 product of the float32 flash kernels.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / k32"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16 b16, or 16 x 32 bytes), four 32-bit registers:
//       a0 row g, a1 row g + 8 (first half of k), a2 row g, a3 row g + 8
//       (second half of k); each register holds the k values 2t, 2t+1
//       (b16) or 4t .. 4t+3 (bytes) of its half.
//   B (16 x 8 b16, or 32 x 8 bytes), two registers: column g, the same k
//       values of the first (b0) and second (b1) half.
//   C (16 x 8, fp32 or s32): c0, c1 at row g, columns 2t, 2t+1; c2, c3 at
//       row g + 8.
// ldmatrix.x4 hands lane l the row l / 4, b16 columns 2(l % 4), +1 of each
// of four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i.  With .trans each matrix arrives transposed.
//
// m16n8k8 with .tf32 operands (32-bit registers, no ldmatrix: it moves
// 16-bit elements, so the fragments are loaded with 32-bit ld.shared):
//   A (16 x 8), four registers: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//       a3 (g + 8, t + 4);
//   B (8 x 8), two registers: b0 (k t, column g), b1 (k t + 4, column g);
//   C as above.
// The C fragment is not an A fragment here (m16n8k16 bf16's is): C holds
// columns 2t, 2t + 1 where A wants t, t + 4.  The flash kernels instead
// number the k steps of a product over C's columns differently: k step
// t of an 8-column block is column 2t and k step t + 4 is column 2t + 1,
// so c0, c2, c1, c3 are a0 .. a3 as they stand, and the B operand takes
// rows 2t, 2t + 1 of the block (a sum over k in another order, no
// shuffles).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy 16 bytes from global to shared memory without holding registers;
// src_bytes = 0 writes 16 zeros and reads nothing (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows row0 .. row0 + ROWS - 1 of one head (D bf16 a row, row stride
// `stride` elements, 16-byte aligned) into a tile whose rows are padded to
// D + 8 bf16 (a 16-byte skew, so the eight rows one ldmatrix reads hit
// eight distinct groups of four banks), THREADS threads together; rows at
// or past `end` are filled with zeros.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              long long stride,
                                              long long row0, long long end,
                                              int tid) {
    constexpr int LD = D + 8, CHUNKS = D / 8;
#pragma unroll
    for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / CHUNKS, c = i % CHUNKS;
        const long long row = row0 + r;
        const bool in = row < end;
        cp_async16(smem_addr(dst + r * LD + c * 8),
                   in ? src + row * stride + c * 8 : src, in ? 16 : 0);
    }
}

// Two fp32 values rounded to bf16 and packed into one 32-bit register (lo
// in the low half): C fragment c0, c1 (or c2, c3) -> one A register.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// c += a @ b: bf16 16x16 by 16x8, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b: s8 16x32 by 32x8, s32 accumulators that wrap mod 2^32 (no
// .satfinite, so the sum is the reference's int32 arithmetic).
__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: 3xTF32
// ---------------------------------------------------------------------------

// Stage rows row0 .. row0 + ROWS - 1 of one head (D fp32 a row, row stride
// `stride` elements, 16-byte aligned) into a tile whose rows are padded to
// D + 4 floats, THREADS threads together; rows at or past `end` are filled
// with zeros.  D + 4 is 4 mod 32 at D = 64 and 128: the 8 rows x 4 columns
// of one tf32 fragment load (rows g, columns t) and the rows 2t, 2t + 1 x
// 8 columns of a permuted B load hit 32 distinct banks.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void cp_async_rows_f32(float* dst,
                                                  const float* src,
                                                  long long stride,
                                                  long long row0,
                                                  long long end, int tid) {
    constexpr int LD = D + 4, CHUNKS = D / 4;
    static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / CHUNKS, c = i % CHUNKS;
        const long long row = row0 + r;
        const bool in = row < end;
        cp_async16(smem_addr(dst + r * LD + c * 4),
                   in ? src + row * stride + c * 4 : src, in ? 16 : 0);
    }
}

// x = hi + lo + e: hi = x rounded to tf32 (10 mantissa bits, to nearest,
// ties away), lo = the rest (exact in fp32) rounded to tf32 again; |e| is
// about 2^-22 |x|.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a @ b: tf32 16x8 by 8x8, fp32 accumulators.
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b to about fp32 accuracy: lo.hi, hi.lo, then hi.hi (the small
// terms first); lo.lo (2^-22 of the product) is left out.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
    mma_tf32_1688(c, al, bh0, bh1);
    mma_tf32_1688(c, ah, bl0, bl1);
    mma_tf32_1688(c, ah, bh0, bh1);
}

// The A fragment (hi and lo) of rows r, r + 8 and columns c, c + 4 of an
// fp32 tile with row stride LD, r = g and c = t of the fragment.
template <int LD>
__device__ __forceinline__ void tf32_a_frag(uint32_t (&ah)[4],
                                            uint32_t (&al)[4],
                                            const float* p) {
    tf32_split(p[0], ah[0], al[0]);
    tf32_split(p[8 * LD], ah[1], al[1]);
    tf32_split(p[4], ah[2], al[2]);
    tf32_split(p[8 * LD + 4], ah[3], al[3]);
}

// The A fragment (hi and lo) of 8 columns of a 16-row C fragment, in the
// permuted k order: a0 .. a3 = c0, c2, c1, c3.
__device__ __forceinline__ void tf32_a_from_c(uint32_t (&ah)[4],
                                              uint32_t (&al)[4],
                                              const float (&c)[4]) {
    tf32_split(c[0], ah[0], al[0]);
    tf32_split(c[2], ah[1], al[1]);
    tf32_split(c[1], ah[2], al[2]);
    tf32_split(c[3], ah[3], al[3]);
}

// The B fragment (hi and lo) of an 8 x 8 block whose n index runs over the
// rows of an fp32 tile (K as K^T's columns): p = the tile at row n0 + g,
// column k0 + t.
__device__ __forceinline__ void tf32_b_frag_rows(uint32_t& bh0, uint32_t& bh1,
                                                 uint32_t& bl0, uint32_t& bl1,
                                                 const float* p) {
    tf32_split(p[0], bh0, bl0);
    tf32_split(p[4], bh1, bl1);
}

// The B fragment (hi and lo) of an 8 x 8 block whose k index runs over the
// rows of an fp32 tile, in the permuted k order (rows 2t and 2t + 1): p =
// the tile at row k0 + 2t, column n0 + g.
template <int LD>
__device__ __forceinline__ void tf32_b_frag_perm(uint32_t& bh0, uint32_t& bh1,
                                                 uint32_t& bl0, uint32_t& bl1,
                                                 const float* p) {
    tf32_split(p[0], bh0, bl0);
    tf32_split(p[LD], bh1, bl1);
}
