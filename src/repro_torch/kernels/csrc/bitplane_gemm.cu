// Exact int8 matrix products for Hopper: int8 (M, K) @ int8 (K, N) -> int32.
//
// Replaces the TPU kernels of repro/kernels/bitplane_gemm.py:
//   _int8_kernel      (wrapper int8_matmul)     one exact int8 product;
//   _bitplane_kernel  (wrapper bitplane_matmul) the same product plane by
//                     plane: wu = w & 0xFF, acc += sign_b * ((x @ ((wu >> b)
//                     & 1)) << b) with sign = -1 on plane nbits-1 -- the
//                     paper's bit-serial precision study (Section VII-E), so
//                     the plane loop stays in the kernel: nbits planes cost
//                     nbits tensor-core products.
// Both are one kernel template, bitplane_gemm_kernel<kFullBytes>, on the
// int8 tensor cores; its two instances share the staging, the fragment
// loads and the epilogue, and differ only in what each K step multiplies.
// The TPU kernels hold all of K in VMEM per 128x128 output tile and pad M/N.
// Here ragged M/N/K are zeros while staging, never padded in device memory.
// Integer sums wrap mod 2^32 like the reference's int32 arithmetic, so any
// summation order gives the same bits.
//
// Bound on this card, at the MLP shape of qwen2-0.5b (x 4096x896 @ w
// 896x4864): bytes -- M*K + K*N read, 4*M*N written, 88 MB -> 26 us at
// 3.35 TB/s -- over the 2*M*N*K int8 ops (35.7 GOP -> 18 us at 1979 TOP/s).
// The bit-plane kernel does nbits such products by design, so its own floor
// is nbits x 18 us of int8 tensor-core time (144 us for 8 planes).
//
// bitplane_gemm_kernel:
//   tile   128x128 int32 per block of 8 warps (2 along M x 4 along N, 64x32
//          each: 4 x 4 mma.m16n8k32 accumulators of 4 registers);
//   stage  K in steps of 64 bytes, x and w by 16-byte cp.async in two
//          stages, so step k+1 loads while step k is multiplied; rows are
//          skewed by 16 bytes so ldmatrix reads are free of bank conflicts.
//          Where K or N is not a multiple of 16 (or a base pointer is not
//          16-byte aligned) no row start is aligned, and every step is
//          staged by guarded scalar loads instead, in the same kernel;
//   A      x (M, K) row-major is the .row A operand, by ldmatrix;
//   B      w (K, N) row-major has N contiguous, but .col wants 4 consecutive
//          k of one column per register.  The w tile is staged with its
//          rows permuted (bp_wrow) so that ldmatrix.trans of 8x8 b16 blocks
//          plus two __byte_perm per register transpose the 4x4 byte blocks
//          in registers: each lane gets columns 2g and 2g+1, which become
//          an even and an odd n-tile; w needs no transposed copy;
//   int8   (kFullBytes) the B registers are the raw weight bytes: one mma
//          per 32 bytes of K (s32, no .satfinite, so sums wrap as int32
//          does);
//   planes (!kFullBytes) the B registers are loaded once per K step; plane
//          b's operand is word & (0x01010101 << b), bytes 0 or 2^b as s8
//          (0x80 = -128 for b = 7, already the negative top power); a top
//          plane b < 7 is negated with __vneg4.  Each plane is one mma
//          into the same accumulators: no shift-add is needed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

#define BP_TILE 128                // output tile edge (M and N)
#define BP_BK 64                   // K bytes per step
#define BP_THREADS 256             // 8 warps: 2 along M x 4 along N
#define BP_LDX (BP_BK + 16)        // x tile row: 64 k bytes + a 16-byte skew
#define BP_LDW (BP_TILE + 16)      // w tile row: 128 n bytes + a 16-byte skew

struct BitplaneTiles {             // two stages of each operand
    int8_t xs[2][BP_TILE * BP_LDX];    // x[m0 + r][k0 + c] at r * LDX + c
    int8_t ws[2][BP_BK * BP_LDW];      // w[k0 + kk][n0 + c] at
                                       // bp_wrow(kk) * LDW + c
};

// Shared-memory row of the w row k0 + kk.  Within each 16-row group, k =
// 4t + i lands on row 2t + (i & 1) + 8 (i >> 1): ldmatrix.trans then hands
// lane (g, t) the bytes of rows {2t, 2t+1, 2t+8, 2t+9} = k {4t .. 4t+3},
// in columns 2g and 2g+1, and two __byte_perm make the .col B fragments of
// those two columns with k in the order the .row A fragment of x has.
__device__ __forceinline__ int bp_wrow(int kk) {
    const int q = kk & 15;
    return (kk & ~15) | ((q >> 2) << 1) | (q & 1) | (((q >> 1) & 1) << 3);
}

// 16 bytes of a row into shared memory by scalar loads; bytes at or past
// `avail` are 0.
__device__ __forceinline__ void bp_stage16_scalar(int8_t* dst,
                                                  const int8_t* src,
                                                  long long avail) {
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if (j < avail)
            wd[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Stage one K step of both operands into stage buffers xs, ws: 16-byte
// cp.async where rows are 16-byte aligned (everything outside the matrices
// is zero-filled), guarded scalar loads otherwise.
__device__ __forceinline__ void bp_stage(const int8_t* __restrict__ x,
                                         const int8_t* __restrict__ w,
                                         int8_t* xs, int8_t* ws, long long M,
                                         long long N, long long K,
                                         long long m0, long long n0,
                                         long long k0, bool aligned,
                                         int tid) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {           // x: 128 rows x 4 chunks
        const int i = tid + it * BP_THREADS;
        const int r = i >> 2, c = i & 3;
        const long long row = m0 + r, kk = k0 + 16 * c;
        int8_t* dst = xs + r * BP_LDX + 16 * c;
        const bool in = row < M && kk < K;
        if (aligned)
            cp_async16(smem_addr(dst), in ? x + row * K + kk : x, in ? 16 : 0);
        else
            bp_stage16_scalar(dst, x + row * K + kk, in ? K - kk : 0);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {           // w: 64 rows x 8 chunks
        const int i = tid + it * BP_THREADS;
        const int r = i >> 3, c = i & 7;
        const long long krow = k0 + r, col = n0 + 16 * c;
        int8_t* dst = ws + bp_wrow(r) * BP_LDW + 16 * c;
        const bool in = krow < K && col < N;
        if (aligned)
            cp_async16(smem_addr(dst), in ? w + krow * N + col : w,
                       in ? 16 : 0);
        else
            bp_stage16_scalar(dst, w + krow * N + col, in ? N - col : 0);
    }
}

template <bool kFullBytes>
__global__ void __launch_bounds__(BP_THREADS, 2)
bitplane_gemm_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     long long M, long long N, long long K, int nbits,
                     int aligned) {
    __shared__ __align__(16) BitplaneTiles t;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tq = lane & 3;
    const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;   // warp's tile
    const long long m0 = (long long)blockIdx.y * BP_TILE;
    const long long n0 = (long long)blockIdx.x * BP_TILE;
    const long long nk = (K + BP_BK - 1) / BP_BK;

    // acc[i][n]: m-tile i (16 rows), n-tile n: the even (n = 2c) and odd
    // (n = 2c + 1) columns of the warp's 16-column chunk c
    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
            acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0;

    const int a_lane = (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * BP_LDX +
                       (lane >> 4) * 16;
    const int b_lane = lane * BP_LDW + wn;

    bp_stage(x, w, t.xs[0], t.ws[0], M, N, K, m0, n0, 0, aligned, tid);
    cp_async_commit();
    for (long long kt = 0; kt < nk; ++kt) {
        const int st = (int)(kt & 1);
        if (kt + 1 < nk)
            bp_stage(x, w, t.xs[st ^ 1], t.ws[st ^ 1], M, N, K, m0, n0,
                     (kt + 1) * BP_BK, aligned, tid);
        cp_async_commit();
        cp_async_wait<1>();                    // step kt has landed
        __syncthreads();
#pragma unroll
        for (int s32 = 0; s32 < BP_BK / 32; ++s32) {
            uint32_t a[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldsm_x4(a[i], smem_addr(t.xs[st] + a_lane + i * 16 * BP_LDX +
                                        s32 * 32));
            // the B fragments of w, loaded once for every plane
            uint32_t bw[4][2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                uint32_t r[4];
                ldsm_x4_trans(r, smem_addr(t.ws[st] + b_lane +
                                           s32 * 32 * BP_LDW + c * 16));
                bw[2 * c][0] = __byte_perm(r[0], r[1], 0x6420);
                bw[2 * c + 1][0] = __byte_perm(r[0], r[1], 0x7531);
                bw[2 * c][1] = __byte_perm(r[2], r[3], 0x6420);
                bw[2 * c + 1][1] = __byte_perm(r[2], r[3], 0x7531);
            }
            if constexpr (kFullBytes) {
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        mma_s8_16832(acc[i][n], a[i], bw[n][0], bw[n][1]);
            } else {
                // bit-serial over planes: plane b's bytes are 0 or 2^b as
                // s8 (0x80 = -128 for b = 7); a top plane below 7 is negated
                for (int b = 0; b < nbits; ++b) {
                    const uint32_t mask = 0x01010101u << b;
                    const bool negate = b == nbits - 1 && b < 7;
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        uint32_t p0 = bw[n][0] & mask, p1 = bw[n][1] & mask;
                        if (negate) {
                            p0 = __vneg4(p0);
                            p1 = __vneg4(p1);
                        }
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            mma_s8_16832(acc[i][n], a[i], p0, p1);
                    }
                }
            }
        }
        __syncthreads();                       // stage st is free again
    }

    // lane (g, tq) holds columns 4tq .. 4tq+3 of each chunk: even, odd,
    // even, odd n-tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long row = m0 + wm + 16 * i + g + 8 * h;
            if (row >= M) continue;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const long long col = n0 + wn + 16 * c + 4 * tq;
                const int v[4] = {
                    acc[i][2 * c][2 * h], acc[i][2 * c + 1][2 * h],
                    acc[i][2 * c][2 * h + 1], acc[i][2 * c + 1][2 * h + 1]};
                int32_t* o = out + row * N + col;
                if ((N & 3) == 0 && col + 3 < N) {
                    *reinterpret_cast<int4*>(o) =
                        make_int4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (col + j < N) o[j] = v[j];
                }
            }
        }
    }
}

template <bool kFullBytes>
static int launch(const void* x, const void* w, void* out, long long M,
                  long long N, long long K, int nbits, void* stream) {
    // cp.async needs every row start 16-byte aligned (and K = 0, where x
    // and w may be null, reads nothing on the scalar path)
    const int aligned = K > 0 && K % 16 == 0 && N % 16 == 0 &&
                        (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
    const dim3 grid((unsigned)((N + BP_TILE - 1) / BP_TILE),
                    (unsigned)((M + BP_TILE - 1) / BP_TILE));
    bitplane_gemm_kernel<kFullBytes>
        <<<grid, BP_THREADS, 0, (cudaStream_t)stream>>>(
            (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K,
            nbits, aligned);
    return (int)cudaGetLastError();
}

// x: M x K int8, w: K x N int8, out: M x N int32, all contiguous row-major;
// the caller guarantees M, N > 0 and M within gridDim.y * 128.  Returns the
// CUDA error code of the launch (0 = success).
extern "C" int int8_gemm_launch(const void* x, const void* w, void* out,
                                long long M, long long N, long long K,
                                void* stream) {
    return launch<true>(x, w, out, M, N, K, 8, stream);
}

// As int8_gemm_launch, computed over the nbits (1..8) low planes of w;
// returns -1 for nbits outside 1..8.
extern "C" int bitplane_gemm_launch(const void* x, const void* w, void* out,
                                    long long M, long long N, long long K,
                                    int nbits, void* stream) {
    if (nbits < 1 || nbits > 8) return -1;
    return launch<false>(x, w, out, M, N, K, nbits, stream);
}
