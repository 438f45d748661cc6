// Exact int8 matrix products for Hopper: int8 (M, K) @ int8 (K, N) -> int32.
//
// Replaces the TPU kernels of repro/kernels/bitplane_gemm.py:
//   _int8_kernel      (wrapper int8_matmul)     one exact int8 product;
//   _bitplane_kernel  (wrapper bitplane_matmul) the same product plane by
//                     plane: wu = w & 0xFF, acc += sign_b * ((x @ ((wu >> b)
//                     & 1)) << b) with sign = -1 on plane nbits-1 -- the
//                     paper's bit-serial precision study (Section VII-E), so
//                     the plane loop stays in the kernel: nbits planes cost
//                     nbits binary products.
// The TPU kernels hold all of K in VMEM per 128x128 output tile and pad M/N.
// Here one block of 256 threads computes a 64x64 int32 tile (4x4 outputs per
// thread) and loops over K in steps of 32 bytes staged in shared memory, four
// int8 values packed per 32-bit word (x row-major, w transposed so a word
// holds four consecutive k of one column), multiplied with __dp4a.  Ragged
// M/N/K are masked while staging (zeros), never padded in device memory.
// Integer sums wrap mod 2^32 like the reference's int32 arithmetic, so any
// summation order gives the same bits.
//
// Bound on this card, at the MLP shape of qwen2-0.5b (x 4096x896 @ w
// 896x4864): bytes -- M*K + K*N read, 4*M*N written, 88 MB -> 26 us at
// 3.35 TB/s -- over the 2*M*N*K int8 ops (35.7 GOP -> 18 us at 1979 TOP/s).
// __dp4a runs on the integer pipes, not the tensor cores, so this kernel is
// bound by those pipes, well above both numbers.
#include <cuda_runtime.h>
#include <stdint.h>

#define GM_TILE 64                 // output tile edge (M and N)
#define GM_BK 32                   // K bytes staged per step
#define GM_KW (GM_BK / 4)          // packed words per staged row
#define GM_THREADS 256             // 16 x 16 threads, 4 x 4 outputs each

struct GemmTiles {
    int xs[GM_TILE][GM_KW + 1];    // xs[m][w]: x[m0+m][k0+4w .. +3]
    int ws[GM_TILE][GM_KW + 1];    // ws[n][w]: w[k0+4w .. +3][n0+n]
};

// Stage one K step of both operands, packing 4 bytes per word; everything
// outside the matrices is 0.
__device__ __forceinline__ void stage(const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ w,
                                      GemmTiles& t, long long M, long long N,
                                      long long K, long long m0,
                                      long long n0, long long k0, int tid) {
    for (int i = tid; i < GM_TILE * GM_KW; i += GM_THREADS) {
        const int r = i / GM_KW, wd = i % GM_KW;
        const long long row = m0 + r;
        uint32_t packed = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const long long kk = k0 + 4 * wd + b;
            const uint32_t byte =
                (row < M && kk < K) ? (uint8_t)x[row * K + kk] : 0u;
            packed |= byte << (8 * b);
        }
        t.xs[r][wd] = (int)packed;
    }
    for (int i = tid; i < GM_TILE * GM_KW; i += GM_THREADS) {
        const int c = i % GM_TILE, wd = i / GM_TILE;
        const long long col = n0 + c;
        uint32_t packed = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const long long kk = k0 + 4 * wd + b;
            const uint32_t byte =
                (col < N && kk < K) ? (uint8_t)w[kk * N + col] : 0u;
            packed |= byte << (8 * b);
        }
        t.ws[c][wd] = (int)packed;
    }
}

__device__ __forceinline__ void store_tile(int32_t* __restrict__ out,
                                           const uint32_t (&acc)[4][4],
                                           long long M, long long N,
                                           long long m0, long long n0,
                                           int tx, int ty) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long row = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long col = n0 + tx + 16 * j;
            if (row < M && col < N) out[row * N + col] = (int32_t)acc[i][j];
        }
    }
}

__global__ void __launch_bounds__(GM_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, long long M, long long N,
                 long long K) {
    __shared__ GemmTiles t;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const long long m0 = (long long)blockIdx.y * GM_TILE;
    const long long n0 = (long long)blockIdx.x * GM_TILE;
    int acc[4][4] = {};
    for (long long k0 = 0; k0 < K; k0 += GM_BK) {
        stage(x, w, t, M, N, K, m0, n0, k0, tid);
        __syncthreads();
#pragma unroll
        for (int wd = 0; wd < GM_KW; ++wd) {
            int a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = t.xs[ty + 16 * i][wd];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = t.ws[tx + 16 * j][wd];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    uint32_t bits[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) bits[i][j] = (uint32_t)acc[i][j];
    store_tile(out, bits, M, N, m0, n0, tx, ty);
}

__global__ void __launch_bounds__(GM_THREADS)
bitplane_gemm_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     long long M, long long N, long long K, int nbits) {
    __shared__ GemmTiles t;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const long long m0 = (long long)blockIdx.y * GM_TILE;
    const long long n0 = (long long)blockIdx.x * GM_TILE;
    uint32_t acc[4][4] = {};
    for (long long k0 = 0; k0 < K; k0 += GM_BK) {
        stage(x, w, t, M, N, K, m0, n0, k0, tid);
        __syncthreads();
        for (int b = 0; b < nbits; ++b) {          // bit-serial over planes
            int part[4][4] = {};
#pragma unroll
            for (int wd = 0; wd < GM_KW; ++wd) {
                int a[4], plane[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = t.xs[ty + 16 * i][wd];
                // (wu >> b) & 1 for the four bytes of the word at once
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    plane[j] = (int)(((uint32_t)t.ws[tx + 16 * j][wd] >> b) &
                                     0x01010101u);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        part[i][j] = __dp4a(a[i], plane[j], part[i][j]);
            }
            // two's complement: the top plane carries the negative power
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const uint32_t shifted = (uint32_t)part[i][j] << b;
                    acc[i][j] += b == nbits - 1 ? 0u - shifted : shifted;
                }
        }
        __syncthreads();
    }
    store_tile(out, acc, M, N, m0, n0, tx, ty);
}

static dim3 gemm_grid(long long M, long long N) {
    return dim3((unsigned)((N + GM_TILE - 1) / GM_TILE),
                (unsigned)((M + GM_TILE - 1) / GM_TILE));
}

// x: M x K int8, w: K x N int8, out: M x N int32, all contiguous row-major;
// the caller guarantees M, N > 0.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int int8_gemm_launch(const void* x, const void* w, void* out,
                                long long M, long long N, long long K,
                                void* stream) {
    int8_gemm_kernel<<<gemm_grid(M, N), GM_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K);
    return (int)cudaGetLastError();
}

// As int8_gemm_launch, computed over the nbits (1..8) low planes of w;
// returns -1 for nbits outside 1..8.
extern "C" int bitplane_gemm_launch(const void* x, const void* w, void* out,
                                    long long M, long long N, long long K,
                                    int nbits, void* stream) {
    if (nbits < 1 || nbits > 8) return -1;
    bitplane_gemm_kernel<<<gemm_grid(M, N), GM_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K, nbits);
    return (int)cudaGetLastError();
}
