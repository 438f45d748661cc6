// The intra-chunk (diagonal-block) term of Mamba2's SSD scan, forward and
// backward, for Hopper (wrapper kernels/ssd_chunk.py).
//
// Replaces no TPU kernel: the reference (repro/models/ssm.py::ssd_chunked)
// computes the term as einsums over an (L, L) decay matrix per head, which
// the port's plain route (models/ssm.py) keeps for the CPU.  On the card that
// route writes and reads (B, C, G, H, L, L) float32 blocks (1.9 GB at
// Zamba2-7B's training shape) in a dozen elementwise passes per call; these
// kernels keep every L x L block on chip and write only the results.
//
// For one row of the batch, one chunk c and one group g (L positions, the
// group's H heads of P = 64, state size N), with C, B (L, N), X_h (L, P) and
// A_h (L) the chunk's cumulative log decay of head h:
//   S[l, s]   = C[l] . B[s]                      (once for all H heads)
//   L_h[l, s] = exp(A_h[l] - A_h[s])  for s <= l in one run, else 0
//   M_h       = S o L_h
//   y_h       = M_h X_h                          (forward)
// and, for dy_h:
//   dX_h      = M_h^T dy_h
//   dM_h      = dy_h X_h^T
//   dS        = sum_h dM_h o L_h   -> dC = dS B, dB = dS^T C (the wrapper)
//   dA_h[l]   = sum_s (dM_h o M_h)[l, s] - sum_s (dM_h o M_h)[s, l]
// A run is a stretch of one document (models/ssm.py::document_runs): with
// run ids (SEG = true) a pair of two runs is masked, as the plain route's
// decay matrix is cut.  A call without ids runs SEG = false, with no run
// test at all.
//
// Arithmetic: float32 throughout, every product as three TF32 ones on the
// tensor cores (mma.sync m16n8k8, hi*hi + hi*lo + lo*hi, mma_sync.cuh), as
// the fp32 flash kernels.  No operand is rounded below float32 (lo*lo,
// 2^-22 of a product, is left out); the decay's exp is within 2.4e-7 of
// e^d (sc_exp).
//
// The diagonal term's three kernels, all on 64-row tiles of the chunk (L =
// 64 .. 256, so 1 to 4 tiles), each warp owning 16 rows of its block's
// tile (the chunk states' three kernels are described further down):
//
// ssd_fwd_kernel: one block per (row-chunk-group, l tile i, 8 heads), 8
//   warps in two quads of 4.  First S[i, j] for every tile j <= i is
//   computed once (the quads take half the columns each) and kept in shared
//   memory in C-fragment order, each thread's values where that thread (and
//   its twin in the other quad, which owns the same rows) reads them back;
//   then each quad takes every other head: for j = 0 .. i it forms M_h's
//   fragment from S, the decay and the mask (only on the diagonal tile and,
//   with SEG, on a tile that is not one run on both sides), splits it into
//   tf32 hi and lo in registers and multiplies X_h's tile j (staged by
//   cp.async, two stages) into y_h's accumulators.  M_h's C fragment is
//   used as the A operand in the permuted k order of the flash kernels (k
//   step t is column 2t, t + 4 is 2t + 1; X's rows are read in that order).
//   Tiles past the diagonal are never visited; with SEG a warp skips a tile
//   whose runs miss its rows' runs.
// ssd_bwd_dx_kernel: the transposed block: one block per (row-chunk-group,
//   s tile j, 8 heads), rows s.  S^T[j, i] for i >= j is kept as above; each
//   quad takes every other head, holds X_h's 16 rows of the warp as tf32 A
//   fragments in registers, and for i = j .. L/64 - 1 computes dM_h^T = X_h
//   dy_h^T for its tile, M_h^T from S^T and the decay, dX_h += M_h^T dy_h,
//   and the column half of dA_h (sum over l of dM_h o M_h), which the block
//   sees whole for its rows s.
// ssd_bwd_ds_kernel: one block per (row-chunk-group, tile pair i >= j), 4
//   warps, rows l of tile i, over all H heads: S[i, j] once (kept, with
//   dS's sum, in shared memory in fragment order), then for each head (its
//   dy and X tiles and log decay staged by cp.async, two stages) dM_h =
//   dy_h X_h^T for the pair, dS += dM_h o L_h, and the row half of dA_h
//   (sum over s of dM_h o M_h), written to the pair's slot j of a
//   (L/64)-slot buffer that the wrapper sums.  dS's tile is written once;
//   dC and dB are two small products the wrapper hands to torch.
// Every sum is taken in a fixed order (no atomics), so a call gives the
// same bits every time.
//
// Bound on this card at Zamba2-7B's training shape (B = 4, S = 4096, L =
// 256, G = 2, 56 heads a group, N = P = 64): the forward's products over
// whole chunks, 2 L^2 (N + H P) a (row, chunk, group), are 61.2 GFLOP ->
// 0.371 ms at 165 TFLOP/s of fp32 work (three TF32 products at 495),
// over its 0.96 GB of bytes (0.29 ms at 3.35 TB/s); the backward's,
// 2 L^2 (3 N + 2 H P), 123.5 GFLOP -> 0.749 ms.  Only the causal half of
// each product is visited, so the kernels can at best reach about 1.6
// times those bounds' work rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

#define SC_TILE 64                  // rows of a tile
#define SC_MAX_TILES 4              // chunk <= 256
#define SC_MAX_LEN (SC_TILE * SC_MAX_TILES)
#define SC_P 64                     // head dim
#define SC_LDP (SC_P + 4)           // padded fp32 row (mma_sync.cuh)
#define SC_HB 8                     // heads a block (forward, dX)
#define SC_WIDE 256                 // threads of the forward and dX blocks
#define SC_NARROW 128               // threads of the dS block
// one fp32 C fragment of 16 x 64 a warp, every tile, 128 thread slots
#define SC_CACHE (SC_MAX_TILES * 8 * 4 * 128)

struct SsdShape {
    long long chunks;               // B * C
    int groups, heads;              // G, heads a group
    int len, tiles;                 // L, L / 64
    const int* runs;                // (B * C, L) int32, null without ids
};

// exp(d) for the decay, d = A[l] - A[s] <= 0 on every pair that counts
// (a pair with d > 0 is masked to 0 after): ex2.approx of d log2(e), whose
// error is (2 + 1.173 |d|) ulp of e^d (CUDA's bound for __expf), so at
// most about 2 ulp of 1 (2.4e-7) for any d <= 0 -- the size of what the
// 3xTF32 products leave out -- where expf's accurate path costs some ten
// instructions more a pair.
__device__ __forceinline__ float sc_exp(float d) { return __expf(d); }

// a 4-byte copy to shared memory (a strided operand's single floats)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

// the element of position pos of a (B*C, L, G, ...) tensor's (chunk, group)
__device__ __forceinline__ long long sc_pos(const SsdShape& s, long long ch,
                                            int grp, long long pos) {
    return (ch * s.len + pos) * s.groups + grp;
}

// The run interval of each 16-row group of the chunk (least, largest run),
// into rng[2 * k], rng[2 * k + 1]; runs_s holds the chunk's L runs.  The
// caller syncs before and after.
__device__ __forceinline__ void sc_run_groups(const int* runs_s, int* rng,
                                              int len, int tid) {
    if (tid < len / 16) {
        int lo = runs_s[tid * 16], hi = lo;
        for (int r = 1; r < 16; ++r) {
            const int v = runs_s[tid * 16 + r];
            lo = v < lo ? v : lo;
            hi = v > hi ? v : hi;
        }
        rng[2 * tid] = lo;
        rng[2 * tid + 1] = hi;
    }
}

// Whether 16 rows (group w) and a 64-row tile (groups 4 * tile ..) share a
// run (else the pair is skipped), and whether they hold one run only (then
// no pair needs the run test).
__device__ __forceinline__ void sc_meet(const int* rng, int w, int tile,
                                        bool& meet, bool& single) {
    const int wlo = rng[2 * w], whi = rng[2 * w + 1];
    int tlo = rng[8 * tile], thi = rng[8 * tile + 1];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        tlo = min(tlo, rng[8 * tile + 2 * k]);
        thi = max(thi, rng[8 * tile + 2 * k + 1]);
    }
    meet = wlo <= thi && tlo <= whi;
    single = wlo == whi && tlo == thi && wlo == tlo;
}

template <int N>
__host__ __device__ constexpr int sc_ring_floats() {
    // the S phase's three N-wide tiles, or four P-wide tiles after it
    return 3 * SC_TILE * (N + 4) > 4 * SC_TILE * SC_LDP
               ? 3 * SC_TILE * (N + 4) : 4 * SC_TILE * SC_LDP;
}

template <int N>
constexpr size_t sc_wide_smem_bytes() {
    return (size_t)(SC_CACHE + sc_ring_floats<N>() + SC_HB * SC_MAX_LEN) *
               sizeof(float) +
           (SC_MAX_LEN + 2 * (SC_MAX_LEN / 16)) * sizeof(int);
}

// The S phase of the forward and dX blocks: for each tile u of `count`
// tiles from `first`, the warp's 16 rows of the fixed tile (rows `fixed`,
// staged once) against tile u's 64 rows, S = F U^T over N, into the cache
// at slot u - first.  Quad q computes columns 32q .. 32q + 31.  F is C
// (forward: S) or B (dX: S^T); U is B or C.  `ring` holds F, then U in
// two stages.  Ends with every cp.async group landed and a barrier.
template <int N>
__device__ __forceinline__ void sc_s_phase(
        float* cache, float* ring, const float* f_base, const float* u_base,
        long long stride, int fixed, int first, int count, int len, int tid) {
    constexpr int LDN = N + 4, TN = SC_TILE * LDN;
    const int lane = tid & 31, warp = tid >> 5;
    const int quad = warp >> 2, wq = warp & 3, tq = tid & 127;
    const int g = lane >> 2, t = lane & 3;
    float* f_t = ring;
    float* u_t = ring + TN;
    cp_async_rows_f32<SC_TILE, N, SC_WIDE>(f_t, f_base, stride,
                                           (long long)fixed * SC_TILE, len,
                                           tid);
    cp_async_rows_f32<SC_TILE, N, SC_WIDE>(u_t, u_base, stride,
                                           (long long)first * SC_TILE, len,
                                           tid);
    cp_async_commit();
    for (int u = 0; u < count; ++u) {
        if (u + 1 < count)
            cp_async_rows_f32<SC_TILE, N, SC_WIDE>(
                u_t + ((u + 1) & 1) * TN, u_base, stride,
                (long long)(first + u + 1) * SC_TILE, len, tid);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
            sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        const float* f_w = f_t + (wq * 16 + g) * LDN + t;
        const float* u_w = u_t + (u & 1) * TN + (quad * 32 + g) * LDN + t;
#pragma unroll
        for (int kk = 0; kk < N / 8; ++kk) {
            uint32_t ah[4], al[4];
            tf32_a_frag<LDN>(ah, al, f_w + kk * 8);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                uint32_t bh0, bh1, bl0, bl1;
                tf32_b_frag_rows(bh0, bh1, bl0, bl1,
                                 u_w + n * 8 * LDN + kk * 8);
                mma_3xtf32(sc[n], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                cache[((u * 8 + quad * 4 + n) * 4 + e) * 128 + tq] =
                    sc[n][e];
        __syncthreads();             // stage u & 1 is free for tile u + 2
    }
}

// The block's heads' cumulative log decay, a_s[head - h0][pos] for all L
// positions, and with SEG the chunk's runs and their 16-row intervals.
template <bool SEG>
__device__ __forceinline__ void sc_stage_small(
        const float* __restrict__ da, const SsdShape& s, long long ch,
        int grp, int h0, int nh, float* a_s, int* runs_s, int* rng,
        int tid) {
    for (int e = tid; e < nh * s.len; e += blockDim.x) {
        const int hl = e / s.len, pos = e % s.len;
        a_s[hl * s.len + pos] = da[sc_pos(s, ch, grp, pos) * s.heads + h0 + hl];
    }
    if constexpr (SEG) {
        for (int p = tid; p < s.len; p += blockDim.x)
            runs_s[p] = s.runs[ch * s.len + p];
        __syncthreads();
        sc_run_groups(runs_s, rng, s.len, tid);
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int N, bool SEG>
__global__ void __launch_bounds__(SC_WIDE, 1)
ssd_fwd_kernel(const float* __restrict__ cc, const float* __restrict__ bc,
               const float* __restrict__ xf, const float* __restrict__ da,
               float* __restrict__ y, SsdShape s) {
    extern __shared__ float4 sc_smem[];
    constexpr int TP = SC_TILE * SC_LDP;
    float* cache = reinterpret_cast<float*>(sc_smem);
    float* ring = cache + SC_CACHE;
    float* a_s = ring + sc_ring_floats<N>();
    int* runs_s = reinterpret_cast<int*>(a_s + SC_HB * SC_MAX_LEN);
    int* rng = runs_s + SC_MAX_LEN;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int quad = warp >> 2, wq = warp & 3, tq = tid & 127;
    const int g = lane >> 2, t = lane & 3;
    const long long ch = blockIdx.x / s.groups;
    const int grp = blockIdx.x % s.groups;
    const int i = s.tiles - 1 - blockIdx.y;     // longest rows first
    const int h0 = blockIdx.z * SC_HB;
    const int nh = min(SC_HB, s.heads - h0);
    const long long nstride = (long long)s.groups * N;
    const long long xstride = (long long)s.groups * s.heads * SC_P;
    const float* c_base = cc + sc_pos(s, ch, grp, 0) * N;
    const float* b_base = bc + sc_pos(s, ch, grp, 0) * N;

    sc_stage_small<SEG>(da, s, ch, grp, h0, nh, a_s, runs_s, rng, tid);
    sc_s_phase<N>(cache, ring, c_base, b_base, nstride, i, 0, i + 1, s.len,
                  tid);

    // each quad takes every other head of the block; step k of a quad is
    // its head 2 (k / (i + 1)) + quad and tile j = k % (i + 1)
    const int steps = (nh + 1) / 2 * (i + 1);
    float* x_t = ring;                              // [stage][quad] tiles
    const int row0 = i * SC_TILE + wq * 16;         // the warp's first row
    {
        const int hl = quad;
        if (hl < nh)
            cp_async_rows_f32<SC_TILE, SC_P, 128>(
                x_t + quad * TP, xf + (sc_pos(s, ch, grp, 0) * s.heads + h0 +
                                       hl) * SC_P,
                xstride, 0, s.len, tq);
    }
    cp_async_commit();
    float acc[8][4];
    for (int k = 0; k < steps; ++k) {
        if (k + 1 < steps) {
            const int hn = 2 * ((k + 1) / (i + 1)) + quad;
            const int jn = (k + 1) % (i + 1);
            if (hn < nh)
                cp_async_rows_f32<SC_TILE, SC_P, 128>(
                    x_t + (((k + 1) & 1) * 2 + quad) * TP,
                    xf + (sc_pos(s, ch, grp, 0) * s.heads + h0 + hn) * SC_P,
                    xstride, (long long)jn * SC_TILE, s.len, tq);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int hl = 2 * (k / (i + 1)) + quad, j = k % (i + 1);
        if (hl < nh) {
            if (j == 0) {
#pragma unroll
                for (int n = 0; n < 8; ++n)
                    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
            }
            bool skip = false, edge = j == i;
            if constexpr (SEG) {
                bool meet, single;
                sc_meet(rng, i * 4 + wq, j, meet, single);
                skip = !meet;
                edge = edge || !single;
            }
            if (!skip) {
                const float* arow = a_s + hl * s.len;
                const float al0 = arow[row0 + g], al1 = arow[row0 + g + 8];
                const float* xs = x_t + ((k & 1) * 2 + quad) * TP +
                                  2 * t * SC_LDP + g;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    const int col = j * SC_TILE + kk * 8 + 2 * t;
                    const float2 as =
                        *reinterpret_cast<const float2*>(arow + col);
                    float m[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float sv =
                            cache[((j * 8 + kk) * 4 + e) * 128 + tq];
                        const float d = ((e >> 1) ? al1 : al0) -
                                        ((e & 1) ? as.y : as.x);
                        float v = sv * sc_exp(d);
                        if (edge) {
                            const int row = row0 + g + 8 * (e >> 1);
                            const int c = col + (e & 1);
                            bool valid = c <= row;
                            if constexpr (SEG)
                                valid = valid && runs_s[row] == runs_s[c];
                            v = valid ? v : 0.f;
                        }
                        m[e] = v;
                    }
                    uint32_t ah[4], al[4];
                    tf32_a_from_c(ah, al, m);
#pragma unroll
                    for (int dn = 0; dn < 8; ++dn) {
                        uint32_t bh0, bh1, bl0, bl1;
                        tf32_b_frag_perm<SC_LDP>(bh0, bh1, bl0, bl1,
                                                 xs + kk * 8 * SC_LDP +
                                                     dn * 8);
                        mma_3xtf32(acc[dn], ah, al, bh0, bh1, bl0, bl1);
                    }
                }
            }
            if (j == i) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float* yrow = y + (sc_pos(s, ch, grp, row0 + g + 8 * r) *
                                           s.heads + h0 + hl) * SC_P + 2 * t;
#pragma unroll
                    for (int dn = 0; dn < 8; ++dn)
                        *reinterpret_cast<float2*>(yrow + dn * 8) =
                            make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
                }
            }
        }
        __syncthreads();             // stage k & 1 is free for step k + 2
    }
}

// ---------------------------------------------------------------------------
// backward: dX and the column half of dA
// ---------------------------------------------------------------------------

template <int N, bool SEG>
__global__ void __launch_bounds__(SC_WIDE, 1)
ssd_bwd_dx_kernel(const float* __restrict__ cc, const float* __restrict__ bc,
                  const float* __restrict__ xf, const float* __restrict__ da,
                  const float* __restrict__ dy, float* __restrict__ dx,
                  float* __restrict__ da_cols, SsdShape s) {
    extern __shared__ float4 sc_smem[];
    constexpr int TP = SC_TILE * SC_LDP;
    float* cache = reinterpret_cast<float*>(sc_smem);
    float* ring = cache + SC_CACHE;
    float* a_s = ring + sc_ring_floats<N>();
    int* runs_s = reinterpret_cast<int*>(a_s + SC_HB * SC_MAX_LEN);
    int* rng = runs_s + SC_MAX_LEN;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int quad = warp >> 2, wq = warp & 3, tq = tid & 127;
    const int g = lane >> 2, t = lane & 3;
    const long long ch = blockIdx.x / s.groups;
    const int grp = blockIdx.x % s.groups;
    const int j = blockIdx.y;                   // most l tiles first
    const int ni = s.tiles - j;                 // l tiles i = j .. tiles-1
    const int h0 = blockIdx.z * SC_HB;
    const int nh = min(SC_HB, s.heads - h0);
    const long long nstride = (long long)s.groups * N;
    const long long xstride = (long long)s.groups * s.heads * SC_P;
    const float* c_base = cc + sc_pos(s, ch, grp, 0) * N;
    const float* b_base = bc + sc_pos(s, ch, grp, 0) * N;

    sc_stage_small<SEG>(da, s, ch, grp, h0, nh, a_s, runs_s, rng, tid);
    // S^T[j, i] = B_j C_i^T for i = j .. tiles - 1, at slot i - j
    sc_s_phase<N>(cache, ring, b_base, c_base, nstride, j, j, ni, s.len,
                  tid);

    const int steps = (nh + 1) / 2 * ni;
    float* y_t = ring;                              // dy tiles [stage][quad]
    const int srow0 = j * SC_TILE + wq * 16;        // the warp's first row
    {
        const int hl = quad;
        if (hl < nh)
            cp_async_rows_f32<SC_TILE, SC_P, 128>(
                y_t + quad * TP, dy + (sc_pos(s, ch, grp, 0) * s.heads + h0 +
                                       hl) * SC_P,
                xstride, (long long)j * SC_TILE, s.len, tq);
    }
    cp_async_commit();
    uint32_t xh[8][4], xl[8][4];                    // X_h's 16 rows, A frags
    float acc[8][4], dacc[2];
    for (int k = 0; k < steps; ++k) {
        if (k + 1 < steps) {
            const int hn = 2 * ((k + 1) / ni) + quad;
            const int in = j + (k + 1) % ni;
            if (hn < nh)
                cp_async_rows_f32<SC_TILE, SC_P, 128>(
                    y_t + (((k + 1) & 1) * 2 + quad) * TP,
                    dy + (sc_pos(s, ch, grp, 0) * s.heads + h0 + hn) * SC_P,
                    xstride, (long long)in * SC_TILE, s.len, tq);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int hl = 2 * (k / ni) + quad, i = j + k % ni;
        if (hl < nh) {
            const float* arow = a_s + hl * s.len;
            if (i == j) {               // the head's first step
                const float* xrow =
                    xf + (sc_pos(s, ch, grp, srow0 + g) * s.heads + h0 + hl) *
                             SC_P + t;
                const long long down = 8 * xstride;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    tf32_split(__ldg(xrow + kk * 8), xh[kk][0], xl[kk][0]);
                    tf32_split(__ldg(xrow + down + kk * 8), xh[kk][1],
                               xl[kk][1]);
                    tf32_split(__ldg(xrow + kk * 8 + 4), xh[kk][2],
                               xl[kk][2]);
                    tf32_split(__ldg(xrow + down + kk * 8 + 4), xh[kk][3],
                               xl[kk][3]);
                }
#pragma unroll
                for (int n = 0; n < 8; ++n)
                    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
                dacc[0] = dacc[1] = 0.f;
            }
            bool skip = false, edge = i == j;
            if constexpr (SEG) {
                bool meet, single;
                sc_meet(rng, j * 4 + wq, i, meet, single);
                skip = !meet;
                edge = edge || !single;
            }
            if (!skip) {
                const float* ys = y_t + ((k & 1) * 2 + quad) * TP;
                // dM^T = X dy^T: the warp's 16 rows s x the tile's 64 l
                float dm[8][4];
#pragma unroll
                for (int n = 0; n < 8; ++n)
                    dm[n][0] = dm[n][1] = dm[n][2] = dm[n][3] = 0.f;
                const float* yr = ys + g * SC_LDP + t;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
                    for (int n = 0; n < 8; ++n) {
                        uint32_t bh0, bh1, bl0, bl1;
                        tf32_b_frag_rows(bh0, bh1, bl0, bl1,
                                         yr + n * 8 * SC_LDP + kk * 8);
                        mma_3xtf32(dm[n], xh[kk], xl[kk], bh0, bh1, bl0,
                                   bl1);
                    }
                }
                const float as0 = arow[srow0 + g], as1 = arow[srow0 + g + 8];
                const float* yp = ys + 2 * t * SC_LDP + g;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    const int col = i * SC_TILE + kk * 8 + 2 * t;   // l
                    const float2 alv =
                        *reinterpret_cast<const float2*>(arow + col);
                    float m[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float sv =
                            cache[(((i - j) * 8 + kk) * 4 + e) * 128 + tq];
                        const float d = ((e & 1) ? alv.y : alv.x) -
                                        ((e >> 1) ? as1 : as0);
                        float v = sv * sc_exp(d);
                        if (edge) {
                            const int row = srow0 + g + 8 * (e >> 1);  // s
                            const int c = col + (e & 1);               // l
                            bool valid = c >= row;
                            if constexpr (SEG)
                                valid = valid && runs_s[row] == runs_s[c];
                            v = valid ? v : 0.f;
                        }
                        m[e] = v;
                        dacc[e >> 1] += dm[kk][e] * v;
                    }
                    uint32_t ah[4], al[4];
                    tf32_a_from_c(ah, al, m);
#pragma unroll
                    for (int dn = 0; dn < 8; ++dn) {
                        uint32_t bh0, bh1, bl0, bl1;
                        tf32_b_frag_perm<SC_LDP>(bh0, bh1, bl0, bl1,
                                                 yp + kk * 8 * SC_LDP +
                                                     dn * 8);
                        mma_3xtf32(acc[dn], ah, al, bh0, bh1, bl0, bl1);
                    }
                }
            }
            if (i == s.tiles - 1) {     // the head's last step
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float v = dacc[r];
                    v += __shfl_xor_sync(0xffffffffu, v, 1);
                    v += __shfl_xor_sync(0xffffffffu, v, 2);
                    const long long at = sc_pos(s, ch, grp, srow0 + g + 8 * r);
                    if (t == 0) da_cols[at * s.heads + h0 + hl] = -v;
                    float* xrow = dx + (at * s.heads + h0 + hl) * SC_P + 2 * t;
#pragma unroll
                    for (int dn = 0; dn < 8; ++dn)
                        *reinterpret_cast<float2*>(xrow + dn * 8) =
                            make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
                }
            }
        }
        __syncthreads();             // stage k & 1 is free for step k + 2
    }
}

// ---------------------------------------------------------------------------
// backward: dS and the row half of dA
// ---------------------------------------------------------------------------

template <int N>
__host__ __device__ constexpr int sc_narrow_stage_floats() {
    // dy_i and X_j, and the head's log decay on both tiles' rows
    return 2 * SC_TILE * SC_LDP + 2 * SC_TILE;
}

template <int N>
__host__ __device__ constexpr int sc_narrow_ring_floats() {
    // C_i and B_j, or two stages
    return 2 * SC_TILE * (N + 4) > 2 * sc_narrow_stage_floats<N>()
               ? 2 * SC_TILE * (N + 4) : 2 * sc_narrow_stage_floats<N>();
}

template <int N>
constexpr size_t sc_narrow_smem_bytes() {
    return (size_t)(sc_narrow_ring_floats<N>() + 2 * 32 * SC_NARROW) *
               sizeof(float) +
           (SC_MAX_LEN + 2 * (SC_MAX_LEN / 16)) * sizeof(int);
}

template <int N, bool SEG>
__global__ void __launch_bounds__(SC_NARROW)
ssd_bwd_ds_kernel(const float* __restrict__ cc, const float* __restrict__ bc,
                  const float* __restrict__ xf, const float* __restrict__ da,
                  const float* __restrict__ dy, float* __restrict__ ds,
                  float* __restrict__ da_rows, SsdShape s) {
    extern __shared__ float4 sc_smem[];
    constexpr int LDN = N + 4, TN = SC_TILE * LDN, TP = SC_TILE * SC_LDP;
    constexpr int STAGE = sc_narrow_stage_floats<N>();
    float* ring = reinterpret_cast<float*>(sc_smem);
    float* sv = ring + sc_narrow_ring_floats<N>();      // S, fragment order
    float* dsum = sv + 32 * SC_NARROW;                  // dS's sum, as S
    int* runs_s = reinterpret_cast<int*>(dsum + 32 * SC_NARROW);
    int* rng = runs_s + SC_MAX_LEN;

    const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long ch = blockIdx.x / s.groups;
    const int grp = blockIdx.x % s.groups;
    int i = 0, j = blockIdx.y;                  // pair y -> (i, j <= i)
    while (j > i) j -= ++i;
    const long long nstride = (long long)s.groups * N;
    const long long xstride = (long long)s.groups * s.heads * SC_P;
    const long long astride = (long long)s.groups * s.heads;

    if constexpr (SEG) {
        for (int p = tid; p < s.len; p += SC_NARROW)
            runs_s[p] = s.runs[ch * s.len + p];
        __syncthreads();
        sc_run_groups(runs_s, rng, s.len, tid);
        __syncthreads();
        bool meet, single;                      // the whole tile pair
        sc_meet(rng, i * 4, j, meet, single);
        bool any = meet;
#pragma unroll
        for (int w = 1; w < 4; ++w) {
            sc_meet(rng, i * 4 + w, j, meet, single);
            any = any || meet;
        }
        if (!any) return;                       // dS and dA stay zero
    }

    // S[i, j] for the warp's 16 rows, kept in shared memory in C-fragment
    // order, as dS's running sum: each thread reads back only its own
    // slots, and in registers the two spill beside dM
    {
        float* c_t = ring;
        float* b_t = ring + TN;
        cp_async_rows_f32<SC_TILE, N, SC_NARROW>(
            c_t, cc + sc_pos(s, ch, grp, 0) * N, nstride,
            (long long)i * SC_TILE, s.len, tid);
        cp_async_rows_f32<SC_TILE, N, SC_NARROW>(
            b_t, bc + sc_pos(s, ch, grp, 0) * N, nstride,
            (long long)j * SC_TILE, s.len, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float sc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
            sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        const float* c_w = c_t + (wq * 16 + g) * LDN + t;
        const float* b_w = b_t + g * LDN + t;
#pragma unroll
        for (int kk = 0; kk < N / 8; ++kk) {
            uint32_t ah[4], al[4];
            tf32_a_frag<LDN>(ah, al, c_w + kk * 8);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                uint32_t bh0, bh1, bl0, bl1;
                tf32_b_frag_rows(bh0, bh1, bl0, bl1,
                                 b_w + n * 8 * LDN + kk * 8);
                mma_3xtf32(sc[n], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                sv[(n * 4 + e) * SC_NARROW + tid] = sc[n][e];
        __syncthreads();             // the ring is free for dy and X
    }

    bool skip = false, edge = i == j;
    if constexpr (SEG) {
        bool meet, single;
        sc_meet(rng, i * 4 + wq, j, meet, single);
        skip = !meet;
        edge = edge || !single;
    }
    const int row0 = i * SC_TILE + wq * 16;         // the warp's first row
    const float* dy0 = dy + sc_pos(s, ch, grp, 0) * s.heads * SC_P;
    const float* x0 = xf + sc_pos(s, ch, grp, 0) * s.heads * SC_P;
    const float* a0 = da + sc_pos(s, ch, grp, 0) * s.heads;
    // stage h & 1: dy_h's tile i, X_h's tile j, A_h on rows i, then rows j
    auto stage = [&](float* dst, int h) {
        cp_async_rows_f32<SC_TILE, SC_P, SC_NARROW>(
            dst, dy0 + h * SC_P, xstride, (long long)i * SC_TILE, s.len,
            tid);
        cp_async_rows_f32<SC_TILE, SC_P, SC_NARROW>(
            dst + TP, x0 + h * SC_P, xstride, (long long)j * SC_TILE, s.len,
            tid);
        const int tile = tid < SC_TILE ? i : j;
        cp_async4(dst + 2 * TP + tid,
                  a0 + (long long)(tile * SC_TILE + (tid & (SC_TILE - 1))) *
                           astride + h);
    };
    stage(ring, 0);
    cp_async_commit();
    for (int k = 0; k < 32; ++k) dsum[k * SC_NARROW + tid] = 0.f;
    for (int h = 0; h < s.heads; ++h) {
        if (h + 1 < s.heads) stage(ring + ((h + 1) & 1) * STAGE, h + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (!skip) {
            const float* y_t = ring + (h & 1) * STAGE;
            const float* x_t = y_t + TP;
            const float* a_l = y_t + 2 * TP;            // rows of tile i
            const float* a_c = a_l + SC_TILE;           // rows of tile j
            // dM = dy X^T, the warp's 16 rows l x the tile's 64 s, one
            // 8-column tile at a time over dy's fragments kept in
            // registers, each tile folded into dS's sum and dA's row sum
            // at once; the tiles one after the other (interleaved, they
            // spill)
            uint32_t ah[8][4], al[8][4];
            const float* y_w = y_t + (wq * 16 + g) * SC_LDP + t;
            const float* x_w = x_t + g * SC_LDP + t;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
                tf32_a_frag<SC_LDP>(ah[kk], al[kk], y_w + kk * 8);
            const float al0 = a_l[wq * 16 + g], al1 = a_l[wq * 16 + g + 8];
            float rsum[2] = {0.f, 0.f};
#pragma unroll 1
            for (int n = 0; n < 8; ++n) {
                float dm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) {
                    uint32_t bh0, bh1, bl0, bl1;
                    tf32_b_frag_rows(bh0, bh1, bl0, bl1,
                                     x_w + n * 8 * SC_LDP + kk * 8);
                    mma_3xtf32(dm, ah[kk], al[kk], bh0, bh1, bl0, bl1);
                }
                const float2 as =
                    *reinterpret_cast<const float2*>(a_c + n * 8 + 2 * t);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float d = ((e >> 1) ? al1 : al0) -
                                    ((e & 1) ? as.y : as.x);
                    float lv = sc_exp(d);
                    if (edge) {
                        const int row = row0 + g + 8 * (e >> 1);
                        const int c = j * SC_TILE + n * 8 + 2 * t + (e & 1);
                        bool valid = c <= row;
                        if constexpr (SEG)
                            valid = valid && runs_s[row] == runs_s[c];
                        lv = valid ? lv : 0.f;
                    }
                    const int at = (n * 4 + e) * SC_NARROW + tid;
                    dsum[at] += dm[e] * lv;
                    rsum[e >> 1] += dm[e] * (sv[at] * lv);
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float v = rsum[r];
                v += __shfl_xor_sync(0xffffffffu, v, 1);
                v += __shfl_xor_sync(0xffffffffu, v, 2);
                if (t == 0)
                    da_rows[(j * s.chunks * s.len + ch * s.len + row0 + g +
                             8 * r) * s.groups * s.heads +
                            grp * s.heads + h] = v;
            }
        }
        __syncthreads();             // stage h & 1 is free for head h + 2
    }
    if (skip) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float* drow = ds + ((ch * s.groups + grp) * s.len + row0 + g + 8 * r) *
                               s.len + j * SC_TILE + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
            *reinterpret_cast<float2*>(drow + n * 8) = make_float2(
                dsum[(n * 4 + 2 * r) * SC_NARROW + tid],
                dsum[(n * 4 + 2 * r + 1) * SC_NARROW + tid]);
    }
}

// ---------------------------------------------------------------------------
// the chunk states and the entering states' term: gather, apply, cross
// ---------------------------------------------------------------------------
//
// Beside the diagonal term the chunked scan has two linear forms over the
// same rows, each a product per (chunk, group, head) with a per-row weight:
// the state a chunk leaves, R_h = sum_l w[l, h] U_h[l]^T V[l] (U = x dt, V =
// B, w the decay to the chunk's end: "gather"), and the entering state's
// term, out_h[l] = w[l, h] V[l] W_h^T (V = C, W = the entering state, w the
// decay from the chunk's start: "apply").  Their gradients are the same
// forms and one more, "cross": Z_h = U_h W_h, dV = sum_h w o Z_h and dw[l,
// h] = V[l] . Z_h[l] (dC and the decay's gradient of the entering term, dB
// and the decay's of the states), besides dX = apply(B, dR, w) and dW =
// gather(dy, C, w).  Weights carry the run masks, so none of these kernels
// reads run ids.  Operands as the diagonal kernels': U, out (chunks, len,
// groups, heads, 64); V (chunks, len, groups, N); w (chunks, len, groups,
// heads); W, R (chunks, groups, heads, 64, N); all float32, products as
// three TF32 ones.

// Stage rows row0 .. row0 + 63 of a (rows, D) fp32 operand with row stride
// `stride` into a tile with rows padded to LD floats, THREADS threads.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void sc_rows(float* dst, const float* src,
                                        long long stride, long long row0,
                                        int tid) {
    constexpr int CHUNKS = D / 4;
#pragma unroll
    for (int it = 0; it < SC_TILE * CHUNKS / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / CHUNKS, c = i % CHUNKS;
        cp_async16(smem_addr(dst + r * LD + c * 4),
                   src + (row0 + r) * stride + c * 4, 16);
    }
}

// R_h = sum_l w[l, h] U_h[l]^T V[l]: one block per (chunk-group, head), 4
// warps of 16 rows p, the chunk's rows in 64-row tiles through two stages.
// The A operand is (w U)^T, read down the U tile's columns (row k0 + t,
// column p: rows padded to 72 floats, 8t + g distinct banks); the B
// operand V's rows k0 + t, + 4 (padded to N + 8).
template <int N>
__global__ void __launch_bounds__(SC_NARROW)
ssd_gather_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ r,
                  SsdShape s) {
    extern __shared__ float4 sc_smem[];
    constexpr int LDU = SC_P + 8, LDV = N + 8;
    constexpr int TU = SC_TILE * LDU, TV = SC_TILE * LDV;
    float* u_t = reinterpret_cast<float*>(sc_smem);     // two stages each
    float* v_t = u_t + 2 * TU;
    float* w_t = v_t + 2 * TV;
    const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long ch = blockIdx.x / s.groups;
    const int grp = blockIdx.x % s.groups, h = blockIdx.y;
    const long long ustride = (long long)s.groups * s.heads * SC_P;
    const long long wstride = (long long)s.groups * s.heads;
    const float* u0 = u + (sc_pos(s, ch, grp, 0) * s.heads + h) * SC_P;
    const float* v0 = v + sc_pos(s, ch, grp, 0) * N;
    const float* w0 = w + sc_pos(s, ch, grp, 0) * s.heads + h;

    float acc[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    sc_rows<SC_P, LDU, SC_NARROW>(u_t, u0, ustride, 0, tid);
    sc_rows<N, LDV, SC_NARROW>(v_t, v0, (long long)s.groups * N, 0, tid);
    if (tid < SC_TILE) cp_async4(w_t + tid, w0 + tid * wstride);
    cp_async_commit();
#pragma unroll 1
    for (int k = 0; k < s.tiles; ++k) {
        const int st = k & 1;
        if (k + 1 < s.tiles) {
            const long long row0 = (long long)(k + 1) * SC_TILE;
            sc_rows<SC_P, LDU, SC_NARROW>(u_t + (st ^ 1) * TU, u0, ustride,
                                          row0, tid);
            sc_rows<N, LDV, SC_NARROW>(v_t + (st ^ 1) * TV, v0,
                                       (long long)s.groups * N, row0, tid);
            if (tid < SC_TILE)
                cp_async4(w_t + (st ^ 1) * SC_TILE + tid,
                          w0 + (row0 + tid) * wstride);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* ws = w_t + st * SC_TILE;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const float* ur = u_t + st * TU + (kk * 8 + t) * LDU + wq * 16 + g;
            const float wa = ws[kk * 8 + t], wb = ws[kk * 8 + t + 4];
            uint32_t ah[4], al[4];
            tf32_split(ur[0] * wa, ah[0], al[0]);
            tf32_split(ur[8] * wa, ah[1], al[1]);
            tf32_split(ur[4 * LDU] * wb, ah[2], al[2]);
            tf32_split(ur[4 * LDU + 8] * wb, ah[3], al[3]);
            const float* vr = v_t + st * TV + (kk * 8 + t) * LDV + g;
#pragma unroll
            for (int dn = 0; dn < N / 8; ++dn) {
                uint32_t bh0, bh1, bl0, bl1;
                tf32_split(vr[dn * 8], bh0, bl0);
                tf32_split(vr[4 * LDV + dn * 8], bh1, bl1);
                mma_3xtf32(acc[dn], ah, al, bh0, bh1, bl0, bl1);
            }
        }
        __syncthreads();             // stage st is free for tile k + 2
    }
    float* rh = r + ((ch * s.groups + grp) * s.heads + h) * SC_P * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float* row = rh + (long long)(wq * 16 + g + 8 * i) * N + 2 * t;
#pragma unroll
        for (int dn = 0; dn < N / 8; ++dn)
            *reinterpret_cast<float2*>(row + dn * 8) =
                make_float2(acc[dn][2 * i], acc[dn][2 * i + 1]);
    }
}

// out_h[l] = base_h[l] + w[l, h] V[l] W_h^T: one block per (chunk-group,
// l tile, 8 heads), 4 warps of 16 rows l.  V's tile once; W_h (64 rows p
// of N) through two stages; the A operand V's rows scaled by the head's
// weight and split anew a head; base may be null (then out = the term).
template <int N>
__global__ void __launch_bounds__(SC_NARROW)
ssd_apply_kernel(const float* __restrict__ v, const float* __restrict__ wm,
                 const float* __restrict__ w, const float* base,
                 float* out, SsdShape s) {
    extern __shared__ float4 sc_smem[];
    constexpr int LD = N + 4, TN = SC_TILE * LD;
    float* v_t = reinterpret_cast<float*>(sc_smem);
    float* w_t = v_t + TN;                              // two stages
    const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long ch = blockIdx.x / s.groups;
    const int grp = blockIdx.x % s.groups, i = blockIdx.y;
    const int h0 = blockIdx.z * SC_HB, nh = min(SC_HB, s.heads - h0);
    const float* wm0 = wm + ((ch * s.groups + grp) * s.heads + h0) * SC_P * N;
    const int row0 = i * SC_TILE + wq * 16;

    sc_rows<N, LD, SC_NARROW>(v_t, v + sc_pos(s, ch, grp, 0) * N,
                              (long long)s.groups * N,
                              (long long)i * SC_TILE, tid);
    sc_rows<N, LD, SC_NARROW>(w_t, wm0, N, 0, tid);
    cp_async_commit();
    for (int k = 0; k < nh; ++k) {
        const int st = k & 1, h = h0 + k;
        if (k + 1 < nh)
            sc_rows<N, LD, SC_NARROW>(w_t + (st ^ 1) * TN,
                                      wm0 + (long long)(k + 1) * SC_P * N, N,
                                      0, tid);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const long long at0 = sc_pos(s, ch, grp, row0 + g);
        const long long at1 = sc_pos(s, ch, grp, row0 + g + 8);
        const float wl0 = __ldg(w + at0 * s.heads + h);
        const float wl1 = __ldg(w + at1 * s.heads + h);
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
            acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        const float* vr = v_t + (wq * 16 + g) * LD + t;
        const float* wr = w_t + st * TN + g * LD + t;
#pragma unroll
        for (int kk = 0; kk < N / 8; ++kk) {
            uint32_t ah[4], al[4];
            tf32_split(vr[kk * 8] * wl0, ah[0], al[0]);
            tf32_split(vr[8 * LD + kk * 8] * wl1, ah[1], al[1]);
            tf32_split(vr[kk * 8 + 4] * wl0, ah[2], al[2]);
            tf32_split(vr[8 * LD + kk * 8 + 4] * wl1, ah[3], al[3]);
#pragma unroll
            for (int dn = 0; dn < 8; ++dn) {
                uint32_t bh0, bh1, bl0, bl1;
                tf32_b_frag_rows(bh0, bh1, bl0, bl1,
                                 wr + dn * 8 * LD + kk * 8);
                mma_3xtf32(acc[dn], ah, al, bh0, bh1, bl0, bl1);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const long long at = (r ? at1 : at0) * s.heads + h;
#pragma unroll
            for (int dn = 0; dn < 8; ++dn) {
                const long long e = at * SC_P + dn * 8 + 2 * t;
                float2 o = make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
                if (base != nullptr) {
                    const float2 b = *reinterpret_cast<const float2*>(base + e);
                    o.x += b.x;
                    o.y += b.y;
                }
                *reinterpret_cast<float2*>(out + e) = o;
            }
        }
        __syncthreads();             // stage st is free for head k + 2
    }
}

// Z_h = U_h W_h, dV[l] = sum_h w[l, h] Z_h[l], dw[l, h] = V[l] . Z_h[l]:
// one block per (chunk-group, l tile), 4 warps of 16 rows l, over every
// head.  U_h's tile (A operand, rows padded to 68) and W_h (B operand down
// its rows p, padded to N + 8) through two stages; V's tile once (read in
// the C fragment's places, float2, padded to N + 8).
template <int N>
__global__ void __launch_bounds__(SC_NARROW)
ssd_cross_kernel(const float* __restrict__ u, const float* __restrict__ wm,
                 const float* __restrict__ v, const float* __restrict__ w,
                 float* __restrict__ dv, float* __restrict__ dw,
                 SsdShape s) {
    extern __shared__ float4 sc_smem[];
    constexpr int LDU = SC_LDP, LDW = N + 8;
    constexpr int TU = SC_TILE * LDU, TW = SC_P * LDW, STAGE = TU + TW;
    float* v_t = reinterpret_cast<float*>(sc_smem);     // 64 x LDW
    float* ring = v_t + SC_TILE * LDW;                  // two stages
    const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long ch = blockIdx.x / s.groups;
    const int grp = blockIdx.x % s.groups, i = blockIdx.y;
    const long long ustride = (long long)s.groups * s.heads * SC_P;
    const float* u0 = u + sc_pos(s, ch, grp, 0) * s.heads * SC_P;
    const float* wm0 = wm + (ch * s.groups + grp) * s.heads * SC_P * N;
    const int row0 = i * SC_TILE + wq * 16;

    sc_rows<N, LDW, SC_NARROW>(v_t, v + sc_pos(s, ch, grp, 0) * N,
                               (long long)s.groups * N,
                               (long long)i * SC_TILE, tid);
    sc_rows<SC_P, LDU, SC_NARROW>(ring, u0, ustride, (long long)i * SC_TILE,
                                  tid);
    sc_rows<N, LDW, SC_NARROW>(ring + TU, wm0, N, 0, tid);
    cp_async_commit();
    float dvacc[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
        dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
    const long long at0 = sc_pos(s, ch, grp, row0 + g);
    const long long at1 = sc_pos(s, ch, grp, row0 + g + 8);
#pragma unroll 1
    for (int h = 0; h < s.heads; ++h) {
        const int st = h & 1;
        if (h + 1 < s.heads) {
            float* nxt = ring + (st ^ 1) * STAGE;
            sc_rows<SC_P, LDU, SC_NARROW>(nxt, u0 + (h + 1) * SC_P, ustride,
                                          (long long)i * SC_TILE, tid);
            sc_rows<N, LDW, SC_NARROW>(nxt + TU,
                                       wm0 + (long long)(h + 1) * SC_P * N,
                                       N, 0, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* u_t = ring + st * STAGE;
        const float* w_t = u_t + TU;
        float z[N / 8][4];
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
            z[n][0] = z[n][1] = z[n][2] = z[n][3] = 0.f;
        const float* ur = u_t + (wq * 16 + g) * LDU + t;
        const float* wr = w_t + t * LDW + g;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            uint32_t ah[4], al[4];
            tf32_a_frag<LDU>(ah, al, ur + kk * 8);
#pragma unroll
            for (int dn = 0; dn < N / 8; ++dn) {
                uint32_t bh0, bh1, bl0, bl1;
                tf32_split(wr[kk * 8 * LDW + dn * 8], bh0, bl0);
                tf32_split(wr[(kk * 8 + 4) * LDW + dn * 8], bh1, bl1);
                mma_3xtf32(z[dn], ah, al, bh0, bh1, bl0, bl1);
            }
        }
        const float wl[2] = {__ldg(w + at0 * s.heads + h),
                             __ldg(w + at1 * s.heads + h)};
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int dn = 0; dn < N / 8; ++dn) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float2 vv = *reinterpret_cast<const float2*>(
                    v_t + (wq * 16 + g + 8 * r) * LDW + dn * 8 + 2 * t);
                dvacc[dn][2 * r] += wl[r] * z[dn][2 * r];
                dvacc[dn][2 * r + 1] += wl[r] * z[dn][2 * r + 1];
                dsum[r] += vv.x * z[dn][2 * r] + vv.y * z[dn][2 * r + 1];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float x = dsum[r];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            if (t == 0) dw[(r ? at1 : at0) * s.heads + h] = x;
        }
        __syncthreads();             // stage st is free for head h + 2
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float* row = dv + (r ? at1 : at0) * N + 2 * t;
#pragma unroll
        for (int dn = 0; dn < N / 8; ++dn)
            *reinterpret_cast<float2*>(row + dn * 8) =
                make_float2(dvacc[dn][2 * r], dvacc[dn][2 * r + 1]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
static int sc_prepare(Kernel kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static SsdShape sc_shape(long long chunks, int groups, int heads, int len,
                         const void* runs) {
    SsdShape s;
    s.chunks = chunks;
    s.groups = groups;
    s.heads = heads;
    s.len = len;
    s.tiles = len / SC_TILE;
    s.runs = (const int*)runs;
    return s;
}

template <int N, bool SEG>
static int sc_fwd(const float* cc, const float* bc, const float* xf,
                  const float* da, float* y, const SsdShape& s,
                  cudaStream_t st) {
    const size_t smem = sc_wide_smem_bytes<N>();
    int err = sc_prepare(ssd_fwd_kernel<N, SEG>, smem);
    if (err) return err;
    const dim3 grid((unsigned)(s.chunks * s.groups), (unsigned)s.tiles,
                    (unsigned)((s.heads + SC_HB - 1) / SC_HB));
    ssd_fwd_kernel<N, SEG><<<grid, SC_WIDE, smem, st>>>(cc, bc, xf, da, y, s);
    return (int)cudaGetLastError();
}

template <int N, bool SEG>
static int sc_bwd(const float* cc, const float* bc, const float* xf,
                  const float* da, const float* dy, float* dx,
                  float* da_cols, float* ds, float* da_rows,
                  const SsdShape& s, cudaStream_t st) {
    const size_t wide = sc_wide_smem_bytes<N>();
    int err = sc_prepare(ssd_bwd_dx_kernel<N, SEG>, wide);
    if (err) return err;
    const dim3 grid((unsigned)(s.chunks * s.groups), (unsigned)s.tiles,
                    (unsigned)((s.heads + SC_HB - 1) / SC_HB));
    ssd_bwd_dx_kernel<N, SEG><<<grid, SC_WIDE, wide, st>>>(
        cc, bc, xf, da, dy, dx, da_cols, s);
    err = (int)cudaGetLastError();
    if (err) return err;
    const size_t narrow = sc_narrow_smem_bytes<N>();
    err = sc_prepare(ssd_bwd_ds_kernel<N, SEG>, narrow);
    if (err) return err;
    const dim3 pairs((unsigned)(s.chunks * s.groups),
                     (unsigned)(s.tiles * (s.tiles + 1) / 2));
    ssd_bwd_ds_kernel<N, SEG><<<pairs, SC_NARROW, narrow, st>>>(
        cc, bc, xf, da, dy, ds, da_rows, s);
    return (int)cudaGetLastError();
}

// Operands, all float32 and contiguous, for `chunks` = B * C chunks of
// `len` positions (64, 128, 192 or 256), `groups` groups of `heads` heads
// of 64 and a state of d_state (64 or 128):
//   cc, bc (chunks, len, groups, d_state); xf, y (chunks, len, groups,
//   heads, 64); da (chunks, len, groups, heads), the cumulative log decay
//   within each chunk; runs (chunks, len) int32 or null.
// Returns the CUDA error code of the first failing call (0 = success), or
// -1 for a shape no kernel is instantiated for.
extern "C" int ssd_chunk_fwd_launch(const void* cc, const void* bc,
                                    const void* xf, const void* da,
                                    const void* runs, void* y,
                                    long long chunks, int groups, int heads,
                                    int len, int d_state, void* stream) {
    if (len % SC_TILE || len > SC_MAX_LEN || len <= 0) return -1;
    const SsdShape s = sc_shape(chunks, groups, heads, len, runs);
    cudaStream_t st = (cudaStream_t)stream;
    const float *c = (const float*)cc, *b = (const float*)bc,
                *x = (const float*)xf, *a = (const float*)da;
    float* out = (float*)y;
    if (d_state == 64)
        return runs ? sc_fwd<64, true>(c, b, x, a, out, s, st)
                    : sc_fwd<64, false>(c, b, x, a, out, s, st);
    if (d_state == 128)
        return runs ? sc_fwd<128, true>(c, b, x, a, out, s, st)
                    : sc_fwd<128, false>(c, b, x, a, out, s, st);
    return -1;
}

// The forward's operands and dy (as y); writes dx (as xf), da_cols
// (chunks, len, groups, heads): minus the column sums of dM o M, every
// entry; ds (chunks, groups, len, len): dS's tiles on and below the
// diagonal; da_rows (len / 64, chunks, len, groups, heads): the row sums
// of dM o M over each 64-column tile at or left of the row's own.  ds and
// da_rows are left untouched elsewhere (the caller zeroes them).
extern "C" int ssd_chunk_bwd_launch(const void* cc, const void* bc,
                                    const void* xf, const void* da,
                                    const void* runs, const void* dy,
                                    void* dx, void* da_cols, void* ds,
                                    void* da_rows, long long chunks,
                                    int groups, int heads, int len,
                                    int d_state, void* stream) {
    if (len % SC_TILE || len > SC_MAX_LEN || len <= 0) return -1;
    const SsdShape s = sc_shape(chunks, groups, heads, len, runs);
    cudaStream_t st = (cudaStream_t)stream;
    const float *c = (const float*)cc, *b = (const float*)bc,
                *x = (const float*)xf, *a = (const float*)da,
                *g = (const float*)dy;
    float *x_d = (float*)dx, *cols = (float*)da_cols, *s_d = (float*)ds,
          *rows = (float*)da_rows;
    if (d_state == 64)
        return runs ? sc_bwd<64, true>(c, b, x, a, g, x_d, cols, s_d, rows,
                                       s, st)
                    : sc_bwd<64, false>(c, b, x, a, g, x_d, cols, s_d, rows,
                                        s, st);
    if (d_state == 128)
        return runs ? sc_bwd<128, true>(c, b, x, a, g, x_d, cols, s_d, rows,
                                        s, st)
                    : sc_bwd<128, false>(c, b, x, a, g, x_d, cols, s_d, rows,
                                         s, st);
    return -1;
}

template <int N>
static int sc_gather(const float* u, const float* v, const float* w,
                     float* r, const SsdShape& s, cudaStream_t st) {
    const size_t smem = (size_t)(2 * SC_TILE * (SC_P + 8) +
                                 2 * SC_TILE * (N + 8) + 2 * SC_TILE) *
                        sizeof(float);
    int err = sc_prepare(ssd_gather_kernel<N>, smem);
    if (err) return err;
    const dim3 grid((unsigned)(s.chunks * s.groups), (unsigned)s.heads);
    ssd_gather_kernel<N><<<grid, SC_NARROW, smem, st>>>(u, v, w, r, s);
    return (int)cudaGetLastError();
}

template <int N>
static int sc_apply(const float* v, const float* wm, const float* w,
                    const float* base, float* out, const SsdShape& s,
                    cudaStream_t st) {
    const size_t smem = (size_t)3 * SC_TILE * (N + 4) * sizeof(float);
    int err = sc_prepare(ssd_apply_kernel<N>, smem);
    if (err) return err;
    const dim3 grid((unsigned)(s.chunks * s.groups), (unsigned)s.tiles,
                    (unsigned)((s.heads + SC_HB - 1) / SC_HB));
    ssd_apply_kernel<N><<<grid, SC_NARROW, smem, st>>>(v, wm, w, base, out,
                                                       s);
    return (int)cudaGetLastError();
}

template <int N>
static int sc_cross(const float* u, const float* wm, const float* v,
                    const float* w, float* dv, float* dw, const SsdShape& s,
                    cudaStream_t st) {
    const size_t smem = (size_t)(SC_TILE * (N + 8) +
                                 2 * (SC_TILE * SC_LDP + SC_P * (N + 8))) *
                        sizeof(float);
    int err = sc_prepare(ssd_cross_kernel<N>, smem);
    if (err) return err;
    const dim3 grid((unsigned)(s.chunks * s.groups), (unsigned)s.tiles);
    ssd_cross_kernel<N><<<grid, SC_NARROW, smem, st>>>(u, wm, v, w, dv, dw,
                                                       s);
    return (int)cudaGetLastError();
}

// The linear forms beside the diagonal term (operands above the gather
// kernel), for `chunks` chunks of `len` positions (a multiple of 64, up
// to 256), `groups` groups of `heads` heads of 64, state d_state (64 or
// 128).  op 0, gather: r = sum_l w u^T v (a = u, b = v, c = w, out = r);
// op 1, apply: out = base + w v W^T (a = v, b = W, c = w, d = base or
// null); op 2, cross: out = dV, out2 = dw of z = u W (a = u, b = W, c = v,
// d = w).  Returns the CUDA error code of the first failing call (0 =
// success), or -1 for a shape or op no kernel is instantiated for.
extern "C" int ssd_chunk_state_launch(int op, const void* a, const void* b,
                                      const void* c, const void* d,
                                      void* out, void* out2,
                                      long long chunks, int groups,
                                      int heads, int len, int d_state,
                                      void* stream) {
    if (len % SC_TILE || len > SC_MAX_LEN || len <= 0) return -1;
    const SsdShape s = sc_shape(chunks, groups, heads, len, nullptr);
    cudaStream_t st = (cudaStream_t)stream;
    const float *fa = (const float*)a, *fb = (const float*)b,
                *fc = (const float*)c, *fd = (const float*)d;
    float *o = (float*)out, *o2 = (float*)out2;
    if (d_state == 64) {
        if (op == 0) return sc_gather<64>(fa, fb, fc, o, s, st);
        if (op == 1) return sc_apply<64>(fa, fb, fc, fd, o, s, st);
        if (op == 2) return sc_cross<64>(fa, fb, fc, fd, o, o2, s, st);
    }
    if (d_state == 128) {
        if (op == 0) return sc_gather<128>(fa, fb, fc, o, s, st);
        if (op == 1) return sc_apply<128>(fa, fb, fc, fd, o, s, st);
        if (op == 2) return sc_cross<128>(fa, fb, fc, fd, o, o2, s, st);
    }
    return -1;
}
