// Backward of the flash-attention forward (flash_attention.cu), for Hopper.
//
// Not a TPU kernel: the reference trains through its plain jnp attention
// (jax.value_and_grad of repro/models/attention.py::chunked_attention) and
// has no backward Pallas kernel.  The port's flash route has no plain
// alternative on the card, so its gradient is a kernel too: the recompute
// backward of flash-attention-2,
//
//   P  = exp(S * scale - lse)   (masked -> 0; a row with lse = -inf -> 0)
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K * scale,
//   dK = dS^T Q * scale,        D = rowsum(dO * O),
//
// dK and dV summed over the G = H / Hkv q heads that share a kv head.
// Masks as the forward: keys past Sk, and keys past the causal diagonal at
// offset = Sk - Sq.  Inputs: q/k/v/dO strided with only the head dimension
// dense, O and lse contiguous; everything is summed in fp32; dq, dk, dv
// come out contiguous, in the inputs' type.  The dtype picks the kernels,
// as in the forward:
//
// bfloat16, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums;
// the fragment tricks of flash_fwd_mma_kernel, mma_sync.cuh):
//   flash_bwd_delta_kernel     D, one warp per q row;
//   flash_bwd_dkdv_mma_kernel  grid (ceil(Sk / 64), B * Hkv), or B * H with
//        the GQA split below; 4 warps of 16 K rows.  The block's K and V
//        tiles stay in shared memory (read by ldmatrix on every use: at
//        D = 128, fragments of both in registers would spill); the q and
//        dO tiles of 64 rows, and their lse and D, are staged by 16-byte
//        cp.async in two stages over the q heads and their q tiles from
//        the causal diagonal on.  S^T = K Q^T and dP^T = V dO^T take K, V
//        as the A operand and Q, dO as the .col B operand as they stand;
//        P^T and dS^T leave the C fragment rounded to bf16 as the A
//        fragment of dV += P^T dO and dK += dS^T Q, whose dO and Q go in
//        through ldmatrix.trans.  The 64 q rows of a tile are taken 32 at
//        a time (S^T and dP^T take 32 fp32 registers a thread, dK and dV
//        D of them), and the k steps of S^T are not unrolled: fully
//        unrolled, ptxas hoists their loads and spills at D = 128.
//        ptxas: 168 registers at D = 64 (three blocks an SM), 255 at
//        D = 128, no spills;
//   flash_bwd_gqa_sum_kernel   with the split only: dK, dV = the sum of
//        the G fp32 partials in head order, rounded to bf16;
//   flash_bwd_dq_mma_kernel    grid (ceil(Sq / 64), B * H), the q tiles in
//        reverse (causal: the longest first); 4 warps of 16 q rows.  The
//        q and dO tiles stay in shared memory, K and V tiles of 64 rows
//        are staged by cp.async in two stages up to the causal diagonal.
//        S = Q K^T and dP = dO V^T as the forward's S; dQ += dS K with dS
//        from the C fragment and K through ldmatrix.trans.  ptxas: 166
//        registers at D = 64, 240 at D = 128, no spills.
//   Shared memory: six padded tiles of 64 x (D + 8) bf16 (and 1 KB of lse
//   and D): 56 KB at D = 64, 103 KB at D = 128, dynamic, so each kernel
//   first raises its limit with cudaFuncSetAttribute.  Tiles that cross
//   the causal diagonal or the Sq / Sk edge are masked; a warp skips a
//   tile it sees no pair of.  P and dS are rounded to bf16 as A operands
//   (as flash-attention-2 does, and as the forward rounds P): the one
//   rounding the plain version, which keeps them in fp32, does not have.
//
// The GQA split: keeping a kv head's sum inside its block makes
// B * Hkv * ceil(Sk / 64) blocks, 128 at qwen2-0.5b's training shape (4 x
// 2 kv heads x 1024 keys) for 132 SMs, each walking 7 q heads.  Where that
// count is under two blocks per SM (the wrapper's rule), the dK/dV kernel
// takes one q head per block instead and writes its fp32 partial dK (times
// the scale) and dV to a scratch of (2, B, H, Sk, D) that the wrapper
// allocates; flash_bwd_gqa_sum_kernel then sums them: one launch more,
// 2 * 4 * B * H * Sk * D bytes more (29 MB at qwen2, about 9 us).
//
// float32, on the tensor cores too, each product as three TF32 ones
// (3xTF32: lo*hi, hi*lo, hi*hi of mma.sync m16n8k8, hi and lo split by
// cvt.rna.tf32.f32, as flash_attention.cu's flash_fwd_tf32_kernel; one
// TF32 product, about 10 mantissa bits, could not hold the fp32
// comparison, 1e-4):
//   flash_bwd_delta_kernel      as above;
//   flash_bwd_dkdv_tf32_kernel  flash_bwd_dkdv_mma_kernel's design on fp32
//        tiles padded to D + 4 floats, every fragment loaded with 32-bit
//        ld.shared (ldmatrix moves 16-bit elements) and split where it is
//        used; P^T and dS^T stay in fp32 and are split from the C fragment
//        into the A fragment of dV += P^T dO and dK += dS^T Q in the
//        permuted k order of mma_sync.cuh (q rows 2t, 2t + 1 of each 8 are
//        k steps t, t + 4; dO and Q read in that order), so no shuffle
//        moves them; q rows 32 at a time; at D = 128, where dK and dV
//        together would hold 128 fp32 registers a thread and spill, dV
//        and dK are two launches (S^T computed in both); the same GQA sum,
//        in the block or split (flash_bwd_gqa_sum_kernel<float>);
//   flash_bwd_dq_tf32_kernel    flash_bwd_dq_mma_kernel's design likewise,
//        K/V tiles of 64 rows (32 at D = 128).
//   Shared memory: dK/dV six padded fp32 tiles of 64 rows (105 KB at D =
//   64, 204 KB at D = 128), dQ two of 64 rows and four of the K/V tile
//   (104 KB, 135 KB).  Sums in fp32 and expf, as the plain version.
//
// Segment ids: each dK/dV and dQ kernel, both dtypes, has a SEG = true
// instantiation for a call with the forward's ids, over the forward's
// segment records (flash_attention.cu, flash_segments.cuh; a call without
// ids runs SEG = false, the code as it was).  The dK/dV block loops over
// its K tile's range of q rows (over each q head), the dQ block over its q
// tile's range of keys, each inside the causal bound; a warp skips a tile
// whose id interval misses its own keys' (dK/dV) or rows' (dQ); the
// per-pair test of the ids joins the mask only on a tile that is not one
// id on both sides.  The dK/dV block stages each q tile's ids beside its
// lse and D; the block's own ids and each warp's bounds sit in shared
// memory (fs_rows).  A dK/dV block whose range is empty (kv ids that no
// query shares) writes zeros.
//
// Every kernel sums in a fixed order with no atomics, so a training step
// is deterministic; dQ has its own kernel that recomputes S and dP.
//
// Bound on this card: the five 2 * D products per visible (q, k) pair
// (S and dP, dV, dK, dQ: 10 * D operations) at the bf16 tensor-core peak
// (fp32: 3 x 495 TFLOP/s TF32 or 67 TFLOP/s on the CUDA cores, whichever
// is faster: 165 TFLOP/s of fp32 work), against q, k, v, o, dO, lse read
// once and dq, dk, dv written once; operations lead at the training
// shapes (whisper's encoder, 4 x 8 x 1500 x 64: 46 GFLOP -> 47 us at 989
// TFLOP/s, 31 MB -> 9 us; in fp32 0.28 ms).  The kernels here compute S
// and dP in both the dK/dV and the dQ kernel: 14 * D operations a pair,
// 1.4 times the bound's.  Their times are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_segments.cuh"
#include "mma_sync.cuh"

struct FbShape {
    long long heads, kv_heads, kv_group;    // H, Hkv, H / Hkv
    long long sq, sk, offset;               // offset = sk - sq
    long long q_sb, q_sh, q_ss;             // element strides (head dim dense)
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long do_sb, do_sh, do_ss;
    int causal;
    float scale;
    FsIds seg;                              // the segment ids (SEG kernels)
};

// The q tiles of a dK/dV block (K tile k0): the first q row i_first and
// the number of 64-row tiles from it, the causal bound and, with SEG,
// inside it the pre-pass's range of q rows.
template <bool SEG>
__device__ __forceinline__ void fb_q_range(const FbShape& s, long long b,
                                           long long k0, long long& i_first,
                                           long long& n_tiles) {
    // the first q tile with a row that sees key k0 (always < Sq: k0 < Sk)
    i_first = 0;
    if (s.causal && k0 - s.offset > 0)
        i_first = (k0 - s.offset) / 64 * 64;
    if constexpr (!SEG) {
        n_tiles = (s.sq - i_first + 63) / 64;
    } else {
        const int4 rec = fs_k_rec(s.seg, b, k0 / FS_TILE);
        if (rec.z > i_first) i_first = rec.z;
        n_tiles = rec.w > i_first ? (rec.w - i_first + 63) / 64 : 0;
    }
}

__device__ __forceinline__ float fb_load(const float* p) { return *p; }
__device__ __forceinline__ float fb_load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// D = rowsum(dO * O) for each of the B * H * Sq rows, one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, FbShape s, long long rows) {
    const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (r >= rows) return;                       // warp-uniform
    const long long bh = r / s.sq, i = r % s.sq;
    const long long b = bh / s.heads, h = bh % s.heads;
    const T* orow = o + r * D;
    const T* drow = dout + b * s.do_sb + h * s.do_sh + i * s.do_ss;
    float acc = 0.f;
#pragma unroll
    for (int c = lane; c < D; c += 32)
        acc += fb_load(orow + c) * fb_load(drow + c);
#pragma unroll
    for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

#define FBM_ROWS 64          // K rows per dK/dV block, q rows per dQ block,
                             // rows of every staged tile
#define FBM_THREADS 128      // 4 warps x 16 rows
#define FBM_LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

// Ints past the lse and D rows of a segmented kernel: two staged rows of q
// ids (dK/dV) and fs_rows' ids and bounds.
#define FB_SEG_INTS (2 * FBM_ROWS + FS_SMEM_INTS)

template <int D, bool SEG>
constexpr size_t fbm_smem_bytes() {  // six padded tiles + 2 x 2 rows of 64
    return (size_t)6 * FBM_ROWS * (D + 8) * sizeof(bf16) +
           (size_t)4 * FBM_ROWS * sizeof(float) +
           (SEG ? FB_SEG_INTS * sizeof(int) : 0);
}

template <int D>
__device__ __forceinline__ void fbm_stage(bf16* dst, const bf16* src,
                                          long long stride, long long row0,
                                          long long end, int tid) {
    cp_async_rows<FBM_ROWS, D, FBM_THREADS>(dst, src, stride, row0, end,
                                            tid);
}

// two neighbouring columns of an output row
__device__ __forceinline__ void fbm_store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void fbm_store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// the A fragment of 16 columns (k) kk of a 16-row C fragment, in bf16
__device__ __forceinline__ void fbm_a_from_c(uint32_t (&a)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
    a[0] = pack_bf16x2(c0[0], c0[1]);
    a[1] = pack_bf16x2(c0[2], c0[3]);
    a[2] = pack_bf16x2(c1[0], c1[1]);
    a[3] = pack_bf16x2(c1[2], c1[3]);
}

// dK, dV of one 64-row K tile.  TO = bf16: the block sums the G q heads of
// kv head blockIdx.y % Hkv and writes dk, dv (B, Hkv, Sk, D); TO = float
// (the GQA split): the block takes q head blockIdx.y % H alone and writes
// its partials to dk, dv (B, H, Sk, D).
template <int D, typename TO, bool SEG>
__global__ void __launch_bounds__(FBM_THREADS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          TO* __restrict__ dk, TO* __restrict__ dv,
                          FbShape s) {
    extern __shared__ float4 fbm_smem[];
    constexpr bool SPLIT = sizeof(TO) == 4;
    constexpr int LD = D + 8, TILE = FBM_ROWS * LD;
    constexpr int QC = 32;                   // q rows of S^T per pass
    bf16* k_s = reinterpret_cast<bf16*>(fbm_smem);
    bf16* v_s = k_s + TILE;
    bf16* q_s = v_s + TILE;                  // two stages
    bf16* do_s = q_s + 2 * TILE;             // two stages
    float* lse_s = reinterpret_cast<float*>(do_s + 2 * TILE);  // two stages
    float* dl_s = lse_s + 2 * FBM_ROWS;                        // two stages
    int* id_s = reinterpret_cast<int*>(dl_s + 2 * FBM_ROWS);   // (SEG) two
    int* kid_s = id_s + 2 * FBM_ROWS;           // (SEG) the block's key ids
    int* wb_s = kid_s + FS_TILE;                // (SEG) each warp's bounds

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long out_heads = SPLIT ? s.heads : s.kv_heads;
    const long long b = blockIdx.y / out_heads, oh = blockIdx.y % out_heads;
    const long long hk = SPLIT ? oh / s.kv_group : oh;
    const long long h_first = SPLIT ? oh : oh * s.kv_group;
    const long long n_heads = SPLIT ? 1 : s.kv_group;
    const long long k0 = (long long)blockIdx.x * FBM_ROWS;
    const long long kw0 = k0 + warp * 16;       // the warp's first key

    long long i_first, n_tiles;
    fb_q_range<SEG>(s, b, k0, i_first, n_tiles);
    if constexpr (SEG)
        fs_rows(kid_s, wb_s, s.seg.k + b * s.sk, s.sk, k0, tid);
    const long long steps = n_heads * n_tiles;

    // step j: q head h_first + j / n_tiles, q tile i_first + 64 (j % n_tiles)
    auto stage = [&](long long j, int st) {
        const long long h = h_first + j / n_tiles;
        const long long i0 = i_first + (j % n_tiles) * FBM_ROWS;
        fbm_stage<D>(q_s + st * TILE, q + b * s.q_sb + h * s.q_sh, s.q_ss,
                     i0, s.sq, tid);
        fbm_stage<D>(do_s + st * TILE, dout + b * s.do_sb + h * s.do_sh,
                     s.do_ss, i0, s.sq, tid);
        if (tid < FBM_ROWS) {
            const long long i = i0 + tid;
            const long long row = (b * s.heads + h) * s.sq + i;
            lse_s[st * FBM_ROWS + tid] = i < s.sq ? lse[row] : 0.f;
            dl_s[st * FBM_ROWS + tid] = i < s.sq ? delta[row] : 0.f;
            if constexpr (SEG)
                id_s[st * FBM_ROWS + tid] =
                    i < s.sq ? s.seg.q[b * s.sq + i] : 0;
        }
    };

    // group 0: the K and V tiles and step 0's q and dO (none where the
    // pre-pass found no q tile: the block writes zeros)
    if (!SEG || steps > 0) {
        fbm_stage<D>(k_s, k + b * s.k_sb + hk * s.k_sh, s.k_ss, k0, s.sk,
                     tid);
        fbm_stage<D>(v_s, v + b * s.v_sb + hk * s.v_sh, s.v_ss, k0, s.sk,
                     tid);
        stage(0, 0);
    }
    cp_async_commit();

    // lane addresses (flash_attention.cu): A tiles and .trans B tiles take
    // rows (lane & 7) + 8 * bit 3, column 8 * bit 4; .col B tiles rows
    // (lane & 7) + 8 * bit 4, column 8 * bit 3
    const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
    const int b_lane = ((lane & 7) + (lane >> 4) * 8) * LD +
                       ((lane >> 3) & 1) * 8;
    const uint32_t k_addr = smem_addr(k_s + warp * 16 * LD + a_lane);
    const uint32_t v_addr = smem_addr(v_s + warp * 16 * LD + a_lane);

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

    for (long long j = 0; j < steps; ++j) {
        const int st = (int)(j & 1);
        if (j + 1 < steps) stage(j + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();                     // step j has landed
        __syncthreads();

        const long long i0 = i_first + (j % n_tiles) * FBM_ROWS;
        bool sees = !s.causal || i0 + FBM_ROWS - 1 + s.offset >= kw0;
        bool split = false;                     // crosses a segment edge
        if constexpr (SEG)
            fs_warp_tile(wb_s + 2 * warp, fs_q_rec(s.seg, b, i0 / FS_TILE),
                         sees, split);
        if (sees) {
            const bool edge = (s.causal && i0 + s.offset < kw0 + 15) ||
                              i0 + FBM_ROWS > s.sq || kw0 + 16 > s.sk ||
                              split;
            const float* lse_t = lse_s + st * FBM_ROWS;
            const float* dl_t = dl_s + st * FBM_ROWS;
            const int* id_t = id_s + st * FBM_ROWS;
            const uint32_t q_col = smem_addr(q_s + st * TILE + b_lane);
            const uint32_t do_col = smem_addr(do_s + st * TILE + b_lane);
            const uint32_t q_tr = smem_addr(q_s + st * TILE + a_lane);
            const uint32_t do_tr = smem_addr(do_s + st * TILE + a_lane);
#pragma unroll
            for (int qc = 0; qc < FBM_ROWS; qc += QC) {
                // S^T = K Q^T, dP^T = V dO^T: 16 keys x QC q rows
                float sc[QC / 8][4], dp[QC / 8][4];
#pragma unroll
                for (int n = 0; n < QC / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
                // not unrolled: loads hoisted across the k steps take the
                // registers dK and dV need (spills at D = 128)
#pragma unroll 1
                for (int kk = 0; kk < D / 16; ++kk) {
                    uint32_t ka[4], va[4];
                    ldsm_x4(ka, k_addr + kk * 32);
                    ldsm_x4(va, v_addr + kk * 32);
#pragma unroll
                    for (int np = 0; np < QC / 16; ++np) {
                        const int off = ((qc + np * 16) * LD + kk * 16) * 2;
                        uint32_t r[4];
                        ldsm_x4(r, q_col + off);
                        mma_bf16_16816(sc[2 * np], ka, r[0], r[1]);
                        mma_bf16_16816(sc[2 * np + 1], ka, r[2], r[3]);
                        ldsm_x4(r, do_col + off);
                        mma_bf16_16816(dp[2 * np], va, r[0], r[1]);
                        mma_bf16_16816(dp[2 * np + 1], va, r[2], r[3]);
                    }
                }
                // P^T and dS^T in fp32: row key, column q row qc + c
#pragma unroll
                for (int n = 0; n < QC / 8; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = qc + n * 8 + 2 * t + (e & 1);
                        float p = exp2f((sc[n][e] * s.scale - lse_t[c]) *
                                        FBM_LOG2E);
                        if (edge) {
                            const long long key = kw0 + g + 8 * (e >> 1);
                            const long long i = i0 + c;
                            bool valid = key < s.sk && i < s.sq &&
                                         (!s.causal || i + s.offset >= key);
                            if constexpr (SEG)
                                valid = valid &&
                                        id_t[c] == kid_s[warp * 16 + g +
                                                         (e >> 1) * 8];
                            p = valid ? p : 0.f;
                        }
                        sc[n][e] = p;
                        dp[n][e] = p * (dp[n][e] - dl_t[c]);
                    }
                }
                // dV += P^T dO, dK += dS^T Q over these QC q rows
#pragma unroll
                for (int kk = 0; kk < QC / 16; ++kk) {
                    uint32_t pa[4], da[4];
                    fbm_a_from_c(pa, sc[2 * kk], sc[2 * kk + 1]);
                    fbm_a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
                    for (int dn = 0; dn < D / 16; ++dn) {
                        const int off = ((qc + kk * 16) * LD + dn * 16) * 2;
                        uint32_t r[4];
                        ldsm_x4_trans(r, do_tr + off);
                        mma_bf16_16816(dva[2 * dn], pa, r[0], r[1]);
                        mma_bf16_16816(dva[2 * dn + 1], pa, r[2], r[3]);
                        ldsm_x4_trans(r, q_tr + off);
                        mma_bf16_16816(dka[2 * dn], da, r[0], r[1]);
                        mma_bf16_16816(dka[2 * dn + 1], da, r[2], r[3]);
                    }
                }
            }
        }
        __syncthreads();             // stage st is free for step j + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long key = kw0 + g + 8 * i;
        if (key >= s.sk) continue;
        const long long row = ((long long)blockIdx.y * s.sk + key) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            fbm_store2(dk + row + n * 8, dka[n][2 * i] * s.scale,
                       dka[n][2 * i + 1] * s.scale);
            fbm_store2(dv + row + n * 8, dva[n][2 * i], dva[n][2 * i + 1]);
        }
    }
}

// The GQA split's sum: dk, dv (B, Hkv, Sk, D) = the sum over each kv head's
// G q heads of part (2, B, H, Sk, D) fp32 (dK partials, then dV), in head
// order, in the inputs' type (bf16 rounds once).  One thread per 4
// neighbouring elements.
template <typename TO>
__global__ void __launch_bounds__(256)
flash_bwd_gqa_sum_kernel(const float* __restrict__ part, TO* __restrict__ dk,
                         TO* __restrict__ dv, long long kv_rows,
                         long long group, long long row_elems) {
    const long long n4 = kv_rows * row_elems / 4;    // per output
    long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
    if (idx >= 2 * n4) return;
    const int which = idx >= n4;
    if (which) idx -= n4;
    const long long e = idx * 4;
    const long long bk = e / row_elems, off = e % row_elems;
    const float* src = part + ((which * kv_rows + bk) * group) * row_elems
                       + off;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (long long gi = 1; gi < group; ++gi) {
        const float4 x =
            *reinterpret_cast<const float4*>(src + gi * row_elems);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
    }
    TO* dst = (which ? dv : dk) + e;
    fbm_store2(dst, acc.x, acc.y);
    fbm_store2(dst + 2, acc.z, acc.w);
}

// dQ of one 64-row q tile of q head blockIdx.y % H.
template <int D, bool SEG>
__global__ void __launch_bounds__(FBM_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, FbShape s) {
    extern __shared__ float4 fbm_smem[];
    constexpr int LD = D + 8, TILE = FBM_ROWS * LD;
    bf16* q_s = reinterpret_cast<bf16*>(fbm_smem);
    bf16* do_s = q_s + TILE;
    bf16* k_s = do_s + TILE;                    // two stages
    bf16* v_s = k_s + 2 * TILE;                 // two stages
    int* ids_s = reinterpret_cast<int*>(v_s + 2 * TILE);   // (SEG) row ids
    int* wb_s = ids_s + FS_TILE;                           // (SEG) bounds

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long bh = blockIdx.y;
    const long long b = bh / s.heads, h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * FBM_ROWS;
    const long long qw0 = q0 + warp * 16;       // the warp's first q row
    const bf16* kb = k + b * s.k_sb + hk * s.k_sh;
    const bf16* vb = v + b * s.v_sb + hk * s.v_sh;

    long long lower, upper;
    fs_kv_range<SEG, FBM_ROWS>(s, b, q0, lower, upper);
    if constexpr (SEG)
        fs_rows(ids_s, wb_s, s.seg.q + b * s.sq, s.sq, q0, tid);

    // group 0: the q and dO tiles and K/V tile `lower`
    fbm_stage<D>(q_s, q + b * s.q_sb + h * s.q_sh, s.q_ss, q0, s.sq, tid);
    fbm_stage<D>(do_s, dout + b * s.do_sb + h * s.do_sh, s.do_ss, q0, s.sq,
                 tid);
    if (upper > lower) {
        fbm_stage<D>(k_s, kb, s.k_ss, lower * FBM_ROWS, s.sk, tid);
        fbm_stage<D>(v_s, vb, s.v_ss, lower * FBM_ROWS, s.sk, tid);
    }
    cp_async_commit();

    float lse_r[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long row = qw0 + g + 8 * i;
        lse_r[i] = row < s.sq ? lse[bh * s.sq + row] : 0.f;
        dl_r[i] = row < s.sq ? delta[bh * s.sq + row] : 0.f;
    }
    const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
    const int b_lane = ((lane & 7) + (lane >> 4) * 8) * LD +
                       ((lane >> 3) & 1) * 8;
    const uint32_t q_addr = smem_addr(q_s + warp * 16 * LD + a_lane);
    const uint32_t do_addr = smem_addr(do_s + warp * 16 * LD + a_lane);

    float dqa[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
        dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

    for (long long j = lower; j < upper; ++j) {
        const int st = (int)((j - lower) & 1);
        if (j + 1 < upper) {
            const long long next = (j + 1) * FBM_ROWS;
            fbm_stage<D>(k_s + (st ^ 1) * TILE, kb, s.k_ss, next, s.sk, tid);
            fbm_stage<D>(v_s + (st ^ 1) * TILE, vb, s.v_ss, next, s.sk, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();                     // tile j has landed
        __syncthreads();

        const long long k0 = j * FBM_ROWS;
        bool sees = !s.causal || k0 <= qw0 + 15 + s.offset;
        bool split = false;                     // crosses a segment edge
        if constexpr (SEG)
            fs_warp_tile(wb_s + 2 * warp, fs_k_rec(s.seg, b, k0 / FS_TILE),
                         sees, split);
        if (sees) {
            // S = Q K^T, dP = dO V^T: 16 q rows x 64 keys
            float sc[FBM_ROWS / 8][4], dp[FBM_ROWS / 8][4];
#pragma unroll
            for (int n = 0; n < FBM_ROWS / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
            const uint32_t k_col = smem_addr(k_s + st * TILE + b_lane);
            const uint32_t v_col = smem_addr(v_s + st * TILE + b_lane);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t qa[4], da[4];
                ldsm_x4(qa, q_addr + kk * 32);
                ldsm_x4(da, do_addr + kk * 32);
#pragma unroll
                for (int np = 0; np < FBM_ROWS / 16; ++np) {
                    const int off = (np * 16 * LD + kk * 16) * 2;
                    uint32_t r[4];
                    ldsm_x4(r, k_col + off);
                    mma_bf16_16816(sc[2 * np], qa, r[0], r[1]);
                    mma_bf16_16816(sc[2 * np + 1], qa, r[2], r[3]);
                    ldsm_x4(r, v_col + off);
                    mma_bf16_16816(dp[2 * np], da, r[0], r[1]);
                    mma_bf16_16816(dp[2 * np + 1], da, r[2], r[3]);
                }
            }
            // dS = P * (dP - D) in fp32
            const bool edge = (s.causal && k0 + FBM_ROWS - 1 > qw0 + s.offset)
                              || k0 + FBM_ROWS > s.sk || qw0 + 16 > s.sq ||
                              split;
#pragma unroll
            for (int n = 0; n < FBM_ROWS / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = exp2f((sc[n][e] * s.scale - lse_r[e >> 1]) *
                                    FBM_LOG2E);
                    if (edge) {
                        const long long key = k0 + n * 8 + 2 * t + (e & 1);
                        const long long row = qw0 + g + 8 * (e >> 1);
                        bool valid = key < s.sk && row < s.sq &&
                                     (!s.causal || row + s.offset >= key);
                        if constexpr (SEG)
                            valid = valid && s.seg.k[b * s.sk + key] ==
                                                 ids_s[warp * 16 + g +
                                                       (e >> 1) * 8];
                        p = valid ? p : 0.f;
                    }
                    dp[n][e] = p * (dp[n][e] - dl_r[e >> 1]);
                }
            }
            // dQ += dS K: dS in bf16 as the A operand, K through .trans
            const uint32_t k_tr = smem_addr(k_s + st * TILE + a_lane);
#pragma unroll
            for (int kk = 0; kk < FBM_ROWS / 16; ++kk) {
                uint32_t a[4];
                fbm_a_from_c(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
                for (int dn = 0; dn < D / 16; ++dn) {
                    uint32_t r[4];
                    ldsm_x4_trans(r, k_tr + (kk * 16 * LD + dn * 16) * 2);
                    mma_bf16_16816(dqa[2 * dn], a, r[0], r[1]);
                    mma_bf16_16816(dqa[2 * dn + 1], a, r[2], r[3]);
                }
            }
        }
        __syncthreads();             // stage st is free for tile j + 2
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long row = qw0 + g + 8 * i;
        if (row >= s.sq) continue;
        bf16* out = dq + (bh * s.sq + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            fbm_store2(out + n * 8, dqa[n][2 * i] * s.scale,
                       dqa[n][2 * i + 1] * s.scale);
    }
}

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// K/V rows a staged tile of the dQ kernel
template <int D>
__host__ __device__ constexpr int ftb_kv_rows() { return D == 64 ? 64 : 32; }

// What a dK/dV launch accumulates: both (D = 64), or one each in two
// launches (D = 128, where dK and dV together hold 128 fp32 registers a
// thread and spill; the dV launch computes S^T alone, the dK launch S^T
// and dP^T again)
enum { FTB_DK = 1, FTB_DV = 2, FTB_BOTH = 3 };

template <int D, bool SEG>
constexpr size_t ftb_dkdv_smem_bytes() {  // K, V + two stages of q, dO
    return (size_t)6 * FBM_ROWS * (D + 4) * sizeof(float) +
           (size_t)4 * FBM_ROWS * sizeof(float) +
           (SEG ? FB_SEG_INTS * sizeof(int) : 0);
}

template <int D, bool SEG>
constexpr size_t ftb_dq_smem_bytes() {    // q, dO + two stages of K, V
    return (size_t)(2 * FBM_ROWS + 4 * ftb_kv_rows<D>()) * (D + 4) *
           sizeof(float) + (SEG ? FS_SMEM_INTS * sizeof(int) : 0);
}

// dK and / or dV (WHAT) of one 64-row K tile in float32, as
// flash_bwd_dkdv_mma_kernel: SPLIT = false sums the G q heads of kv head
// blockIdx.y % Hkv and writes dk, dv (B, Hkv, Sk, D); SPLIT = true takes q
// head blockIdx.y % H alone and writes its partials to dk, dv (B, H, Sk,
// D).
template <int D, bool SPLIT, int WHAT, bool SEG>
__global__ void __launch_bounds__(FBM_THREADS)
flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           FbShape s) {
    extern __shared__ float4 ftb_smem[];
    constexpr int LD = D + 4, TILE = FBM_ROWS * LD, QC = 32;
    constexpr bool DK = WHAT & FTB_DK, DV = WHAT & FTB_DV;
    float* k_s = reinterpret_cast<float*>(ftb_smem);
    float* v_s = k_s + TILE;
    float* q_s = v_s + TILE;                     // two stages
    float* do_s = q_s + 2 * TILE;                // two stages
    float* lse_s = do_s + 2 * TILE;              // two stages
    float* dl_s = lse_s + 2 * FBM_ROWS;          // two stages
    int* id_s = reinterpret_cast<int*>(dl_s + 2 * FBM_ROWS);   // (SEG) two
    int* kid_s = id_s + 2 * FBM_ROWS;           // (SEG) the block's key ids
    int* wb_s = kid_s + FS_TILE;                // (SEG) each warp's bounds

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long out_heads = SPLIT ? s.heads : s.kv_heads;
    const long long b = blockIdx.y / out_heads, oh = blockIdx.y % out_heads;
    const long long hk = SPLIT ? oh / s.kv_group : oh;
    const long long h_first = SPLIT ? oh : oh * s.kv_group;
    const long long n_heads = SPLIT ? 1 : s.kv_group;
    const long long k0 = (long long)blockIdx.x * FBM_ROWS;
    const long long kw0 = k0 + warp * 16;       // the warp's first key

    long long i_first, n_tiles;
    fb_q_range<SEG>(s, b, k0, i_first, n_tiles);
    if constexpr (SEG)
        fs_rows(kid_s, wb_s, s.seg.k + b * s.sk, s.sk, k0, tid);
    const long long steps = n_heads * n_tiles;

    // step j: q head h_first + j / n_tiles, q tile i_first + 64 (j % n_tiles)
    auto stage = [&](long long j, int st) {
        const long long h = h_first + j / n_tiles;
        const long long i0 = i_first + (j % n_tiles) * FBM_ROWS;
        cp_async_rows_f32<FBM_ROWS, D, FBM_THREADS>(
            q_s + st * TILE, q + b * s.q_sb + h * s.q_sh, s.q_ss, i0, s.sq,
            tid);
        cp_async_rows_f32<FBM_ROWS, D, FBM_THREADS>(
            do_s + st * TILE, dout + b * s.do_sb + h * s.do_sh, s.do_ss, i0,
            s.sq, tid);
        if (tid < FBM_ROWS) {
            const long long i = i0 + tid;
            const long long row = (b * s.heads + h) * s.sq + i;
            lse_s[st * FBM_ROWS + tid] = i < s.sq ? lse[row] : 0.f;
            dl_s[st * FBM_ROWS + tid] = i < s.sq ? delta[row] : 0.f;
            if constexpr (SEG)
                id_s[st * FBM_ROWS + tid] =
                    i < s.sq ? s.seg.q[b * s.sq + i] : 0;
        }
    };

    // group 0: the K and V tiles and step 0's q and dO (none where the
    // pre-pass found no q tile: the block writes zeros)
    if (!SEG || steps > 0) {
        cp_async_rows_f32<FBM_ROWS, D, FBM_THREADS>(
            k_s, k + b * s.k_sb + hk * s.k_sh, s.k_ss, k0, s.sk, tid);
        cp_async_rows_f32<FBM_ROWS, D, FBM_THREADS>(
            v_s, v + b * s.v_sb + hk * s.v_sh, s.v_ss, k0, s.sk, tid);
        stage(0, 0);
    }
    cp_async_commit();

    // the warp's 16 keys are the A operand of S^T = K Q^T, dP^T = V dO^T
    const float* k_w = k_s + (warp * 16 + g) * LD + t;
    const float* v_w = v_s + (warp * 16 + g) * LD + t;

    float dka[DK ? D / 8 : 1][4], dva[DV ? D / 8 : 1][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if constexpr (DK) dka[n][e] = 0.f;
            if constexpr (DV) dva[n][e] = 0.f;
        }

    for (long long j = 0; j < steps; ++j) {
        const int st = (int)(j & 1);
        if (j + 1 < steps) stage(j + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();                     // step j has landed
        __syncthreads();

        const long long i0 = i_first + (j % n_tiles) * FBM_ROWS;
        bool sees = !s.causal || i0 + FBM_ROWS - 1 + s.offset >= kw0;
        bool split = false;                     // crosses a segment edge
        if constexpr (SEG)
            fs_warp_tile(wb_s + 2 * warp, fs_q_rec(s.seg, b, i0 / FS_TILE),
                         sees, split);
        if (sees) {
            const bool edge = (s.causal && i0 + s.offset < kw0 + 15) ||
                              i0 + FBM_ROWS > s.sq || kw0 + 16 > s.sk ||
                              split;
            const float* lse_t = lse_s + st * FBM_ROWS;
            const float* dl_t = dl_s + st * FBM_ROWS;
            const int* id_t = id_s + st * FBM_ROWS;
            const float* q_t = q_s + st * TILE;
            const float* do_t = do_s + st * TILE;
#pragma unroll
            for (int qc = 0; qc < FBM_ROWS; qc += QC) {
                // S^T = K Q^T, dP^T = V dO^T: 16 keys x QC q rows
                float sc[QC / 8][4], dp[DK ? QC / 8 : 1][4];
#pragma unroll
                for (int n = 0; n < QC / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        sc[n][e] = 0.f;
                        if constexpr (DK) dp[n][e] = 0.f;
                    }
                const float* q_c = q_t + (qc + g) * LD + t;
                const float* do_c = do_t + (qc + g) * LD + t;
                // not unrolled: loads hoisted across the k steps take the
                // registers dK and dV need
#pragma unroll 1
                for (int kk = 0; kk < D / 8; ++kk) {
                    uint32_t kh[4], kl[4], vh[4], vl[4];
                    tf32_a_frag<LD>(kh, kl, k_w + kk * 8);
                    if constexpr (DK) tf32_a_frag<LD>(vh, vl, v_w + kk * 8);
#pragma unroll
                    for (int n = 0; n < QC / 8; ++n) {
                        const int off = n * 8 * LD + kk * 8;
                        uint32_t bh0, bh1, bl0, bl1;
                        tf32_b_frag_rows(bh0, bh1, bl0, bl1, q_c + off);
                        mma_3xtf32(sc[n], kh, kl, bh0, bh1, bl0, bl1);
                        if constexpr (DK) {
                            tf32_b_frag_rows(bh0, bh1, bl0, bl1, do_c + off);
                            mma_3xtf32(dp[n], vh, vl, bh0, bh1, bl0, bl1);
                        }
                    }
                }
                // P^T and dS^T: row key, column q row qc + c
#pragma unroll
                for (int n = 0; n < QC / 8; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = qc + n * 8 + 2 * t + (e & 1);
                        float p = expf(sc[n][e] * s.scale - lse_t[c]);
                        if (edge) {
                            const long long key = kw0 + g + 8 * (e >> 1);
                            const long long i = i0 + c;
                            bool valid = key < s.sk && i < s.sq &&
                                         (!s.causal || i + s.offset >= key);
                            if constexpr (SEG)
                                valid = valid &&
                                        id_t[c] == kid_s[warp * 16 + g +
                                                         (e >> 1) * 8];
                            p = valid ? p : 0.f;
                        }
                        sc[n][e] = p;
                        if constexpr (DK) dp[n][e] = p * (dp[n][e] - dl_t[c]);
                    }
                }
                // dV += P^T dO, dK += dS^T Q over these QC q rows (the
                // permuted k order: q rows 2t, 2t + 1 of each 8)
                const float* do_p = do_t + (qc + 2 * t) * LD + g;
                const float* q_p = q_t + (qc + 2 * t) * LD + g;
#pragma unroll
                for (int kk = 0; kk < QC / 8; ++kk) {
                    uint32_t ph[4], pl[4], dh[4], dl[4];
                    if constexpr (DV) tf32_a_from_c(ph, pl, sc[kk]);
                    if constexpr (DK) tf32_a_from_c(dh, dl, dp[kk]);
#pragma unroll
                    for (int dn = 0; dn < D / 8; ++dn) {
                        const int off = kk * 8 * LD + dn * 8;
                        uint32_t bh0, bh1, bl0, bl1;
                        if constexpr (DV) {
                            tf32_b_frag_perm<LD>(bh0, bh1, bl0, bl1,
                                                 do_p + off);
                            mma_3xtf32(dva[dn], ph, pl, bh0, bh1, bl0, bl1);
                        }
                        if constexpr (DK) {
                            tf32_b_frag_perm<LD>(bh0, bh1, bl0, bl1,
                                                 q_p + off);
                            mma_3xtf32(dka[dn], dh, dl, bh0, bh1, bl0, bl1);
                        }
                    }
                }
            }
        }
        __syncthreads();             // stage st is free for step j + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long key = kw0 + g + 8 * i;
        if (key >= s.sk) continue;
        const long long row = ((long long)blockIdx.y * s.sk + key) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            if constexpr (DK)
                fbm_store2(dk + row + n * 8, dka[n][2 * i] * s.scale,
                           dka[n][2 * i + 1] * s.scale);
            if constexpr (DV)
                fbm_store2(dv + row + n * 8, dva[n][2 * i],
                           dva[n][2 * i + 1]);
        }
    }
}

// dQ of one 64-row q tile of q head blockIdx.y % H in float32, as
// flash_bwd_dq_mma_kernel.
template <int D, bool SEG>
__global__ void __launch_bounds__(FBM_THREADS)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, FbShape s) {
    extern __shared__ float4 ftb_smem[];
    constexpr int LD = D + 4, BK = ftb_kv_rows<D>(), TILE = BK * LD;
    float* q_s = reinterpret_cast<float*>(ftb_smem);
    float* do_s = q_s + FBM_ROWS * LD;
    float* k_s = do_s + FBM_ROWS * LD;          // two stages
    float* v_s = k_s + 2 * TILE;                // two stages
    int* ids_s = reinterpret_cast<int*>(v_s + 2 * TILE);   // (SEG) row ids
    int* wb_s = ids_s + FS_TILE;                           // (SEG) bounds

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long bh = blockIdx.y;
    const long long b = bh / s.heads, h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * FBM_ROWS;
    const long long qw0 = q0 + warp * 16;       // the warp's first q row
    const float* kb = k + b * s.k_sb + hk * s.k_sh;
    const float* vb = v + b * s.v_sb + hk * s.v_sh;

    long long lower, upper;
    fs_kv_range<SEG, BK>(s, b, q0, lower, upper);
    if constexpr (SEG)
        fs_rows(ids_s, wb_s, s.seg.q + b * s.sq, s.sq, q0, tid);

    // group 0: the q and dO tiles and K/V tile `lower`
    cp_async_rows_f32<FBM_ROWS, D, FBM_THREADS>(
        q_s, q + b * s.q_sb + h * s.q_sh, s.q_ss, q0, s.sq, tid);
    cp_async_rows_f32<FBM_ROWS, D, FBM_THREADS>(
        do_s, dout + b * s.do_sb + h * s.do_sh, s.do_ss, q0, s.sq, tid);
    if (upper > lower) {
        cp_async_rows_f32<BK, D, FBM_THREADS>(k_s, kb, s.k_ss, lower * BK,
                                              s.sk, tid);
        cp_async_rows_f32<BK, D, FBM_THREADS>(v_s, vb, s.v_ss, lower * BK,
                                              s.sk, tid);
    }
    cp_async_commit();

    float lse_r[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long row = qw0 + g + 8 * i;
        lse_r[i] = row < s.sq ? lse[bh * s.sq + row] : 0.f;
        dl_r[i] = row < s.sq ? delta[bh * s.sq + row] : 0.f;
    }
    const float* q_w = q_s + (warp * 16 + g) * LD + t;
    const float* do_w = do_s + (warp * 16 + g) * LD + t;

    float dqa[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
        dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

    for (long long j = lower; j < upper; ++j) {
        const int st = (int)((j - lower) & 1);
        if (j + 1 < upper) {
            const long long next = (j + 1) * BK;
            cp_async_rows_f32<BK, D, FBM_THREADS>(k_s + (st ^ 1) * TILE, kb,
                                                  s.k_ss, next, s.sk, tid);
            cp_async_rows_f32<BK, D, FBM_THREADS>(v_s + (st ^ 1) * TILE, vb,
                                                  s.v_ss, next, s.sk, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();                     // tile j has landed
        __syncthreads();

        const long long k0 = j * BK;
        bool sees = !s.causal || k0 <= qw0 + 15 + s.offset;
        bool split = false;                     // crosses a segment edge
        if constexpr (SEG)
            fs_warp_tile(wb_s + 2 * warp, fs_k_rec(s.seg, b, k0 / FS_TILE),
                         sees, split);
        if (sees) {
            // S = Q K^T, dP = dO V^T: 16 q rows x BK keys
            float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
            const float* k_t = k_s + st * TILE + g * LD + t;
            const float* v_t = v_s + st * TILE + g * LD + t;
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
                uint32_t qh[4], ql[4], dh[4], dl[4];
                tf32_a_frag<LD>(qh, ql, q_w + kk * 8);
                tf32_a_frag<LD>(dh, dl, do_w + kk * 8);
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    const int off = n * 8 * LD + kk * 8;
                    uint32_t bh0, bh1, bl0, bl1;
                    tf32_b_frag_rows(bh0, bh1, bl0, bl1, k_t + off);
                    mma_3xtf32(sc[n], qh, ql, bh0, bh1, bl0, bl1);
                    tf32_b_frag_rows(bh0, bh1, bl0, bl1, v_t + off);
                    mma_3xtf32(dp[n], dh, dl, bh0, bh1, bl0, bl1);
                }
            }
            // dS = P * (dP - D)
            const bool edge = (s.causal && k0 + BK - 1 > qw0 + s.offset)
                              || k0 + BK > s.sk || qw0 + 16 > s.sq || split;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = expf(sc[n][e] * s.scale - lse_r[e >> 1]);
                    if (edge) {
                        const long long key = k0 + n * 8 + 2 * t + (e & 1);
                        const long long row = qw0 + g + 8 * (e >> 1);
                        bool valid = key < s.sk && row < s.sq &&
                                     (!s.causal || row + s.offset >= key);
                        if constexpr (SEG)
                            valid = valid && s.seg.k[b * s.sk + key] ==
                                                 ids_s[warp * 16 + g +
                                                       (e >> 1) * 8];
                        p = valid ? p : 0.f;
                    }
                    dp[n][e] = p * (dp[n][e] - dl_r[e >> 1]);
                }
            }
            // dQ += dS K (the permuted k order: K rows 2t, 2t + 1 of each 8)
            const float* k_p = k_s + st * TILE + 2 * t * LD + g;
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
                uint32_t sh[4], sl[4];
                tf32_a_from_c(sh, sl, dp[kk]);
#pragma unroll
                for (int dn = 0; dn < D / 8; ++dn) {
                    uint32_t bh0, bh1, bl0, bl1;
                    tf32_b_frag_perm<LD>(bh0, bh1, bl0, bl1,
                                         k_p + kk * 8 * LD + dn * 8);
                    mma_3xtf32(dqa[dn], sh, sl, bh0, bh1, bl0, bl1);
                }
            }
        }
        __syncthreads();             // stage st is free for tile j + 2
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long row = qw0 + g + 8 * i;
        if (row >= s.sq) continue;
        float* out = dq + (bh * s.sq + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            fbm_store2(out + n * 8, dqa[n][2 * i] * s.scale,
                       dqa[n][2 * i + 1] * s.scale);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
static int launch_delta(const void* o, const void* dout, float* delta,
                        const FbShape& s, long long batch,
                        cudaStream_t stream) {
    const long long rows = batch * s.heads * s.sq;
    flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                   stream>>>((const T*)o, (const T*)dout,
                                             delta, s, rows);
    return (int)cudaGetLastError();
}

// one launch of a kernel that takes dynamic shared memory past 48 KB
template <typename Kernel, typename... Args>
static int launch_smem(Kernel kernel, dim3 grid, size_t smem,
                       cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, FBM_THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

template <int D, bool SEG>
static int run_mma(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, float* part,
                   const FbShape& s, long long batch, cudaStream_t stream) {
    int err = launch_delta<bf16, D>(o, dout, delta, s, batch, stream);
    if (err) return err;
    const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
               *vb = (const bf16*)v, *db = (const bf16*)dout;
    const size_t smem = fbm_smem_bytes<D, SEG>();
    const unsigned k_tiles = (unsigned)((s.sk + FBM_ROWS - 1) / FBM_ROWS);
    if (part == nullptr) {
        err = launch_smem(flash_bwd_dkdv_mma_kernel<D, bf16, SEG>,
                          dim3(k_tiles, (unsigned)(batch * s.kv_heads)),
                          smem, stream, qb, kb, vb, db, lse,
                          (const float*)delta, (bf16*)dk, (bf16*)dv, s);
        if (err) return err;
    } else {
        const long long per = batch * s.heads * s.sk * D;
        err = launch_smem(flash_bwd_dkdv_mma_kernel<D, float, SEG>,
                          dim3(k_tiles, (unsigned)(batch * s.heads)), smem,
                          stream, qb, kb, vb, db, lse, (const float*)delta,
                          part, part + per, s);
        if (err) return err;
        const long long kv_rows = batch * s.kv_heads;
        const long long threads = 2 * kv_rows * s.sk * D / 4;
        flash_bwd_gqa_sum_kernel<bf16><<<(unsigned)((threads + 255) / 256),
                                         256, 0, stream>>>(
            part, (bf16*)dk, (bf16*)dv, kv_rows, s.kv_group, s.sk * D);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    return launch_smem(flash_bwd_dq_mma_kernel<D, SEG>,
                       dim3((unsigned)((s.sq + FBM_ROWS - 1) / FBM_ROWS),
                            (unsigned)(batch * s.heads)),
                       smem, stream, qb, kb, vb, db, lse,
                       (const float*)delta, (bf16*)dq, s);
}

// the dK/dV launches of one backward in float32 (FTB_BOTH at D = 64, a dV
// and a dK launch at D = 128)
template <int D, bool SPLIT, bool SEG>
static int launch_dkdv_tf32(dim3 grid, cudaStream_t stream, const float* q,
                            const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dk, float* dv,
                            const FbShape& s) {
    const size_t smem = ftb_dkdv_smem_bytes<D, SEG>();
    if constexpr (D == 64) {
        return launch_smem(
            flash_bwd_dkdv_tf32_kernel<D, SPLIT, FTB_BOTH, SEG>, grid, smem,
            stream, q, k, v, dout, lse, delta, dk, dv, s);
    } else {
        const int err = launch_smem(
            flash_bwd_dkdv_tf32_kernel<D, SPLIT, FTB_DV, SEG>, grid, smem,
            stream, q, k, v, dout, lse, delta, dk, dv, s);
        if (err) return err;
        return launch_smem(
            flash_bwd_dkdv_tf32_kernel<D, SPLIT, FTB_DK, SEG>, grid, smem,
            stream, q, k, v, dout, lse, delta, dk, dv, s);
    }
}

template <int D, bool SEG>
static int run_tf32(const void* q, const void* k, const void* v,
                    const void* o, const float* lse, const void* dout,
                    void* dq, void* dk, void* dv, float* delta, float* part,
                    const FbShape& s, long long batch, cudaStream_t stream) {
    int err = launch_delta<float, D>(o, dout, delta, s, batch, stream);
    if (err) return err;
    const float *qf = (const float*)q, *kf = (const float*)k,
                *vf = (const float*)v, *df = (const float*)dout;
    const unsigned k_tiles = (unsigned)((s.sk + FBM_ROWS - 1) / FBM_ROWS);
    if (part == nullptr) {
        err = launch_dkdv_tf32<D, false, SEG>(
            dim3(k_tiles, (unsigned)(batch * s.kv_heads)), stream, qf, kf, vf,
            df, lse, delta, (float*)dk, (float*)dv, s);
        if (err) return err;
    } else {
        const long long per = batch * s.heads * s.sk * D;
        err = launch_dkdv_tf32<D, true, SEG>(
            dim3(k_tiles, (unsigned)(batch * s.heads)), stream, qf, kf, vf,
            df, lse, delta, part, part + per, s);
        if (err) return err;
        const long long kv_rows = batch * s.kv_heads;
        const long long threads = 2 * kv_rows * s.sk * D / 4;
        flash_bwd_gqa_sum_kernel<float><<<(unsigned)((threads + 255) / 256),
                                          256, 0, stream>>>(
            part, (float*)dk, (float*)dv, kv_rows, s.kv_group, s.sk * D);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    return launch_smem(flash_bwd_dq_tf32_kernel<D, SEG>,
                       dim3((unsigned)((s.sq + FBM_ROWS - 1) / FBM_ROWS),
                            (unsigned)(batch * s.heads)),
                       ftb_dq_smem_bytes<D, SEG>(), stream, qf, kf, vf, df,
                       lse, (const float*)delta, (float*)dq, s);
}

template <bool SEG>
static int run_dtype(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* o, const float* l,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* dl, float* pt, const FbShape& s, long long batch,
                     cudaStream_t st) {
    if (dtype == 0 && head_dim == 64)
        return run_tf32<64, SEG>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, s,
                                 batch, st);
    if (dtype == 0 && head_dim == 128)
        return run_tf32<128, SEG>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, s,
                                  batch, st);
    if (dtype == 1 && head_dim == 64)
        return run_mma<64, SEG>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, s,
                                batch, st);
    if (dtype == 1 && head_dim == 128)
        return run_mma<128, SEG>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, s,
                                 batch, st);
    return -1;
}

// q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); each given by the element
// strides of its first three dimensions in `strides` (q, k, v, dout: 12
// values), the last dimension dense, base pointers and strides 16-byte
// aligned (cp.async).  o: (B, H, Sq, D) contiguous of
// q's type; lse: (B, H, Sq) fp32 contiguous; delta: (B, H, Sq) fp32
// scratch.  dq: (B, H, Sq, D), dk, dv: (B, Hkv, Sk, D), contiguous, of q's
// type.  part: null, or a (2, B, H, Sk, D) fp32 scratch that selects the
// GQA split.  seg_q, seg_k, tiles: null, or the forward's segment ids and
// the pre-pass's records (flash_attention.cu), which select the segmented
// kernels.  dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128.  The
// caller guarantees B*H, Sq, Sk > 0, H % Hkv == 0 and B*H < 65536.
// Returns the CUDA error code of the first failing call (0 = success), or
// -1 for a type or head dimension no kernel is instantiated for.
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* delta, void* part, int dtype, int head_dim, long long batch,
        long long heads, long long kv_heads, long long sq, long long sk,
        const long long* strides, int causal, float scale,
        const void* seg_q, const void* seg_k, const void* tiles,
        void* stream) {
    FbShape s;
    s.heads = heads;
    s.kv_heads = kv_heads;
    s.kv_group = heads / kv_heads;
    s.sq = sq;
    s.sk = sk;
    s.offset = sk - sq;
    s.q_sb = strides[0]; s.q_sh = strides[1]; s.q_ss = strides[2];
    s.k_sb = strides[3]; s.k_sh = strides[4]; s.k_ss = strides[5];
    s.v_sb = strides[6]; s.v_sh = strides[7]; s.v_ss = strides[8];
    s.do_sb = strides[9]; s.do_sh = strides[10]; s.do_ss = strides[11];
    s.causal = causal;
    s.scale = scale;
    s.seg.q = (const int*)seg_q;
    s.seg.k = (const int*)seg_k;
    s.seg.tiles = (const int*)tiles;
    s.seg.nq = (sq + FS_TILE - 1) / FS_TILE;
    s.seg.nk = (sk + FS_TILE - 1) / FS_TILE;
    cudaStream_t st = (cudaStream_t)stream;
    const float* l = (const float*)lse;
    float* dl = (float*)delta;
    float* pt = (float*)part;
    if (seg_q != nullptr)
        return run_dtype<true>(dtype, head_dim, q, k, v, o, l, dout, dq, dk,
                               dv, dl, pt, s, batch, st);
    return run_dtype<false>(dtype, head_dim, q, k, v, o, l, dout, dq, dk, dv,
                            dl, pt, s, batch, st);
}
