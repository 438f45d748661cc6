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
// float32, on the fp32 CUDA cores (TF32 keeps about 10 mantissa bits, too
// few for the fp32 comparison, 1e-4):
//   flash_bwd_delta_kernel  as above;
//   flash_bwd_dkdv_kernel   one block per (batch, kv head, 64-row K tile),
//        the G q heads summed inside; a thread owns 32 of a row's D
//        columns (the float4 chunks c * D/32 + part), so a row is D/32
//        threads that sum their partial dot products with __shfl_xor_sync,
//        and keeps its K, V columns and dK, dV sums in registers; q and dO
//        tiles of 32 rows sit in shared memory in fp32;
//   flash_bwd_dq_kernel     one block per (batch, q head, 64-row q tile),
//        over K and V tiles of 32 rows in shared memory.
//
// Every kernel sums in a fixed order with no atomics, so a training step
// is deterministic; dQ has its own kernel that recomputes S and dP.
//
// Bound on this card: the five 2 * D products per visible (q, k) pair
// (S and dP, dV, dK, dQ: 10 * D operations) at the bf16 tensor-core peak,
// against q, k, v, o, dO, lse read once and dq, dk, dv written once;
// operations lead at the training shapes (whisper's encoder, 4 x 8 x 1500
// x 64: 46 GFLOP -> 47 us at 989 TFLOP/s, 31 MB -> 9 us).  The kernels
// here compute S and dP in both the dK/dV and the dQ kernel: 14 * D
// operations a pair, 1.4 times the bound's.  Their times are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

#define FB_COLS 32          // columns of a row held by one thread
#define FB_KROWS 64         // K rows per dK/dV block (one per thread group)
#define FB_QTILE 32         // q rows per shared tile of the dK/dV kernel
#define FB_QROWS 64         // q rows per dQ block
#define FB_KTILE 32         // K rows per shared tile of the dQ kernel

struct FbShape {
    long long heads, kv_heads, kv_group;    // H, Hkv, H / Hkv
    long long sq, sk, offset;               // offset = sk - sq
    long long q_sb, q_sh, q_ss;             // element strides (head dim dense)
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long do_sb, do_sh, do_ss;
    int causal;
    float scale;
};

__device__ __forceinline__ float fb_load(const float* p) { return *p; }
__device__ __forceinline__ float fb_load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void fb_store(float* p, float x) { *p = x; }

// the column of a thread's e-th element: float4 chunk (e / 4) * parts + part
template <int D>
__device__ __forceinline__ int fb_col(int e, int part) {
    return ((e >> 2) * (D / FB_COLS) + part) * 4 + (e & 3);
}

// the sum of a partial dot product over the D / 32 lanes of one row
template <int D>
__device__ __forceinline__ float fb_row_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (D / FB_COLS == 4) x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x;
}

// partial dot products of one shared-memory row (fp32, read as float4)
// with the thread's 32 columns a[] and b[] of two other rows
template <int D>
__device__ __forceinline__ float fb_dot(const float* row, const float* a,
                                        int part) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < FB_COLS / 4; ++c) {
        const float4 x = r4[c * (D / FB_COLS) + part];
        acc += x.x * a[4 * c] + x.y * a[4 * c + 1] + x.z * a[4 * c + 2] +
               x.w * a[4 * c + 3];
    }
    return acc;
}

// acc[] += w * the thread's 32 columns of a shared-memory row
template <int D>
__device__ __forceinline__ void fb_axpy(float* acc, float w, const float* row,
                                        int part) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int c = 0; c < FB_COLS / 4; ++c) {
        const float4 x = r4[c * (D / FB_COLS) + part];
        acc[4 * c] += w * x.x;
        acc[4 * c + 1] += w * x.y;
        acc[4 * c + 2] += w * x.z;
        acc[4 * c + 3] += w * x.w;
    }
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

template <int D>
__global__ void __launch_bounds__(FB_KROWS * (D / FB_COLS))
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, FbShape s) {
    constexpr int P = D / FB_COLS, THREADS = FB_KROWS * P;
    __shared__ __align__(16) float q_s[FB_QTILE * D];
    __shared__ __align__(16) float do_s[FB_QTILE * D];
    __shared__ float lse_s[FB_QTILE], dl_s[FB_QTILE];

    const int tid = threadIdx.x, part = tid % P;
    const long long bk = blockIdx.y;                 // b * Hkv + kv head
    const long long b = bk / s.kv_heads, hk = bk % s.kv_heads;
    const long long k0 = (long long)blockIdx.x * FB_KROWS;
    const long long key = k0 + tid / P;
    const bool key_in = key < s.sk;

    float kr[FB_COLS], vr[FB_COLS], dkr[FB_COLS], dvr[FB_COLS];
    const long long kr0 = key_in ? key : 0;
    const float* krow = k + b * s.k_sb + hk * s.k_sh + kr0 * s.k_ss;
    const float* vrow = v + b * s.v_sb + hk * s.v_sh + kr0 * s.v_ss;
#pragma unroll
    for (int e = 0; e < FB_COLS; ++e) {
        const int c = fb_col<D>(e, part);
        kr[e] = key_in ? fb_load(krow + c) : 0.f;
        vr[e] = key_in ? fb_load(vrow + c) : 0.f;
        dkr[e] = dvr[e] = 0.f;
    }

    // the first q tile with a row that sees key k0
    long long i_first = 0;
    if (s.causal && k0 - s.offset > 0)
        i_first = (k0 - s.offset) / FB_QTILE * FB_QTILE;

    for (long long gi = 0; gi < s.kv_group; ++gi) {
        const long long h = hk * s.kv_group + gi;
        const long long bh = b * s.heads + h;
        const float* qb = q + b * s.q_sb + h * s.q_sh;
        const float* db = dout + b * s.do_sb + h * s.do_sh;
        for (long long i0 = i_first; i0 < s.sq; i0 += FB_QTILE) {
            __syncthreads();                     // the last tile is consumed
            for (int idx = tid; idx < FB_QTILE * D; idx += THREADS) {
                const long long i = i0 + idx / D;
                const int c = idx % D;
                const bool in = i < s.sq;
                q_s[idx] = in ? fb_load(qb + i * s.q_ss + c) : 0.f;
                do_s[idx] = in ? fb_load(db + i * s.do_ss + c) : 0.f;
            }
            if (tid < FB_QTILE) {
                const long long i = i0 + tid;
                lse_s[tid] = i < s.sq ? lse[bh * s.sq + i] : 0.f;
                dl_s[tid] = i < s.sq ? delta[bh * s.sq + i] : 0.f;
            }
            __syncthreads();
            const int rows = (int)(s.sq - i0 < FB_QTILE ? s.sq - i0
                                                        : FB_QTILE);
            for (int r = 0; r < rows; ++r) {
                const float* qrow = q_s + r * D;
                const float* drow = do_s + r * D;
                const float sc = fb_row_sum<D>(fb_dot<D>(qrow, kr, part));
                const float dp = fb_row_sum<D>(fb_dot<D>(drow, vr, part));
                const bool valid =
                    key_in && (!s.causal || i0 + r + s.offset >= key);
                const float p = valid ? expf(sc * s.scale - lse_s[r]) : 0.f;
                const float ds = p * (dp - dl_s[r]);
                fb_axpy<D>(dvr, p, drow, part);
                fb_axpy<D>(dkr, ds, qrow, part);
            }
        }
    }

    if (!key_in) return;
    float* dkrow = dk + (bk * s.sk + key) * D;
    float* dvrow = dv + (bk * s.sk + key) * D;
#pragma unroll
    for (int e = 0; e < FB_COLS; ++e) {
        const int c = fb_col<D>(e, part);
        fb_store(dkrow + c, dkr[e] * s.scale);
        fb_store(dvrow + c, dvr[e]);
    }
}

template <int D>
__global__ void __launch_bounds__(FB_QROWS * (D / FB_COLS))
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    FbShape s) {
    constexpr int P = D / FB_COLS, THREADS = FB_QROWS * P;
    __shared__ __align__(16) float k_s[FB_KTILE * D];
    __shared__ __align__(16) float v_s[FB_KTILE * D];

    const int tid = threadIdx.x, part = tid % P;
    const long long bh = blockIdx.y;                 // b * H + q head
    const long long b = bh / s.heads, h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)blockIdx.x * FB_QROWS;
    const long long i = q0 + tid / P;
    const bool row_in = i < s.sq;

    float qr[FB_COLS], dr[FB_COLS], dqr[FB_COLS];
    const float* qrow =
        q + b * s.q_sb + h * s.q_sh + (row_in ? i : 0) * s.q_ss;
    const float* drow =
        dout + b * s.do_sb + h * s.do_sh + (row_in ? i : 0) * s.do_ss;
#pragma unroll
    for (int e = 0; e < FB_COLS; ++e) {
        const int c = fb_col<D>(e, part);
        qr[e] = row_in ? fb_load(qrow + c) : 0.f;
        dr[e] = row_in ? fb_load(drow + c) : 0.f;
        dqr[e] = 0.f;
    }
    const float lse_i = row_in ? lse[bh * s.sq + i] : 0.f;
    const float delta_i = row_in ? delta[bh * s.sq + i] : 0.f;
    const float* kb = k + b * s.k_sb + hk * s.k_sh;
    const float* vb = v + b * s.v_sb + hk * s.v_sh;

    const long long nk = (s.sk + FB_KTILE - 1) / FB_KTILE;
    long long upper = nk;
    if (s.causal) {
        const long long last = (q0 + FB_QROWS < s.sq ? q0 + FB_QROWS : s.sq)
                               - 1 + s.offset;
        upper = last < 0 ? 0 : (last / FB_KTILE + 1 < nk ? last / FB_KTILE + 1
                                                         : nk);
    }
    for (long long j = 0; j < upper; ++j) {
        const long long k0 = j * FB_KTILE;
        __syncthreads();                         // the last tile is consumed
        for (int idx = tid; idx < FB_KTILE * D; idx += THREADS) {
            const long long key = k0 + idx / D;
            const int c = idx % D;
            const bool in = key < s.sk;
            k_s[idx] = in ? fb_load(kb + key * s.k_ss + c) : 0.f;
            v_s[idx] = in ? fb_load(vb + key * s.v_ss + c) : 0.f;
        }
        __syncthreads();
        const int rows = (int)(s.sk - k0 < FB_KTILE ? s.sk - k0 : FB_KTILE);
        for (int r = 0; r < rows; ++r) {
            const float* krow = k_s + r * D;
            const float sc = fb_row_sum<D>(fb_dot<D>(krow, qr, part));
            const float dp = fb_row_sum<D>(fb_dot<D>(v_s + r * D, dr, part));
            const bool valid = row_in && (!s.causal || i + s.offset >= k0 + r);
            const float p = valid ? expf(sc * s.scale - lse_i) : 0.f;
            fb_axpy<D>(dqr, p * (dp - delta_i), krow, part);
        }
    }

    if (!row_in) return;
    float* dqrow = dq + (bh * s.sq + i) * D;
#pragma unroll
    for (int e = 0; e < FB_COLS; ++e)
        fb_store(dqrow + fb_col<D>(e, part), dqr[e] * s.scale);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

#define FBM_ROWS 64          // K rows per dK/dV block, q rows per dQ block,
                             // rows of every staged tile
#define FBM_THREADS 128      // 4 warps x 16 rows
#define FBM_LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

template <int D>
constexpr size_t fbm_smem_bytes() {  // six padded tiles + 2 x 2 rows of 64
    return (size_t)6 * FBM_ROWS * (D + 8) * sizeof(bf16) +
           (size_t)4 * FBM_ROWS * sizeof(float);
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
template <int D, typename TO>
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

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long out_heads = SPLIT ? s.heads : s.kv_heads;
    const long long b = blockIdx.y / out_heads, oh = blockIdx.y % out_heads;
    const long long hk = SPLIT ? oh / s.kv_group : oh;
    const long long h_first = SPLIT ? oh : oh * s.kv_group;
    const long long n_heads = SPLIT ? 1 : s.kv_group;
    const long long k0 = (long long)blockIdx.x * FBM_ROWS;
    const long long kw0 = k0 + warp * 16;       // the warp's first key

    // the first q tile with a row that sees key k0 (always < Sq: k0 < Sk)
    long long i_first = 0;
    if (s.causal && k0 - s.offset > 0)
        i_first = (k0 - s.offset) / FBM_ROWS * FBM_ROWS;
    const long long n_tiles = (s.sq - i_first + FBM_ROWS - 1) / FBM_ROWS;
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
        }
    };

    // group 0: the K and V tiles and step 0's q and dO
    fbm_stage<D>(k_s, k + b * s.k_sb + hk * s.k_sh, s.k_ss, k0, s.sk, tid);
    fbm_stage<D>(v_s, v + b * s.v_sb + hk * s.v_sh, s.v_ss, k0, s.sk, tid);
    stage(0, 0);
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
        if (!s.causal || i0 + FBM_ROWS - 1 + s.offset >= kw0) {
            const bool edge = (s.causal && i0 + s.offset < kw0 + 15) ||
                              i0 + FBM_ROWS > s.sq || kw0 + 16 > s.sk;
            const float* lse_t = lse_s + st * FBM_ROWS;
            const float* dl_t = dl_s + st * FBM_ROWS;
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
                            const bool valid =
                                key < s.sk && i < s.sq &&
                                (!s.causal || i + s.offset >= key);
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
// order, rounded to bf16.  One thread per 4 neighbouring elements.
__global__ void __launch_bounds__(256)
flash_bwd_gqa_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, long long kv_rows,
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
    bf16* dst = (which ? dv : dk) + e;
    fbm_store2(dst, acc.x, acc.y);
    fbm_store2(dst + 2, acc.z, acc.w);
}

// dQ of one 64-row q tile of q head blockIdx.y % H.
template <int D>
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

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long bh = blockIdx.y;
    const long long b = bh / s.heads, h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * FBM_ROWS;
    const long long qw0 = q0 + warp * 16;       // the warp's first q row
    const bf16* kb = k + b * s.k_sb + hk * s.k_sh;
    const bf16* vb = v + b * s.v_sb + hk * s.v_sh;

    const long long nk = (s.sk + FBM_ROWS - 1) / FBM_ROWS;
    long long upper = nk;
    if (s.causal) {
        const long long last =
            (q0 + FBM_ROWS < s.sq ? q0 + FBM_ROWS : s.sq) - 1 + s.offset;
        upper = last < 0 ? 0 : (last / FBM_ROWS + 1 < nk ? last / FBM_ROWS + 1
                                                         : nk);
    }

    // group 0: the q and dO tiles and K/V tile 0
    fbm_stage<D>(q_s, q + b * s.q_sb + h * s.q_sh, s.q_ss, q0, s.sq, tid);
    fbm_stage<D>(do_s, dout + b * s.do_sb + h * s.do_sh, s.do_ss, q0, s.sq,
                 tid);
    if (upper > 0) {
        fbm_stage<D>(k_s, kb, s.k_ss, 0, s.sk, tid);
        fbm_stage<D>(v_s, vb, s.v_ss, 0, s.sk, tid);
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

    for (long long j = 0; j < upper; ++j) {
        const int st = (int)(j & 1);
        if (j + 1 < upper) {
            const long long next = (j + 1) * FBM_ROWS;
            fbm_stage<D>(k_s + (st ^ 1) * TILE, kb, s.k_ss, next, s.sk, tid);
            fbm_stage<D>(v_s + (st ^ 1) * TILE, vb, s.v_ss, next, s.sk, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();                     // tile j has landed
        __syncthreads();

        const long long k0 = j * FBM_ROWS;
        if (!s.causal || k0 <= qw0 + 15 + s.offset) {
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
                              || k0 + FBM_ROWS > s.sk || qw0 + 16 > s.sq;
#pragma unroll
            for (int n = 0; n < FBM_ROWS / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = exp2f((sc[n][e] * s.scale - lse_r[e >> 1]) *
                                    FBM_LOG2E);
                    if (edge) {
                        const long long key = k0 + n * 8 + 2 * t + (e & 1);
                        const long long row = qw0 + g + 8 * (e >> 1);
                        const bool valid =
                            key < s.sk && row < s.sq &&
                            (!s.causal || row + s.offset >= key);
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

template <int D>
static int run_simt(const void* q, const void* k, const void* v,
                    const void* o, const float* lse, const void* dout,
                    void* dq, void* dk, void* dv, float* delta,
                    const FbShape& s, long long batch, cudaStream_t stream) {
    int err = launch_delta<float, D>(o, dout, delta, s, batch, stream);
    if (err) return err;
    constexpr int P = D / FB_COLS;
    const dim3 kv_grid((unsigned)((s.sk + FB_KROWS - 1) / FB_KROWS),
                       (unsigned)(batch * s.kv_heads));
    flash_bwd_dkdv_kernel<D><<<kv_grid, FB_KROWS * P, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, lse, delta, (float*)dk, (float*)dv, s);
    err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 q_grid((unsigned)((s.sq + FB_QROWS - 1) / FB_QROWS),
                      (unsigned)(batch * s.heads));
    flash_bwd_dq_kernel<D><<<q_grid, FB_QROWS * P, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, lse, delta, (float*)dq, s);
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

template <int D>
static int run_mma(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, float* part,
                   const FbShape& s, long long batch, cudaStream_t stream) {
    int err = launch_delta<bf16, D>(o, dout, delta, s, batch, stream);
    if (err) return err;
    const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
               *vb = (const bf16*)v, *db = (const bf16*)dout;
    const size_t smem = fbm_smem_bytes<D>();
    const unsigned k_tiles = (unsigned)((s.sk + FBM_ROWS - 1) / FBM_ROWS);
    if (part == nullptr) {
        err = launch_smem(flash_bwd_dkdv_mma_kernel<D, bf16>,
                          dim3(k_tiles, (unsigned)(batch * s.kv_heads)),
                          smem, stream, qb, kb, vb, db, lse,
                          (const float*)delta, (bf16*)dk, (bf16*)dv, s);
        if (err) return err;
    } else {
        const long long per = batch * s.heads * s.sk * D;
        err = launch_smem(flash_bwd_dkdv_mma_kernel<D, float>,
                          dim3(k_tiles, (unsigned)(batch * s.heads)), smem,
                          stream, qb, kb, vb, db, lse, (const float*)delta,
                          part, part + per, s);
        if (err) return err;
        const long long kv_rows = batch * s.kv_heads;
        const long long threads = 2 * kv_rows * s.sk * D / 4;
        flash_bwd_gqa_sum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                                   stream>>>(part, (bf16*)dk, (bf16*)dv,
                                             kv_rows, s.kv_group, s.sk * D);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    return launch_smem(flash_bwd_dq_mma_kernel<D>,
                       dim3((unsigned)((s.sq + FBM_ROWS - 1) / FBM_ROWS),
                            (unsigned)(batch * s.heads)),
                       smem, stream, qb, kb, vb, db, lse,
                       (const float*)delta, (bf16*)dq, s);
}

// q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); each given by the element
// strides of its first three dimensions in `strides` (q, k, v, dout: 12
// values), the last dimension dense (and, for bfloat16, 16-byte aligned
// base pointers and strides: cp.async).  o: (B, H, Sq, D) contiguous of
// q's type; lse: (B, H, Sq) fp32 contiguous; delta: (B, H, Sq) fp32
// scratch.  dq: (B, H, Sq, D), dk, dv: (B, Hkv, Sk, D), contiguous, of q's
// type.  part: null, or (bfloat16 only) a (2, B, H, Sk, D) fp32 scratch
// that selects the GQA split.  dtype 0 = float32, 1 = bfloat16; head_dim
// 64 or 128.  The caller guarantees B*H, Sq, Sk > 0, H % Hkv == 0 and
// B*H < 65536.  Returns the CUDA error code of the first failing call
// (0 = success), or -1 for a type or head dimension no kernel is
// instantiated for.
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* delta, void* part, int dtype, int head_dim, long long batch,
        long long heads, long long kv_heads, long long sq, long long sk,
        const long long* strides, int causal, float scale, void* stream) {
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
    cudaStream_t st = (cudaStream_t)stream;
    const float* l = (const float*)lse;
    float* dl = (float*)delta;
    float* pt = (float*)part;
    if (dtype == 0 && part == nullptr && head_dim == 64)
        return run_simt<64>(q, k, v, o, l, dout, dq, dk, dv, dl, s, batch,
                            st);
    if (dtype == 0 && part == nullptr && head_dim == 128)
        return run_simt<128>(q, k, v, o, l, dout, dq, dk, dv, dl, s, batch,
                             st);
    if (dtype == 1 && head_dim == 64)
        return run_mma<64>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, s, batch,
                           st);
    if (dtype == 1 && head_dim == 128)
        return run_mma<128>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, s,
                            batch, st);
    return -1;
}
