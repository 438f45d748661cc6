// Forward attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (wrapper flash_attention).  Same semantics in both kernels below: logits
// of masked positions are set to NEG_INF = -1e30 (not -inf), p is guarded
// by logits > NEG_INF/2, the running max m, sum l and the output
// accumulator stay in fp32, a row that saw no key divides by 1 and comes
// out 0, and the causal diagonal sits at offset = Sk - Sq on the unpadded
// sizes.  Ragged Sq/Sk are masked in the kernel (there is no padded copy in
// device memory); the inputs may be strided views with only the head
// dimension dense; K/V may have fewer heads than Q: head h reads kv head
// h / (H / Hkv), which is jnp.repeat of the kv heads without the copy.
//
// Bound on this card, at the prefill shape of qwen2-0.5b (B = 4, 14 q heads
// over 2 kv heads, S = 1024, D = 64, bf16, causal): the 4*D*B*H*S(S+1)/2
// flops of the visible half (7.5 GFLOP -> 7.6 us at 989 TFLOP/s bf16) weigh
// more than the bytes (q and o for 14 heads, k and v for 2: 16.8 MB ->
// 5.0 us at 3.35 TB/s).  So the products have to run on the tensor cores.
//
// Which dtype takes which kernel:
//   bfloat16 -> flash_fwd_mma_kernel, on the tensor cores (mma.sync);
//   float32  -> flash_fwd_tf32_kernel, on the tensor cores too, each
//               product as three TF32 ones (3xTF32, below).  One TF32
//               product keeps about 10 mantissa bits and could not hold the
//               fp32 comparison (3e-5); three do.  The fp32 path serves the
//               float32 checks (decode against prefill, the flash checks,
//               the runner's kernels section), not bf16 serving.
//
// flash_fwd_mma_kernel (FlashAttention-2 shape):
//   grid   (ceil(Sq / 64), B * H), the q tiles in reverse so the longest
//          causal rows start first; block 4 warps, 16 q rows each
//          (64-row tiles make 896 blocks at the prefill shape, 6.8 per SM,
//          where 128-row tiles would make 3.4: fewer blocks to even out
//          the unequal lengths of causal rows);
//   q      the warp's 16 x D fragment is loaded once with ldmatrix, in bf16
//          and unscaled: the scale multiplies the fp32 logits, so no bit of
//          q is rounded away (the reference scales q in fp32);
//   k, v   64-row tiles staged with 16-byte cp.async in two stages: tile
//          j+1 loads while tile j is computed.  Rows are padded to D + 8
//          bf16 (a 16-byte skew), so the eight rows an ldmatrix reads hit
//          eight distinct groups of four banks;
//   S      = Q K^T with mma.m16n8k16 bf16 -> fp32; K, row-major in shared
//          memory, is the .col B operand as it stands (ldmatrix, no .trans);
//   softmax row max and row sum over the fp32 accumulator fragment, the
//          max shared within the quad of lanes that hold a row
//          (__shfl_xor_sync 1, 2); l is summed from the fp32 p and reduced
//          over the quad once, at the end;
//   P V    p is rounded to bf16 in registers and used directly as the A
//          operand (the C fragment of m16n8k16 is its A fragment); V goes
//          in through ldmatrix.trans; O accumulates in fp32 registers.
//          Rounding p to bf16 is the one rounding point the reference
//          (P V in fp32) does not have; it stays within the card's limit,
//          rtol 1e-2 / atol 8e-3 (tests/test_torch_kernel_numerics.py
//          emulates it);
//   masks  only on tiles that cross the warp's diagonal or the Sk edge;
//          tiles past the block's diagonal are skipped by the loop bound,
//          and a warp skips a tile that lies wholly past its own rows.
//   Needs 16-byte-aligned rows (base pointers and strides); the wrapper
//   makes an operand that is not so contiguous before the launch (both
//   dtypes).
//
// flash_fwd_tf32_kernel (float32), the same shape: 64-row q tiles, 4 warps
// of 16 rows, K/V tiles (64 rows; 32 at D = 128, so that two blocks fit an
// SM) staged by cp.async in two stages, masks only on edge tiles, the
// softmax over the fp32 C fragment with quad shuffles.  What differs:
//   products  mma.sync m16n8k8 .tf32, three a k step: lo*hi, hi*lo, hi*hi,
//             where hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
//             (mma_sync.cuh); lo*lo, 2^-22 of the product, is left out.
//             At the fp32 tolerances this is fp32 arithmetic
//             (tests/test_torch_tf32_numerics.py emulates it);
//   operands  ldmatrix moves 16-bit elements, so every fragment is loaded
//             with 32-bit ld.shared from fp32 tiles padded to D + 4 floats
//             (conflict-free for both load patterns) and split in
//             registers where it is used; q stays in shared memory, scaled
//             in fp32 before its split as the TPU kernel scales it (its hi
//             and lo fragments in registers would spill at D = 128);
//   P V       the C fragment of m16n8k8 is not its A fragment (columns 2t,
//             2t + 1 where A wants t, t + 4): the k steps of P V are
//             numbered so that they are (key 2t is k step t, key 2t + 1 k
//             step t + 4; V's rows are read in the same order), P is split
//             into hi and lo in registers, and no shuffle moves it;
//   exp       expf, not exp2f of a rescaled logit, for fp32 accuracy.
// Bound: the products at 3 x 495 TFLOP/s TF32 or 67 TFLOP/s on the CUDA
// cores, whichever is faster (the TF32 route: 165 TFLOP/s of fp32 work;
// qwen2-0.5b's prefill 7.5 GFLOP -> 45.6 us, over its 33.6 MB of fp32
// bytes, 10.0 us).
//
// Segment ids (packed documents).  Each kernel has a second instantiation,
// SEG = true, for a call with q ids (B, Sq) and kv ids (B, Sk), int32: a
// query sees only the keys of its own id (and causal where asked), the
// plain route's rule, so pads (id 0) see only pads.  A call without ids
// runs SEG = false, the code as it was: the flag is a template parameter,
// not a branch in the loop.  One launch before the kernels,
// flash_seg_tiles_kernel (below), reads the ids once a call and writes a
// record for each 64-row q tile and each 64-row kv tile
// (flash_segments.cuh): its least and largest id, up to three distinct
// ids, and the range of rows of the other side whose tiles may share an
// id with it (tiles of at most three ids each: an id in common; others:
// their id intervals meet; under causal only tiles at or before the
// diagonal).  The backward kernels take the same records.  With SEG:
//   range  a block loops over its q tile's range of keys, inside the
//          causal bound: on packed documents of mean 512 a q tile visits
//          5.4 kv tiles of 64 against 32.5 on a causal row of 4096;
//   skip   a warp skips a tile whose id interval misses its rows' (a
//          tile of the range that holds other documents only);
//   mask   the per-pair test of the ids joins the causal and Sk tests, and
//          only on a tile that is not one id on both sides (a segment
//          edge), so interior tiles of a document run unmasked;
//   ids    the block's 64 row ids and each warp's id bounds sit in shared
//          memory (fs_rows), not in registers, which the loops need (the
//          D = 128 kernels use 240-255); kv ids are read from the card's
//          memory, on edge tiles only.
// The records over-approximate the pairs, so any ids are right, in any
// order; only tiles with no pair of one id are skipped, and those are
// masked out wholly, so a call whose ids are all equal visits and masks
// the tiles of the call without ids, bit for bit.
//
// Both kernels also write the log-sum-exp of each row's scaled logits,
// lse = m + log(l) in fp32 ((B, H, Sq), -inf on a row that saw no key),
// when the caller passes an lse buffer: the backward kernels
// (flash_attention_bwd.cu) rebuild P = exp(S * scale - lse) from it.  A
// null lse (serving) writes nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_segments.cuh"
#include "mma_sync.cuh"

#define FA_NEG_INF (-1e30f)
#define FA_LOG2E 1.4426950408889634f

// lse of a row: m + log(l), or -inf where no key was seen (l = 0)
__device__ __forceinline__ float fa_lse(float m, float l) {
    return l > 0.f ? m + logf(l) : __int_as_float(0xff800000);
}

struct FaShape {
    long long heads, kv_group;          // H, H / Hkv
    long long sq, sk, offset;           // offset = sk - sq
    long long q_sb, q_sh, q_ss;         // element strides (head dim is dense)
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    int causal;
    float scale;
    FsIds seg;                          // the segment ids (SEG kernels)
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

#define FM_ROWS 64                  // q rows per block = kv rows per tile
#define FM_THREADS 128              // 4 warps x 16 q rows

template <int D, bool SEG>
constexpr size_t fm_smem_bytes() {  // q tile + two stages of k and v
    return (size_t)5 * FM_ROWS * (D + 8) * sizeof(__nv_bfloat16) +
           (SEG ? FS_SMEM_INTS * sizeof(int) : 0);
}

// Stage rows row0 .. row0 + 63 of one head into a padded tile
// (mma_sync.cuh); rows at or past `end` are filled with zeros.
template <int D>
__device__ __forceinline__ void fm_stage(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         long long stride, long long row0,
                                         long long end, int tid) {
    cp_async_rows<FM_ROWS, D, FM_THREADS>(dst, src, stride, row0, end, tid);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(FM_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, FaShape s) {
    extern __shared__ float4 fm_smem[];
    constexpr int LD = D + 8, TILE = FM_ROWS * LD;
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fm_smem);
    __nv_bfloat16* k_s = q_s + TILE;            // two stages
    __nv_bfloat16* v_s = k_s + 2 * TILE;        // two stages
    int* ids_s = reinterpret_cast<int*>(v_s + 2 * TILE);   // (SEG) row ids
    int* wb_s = ids_s + FS_TILE;                           // (SEG) bounds

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long bh = blockIdx.y;
    const long long b = bh / s.heads, h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * FM_ROWS;
    const __nv_bfloat16* qb = q + b * s.q_sb + h * s.q_sh;
    const __nv_bfloat16* kb = k + b * s.k_sb + hk * s.k_sh;
    const __nv_bfloat16* vb = v + b * s.v_sb + hk * s.v_sh;
    const long long qw0 = q0 + warp * 16;       // the warp's first q row

    long long lower, upper;
    fs_kv_range<SEG, FM_ROWS>(s, b, q0, lower, upper);
    if constexpr (SEG)
        fs_rows(ids_s, wb_s, s.seg.q + b * s.sq, s.sq, q0, tid);

    // group 0: the q tile; group 1: kv tile `lower`
    fm_stage<D>(q_s, qb, s.q_ss, q0, s.sq, tid);
    cp_async_commit();
    if (upper > lower) {
        fm_stage<D>(k_s, kb, s.k_ss, lower * FM_ROWS, s.sk, tid);
        fm_stage<D>(v_s, vb, s.v_ss, lower * FM_ROWS, s.sk, tid);
    }
    cp_async_commit();

    // lane addresses: A (q) and V^T tiles take rows (lane & 7) + 8 *
    // bit 3 of lane, column 8 * bit 4; K takes rows (lane & 7) + 8 * bit 4,
    // column 8 * bit 3 (see mma_sync.cuh for the fragment layouts)
    const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
    const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD +
                       ((lane >> 3) & 1) * 8;

    cp_async_wait<1>();
    __syncthreads();
    uint32_t qf[D / 16][4];
    const uint32_t q_addr = smem_addr(q_s + warp * 16 * LD + a_lane);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);

    const long long pos0 = qw0 + g + s.offset;  // causal position, row g
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};

    for (long long j = lower; j < upper; ++j) {
        const int st = (int)((j - lower) & 1);
        if (j + 1 < upper) {
            const long long next = (j + 1) * FM_ROWS;
            fm_stage<D>(k_s + (st ^ 1) * TILE, kb, s.k_ss, next, s.sk, tid);
            fm_stage<D>(v_s + (st ^ 1) * TILE, vb, s.v_ss, next, s.sk, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();                     // tile j has landed
        __syncthreads();

        const long long k0 = j * FM_ROWS;
        bool sees = !s.causal || k0 <= qw0 + 15 + s.offset;
        bool split = false;                     // crosses a segment edge
        if constexpr (SEG)
            fs_warp_tile(wb_s + 2 * warp, fs_k_rec(s.seg, b, k0 / FS_TILE),
                         sees, split);
        if (sees) {
            // S = Q K^T for the warp's 16 rows x 64 keys
            float sc[FM_ROWS / 8][4];
#pragma unroll
            for (int n = 0; n < FM_ROWS / 8; ++n)
                sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
            const uint32_t k_addr = smem_addr(k_s + st * TILE + k_lane);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
                for (int np = 0; np < FM_ROWS / 16; ++np) {
                    uint32_t r[4];
                    ldsm_x4(r, k_addr + (np * 16 * LD + kk * 16) * 2);
                    mma_bf16_16816(sc[2 * np], qf[kk], r[0], r[1]);
                    mma_bf16_16816(sc[2 * np + 1], qf[kk], r[2], r[3]);
                }
            }

            // scale in fp32, mask where the tile crosses the diagonal, Sk
            // or (SEG) a segment edge
            const bool edge = (s.causal && k0 + FM_ROWS - 1 > qw0 + s.offset)
                              || k0 + FM_ROWS > s.sk || split;
            float tmax[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
            for (int n = 0; n < FM_ROWS / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = sc[n][e] * s.scale;
                    if (edge) {
                        const long long key = k0 + n * 8 + 2 * t + (e & 1);
                        const long long pos = pos0 + (e >> 1) * 8;
                        bool valid = key < s.sk && (!s.causal || pos >= key);
                        if constexpr (SEG)
                            valid = valid && s.seg.k[b * s.sk + key] ==
                                                 ids_s[warp * 16 + g +
                                                       (e >> 1) * 8];
                        x = valid ? x : FA_NEG_INF;
                    }
                    sc[n][e] = x;
                    tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
                }
            }
            float alpha[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                tmax[i] = fmaxf(tmax[i],
                                __shfl_xor_sync(0xffffffffu, tmax[i], 1));
                tmax[i] = fmaxf(tmax[i],
                                __shfl_xor_sync(0xffffffffu, tmax[i], 2));
                const float m_new = fmaxf(m[i], tmax[i]);
                alpha[i] = exp2f((m[i] - m_new) * FA_LOG2E);
                m[i] = m_new;
                l[i] *= alpha[i];
            }
#pragma unroll
            for (int n = 0; n < FM_ROWS / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float x = sc[n][e];
                    const float p = x > FA_NEG_INF / 2
                                        ? exp2f((x - m[e >> 1]) * FA_LOG2E)
                                        : 0.f;
                    sc[n][e] = p;
                    l[e >> 1] += p;
                }
            }
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                o[n][0] *= alpha[0];
                o[n][1] *= alpha[0];
                o[n][2] *= alpha[1];
                o[n][3] *= alpha[1];
            }

            // O += P V: p in bf16 as the A operand, straight from registers
            const uint32_t v_addr = smem_addr(v_s + st * TILE + a_lane);
#pragma unroll
            for (int kk = 0; kk < FM_ROWS / 16; ++kk) {
                const uint32_t a[4] = {
                    pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                    pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                    pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                    pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
                for (int dp = 0; dp < D / 16; ++dp) {
                    uint32_t r[4];
                    ldsm_x4_trans(r, v_addr + (kk * 16 * LD + dp * 16) * 2);
                    mma_bf16_16816(o[2 * dp], a, r[0], r[1]);
                    mma_bf16_16816(o[2 * dp + 1], a, r[2], r[3]);
                }
            }
        }
        __syncthreads();             // stage st is free for tile j + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const long long row = qw0 + g + 8 * i;
        if (lse != nullptr && t == 0 && row < s.sq)
            lse[bh * s.sq + row] = fa_lse(m[i], l[i]);
        if (l[i] == 0.f) l[i] = 1.f;            // rows that saw no key
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long row = qw0 + g + 8 * i;
        if (row >= s.sq) continue;
        __nv_bfloat16* orow = out + (bh * s.sq + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
                __floats2bfloat162_rn(o[n][2 * i] / l[i],
                                      o[n][2 * i + 1] / l[i]);
    }
}

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

#define FT_ROWS 64                  // q rows per block
#define FT_THREADS 128              // 4 warps x 16 q rows

// kv rows per tile: 32 at D = 128 keeps its shared memory at 99 KB (two
// blocks an SM)
template <int D>
__host__ __device__ constexpr int ft_kv_rows() { return D == 64 ? 64 : 32; }

template <int D, bool SEG>
constexpr size_t ft_smem_bytes() {  // q tile + two stages of k and v
    return (size_t)(FT_ROWS + 4 * ft_kv_rows<D>()) * (D + 4) * sizeof(float) +
           (SEG ? FS_SMEM_INTS * sizeof(int) : 0);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(FT_THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, FaShape s) {
    extern __shared__ float4 ft_smem[];
    constexpr int LD = D + 4, BK = ft_kv_rows<D>(), TILE = BK * LD;
    float* q_s = reinterpret_cast<float*>(ft_smem);     // FT_ROWS x LD
    float* k_s = q_s + FT_ROWS * LD;                     // two stages
    float* v_s = k_s + 2 * TILE;                         // two stages
    int* ids_s = reinterpret_cast<int*>(v_s + 2 * TILE);   // (SEG) row ids
    int* wb_s = ids_s + FS_TILE;                           // (SEG) bounds

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long bh = blockIdx.y;
    const long long b = bh / s.heads, h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * FT_ROWS;
    const float* qb = q + b * s.q_sb + h * s.q_sh;
    const float* kb = k + b * s.k_sb + hk * s.k_sh;
    const float* vb = v + b * s.v_sb + hk * s.v_sh;
    const long long qw0 = q0 + warp * 16;       // the warp's first q row

    long long lower, upper;
    fs_kv_range<SEG, BK>(s, b, q0, lower, upper);
    if constexpr (SEG)
        fs_rows(ids_s, wb_s, s.seg.q + b * s.sq, s.sq, q0, tid);

    // group 0: the q tile; group 1: kv tile `lower`
    cp_async_rows_f32<FT_ROWS, D, FT_THREADS>(q_s, qb, s.q_ss, q0, s.sq, tid);
    cp_async_commit();
    if (upper > lower) {
        cp_async_rows_f32<BK, D, FT_THREADS>(k_s, kb, s.k_ss, lower * BK,
                                             s.sk, tid);
        cp_async_rows_f32<BK, D, FT_THREADS>(v_s, vb, s.v_ss, lower * BK,
                                             s.sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // q scaled in fp32, as the TPU kernel does, before its split
    for (int i = tid; i < FT_ROWS * D; i += FT_THREADS)
        q_s[(i / D) * LD + i % D] *= s.scale;
    __syncthreads();

    const long long pos0 = qw0 + g + s.offset;  // causal position, row g
    const float* q_w = q_s + (warp * 16 + g) * LD + t;
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};

    for (long long j = lower; j < upper; ++j) {
        const int st = (int)((j - lower) & 1);
        if (j + 1 < upper) {
            const long long next = (j + 1) * BK;
            cp_async_rows_f32<BK, D, FT_THREADS>(k_s + (st ^ 1) * TILE, kb,
                                                 s.k_ss, next, s.sk, tid);
            cp_async_rows_f32<BK, D, FT_THREADS>(v_s + (st ^ 1) * TILE, vb,
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
            // S = Q K^T for the warp's 16 rows x BK keys
            float sc[BK / 8][4];
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
                sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
            const float* k_t = k_s + st * TILE + g * LD + t;
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
                uint32_t ah[4], al[4];
                tf32_a_frag<LD>(ah, al, q_w + kk * 8);
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    uint32_t bh0, bh1, bl0, bl1;
                    tf32_b_frag_rows(bh0, bh1, bl0, bl1,
                                     k_t + n * 8 * LD + kk * 8);
                    mma_3xtf32(sc[n], ah, al, bh0, bh1, bl0, bl1);
                }
            }

            // mask where the tile crosses the diagonal, Sk or (SEG) a
            // segment edge
            const bool edge = (s.causal && k0 + BK - 1 > qw0 + s.offset)
                              || k0 + BK > s.sk || split;
            float tmax[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = sc[n][e];
                    if (edge) {
                        const long long key = k0 + n * 8 + 2 * t + (e & 1);
                        const long long pos = pos0 + (e >> 1) * 8;
                        bool valid = key < s.sk && (!s.causal || pos >= key);
                        if constexpr (SEG)
                            valid = valid && s.seg.k[b * s.sk + key] ==
                                                 ids_s[warp * 16 + g +
                                                       (e >> 1) * 8];
                        x = valid ? x : FA_NEG_INF;
                    }
                    sc[n][e] = x;
                    tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
                }
            }
            float alpha[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                tmax[i] = fmaxf(tmax[i],
                                __shfl_xor_sync(0xffffffffu, tmax[i], 1));
                tmax[i] = fmaxf(tmax[i],
                                __shfl_xor_sync(0xffffffffu, tmax[i], 2));
                const float m_new = fmaxf(m[i], tmax[i]);
                alpha[i] = expf(m[i] - m_new);
                m[i] = m_new;
                l[i] *= alpha[i];
            }
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float x = sc[n][e];
                    const float p =
                        x > FA_NEG_INF / 2 ? expf(x - m[e >> 1]) : 0.f;
                    sc[n][e] = p;
                    l[e >> 1] += p;
                }
            }
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                o[n][0] *= alpha[0];
                o[n][1] *= alpha[0];
                o[n][2] *= alpha[1];
                o[n][3] *= alpha[1];
            }

            // O += P V: P split from the C fragment in the permuted k
            // order (mma_sync.cuh), V's rows 2t, 2t + 1 of each 8
            const float* v_t = v_s + st * TILE + 2 * t * LD + g;
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
                uint32_t ph[4], pl[4];
                tf32_a_from_c(ph, pl, sc[kk]);
#pragma unroll
                for (int dn = 0; dn < D / 8; ++dn) {
                    uint32_t bh0, bh1, bl0, bl1;
                    tf32_b_frag_perm<LD>(bh0, bh1, bl0, bl1,
                                         v_t + kk * 8 * LD + dn * 8);
                    mma_3xtf32(o[dn], ph, pl, bh0, bh1, bl0, bl1);
                }
            }
        }
        __syncthreads();             // stage st is free for tile j + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const long long row = qw0 + g + 8 * i;
        if (lse != nullptr && t == 0 && row < s.sq)
            lse[bh * s.sq + row] = fa_lse(m[i], l[i]);
        if (l[i] == 0.f) l[i] = 1.f;            // rows that saw no key
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long row = qw0 + g + 8 * i;
        if (row >= s.sq) continue;
        float* orow = out + (bh * s.sq + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<float2*>(orow + n * 8) =
                make_float2(o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
    }
}

// ---------------------------------------------------------------------------
// the segment pre-pass
// ---------------------------------------------------------------------------

#define FS_THREADS 256

// The segment pre-pass, one block a row of the batch (a few microseconds:
// 4 x 4096 ids in 19 us on this card).  Phase 1: each tile's record but
// its range
// (one thread a tile walks its 64 ids).  Phase 2, after the block's
// barrier (which makes phase 1's global writes visible to the block): each
// tile's range, from the first to the last tile of the other side that it
// meets (flash_segments.cuh; kernels/ref.py::flash_segment_tiles_ref).
__global__ void __launch_bounds__(FS_THREADS)
flash_seg_tiles_kernel(const int* __restrict__ seg_q,
                       const int* __restrict__ seg_k, int* __restrict__ tiles,
                       long long sq, long long sk, int causal) {
    const long long b = blockIdx.x;
    const long long nq = (sq + FS_TILE - 1) / FS_TILE;
    const long long nk = (sk + FS_TILE - 1) / FS_TILE;
    int* rec = tiles + b * (nq + nk) * FS_REC;
    for (long long t = threadIdx.x; t < nq + nk; t += blockDim.x) {
        const bool is_q = t < nq;
        const long long len = is_q ? sq : sk;
        const int* ids = is_q ? seg_q + b * sq : seg_k + b * sk;
        const long long r0 = (is_q ? t : t - nq) * FS_TILE;
        const long long r1 = r0 + FS_TILE < len ? r0 + FS_TILE : len;
        int lo = ids[r0], hi = lo, slot[FS_SLOTS], count = 1;
#pragma unroll
        for (int i = 0; i < FS_SLOTS; ++i) slot[i] = lo;
        for (long long r = r0 + 1; r < r1; ++r) {
            const int x = ids[r];
            lo = min(lo, x);
            hi = max(hi, x);
            bool seen = false;
#pragma unroll
            for (int i = 0; i < FS_SLOTS; ++i)
                seen |= i < count && slot[i] == x;
            if (!seen && count <= FS_SLOTS) {
                if (count < FS_SLOTS) slot[count] = x;
                ++count;
            }
        }
        if (count > FS_SLOTS) {             // an interval: slots the least
#pragma unroll
            for (int i = 0; i < FS_SLOTS; ++i) slot[i] = lo;
        } else {                            // sorted, the least in the rest
#pragma unroll
            for (int i = 0; i < FS_SLOTS; ++i)
#pragma unroll
                for (int j = 0; j + 1 < FS_SLOTS; ++j)
                    if (j + 1 < count && slot[j] > slot[j + 1]) {
                        const int x = slot[j];
                        slot[j] = slot[j + 1];
                        slot[j + 1] = x;
                    }
#pragma unroll
            for (int i = 0; i < FS_SLOTS; ++i)
                if (i >= count) slot[i] = slot[0];
        }
        int* r = rec + t * FS_REC;
        r[0] = lo;
        r[1] = hi;
#pragma unroll
        for (int i = 0; i < FS_SLOTS; ++i) r[4 + i] = slot[i];
        r[7] = count;
    }
    __syncthreads();
    for (long long t = threadIdx.x; t < nq + nk; t += blockDim.x) {
        const bool is_q = t < nq;
        const int* me = rec + t * FS_REC;
        const int lo = me[0], hi = me[1], count = me[7];
        const int s0 = me[4], s1 = me[5], s2 = me[6];
        const long long first_other = is_q ? nq : 0, n_other = is_q ? nk : nq;
        long long first = -1, last = -1;
        for (long long u = 0; u < n_other; ++u) {
            if (causal) {                   // the K tile starts past the
                const long long tq = is_q ? t : u;      // q tile's diagonal
                const long long tk = is_q ? u : t - nq;
                const long long row = (tq + 1) * FS_TILE < sq
                                          ? (tq + 1) * FS_TILE - 1 : sq - 1;
                if (tk * FS_TILE > row + (sk - sq)) {
                    if (is_q) break;
                    continue;
                }
            }
            const int* o = rec + (first_other + u) * FS_REC;
            bool meet;
            if (count <= FS_SLOTS && o[7] <= FS_SLOTS) {
                meet = false;
#pragma unroll
                for (int i = 0; i < FS_SLOTS; ++i)
                    meet |= o[4 + i] == s0 || o[4 + i] == s1 ||
                            o[4 + i] == s2;
            } else {
                meet = lo <= o[1] && o[0] <= hi;
            }
            if (meet) {
                if (first < 0) first = u;
                last = u;
            }
        }
        const long long rows = is_q ? sk : sq;
        const long long end =
            (last + 1) * FS_TILE < rows ? (last + 1) * FS_TILE : rows;
        int* r = rec + t * FS_REC;
        r[2] = first < 0 ? 0 : (int)(first * FS_TILE);
        r[3] = first < 0 ? 0 : (int)end;
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
static int launch(Kernel kernel, size_t smem, int rows, int threads,
                  const void* q, const void* k, const void* v, void* out,
                  float* lse, const FaShape& s, long long bh,
                  cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((s.sq + rows - 1) / rows), (unsigned)bh);
    kernel<<<grid, threads, smem, stream>>>((const T*)q, (const T*)k,
                                            (const T*)v, (T*)out, lse, s);
    return (int)cudaGetLastError();
}

template <bool SEG>
static int launch_dtype(int dtype, int head_dim, const void* q,
                        const void* k, const void* v, void* out, float* l,
                        const FaShape& s, long long bh, cudaStream_t st) {
    if (dtype == 0 && head_dim == 64)
        return launch<float>(flash_fwd_tf32_kernel<64, SEG>,
                             ft_smem_bytes<64, SEG>(), FT_ROWS, FT_THREADS,
                             q, k, v, out, l, s, bh, st);
    if (dtype == 0 && head_dim == 128)
        return launch<float>(flash_fwd_tf32_kernel<128, SEG>,
                             ft_smem_bytes<128, SEG>(), FT_ROWS, FT_THREADS,
                             q, k, v, out, l, s, bh, st);
    if (dtype == 1 && head_dim == 64)
        return launch<__nv_bfloat16>(flash_fwd_mma_kernel<64, SEG>,
                                     fm_smem_bytes<64, SEG>(), FM_ROWS,
                                     FM_THREADS, q, k, v, out, l, s, bh, st);
    if (dtype == 1 && head_dim == 128)
        return launch<__nv_bfloat16>(flash_fwd_mma_kernel<128, SEG>,
                                     fm_smem_bytes<128, SEG>(), FM_ROWS,
                                     FM_THREADS, q, k, v, out, l, s, bh, st);
    return -1;
}

// q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D), each given by element strides of
// its first three dimensions (the last is dense); out: (B, H, Sq, D)
// contiguous, of q's type; lse: (B, H, Sq) fp32 contiguous, or null to
// skip it.  dtype 0 = float32, 1 = bfloat16 (base pointers and strides
// 16-byte aligned in both: cp.async); head_dim 64 or 128.  seg_q, seg_k,
// tiles: null, or the segment ids (int32 (B, Sq), (B, Sk), contiguous) and
// the pre-pass's records (flash_segment_tiles_launch), which select the
// segmented kernels.  The caller guarantees B*H, Sq > 0 and H % Hkv == 0.
// Returns the CUDA error code of the first failing call (0 = success), or
// -1 for a type or head dimension no kernel is instantiated for.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* out, void* lse,
        int dtype, int head_dim, long long batch, long long heads,
        long long kv_heads, long long sq, long long sk, long long q_sb, long long q_sh,
        long long q_ss, long long k_sb, long long k_sh, long long k_ss,
        long long v_sb, long long v_sh, long long v_ss, int causal,
        float scale, const void* seg_q, const void* seg_k, const void* tiles,
        void* stream) {
    FaShape s;
    s.heads = heads;
    s.kv_group = heads / kv_heads;
    s.sq = sq;
    s.sk = sk;
    s.offset = sk - sq;
    s.q_sb = q_sb; s.q_sh = q_sh; s.q_ss = q_ss;
    s.k_sb = k_sb; s.k_sh = k_sh; s.k_ss = k_ss;
    s.v_sb = v_sb; s.v_sh = v_sh; s.v_ss = v_ss;
    s.causal = causal;
    s.scale = scale;
    s.seg.q = (const int*)seg_q;
    s.seg.k = (const int*)seg_k;
    s.seg.tiles = (const int*)tiles;
    s.seg.nq = (sq + FS_TILE - 1) / FS_TILE;
    s.seg.nk = (sk + FS_TILE - 1) / FS_TILE;
    const long long bh = batch * heads;
    cudaStream_t st = (cudaStream_t)stream;
    float* l = (float*)lse;
    if (seg_q != nullptr)
        return launch_dtype<true>(dtype, head_dim, q, k, v, out, l, s, bh,
                                  st);
    return launch_dtype<false>(dtype, head_dim, q, k, v, out, l, s, bh, st);
}

// The segment pre-pass: seg_q (B, Sq), seg_k (B, Sk) int32 contiguous ->
// tiles (B, nq + nk, FS_REC) int32 (flash_segments.cuh), one block a row.
// The caller guarantees B, Sq, Sk > 0.  Returns the CUDA error code of the
// launch (0 = success).
extern "C" int flash_segment_tiles_launch(const void* seg_q,
                                          const void* seg_k, void* tiles,
                                          long long batch, long long sq,
                                          long long sk, int causal,
                                          void* stream) {
    flash_seg_tiles_kernel<<<(unsigned)batch, FS_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int*)seg_q, (const int*)seg_k, (int*)tiles, sq, sk, causal);
    return (int)cudaGetLastError();
}
