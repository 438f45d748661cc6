// Forward attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (wrapper flash_attention).  Same arithmetic: q is scaled in fp32, logits
// of masked positions are set to NEG_INF = -1e30 (not -inf), p is guarded by
// logits > NEG_INF/2, the running max m, sum l and the accumulator stay in
// fp32, a row that saw no key divides by 1 and comes out 0, and the causal
// diagonal sits at offset = Sk - Sq on the unpadded sizes.
//
// Design (the simple kernel that is right; wgmma/TMA come later):
//   grid   (ceil(Sq / 64), B * H): one block per (batch*head, 64-row q tile);
//   block  64 threads, one q row each: the row's accumulator (D floats), m
//          and l live in registers;
//   smem   the q tile (scaled, fp32, rows padded to D + 4 floats so float4
//          reads of a thread's own row do not conflict) and one kv tile of
//          32 rows of K and V converted to fp32; every thread of a warp
//          reads the same K/V row at once (a broadcast);
//   loop   over kv tiles up to clip((q_last + offset) / 32 + 1, 0, nk): the
//          tiles past it are masked for every row of the block;
//   edges  ragged Sq/Sk are masked in the kernel (kv rows past Sk are loaded
//          as 0 and masked unconditionally; q rows past Sq are computed and
//          not stored) -- there is no padded copy in device memory.
// The inputs may be strided views (only the head dimension must be dense),
// and K/V may have fewer heads than Q: head h reads kv head h / (H / Hkv),
// which is jnp.repeat of the kv heads without the copy.
//
// Bound on this card, at the prefill shape of qwen2-0.5b (B = 4, 14 q heads
// over 2 kv heads, S = 1024, D = 64, bf16, causal): the 4*D*B*H*S(S+1)/2
// flops of the visible half (7.5 GFLOP -> 7.6 us at 989 TFLOP/s bf16) weigh
// more than the bytes (q and o for 14 heads, k and v for 2: 16.8 MB ->
// 5.0 us at 3.35 TB/s; with the kv heads repeated in memory it would be
// 29 MB -> 8.8 us).  This kernel computes on the fp32 pipes out of shared
// memory, so it is far from either bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BQ 64            // q rows per block = threads per block
#define FA_BK 32            // kv rows per shared-memory tile
#define FA_NEG_INF (-1e30f)

struct FaShape {
    long long heads, kv_group;          // H, H / Hkv
    long long sq, sk, offset;           // offset = sk - sq
    long long q_sb, q_sh, q_ss;         // element strides (head dim is dense)
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    int causal;
    float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t fa_smem_bytes() {
    return (size_t)(FA_BQ * (D + 4) + 2 * FA_BK * D) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, FaShape s) {
    extern __shared__ float4 fa_smem[];
    constexpr int QS = D + 4;
    float* q_s = reinterpret_cast<float*>(fa_smem);   // FA_BQ x QS
    float* k_s = q_s + FA_BQ * QS;                     // FA_BK x D
    float* v_s = k_s + FA_BK * D;                      // FA_BK x D

    const int t = threadIdx.x;
    const long long bh = blockIdx.y;
    const long long b = bh / s.heads;
    const long long h = bh % s.heads;
    const long long hk = h / s.kv_group;
    const long long q0 = (long long)blockIdx.x * FA_BQ;
    const T* qb = q + b * s.q_sb + h * s.q_sh;
    const T* kb = k + b * s.k_sb + hk * s.k_sh;
    const T* vb = v + b * s.v_sb + hk * s.v_sh;

    // the q tile, scaled in fp32 as the TPU kernel does; rows past Sq are 0
    for (int i = t; i < FA_BQ * D; i += FA_BQ) {
        const int r = i / D, c = i % D;
        const long long row = q0 + r;
        q_s[r * QS + c] =
            row < s.sq ? to_f32(qb[row * s.q_ss + c]) * s.scale : 0.f;
    }

    const long long nk = (s.sk + FA_BK - 1) / FA_BK;
    long long upper = nk;
    if (s.causal) {
        const long long last = q0 + FA_BQ - 1 + s.offset;
        upper = last < 0 ? 0 : (last / FA_BK + 1 < nk ? last / FA_BK + 1 : nk);
    }

    const long long qrow = q0 + t;
    const long long qpos = qrow + s.offset;
    const float4* q4 = reinterpret_cast<const float4*>(q_s + t * QS);
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    float m = FA_NEG_INF, l = 0.f;

    for (long long j = 0; j < upper; ++j) {
        const long long k0 = j * FA_BK;
        __syncthreads();          // q tile staged / previous kv tile consumed
        for (int i = t; i < FA_BK * D; i += FA_BQ) {
            const int r = i / D, c = i % D;
            const long long key = k0 + r;
            const bool in = key < s.sk;
            k_s[i] = in ? to_f32(kb[key * s.k_ss + c]) : 0.f;
            v_s[i] = in ? to_f32(vb[key * s.v_ss + c]) : 0.f;
        }
        __syncthreads();

        // logits of this row against the tile's keys
        float sc[FA_BK];
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) sc[kk] = 0.f;
#pragma unroll 4
        for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 qd = q4[d4];
#pragma unroll
            for (int kk = 0; kk < FA_BK; ++kk) {
                const float4 kd =
                    reinterpret_cast<const float4*>(k_s + kk * D)[d4];
                sc[kk] += qd.x * kd.x + qd.y * kd.y + qd.z * kd.z +
                          qd.w * kd.w;
            }
        }

        // mask (padded kv rows always; the causal diagonal), online softmax
        float tile_max = FA_NEG_INF;
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) {
            const long long key = k0 + kk;
            const bool valid = key < s.sk && (!s.causal || qpos >= key);
            sc[kk] = valid ? sc[kk] : FA_NEG_INF;
            tile_max = fmaxf(tile_max, sc[kk]);
        }
        const float m_new = fmaxf(m, tile_max);
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) {
            sc[kk] = sc[kk] > FA_NEG_INF / 2 ? expf(sc[kk] - m_new) : 0.f;
            psum += sc[kk];
        }
        l = l * alpha + psum;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) {
            const float p = sc[kk];
            const float4* v4 = reinterpret_cast<const float4*>(v_s + kk * D);
#pragma unroll
            for (int d4 = 0; d4 < D / 4; ++d4) {
                const float4 vd = v4[d4];
                acc[4 * d4 + 0] += p * vd.x;
                acc[4 * d4 + 1] += p * vd.y;
                acc[4 * d4 + 2] += p * vd.z;
                acc[4 * d4 + 3] += p * vd.w;
            }
        }
        m = m_new;
    }

    if (qrow < s.sq) {
        const float lf = l == 0.f ? 1.f : l;       // rows that saw no key
        T* o = out + (bh * s.sq + qrow) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) store_f32(o + d, acc[d] / lf);
    }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const FaShape& s, long long bh, cudaStream_t stream) {
    const size_t smem = fa_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((s.sq + FA_BQ - 1) / FA_BQ), (unsigned)bh);
    flash_fwd_kernel<T, D><<<grid, FA_BQ, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, s);
    return (int)cudaGetLastError();
}

// q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D), each given by element strides of
// its first three dimensions (the last is dense); out: (B, H, Sq, D)
// contiguous, of q's type.  dtype 0 = float32, 1 = bfloat16; head_dim 64 or
// 128.  The caller guarantees B*H, Sq > 0 and H % Hkv == 0.  Returns the
// CUDA error code of the first failing call (0 = success), or -1 for a type
// or head dimension no kernel is instantiated for.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* out, int dtype,
        int head_dim, long long batch, long long heads, long long kv_heads,
        long long sq, long long sk, long long q_sb, long long q_sh,
        long long q_ss, long long k_sb, long long k_sh, long long k_ss,
        long long v_sb, long long v_sh, long long v_ss, int causal,
        float scale, void* stream) {
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
    const long long bh = batch * heads;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0 && head_dim == 64)
        return launch<float, 64>(q, k, v, out, s, bh, st);
    if (dtype == 0 && head_dim == 128)
        return launch<float, 128>(q, k, v, out, s, bh, st);
    if (dtype == 1 && head_dim == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, out, s, bh, st);
    if (dtype == 1 && head_dim == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, out, s, bh, st);
    return -1;
}
