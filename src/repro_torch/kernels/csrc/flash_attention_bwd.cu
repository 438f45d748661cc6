// Backward of the flash-attention forward (flash_attention.cu), for Hopper.
//
// Not a TPU kernel: the reference trains through its plain jnp attention
// (jax.value_and_grad of repro/models/attention.py::chunked_attention) and
// has no backward Pallas kernel.  The port's flash route has no plain
// alternative on the card, so its gradient is a kernel too: the recompute
// backward of flash-attention-2, in three kernels launched in order on one
// stream,
//
//   flash_bwd_delta_kernel  D = rowsum(dO * O), one warp per q row;
//   flash_bwd_dkdv_kernel   one block per (batch, kv head, 64-row K tile):
//                           over the G = H / Hkv q heads that share the kv
//                           head and their q tiles (from the causal
//                           diagonal on), P = exp(S * scale - lse),
//                           dV += P^T dO, dK += (P * (dO V^T - D))^T Q,
//                           written once, times the scale for dK;
//   flash_bwd_dq_kernel     one block per (batch, q head, 64-row q tile):
//                           over the K tiles up to the causal diagonal,
//                           dQ += (P * (dO V^T - D)) K, times the scale.
//
// The GQA sum over a kv head's q heads happens inside the dK/dV block, in
// a fixed order and with no atomics, so a training step is deterministic.
// Masks as the forward: keys past Sk, and keys past the causal diagonal at
// offset = Sk - Sq; a row that saw no key has lse = -inf, P = 0 everywhere
// and no gradient.  Inputs: q/k/v/dO of float32 or bfloat16, strided with
// only the head dimension dense; O, lse contiguous.  Everything is summed
// in fp32; dq, dk, dv come out contiguous, in the inputs' type.
//
// Design: SIMT on the fp32 CUDA cores for both types (simple and right
// first; the tensor cores are ROADMAP B2 item 5).  A thread owns 32 of a
// row's D columns (the float4 chunks c * D/32 + part), so a row is D/32
// threads (2 or 4 neighbouring lanes) that sum their partial dot products
// with __shfl_xor_sync.  The dK/dV thread keeps its K and V columns and its
// dK and dV sums in registers (128 floats); q and dO tiles of 32 rows, the
// dQ kernel's K and V tiles of 32 rows, sit in shared memory in fp32 and
// are read as float4 broadcasts (the D/32 lanes of a row read D/32
// neighbouring float4s: no bank conflict).
//
// Bound on this card: the five 2 * D products per visible (q, k) pair
// (S and dP twice, dV, dK, dQ counted once each: 10 * D operations) at the
// bf16 tensor-core peak, against q, k, v, o, dO, lse read once and dq, dk,
// dv written once; operations lead at the training shapes (whisper's
// encoder, 4 x 8 x 1500 x 64: 46 GFLOP -> 47 us at 989 TFLOP/s, 31 MB ->
// 9 us).  The kernels here recompute S and dP in both passes (14 * D
// operations a pair) on the CUDA cores: slow by design, their time is in
// PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void fb_store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(FB_KROWS * (D / FB_COLS))
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, FbShape s) {
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
    const T* krow = k + b * s.k_sb + hk * s.k_sh + (key_in ? key : 0) * s.k_ss;
    const T* vrow = v + b * s.v_sb + hk * s.v_sh + (key_in ? key : 0) * s.v_ss;
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
        const T* qb = q + b * s.q_sb + h * s.q_sh;
        const T* db = dout + b * s.do_sb + h * s.do_sh;
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
    T* dkrow = dk + (bk * s.sk + key) * D;
    T* dvrow = dv + (bk * s.sk + key) * D;
#pragma unroll
    for (int e = 0; e < FB_COLS; ++e) {
        const int c = fb_col<D>(e, part);
        fb_store(dkrow + c, dkr[e] * s.scale);
        fb_store(dvrow + c, dvr[e]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(FB_QROWS * (D / FB_COLS))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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
    const T* qrow = q + b * s.q_sb + h * s.q_sh + (row_in ? i : 0) * s.q_ss;
    const T* drow =
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
    const T* kb = k + b * s.k_sb + hk * s.k_sh;
    const T* vb = v + b * s.v_sb + hk * s.v_sh;

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
    T* dqrow = dq + (bh * s.sq + i) * D;
#pragma unroll
    for (int e = 0; e < FB_COLS; ++e)
        fb_store(dqrow + fb_col<D>(e, part), dqr[e] * s.scale);
}

template <typename T, int D>
static int run(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, const FbShape& s, long long batch,
               cudaStream_t stream) {
    const long long rows = batch * s.heads * s.sq;
    flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0,
                                   stream>>>((const T*)o, (const T*)dout,
                                             delta, s, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr int P = D / FB_COLS;
    const dim3 kv_grid((unsigned)((s.sk + FB_KROWS - 1) / FB_KROWS),
                       (unsigned)(batch * s.kv_heads));
    flash_bwd_dkdv_kernel<T, D><<<kv_grid, FB_KROWS * P, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 q_grid((unsigned)((s.sq + FB_QROWS - 1) / FB_QROWS),
                      (unsigned)(batch * s.heads));
    flash_bwd_dq_kernel<T, D><<<q_grid, FB_QROWS * P, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dq, s);
    return (int)cudaGetLastError();
}

// q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); each given by the element
// strides of its first three dimensions in `strides` (q, k, v, dout: 12
// values), the last dimension dense.  o: (B, H, Sq, D) contiguous of q's
// type; lse: (B, H, Sq) fp32 contiguous; delta: (B, H, Sq) fp32 scratch.
// dq: (B, H, Sq, D), dk, dv: (B, Hkv, Sk, D), contiguous, of q's type.
// dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128.  The caller
// guarantees B*H, Sq, Sk > 0, H % Hkv == 0 and B*H < 65536.  Returns the
// CUDA error code of the first failing launch (0 = success), or -1 for a
// type or head dimension no kernel is instantiated for.
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* delta, int dtype, int head_dim, long long batch,
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
    if (dtype == 0 && head_dim == 64)
        return run<float, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, s, batch,
                              st);
    if (dtype == 0 && head_dim == 128)
        return run<float, 128>(q, k, v, o, l, dout, dq, dk, dv, dl, s, batch,
                               st);
    if (dtype == 1 && head_dim == 64)
        return run<__nv_bfloat16, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, s,
                                      batch, st);
    if (dtype == 1 && head_dim == 128)
        return run<__nv_bfloat16, 128>(q, k, v, o, l, dout, dq, dk, dv, dl,
                                       s, batch, st);
    return -1;
}
