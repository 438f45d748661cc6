// MVE float arithmetic and float <-> half conversions for Hopper, with the
// reference's bits.
//
// There is no TPU kernel behind this file.  The reference computes vadd /
// vsub / vmul on float registers and every float32 <-> float16 conversion
// with XLA on an x86 host, and the port must give its bits.  CUDA's own
// arithmetic differs from x86's in two places:
//
//   NaN results   CUDA returns its canonical NaN (0x7FFFFFFF, half 0x7FFF).
//                 x86 returns the first NaN operand quieted: a if a is a
//                 NaN, else b, else the default NaN 0xFFC00000 (0xFE00);
//                 a conversion keeps sign and payload (F16C):
//                 sign | 0x7E00 | mant >> 13 narrowing,
//                 sign | 0x7FC00000 | mant << 13 widening.
//   denormals     XLA's CPU runtime runs with DAZ and FTZ: a float32
//                 denormal operand counts as a zero of its sign, and so
//                 does a result that is tiny after rounding to 24 bits
//                 with an unbounded exponent (x86 detects tininess after
//                 rounding; CUDA keeps the denormal).
//
// Each instruction is one rounding point (__fadd_rn / __fsub_rn /
// __fmul_rn, never contracted into an FMA).  float16 operands are widened
// to float32 (exact), combined there and rounded once to float16: the
// double rounding is harmless for one add, sub or mul, since float32 has
// more than 2 * 11 + 2 bits of precision.  A float16 value is never
// denormal in float32, so only float32 operands and results are flushed.
//
// Bound: bytes (two operands read, one result written; a conversion reads
// one and writes one).  One thread takes VEC = 4 neighbouring elements as
// one vector load per operand where every pointer is aligned to it, in a
// grid-stride loop.  The plain version is
// repro_torch/kernels/ref.py::float_binary_ref / float_convert_ref.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FO_THREADS 256
#define FO_MAX_BLOCKS (132 * 16)

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) FoPack {
    T v[VEC];
};

__device__ __forceinline__ bool fo_nan(uint32_t u) {
    return (u & 0x7FFFFFFFu) > 0x7F800000u;
}
__device__ __forceinline__ bool fo_nan(uint16_t h) {
    return (h & 0x7FFFu) > 0x7C00u;
}

// float32 denormals count as zeros of their sign (DAZ / FTZ)
__device__ __forceinline__ float fo_flush(float x) {
    return fabsf(x) < 1.17549435e-38f ? copysignf(0.0f, x) : x;
}

template <int OP>
__device__ __forceinline__ float fo_apply(float a, float b) {
    if (OP == 0) return __fadd_rn(a, b);
    if (OP == 1) return __fsub_rn(a, b);
    return __fmul_rn(a, b);
}

template <int OP>
__device__ __forceinline__ uint32_t fo_binary(uint32_t a, uint32_t b) {
    const float fa = fo_flush(__uint_as_float(a));
    const float fb = fo_flush(__uint_as_float(b));
    float r = fo_apply<OP>(fa, fb);
    // FTZ: x86 calls a result tiny after rounding it to 24 bits with an
    // unbounded exponent.  A tiny sum or difference of normals is exact; a
    // product is exact in double, and scaled by 2^64 it rounds to float
    // far from the denormal range.
    const bool tiny =
        OP == 2 ? fabsf(__double2float_rn((double)fa * (double)fb *
                                          18446744073709551616.0)) <
                      1.17549435e-38f * 18446744073709551616.0f
                : fabsf(r) < 1.17549435e-38f;
    if (tiny) r = copysignf(0.0f, r);
    const uint32_t bits = __float_as_uint(r);
    if (!fo_nan(bits)) return bits;
    return fo_nan(a) ? (a | 0x00400000u)
         : fo_nan(b) ? (b | 0x00400000u) : 0xFFC00000u;
}

template <int OP>
__device__ __forceinline__ uint16_t fo_binary(uint16_t a, uint16_t b) {
    const float r = fo_apply<OP>(__half2float(__ushort_as_half(a)),
                                 __half2float(__ushort_as_half(b)));
    if (r != r)
        return fo_nan(a) ? (uint16_t)(a | 0x0200u)
             : fo_nan(b) ? (uint16_t)(b | 0x0200u) : (uint16_t)0xFE00u;
    return __half_as_ushort(__float2half_rn(r));
}

// float32 -> float16 (the bits of a float32 in, of a float16 out)
__device__ __forceinline__ uint16_t fo_convert(uint32_t u) {
    if (fo_nan(u))
        return (uint16_t)(((u >> 16) & 0x8000u) | 0x7E00u |
                          ((u & 0x007FFFFFu) >> 13));
    return __half_as_ushort(__float2half_rn(__uint_as_float(u)));
}

// float16 -> float32
__device__ __forceinline__ uint32_t fo_convert(uint16_t h) {
    if (fo_nan(h))
        return ((uint32_t)(h & 0x8000u) << 16) | 0x7FC00000u |
               ((uint32_t)(h & 0x03FFu) << 13);
    return __float_as_uint(__half2float(__ushort_as_half(h)));
}

template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(FO_THREADS)
float_binary_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * FO_THREADS * VEC;
    for (long long i = ((long long)blockIdx.x * FO_THREADS + threadIdx.x) *
                       VEC;
         i < n; i += step) {
        if (VEC > 1 && i + VEC <= n) {
            const FoPack<T, VEC> pa =
                *reinterpret_cast<const FoPack<T, VEC>*>(a + i);
            const FoPack<T, VEC> pb =
                *reinterpret_cast<const FoPack<T, VEC>*>(b + i);
            FoPack<T, VEC> po;
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                po.v[j] = fo_binary<OP>(pa.v[j], pb.v[j]);
            *reinterpret_cast<FoPack<T, VEC>*>(out + i) = po;
        } else {
            for (int j = 0; j < VEC && i + j < n; ++j)
                out[i + j] = fo_binary<OP>(a[i + j], b[i + j]);
        }
    }
}

template <typename S, typename D, int VEC>
__global__ void __launch_bounds__(FO_THREADS)
float_convert_kernel(const S* __restrict__ x, D* __restrict__ out,
                     long long n) {
    const long long step = (long long)gridDim.x * FO_THREADS * VEC;
    for (long long i = ((long long)blockIdx.x * FO_THREADS + threadIdx.x) *
                       VEC;
         i < n; i += step) {
        if (VEC > 1 && i + VEC <= n) {
            const FoPack<S, VEC> px =
                *reinterpret_cast<const FoPack<S, VEC>*>(x + i);
            FoPack<D, VEC> po;
#pragma unroll
            for (int j = 0; j < VEC; ++j) po.v[j] = fo_convert(px.v[j]);
            *reinterpret_cast<FoPack<D, VEC>*>(out + i) = po;
        } else {
            for (int j = 0; j < VEC && i + j < n; ++j)
                out[i + j] = fo_convert(x[i + j]);
        }
    }
}

static unsigned fo_blocks(long long n, int vec) {
    const long long per = (long long)FO_THREADS * vec;
    const long long blocks = (n + per - 1) / per;
    return (unsigned)(blocks < FO_MAX_BLOCKS ? blocks : FO_MAX_BLOCKS);
}

template <typename T, int OP>
static int launch_binary(const void* a, const void* b, void* out,
                         long long n, int vec, cudaStream_t st) {
    const T* pa = (const T*)a;
    const T* pb = (const T*)b;
    T* po = (T*)out;
    if (vec == 4)
        float_binary_kernel<T, OP, 4>
            <<<fo_blocks(n, 4), FO_THREADS, 0, st>>>(pa, pb, po, n);
    else
        float_binary_kernel<T, OP, 1>
            <<<fo_blocks(n, 1), FO_THREADS, 0, st>>>(pa, pb, po, n);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_binary_op(int op, const void* a, const void* b, void* out,
                            long long n, int vec, cudaStream_t st) {
    switch (op) {
        case 0: return launch_binary<T, 0>(a, b, out, n, vec, st);
        case 1: return launch_binary<T, 1>(a, b, out, n, vec, st);
        case 2: return launch_binary<T, 2>(a, b, out, n, vec, st);
    }
    return -1;
}

// op: 0 add, 1 sub, 2 mul; elem_size: 4 float32, 2 float16; vec: 4 when
// a, b and out are aligned to 4 elements, else 1.
extern "C" int float_binary_launch(int op, int elem_size, const void* a,
                                   const void* b, void* out, long long n,
                                   int vec, void* stream) {
    if (n <= 0) return 0;
    if (vec != 1 && vec != 4) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (elem_size == 4)
        return launch_binary_op<uint32_t>(op, a, b, out, n, vec, st);
    if (elem_size == 2)
        return launch_binary_op<uint16_t>(op, a, b, out, n, vec, st);
    return -1;
}

template <typename S, typename D>
static int launch_convert(const void* x, void* out, long long n, int vec,
                          cudaStream_t st) {
    if (vec == 4)
        float_convert_kernel<S, D, 4><<<fo_blocks(n, 4), FO_THREADS, 0, st>>>(
            (const S*)x, (D*)out, n);
    else
        float_convert_kernel<S, D, 1><<<fo_blocks(n, 1), FO_THREADS, 0, st>>>(
            (const S*)x, (D*)out, n);
    return (int)cudaGetLastError();
}

// src_size: 4 float32 -> float16, 2 float16 -> float32.
extern "C" int float_convert_launch(int src_size, const void* x, void* out,
                                    long long n, int vec, void* stream) {
    if (n <= 0) return 0;
    if (vec != 1 && vec != 4) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (src_size == 4) return launch_convert<uint32_t, uint16_t>(x, out, n, vec, st);
    if (src_size == 2) return launch_convert<uint16_t, uint32_t>(x, out, n, vec, st);
    return -1;
}
