// MVE `vsld` for Hopper: multi-dimensional strided gather.
//
// Replaces the TPU kernel repro/kernels/mdgather.py::_gather_kernel.  There
// one grid step fills an (8,128) lane tile from a VMEM-resident source; here
// one thread owns one lane, walks its address in registers (no address
// tensor is ever uploaded) and moves one element.  Elements are moved as
// bits, by size, so one kernel serves every memory and register type.
//
// Bound: bytes.  batch*lanes*elem read and as much written; there is no
// arithmetic on the data.  At one image (8192 lanes) the kernel is
// launch-bound.  Nothing here allocates or synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mdv_walk.cuh"

template <typename T>
__global__ void mdgather_kernel(const T* __restrict__ src,
                                T* __restrict__ out, MdvWalk w,
                                long long src_len, long long batch,
                                long long lanes) {
    const long long lane =
        (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const bool active = lane < w.total;
    long long addr = 0;
    if (active) {
        addr = mdv_address(w, lane);
        addr = addr < 0 ? 0 : (addr >= src_len ? src_len - 1 : addr);
    }
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
        out[b * lanes + lane] = active ? src[b * src_len + addr] : T(0);
    }
}

template <typename T>
static int launch(const void* src, void* out, const MdvWalk& w,
                  long long src_len, long long batch, long long lanes,
                  cudaStream_t stream) {
    const dim3 grid((unsigned)((lanes + MDV_THREADS - 1) / MDV_THREADS),
                    mdv_grid_y(batch));
    mdgather_kernel<T><<<grid, MDV_THREADS, 0, stream>>>(
        (const T*)src, (T*)out, w, src_len, batch, lanes);
    return (int)cudaGetLastError();
}

// src: batch images of src_len elements, contiguous; out: batch x lanes.
// Returns the CUDA error code of the launch (0 = success), or -1 for an
// element size no kernel is instantiated for.
extern "C" int mdgather_launch(const void* src, void* out, long long batch,
                               long long src_len, long long lanes,
                               int elem_size, int ndims,
                               long long d0, long long d1, long long d2,
                               long long d3, long long s0, long long s1,
                               long long s2, long long s3, long long base,
                               void* stream) {
    const MdvWalk w = mdv_make_walk(ndims, d0, d1, d2, d3, s0, s1, s2, s3,
                                    base);
    cudaStream_t st = (cudaStream_t)stream;
    switch (elem_size) {
        case 1: return launch<uint8_t>(src, out, w, src_len, batch, lanes, st);
        case 2: return launch<uint16_t>(src, out, w, src_len, batch, lanes, st);
        case 4: return launch<uint32_t>(src, out, w, src_len, batch, lanes, st);
        case 8: return launch<uint64_t>(src, out, w, src_len, batch, lanes, st);
    }
    return -1;
}
