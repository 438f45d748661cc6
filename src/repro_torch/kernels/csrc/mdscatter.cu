// MVE `vsst` for Hopper: multi-dimensional strided scatter, highest lane
// wins on equal addresses.
//
// Replaces the TPU kernel repro/kernels/mdscatter.py::_scatter_kernel.  The
// TPU kernel gets last-lane-wins by walking the lane tiles one after another
// inside a single grid step.  Blocks on a GPU run in no order, so the order
// is made explicit in two passes over the lanes:
//
//   pass 1  every active lane atomicMax-es its lane id into an int32 owner
//           table with one entry per destination address (-1 = untouched);
//   pass 2  a lane stores only where it is the owner.
//
// A strided store lands on the same addresses in every image of a batch, so
// one table serves the whole batch.  Inactive lanes (at or past prod(dims),
// or masked off by the per-lane dimension mask) and out-of-range addresses
// write nowhere.  The result is the same on every run.
//
// Bound: bytes.  batch*lanes*elem read and as much written, plus the owner
// table (4 bytes per destination element, set and read once).  Nothing here
// allocates or synchronises; the wrapper owns the table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mdv_walk.cuh"

// Address of an active lane, or -1 when the lane writes nowhere.
__device__ __forceinline__ long long scatter_target(
        const MdvWalk& w, const uint8_t* __restrict__ mask, long long lane,
        long long lanes, long long dst_len) {
    if (lane >= lanes || lane >= w.total) return -1;
    if (mask != nullptr && mask[lane] == 0) return -1;
    const long long addr = mdv_address(w, lane);
    return (addr < 0 || addr >= dst_len) ? -1 : addr;
}

__global__ void mdscatter_owner_kernel(int* __restrict__ owner, MdvWalk w,
                                       const uint8_t* __restrict__ mask,
                                       long long lanes, long long dst_len) {
    const long long lane =
        (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long addr = scatter_target(w, mask, lane, lanes, dst_len);
    if (addr >= 0) atomicMax(&owner[addr], (int)lane);
}

template <typename T>
__global__ void mdscatter_store_kernel(T* __restrict__ dst,
                                       const T* __restrict__ values,
                                       const int* __restrict__ owner,
                                       MdvWalk w,
                                       const uint8_t* __restrict__ mask,
                                       long long lanes, long long dst_len,
                                       long long batch) {
    const long long lane =
        (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long addr = scatter_target(w, mask, lane, lanes, dst_len);
    if (addr < 0 || owner[addr] != (int)lane) return;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
        dst[b * dst_len + addr] = values[b * lanes + lane];
    }
}

template <typename T>
static int launch_store(void* dst, const void* values, const int* owner,
                        const MdvWalk& w, const uint8_t* mask,
                        long long lanes, long long dst_len, long long batch,
                        cudaStream_t stream) {
    const dim3 grid((unsigned)((lanes + MDV_THREADS - 1) / MDV_THREADS),
                    mdv_grid_y(batch));
    mdscatter_store_kernel<T><<<grid, MDV_THREADS, 0, stream>>>(
        (T*)dst, (const T*)values, owner, w, mask, lanes, dst_len, batch);
    return (int)cudaGetLastError();
}

// dst: batch images of dst_len elements, contiguous, updated in place;
// values: batch x lanes; owner: dst_len int32 of scratch (any contents);
// mask: lanes bytes (non-zero = lane active) or null.  Returns the CUDA
// error code of the first failing call (0 = success), or -1 for an element
// size no kernel is instantiated for.
extern "C" int mdscatter_launch(void* dst, const void* values, void* owner,
                                const void* mask, long long batch,
                                long long dst_len, long long lanes,
                                int elem_size, int ndims,
                                long long d0, long long d1, long long d2,
                                long long d3, long long s0, long long s1,
                                long long s2, long long s3, long long base,
                                void* stream) {
    if (elem_size != 1 && elem_size != 2 && elem_size != 4 && elem_size != 8)
        return -1;
    const MdvWalk w = mdv_make_walk(ndims, d0, d1, d2, d3, s0, s1, s2, s3,
                                    base);
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* m = (const uint8_t*)mask;
    int* own = (int*)owner;

    // every byte 0xFF = every int32 entry -1
    cudaError_t err = cudaMemsetAsync(own, 0xFF, (size_t)dst_len * 4, st);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks =
        (unsigned)((lanes + MDV_THREADS - 1) / MDV_THREADS);
    mdscatter_owner_kernel<<<blocks, MDV_THREADS, 0, st>>>(own, w, m, lanes,
                                                           dst_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    switch (elem_size) {
        case 1: return launch_store<uint8_t>(dst, values, own, w, m, lanes, dst_len, batch, st);
        case 2: return launch_store<uint16_t>(dst, values, own, w, m, lanes, dst_len, batch, st);
        case 4: return launch_store<uint32_t>(dst, values, own, w, m, lanes, dst_len, batch, st);
    }
    return launch_store<uint64_t>(dst, values, own, w, m, lanes, dst_len, batch, st);
}
