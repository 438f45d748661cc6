// MVE `vsst` for Hopper: multi-dimensional strided scatter, highest lane
// wins on equal addresses.
//
// Replaces the TPU kernel repro/kernels/mdscatter.py::_scatter_kernel.  The
// TPU kernel gets last-lane-wins by walking the lane tiles one after another
// inside a single grid step.  Blocks on a GPU run in no order, so the order
// has to come from somewhere else.  A strided store's walk (dims, strides,
// base, image length, lane count) is static, and a lane mask only removes
// writers, so the wrapper (kernels/mdscatter.py) classifies each walk once
// on the host and picks one of three routes:
//
//   contiguous  every lane that lands in the image writes lane + shift, and
//               those lanes are one run [lo, lo + count): a masked copy of
//               that run of every image, 16 bytes per thread where both
//               sides are aligned, with no walk, no table and no atomics
//               (mdscatter_contig_launch, one kernel);
//   distinct    no two lanes land on one address, so there is no order to
//               keep: each thread takes one lane of the wrapper's lane
//               table (the lanes that land, sorted by address, so a warp's
//               stores are neighbours), walks its address once in 32-bit
//               arithmetic, and stores it in a slice of the images
//               (mdscatter_launch without an owner table, one kernel);
//   colliding   some lanes share an address, and which of them wins depends
//               on the device-resident mask: every active lane atomicMax-es
//               its id into an int32 owner table (one entry per destination
//               element, -1 = untouched), then only owners store, as in the
//               distinct route (mdscatter_launch with a table: a memset and
//               two kernels).
//
// Inactive lanes (at or past prod(dims), or masked off by the per-lane
// dimension mask) and addresses outside the image (after wrapping [-N, 0)
// to [0, N)) write nowhere.  The result is the same on every run.
//
// Bound: bytes.  Each stored element read once from the lanes and written
// once into the image, plus the lane mask; the colliding route also sets
// and reads its 4-byte-per-element owner table.  The batch is spread over
// enough blocks to fill every SM (mdv_fill_grid_y), each thread looping
// over a slice of it with MDV_INFLIGHT images' loads in flight.  Nothing
// here allocates or synchronises; the wrapper owns the table and the lane
// table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mdv_walk.cuh"

// ---------------------------------------------------------------------------
// contiguous: lanes [lo, lo + count) of every image land on lane + shift
// ---------------------------------------------------------------------------

// One thread per VEC consecutive lanes of the run (VEC * sizeof(T) = 16
// bytes, or VEC = 1 where the two sides are not both 16-byte aligned).
template <typename T, int VEC>
__global__ void __launch_bounds__(MDV_THREADS)
mdscatter_contig_kernel(T* __restrict__ dst, const T* __restrict__ values,
                        const uint8_t* __restrict__ mask, long long lanes,
                        long long dst_len, long long batch, long long lo,
                        long long count, long long shift) {
    const long long first =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
    if (first >= count) return;
    const long long lane = lo + first;
    const int n = count - first < VEC ? (int)(count - first) : VEC;
    unsigned keep = 0;                         // bit j: lane + j stores
#pragma unroll
    for (int j = 0; j < VEC; ++j)
        if (j < n && (mask == nullptr || mask[lane + j] != 0)) keep |= 1u << j;
    if (keep == 0) return;
    const T* src = values + lane;
    T* out = dst + lane + shift;
    const long long gy = gridDim.y;
    long long b = blockIdx.y;
    if (VEC > 1 && keep == (1u << VEC) - 1) {
        // MDV_INFLIGHT images' loads in flight before their stores
        for (; b < batch; b += MDV_INFLIGHT * gy) {
            uint4 v[MDV_INFLIGHT];
#pragma unroll
            for (int u = 0; u < MDV_INFLIGHT; ++u)
                if (b + u * gy < batch)
                    v[u] = *reinterpret_cast<const uint4*>(
                        src + (b + u * gy) * lanes);
#pragma unroll
            for (int u = 0; u < MDV_INFLIGHT; ++u)
                if (b + u * gy < batch)
                    *reinterpret_cast<uint4*>(out + (b + u * gy) * dst_len) =
                        v[u];
        }
        return;
    }
    for (; b < batch; b += gy) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            if ((keep >> j) & 1u) out[b * dst_len + j] = src[b * lanes + j];
    }
}

template <typename T>
static int launch_contig(void* dst, const void* values, const uint8_t* mask,
                         long long batch, long long dst_len, long long lanes,
                         long long lo, long long count, long long shift,
                         cudaStream_t stream) {
    constexpr int kVec = 16 / sizeof(T);
    // 16-byte accesses need the run's first element 16-byte aligned on both
    // sides in every image
    const bool vec =
        (uintptr_t)((const T*)values + lo) % 16 == 0 &&
        (uintptr_t)((T*)dst + lo + shift) % 16 == 0 &&
        (batch == 1 || (lanes * (long long)sizeof(T) % 16 == 0 &&
                        dst_len * (long long)sizeof(T) % 16 == 0));
    const long long units = vec ? (count + kVec - 1) / kVec : count;
    const unsigned bx = (unsigned)((units + MDV_THREADS - 1) / MDV_THREADS);
    const dim3 grid(bx, mdv_fill_grid_y(bx, batch));
    if (vec)
        mdscatter_contig_kernel<T, kVec><<<grid, MDV_THREADS, 0, stream>>>(
            (T*)dst, (const T*)values, mask, lanes, dst_len, batch, lo, count,
            shift);
    else
        mdscatter_contig_kernel<T, 1><<<grid, MDV_THREADS, 0, stream>>>(
            (T*)dst, (const T*)values, mask, lanes, dst_len, batch, lo, count,
            shift);
    return (int)cudaGetLastError();
}

// dst: batch images of dst_len elements, contiguous, updated in place;
// values: batch x lanes; mask: lanes bytes (non-zero = lane active) or
// null.  Lanes lo .. lo+count-1 (count > 0) store to lane + shift, which
// the caller guarantees lies in [0, dst_len).  Returns the CUDA error code
// of the launch (0 = success), or -1 for an element size no kernel is
// instantiated for.
extern "C" int mdscatter_contig_launch(void* dst, const void* values,
                                       const void* mask, long long batch,
                                       long long dst_len, long long lanes,
                                       int elem_size, long long lo,
                                       long long count, long long shift,
                                       void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* m = (const uint8_t*)mask;
    switch (elem_size) {
        case 1: return launch_contig<uint8_t>(dst, values, m, batch, dst_len, lanes, lo, count, shift, st);
        case 2: return launch_contig<uint16_t>(dst, values, m, batch, dst_len, lanes, lo, count, shift, st);
        case 4: return launch_contig<uint32_t>(dst, values, m, batch, dst_len, lanes, lo, count, shift, st);
        case 8: return launch_contig<uint64_t>(dst, values, m, batch, dst_len, lanes, lo, count, shift, st);
    }
    return -1;
}

// ---------------------------------------------------------------------------
// distinct and colliding: one thread per lane, the address walked once
// ---------------------------------------------------------------------------

// The store kernel's threads take the lanes in the order of the wrapper's
// lane table: the lanes that land in the image, sorted by address (ties in
// lane order), so a warp's stores fall on neighbouring addresses whatever
// the walk's strides; the lane values it reads are 32 KB per image and
// stay in cache.  The owner pass runs in lane order instead: there a warp's
// atomics on one address (a sorted run of colliding lanes) would queue.

// Address of an active lane, or -1 when the lane writes nowhere.  An
// address in [-dst_len, 0) lands on addr + dst_len, as the reference's
// scatters index Python-style; collisions are resolved after that wrap.
__device__ __forceinline__ long long scatter_target(
        const MdvLaneWalk& w, const uint8_t* __restrict__ mask, unsigned lane,
        unsigned active, long long dst_len) {
    if (lane >= active) return -1;
    if (mask != nullptr && mask[lane] == 0) return -1;
    long long addr = mdv_lane_address(w, lane);
    if (addr < 0) addr += dst_len;
    return (addr < 0 || addr >= dst_len) ? -1 : addr;
}

__global__ void __launch_bounds__(MDV_THREADS)
mdscatter_owner_kernel(int* __restrict__ owner, MdvLaneWalk w,
                       const uint8_t* __restrict__ mask, unsigned active,
                       long long dst_len) {
    const unsigned lane = blockIdx.x * blockDim.x + threadIdx.x;
    const long long addr = scatter_target(w, mask, lane, active, dst_len);
    if (addr >= 0) atomicMax(&owner[addr], (int)lane);
}

// owner == null: the walk is collision-free and every target stores.
template <typename T>
__global__ void __launch_bounds__(MDV_THREADS)
mdscatter_walk_kernel(T* __restrict__ dst, const T* __restrict__ values,
                      const int* __restrict__ owner, MdvLaneWalk w,
                      const int* __restrict__ order, unsigned count,
                      const uint8_t* __restrict__ mask, unsigned active,
                      long long lanes, long long dst_len, long long batch) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= count) return;
    const unsigned lane = (unsigned)order[t];
    const long long addr = scatter_target(w, mask, lane, active, dst_len);
    if (addr < 0 || (owner != nullptr && owner[addr] != (int)lane)) return;
    const T* src = values + lane;
    T* out = dst + addr;
    const long long gy = gridDim.y;
    for (long long b = blockIdx.y; b < batch; b += MDV_INFLIGHT * gy) {
        T v[MDV_INFLIGHT];
#pragma unroll
        for (int u = 0; u < MDV_INFLIGHT; ++u)
            if (b + u * gy < batch) v[u] = src[(b + u * gy) * lanes];
#pragma unroll
        for (int u = 0; u < MDV_INFLIGHT; ++u)
            if (b + u * gy < batch) out[(b + u * gy) * dst_len] = v[u];
    }
}

template <typename T>
static int launch_walk(void* dst, const void* values, const int* owner,
                       const MdvLaneWalk& w, const int* order, unsigned count,
                       const uint8_t* mask, unsigned active, long long lanes,
                       long long dst_len, long long batch,
                       cudaStream_t stream) {
    const unsigned bx = (count + MDV_THREADS - 1) / MDV_THREADS;
    const dim3 grid(bx, mdv_fill_grid_y(bx, batch));
    mdscatter_walk_kernel<T><<<grid, MDV_THREADS, 0, stream>>>(
        (T*)dst, (const T*)values, owner, w, order, count, mask, active,
        lanes, dst_len, batch);
    return (int)cudaGetLastError();
}

// dst: batch images of dst_len elements, contiguous, updated in place;
// values: batch x lanes (lanes < 2^31); owner: null for a walk on which no
// two lanes share an address, else dst_len int32 of scratch (any
// contents); order: the count (> 0) lanes that land in the image, sorted
// by address; mask: lanes bytes (non-zero = lane active) or null.  Returns
// the CUDA error code of the first failing call (0 = success), or -1 for
// an element size no kernel is instantiated for.
extern "C" int mdscatter_launch(void* dst, const void* values, void* owner,
                                const void* order, long long count,
                                const void* mask, long long batch,
                                long long dst_len, long long lanes,
                                int elem_size, int ndims,
                                long long d0, long long d1, long long d2,
                                long long d3, long long s0, long long s1,
                                long long s2, long long s3, long long base,
                                void* stream) {
    if (elem_size != 1 && elem_size != 2 && elem_size != 4 && elem_size != 8)
        return -1;
    const MdvWalk walk = mdv_make_walk(ndims, d0, d1, d2, d3, s0, s1, s2, s3,
                                       base);
    const MdvLaneWalk w = mdv_lane_walk(walk);
    const unsigned active =
        (unsigned)(lanes < walk.total ? lanes : walk.total);
    const int* ord = (const int*)order;
    const unsigned n = (unsigned)count;
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* m = (const uint8_t*)mask;
    int* own = (int*)owner;

    if (own != nullptr) {
        // every byte 0xFF = every int32 entry -1
        cudaError_t err = cudaMemsetAsync(own, 0xFF, (size_t)dst_len * 4, st);
        if (err != cudaSuccess) return (int)err;
        mdscatter_owner_kernel<<<(active + MDV_THREADS - 1) / MDV_THREADS,
                                 MDV_THREADS, 0, st>>>(own, w, m, active,
                                                       dst_len);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    switch (elem_size) {
        case 1: return launch_walk<uint8_t>(dst, values, own, w, ord, n, m, active, lanes, dst_len, batch, st);
        case 2: return launch_walk<uint16_t>(dst, values, own, w, ord, n, m, active, lanes, dst_len, batch, st);
        case 4: return launch_walk<uint32_t>(dst, values, own, w, ord, n, m, active, lanes, dst_len, batch, st);
    }
    return launch_walk<uint64_t>(dst, values, own, w, ord, n, m, active, lanes, dst_len, batch, st);
}
