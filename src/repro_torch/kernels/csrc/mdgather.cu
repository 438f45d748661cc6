// MVE `vsld` for Hopper: multi-dimensional strided gather.
//
// Replaces the TPU kernel repro/kernels/mdgather.py::_gather_kernel.  There
// one grid step fills an (8,128) lane tile from a VMEM-resident source.  A
// load's walk (dims, strides, base, image length, lane count) is static, so
// the wrapper (kernels/mdgather.py::load_plan) classifies each walk once on
// the host and picks one of three routes of one entry point:
//
//   contiguous  lane l reads base + l and every such address lies in the
//               image: a copy of that run of every image, 16 bytes per
//               thread where both sides are aligned, the lanes at or past
//               prod(dims) zero-filled by the same kernel
//               (mdgather_contig_kernel);
//   walk        any other walk: each thread takes one lane, peels its
//               address once in 32-bit arithmetic, clamps it once, and
//               moves that lane of a slice of the images
//               (mdgather_walk_kernel).  The replicating walks (a stride-0
//               dimension) read a few cached lines and write whole lines;
//   tiled       dimension 0 strides over the image and another dimension
//               has stride +-1: a lane-ordered warp would read 32 scattered
//               sectors, so a block stages a 1024-element tile of each
//               image in shared memory (up to 32 columns along the
//               unit-stride dimension, as many as it has), read along that
//               dimension and written along the lanes, both coalesced
//               (mdgather_tiled_kernel).
//
// Every route computes what the TPU kernel does, bit for bit, with the
// reference executors' clamp: addresses are clamped into [0, N) (the
// Pallas kernel in interpret mode wraps a negative one instead; ROADMAP
// C5), lanes at or past prod(dims) give 0, and elements are moved as bits,
// by size, so one kernel serves every memory and register type.
//
// Bound: bytes.  Each needed distinct source element read once and
// batch * lanes * elem written; there is no arithmetic on the data.  The
// walk is paid per lane, not per (lane, image): a thread walks once and
// loops over a slice of the batch with MDV_INFLIGHT images' loads in
// flight, the batch spread over enough blocks to fill every SM
// (mdv_fill_grid_y).  The copy moves whole 16-byte units; the tile reads
// whole row segments, but a segment that starts off a 64-byte boundary
// (the transpose pattern's rows are 49 elements long) still costs about
// twice its bytes in memory bursts; the replicating walks write whole lines
// and read a few.  At one image the launch dominates.  Nothing here
// allocates or synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mdv_walk.cuh"

// Moves one element (or one 16-byte unit) of every image in this block's
// slice of the batch: out[b * out_stride] = live ? in[b * in_stride] : 0,
// with MDV_INFLIGHT images' loads in flight before their stores.
template <typename U>
__device__ __forceinline__ void copy_batch(const U* __restrict__ in,
                                           long long in_stride,
                                           U* __restrict__ out,
                                           long long out_stride, bool live,
                                           long long batch) {
    const long long gy = gridDim.y;
    for (long long b = blockIdx.y; b < batch; b += MDV_INFLIGHT * gy) {
        U v[MDV_INFLIGHT];
#pragma unroll
        for (int u = 0; u < MDV_INFLIGHT; ++u)
            if (b + u * gy < batch)
                v[u] = live ? in[(b + u * gy) * in_stride] : U{};
#pragma unroll
        for (int u = 0; u < MDV_INFLIGHT; ++u)
            if (b + u * gy < batch) out[(b + u * gy) * out_stride] = v[u];
    }
}

// ---------------------------------------------------------------------------
// contiguous: lanes [0, count) read base + lane, lanes [count, lanes) are 0
// ---------------------------------------------------------------------------

// One thread per VEC consecutive lanes (VEC * sizeof(T) = 16 bytes, or
// VEC = 1 where the two sides are not both 16-byte aligned).
template <typename T, int VEC>
__global__ void __launch_bounds__(MDV_THREADS)
mdgather_contig_kernel(const T* __restrict__ src, T* __restrict__ out,
                       long long src_len, long long batch, long long lanes,
                       long long base, long long count) {
    const long long first =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
    if (first >= lanes) return;
    const T* in = src + base + first;       // dereferenced below count only
    T* dst = out + first;
    if (VEC > 1 && first + VEC <= lanes &&
        (first + VEC <= count || first >= count)) {
        // a whole unit, copied or (past count) zero
        copy_batch(reinterpret_cast<const uint4*>(in), src_len / VEC,
                   reinterpret_cast<uint4*>(dst), lanes / VEC, first < count,
                   batch);
        return;
    }
    // element by element: every lane when VEC = 1, else the one unit that
    // straddles count or the end of the register
    const int n = lanes - first < VEC ? (int)(lanes - first) : VEC;
    for (int j = 0; j < n; ++j)
        copy_batch(in + j, src_len, dst + j, lanes, first + j < count, batch);
}

template <typename T>
static int launch_contig(const void* src, void* out, long long batch,
                         long long src_len, long long lanes, long long base,
                         long long count, cudaStream_t stream) {
    constexpr int kVec = 16 / sizeof(T);
    // 16-byte accesses need the run's first element 16-byte aligned on both
    // sides in every image
    const bool vec =
        (uintptr_t)((const T*)src + base) % 16 == 0 &&
        (uintptr_t)out % 16 == 0 &&
        (batch == 1 || (src_len * (long long)sizeof(T) % 16 == 0 &&
                        lanes * (long long)sizeof(T) % 16 == 0));
    const long long units = vec ? (lanes + kVec - 1) / kVec : lanes;
    const unsigned bx = (unsigned)((units + MDV_THREADS - 1) / MDV_THREADS);
    const dim3 grid(bx, mdv_fill_grid_y(bx, batch));
    if (vec)
        mdgather_contig_kernel<T, kVec><<<grid, MDV_THREADS, 0, stream>>>(
            (const T*)src, (T*)out, src_len, batch, lanes, base, count);
    else
        mdgather_contig_kernel<T, 1><<<grid, MDV_THREADS, 0, stream>>>(
            (const T*)src, (T*)out, src_len, batch, lanes, base, count);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// walk: one thread per lane, the address walked once
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long clamped_address(const MdvLaneWalk& w,
                                                     unsigned lane,
                                                     long long src_len) {
    const long long addr = mdv_lane_address(w, lane);
    return addr < 0 ? 0 : (addr >= src_len ? src_len - 1 : addr);
}

template <typename T>
__global__ void __launch_bounds__(MDV_THREADS)
mdgather_walk_kernel(const T* __restrict__ src, T* __restrict__ out,
                     MdvLaneWalk w, unsigned active, long long src_len,
                     long long batch, long long lanes) {
    const unsigned lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const bool live = lane < active;
    const long long addr = live ? clamped_address(w, lane, src_len) : 0;
    copy_batch(src + addr, src_len, out + lane, lanes, live, batch);
}

template <typename T>
static int launch_walk(const void* src, void* out, const MdvLaneWalk& w,
                       unsigned active, long long batch, long long src_len,
                       long long lanes, cudaStream_t stream) {
    const unsigned bx = (unsigned)((lanes + MDV_THREADS - 1) / MDV_THREADS);
    const dim3 grid(bx, mdv_fill_grid_y(bx, batch));
    mdgather_walk_kernel<T><<<grid, MDV_THREADS, 0, stream>>>(
        (const T*)src, (T*)out, w, active, src_len, batch, lanes);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled: a tile of (dimension 0, unit-stride dimension k) per block
// ---------------------------------------------------------------------------

#define MDV_TILE_ELEMS 1024     // a tile: tc columns (along k) x 1024 / tc rows
#define MDV_TILE_PER_THREAD (MDV_TILE_ELEMS / MDV_THREADS)         // 4
#define MDV_TILE_MIN_TC 4       // so a tile has at most 256 rows
#define MDV_TILE_IMAGES 4       // images staged per round: 16 loads a thread

// Lane of the walk tuple (a along dimension 0, c along dimension k, the
// dimensions between them at lo, those after at hi):
// a + d0 * (lo + p * (c + dk * hi)).  Every tuple is a lane (the plan
// takes this route only when prod(dims) <= lanes).
struct MdvTile {
    unsigned d0, dk, p;         // p = prod(dims[1 .. k-1])
    unsigned tc, ta;            // tile columns (a power of 2 <= 32), rows
    unsigned n0, nk;            // tiles along dimensions 0 and k
    unsigned tiles;             // n0 * nk * p * prod(dims[k+1 ..])
};

// Blocks past t.tiles zero the lanes [active, lanes).  Element e of a tile
// lies at row e / tc, column e % tc when it is read (neighbouring threads
// on neighbouring addresses: along k) and at row e % ta, column e / ta when
// it is written (neighbouring threads on neighbouring lanes: along
// dimension 0); shared memory rows are padded to tc + 1 against bank
// conflicts.
template <typename T>
__global__ void __launch_bounds__(MDV_THREADS)
mdgather_tiled_kernel(const T* __restrict__ src, T* __restrict__ out,
                      MdvLaneWalk w, MdvTile t, unsigned active,
                      long long src_len, long long batch, long long lanes) {
    constexpr int kPadded =
        MDV_TILE_ELEMS + MDV_TILE_ELEMS / MDV_TILE_MIN_TC;
    __shared__ T tile[MDV_TILE_IMAGES][kPadded];
    if (blockIdx.x >= t.tiles) {
        const long long lane = active +
            (long long)(blockIdx.x - t.tiles) * MDV_THREADS + threadIdx.x;
        if (lane < lanes)
            copy_batch(src, src_len, out + lane, lanes, false, batch);
        return;
    }
    unsigned rest = blockIdx.x;
    const unsigned a0 = rest % t.n0 * t.ta;
    rest /= t.n0;
    const unsigned c0 = rest % t.nk * t.tc;
    rest /= t.nk;
    const unsigned lo = rest % t.p, hi = rest / t.p;
    long long raddr[MDV_TILE_PER_THREAD];
    unsigned rslot[MDV_TILE_PER_THREAD], wslot[MDV_TILE_PER_THREAD];
    unsigned wlane[MDV_TILE_PER_THREAD];
    bool rlive[MDV_TILE_PER_THREAD], wlive[MDV_TILE_PER_THREAD];
#pragma unroll
    for (int r = 0; r < MDV_TILE_PER_THREAD; ++r) {
        const unsigned e = threadIdx.x + r * MDV_THREADS;
        unsigned ra = e / t.tc, rc = e % t.tc;
        unsigned a = a0 + ra, c = c0 + rc;
        rlive[r] = a < t.d0 && c < t.dk;
        const unsigned rlane =
            rlive[r] ? a + t.d0 * (lo + t.p * (c + t.dk * hi)) : 0;
        rlive[r] = rlive[r] && rlane < active;
        raddr[r] = rlive[r] ? clamped_address(w, rlane, src_len) : 0;
        rslot[r] = ra * (t.tc + 1) + rc;
        ra = e % t.ta;
        rc = e / t.ta;
        a = a0 + ra;
        c = c0 + rc;
        wlive[r] = a < t.d0 && c < t.dk;
        wlane[r] = wlive[r] ? a + t.d0 * (lo + t.p * (c + t.dk * hi)) : 0;
        wlive[r] = wlive[r] && wlane[r] < active;
        wslot[r] = ra * (t.tc + 1) + rc;
    }
    const long long gy = gridDim.y;
    for (long long b = blockIdx.y; b < batch; b += MDV_TILE_IMAGES * gy) {
        T v[MDV_TILE_IMAGES][MDV_TILE_PER_THREAD];
#pragma unroll
        for (int m = 0; m < MDV_TILE_IMAGES; ++m)
#pragma unroll
            for (int r = 0; r < MDV_TILE_PER_THREAD; ++r)
                v[m][r] = (b + m * gy < batch && rlive[r])
                              ? src[(b + m * gy) * src_len + raddr[r]]
                              : T(0);
#pragma unroll
        for (int m = 0; m < MDV_TILE_IMAGES; ++m)
#pragma unroll
            for (int r = 0; r < MDV_TILE_PER_THREAD; ++r)
                tile[m][rslot[r]] = v[m][r];
        __syncthreads();
#pragma unroll
        for (int m = 0; m < MDV_TILE_IMAGES; ++m)
#pragma unroll
            for (int r = 0; r < MDV_TILE_PER_THREAD; ++r)
                if (b + m * gy < batch && wlive[r])
                    out[(b + m * gy) * lanes + wlane[r]] = tile[m][wslot[r]];
        __syncthreads();
    }
}

template <typename T>
static int launch_tiled(const void* src, void* out, const MdvWalk& walk,
                        const MdvLaneWalk& w, int unit, unsigned active,
                        long long batch, long long src_len, long long lanes,
                        cudaStream_t stream) {
    MdvTile t;
    long long p = 1, h = 1;
    for (int d = 1; d < unit; ++d) p *= walk.dims[d];
    for (int d = unit + 1; d < MDV_MAX_DIMS; ++d) h *= walk.dims[d];
    t.d0 = (unsigned)walk.dims[0];
    t.dk = (unsigned)walk.dims[unit];
    t.p = (unsigned)p;
    // as many columns as dimension k has, up to a warp's 32
    t.tc = MDV_TILE_MIN_TC;
    while (t.tc < 32 && t.tc < t.dk) t.tc *= 2;
    t.ta = MDV_TILE_ELEMS / t.tc;
    t.n0 = (t.d0 + t.ta - 1) / t.ta;
    t.nk = (t.dk + t.tc - 1) / t.tc;
    t.tiles = (unsigned)((long long)t.n0 * t.nk * p * h);
    const long long tail = lanes - active;
    const unsigned bx =
        t.tiles + (unsigned)((tail + MDV_THREADS - 1) / MDV_THREADS);
    const dim3 grid(bx, mdv_fill_grid_y(bx, batch));
    mdgather_tiled_kernel<T><<<grid, MDV_THREADS, 0, stream>>>(
        (const T*)src, (T*)out, w, t, active, src_len, batch, lanes);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <typename T>
static int launch(int route, const void* src, void* out, const MdvWalk& walk,
                  int unit, long long batch, long long src_len,
                  long long lanes, cudaStream_t stream) {
    const unsigned active =
        (unsigned)(lanes < walk.total ? lanes : walk.total);
    if (route == 0)
        return launch_contig<T>(src, out, batch, src_len, lanes, walk.base,
                                active, stream);
    const MdvLaneWalk w = mdv_lane_walk(walk);
    if (route == 1)
        return launch_walk<T>(src, out, w, active, batch, src_len, lanes,
                              stream);
    return launch_tiled<T>(src, out, walk, w, unit, active, batch, src_len,
                           lanes, stream);
}

// One walk's launch arguments, packed once per walk by the wrapper
// (kernels/mdgather.py::_Plan, the same layout) so that a call passes one
// pointer in place of a dozen integers.  route: 0 contiguous (the wrapper
// guarantees lane l < min(lanes, prod(dims)) reads base + l inside the
// image), 1 walk, 2 tiled along dimension `unit` (dimension 0 and `unit` as
// the plan chose them, prod(dims) <= lanes).  Dimensions past ndims are 1
// with stride 0.
struct MdgatherPlan {
    long long src_len, lanes;       // image length; 0 < lanes < 2^31
    long long dims[MDV_MAX_DIMS], strides[MDV_MAX_DIMS], base;
    int route, ndims, unit;
};

// src: batch images of plan->src_len elements, contiguous; out: batch x
// plan->lanes.  Returns the CUDA error code of the launch (0 = success), or
// -1 for an element size or route no kernel is instantiated for.
extern "C" int mdgather_launch(const void* src, void* out, long long batch,
                               int elem_size, const MdgatherPlan* plan,
                               void* stream) {
    const MdgatherPlan& p = *plan;
    if (p.route < 0 || p.route > 2) return -1;
    const MdvWalk w = mdv_make_walk(p.ndims, p.dims[0], p.dims[1], p.dims[2],
                                    p.dims[3], p.strides[0], p.strides[1],
                                    p.strides[2], p.strides[3], p.base);
    cudaStream_t st = (cudaStream_t)stream;
    switch (elem_size) {
        case 1: return launch<uint8_t>(p.route, src, out, w, p.unit, batch, p.src_len, p.lanes, st);
        case 2: return launch<uint16_t>(p.route, src, out, w, p.unit, batch, p.src_len, p.lanes, st);
        case 4: return launch<uint32_t>(p.route, src, out, w, p.unit, batch, p.src_len, p.lanes, st);
        case 8: return launch<uint64_t>(p.route, src, out, w, p.unit, batch, p.src_len, p.lanes, st);
    }
    return -1;
}
