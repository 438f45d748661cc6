// Shared address walk of the MVE multi-dimensional strided access
// (Algorithm 1): lane l < prod(dims) peels idx_d = rem % dims[d],
// rem /= dims[d] with dimension 0 fastest, and lands on
// base + sum_d idx_d * strides[d].  Addresses are 64-bit: strides come
// from control registers and may be negative or large.  mdv_lane_address
// peels a lane id that fits in 32 bits in 32-bit arithmetic (a 64-bit % or
// / is a software routine of dozens of instructions) and forms only the
// address sum in 64 bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MDV_MAX_DIMS 4
#define MDV_THREADS 256
// images a thread loads before it stores them (its slice of the batch is
// about batch / gridDim.y images: 8 for 1024 images on 132 SMs)
#define MDV_INFLIGHT 8

struct MdvWalk {
    long long dims[MDV_MAX_DIMS];
    long long strides[MDV_MAX_DIMS];
    long long base;
    long long total;   // prod(dims): lanes at or past it are inactive
    int ndims;
};

static inline MdvWalk mdv_make_walk(int ndims, long long d0, long long d1,
                                    long long d2, long long d3,
                                    long long s0, long long s1,
                                    long long s2, long long s3,
                                    long long base) {
    MdvWalk w;
    const long long dims[MDV_MAX_DIMS] = {d0, d1, d2, d3};
    const long long strides[MDV_MAX_DIMS] = {s0, s1, s2, s3};
    w.ndims = ndims;
    w.base = base;
    w.total = 1;
    for (int d = 0; d < MDV_MAX_DIMS; ++d) {
        w.dims[d] = d < ndims ? dims[d] : 1;
        w.strides[d] = d < ndims ? strides[d] : 0;
        w.total *= w.dims[d];
    }
    return w;
}

// The walk for lane ids below 2^31: a dimension longer than that is
// clamped to 2^32 - 1, which peels such a lane id exactly as its full
// length does (idx = rem, rem = 0).
struct MdvLaneWalk {
    unsigned dims[MDV_MAX_DIMS];
    long long strides[MDV_MAX_DIMS];
    long long base;
    int ndims;
};

static inline MdvLaneWalk mdv_lane_walk(const MdvWalk& w) {
    MdvLaneWalk lw;
    for (int d = 0; d < MDV_MAX_DIMS; ++d) {
        lw.dims[d] = (unsigned)(w.dims[d] < 0xFFFFFFFFLL ? w.dims[d]
                                                         : 0xFFFFFFFFLL);
        lw.strides[d] = w.strides[d];
    }
    lw.base = w.base;
    lw.ndims = w.ndims;
    return lw;
}

__device__ __forceinline__ long long mdv_lane_address(const MdvLaneWalk& w,
                                                      unsigned lane) {
    unsigned rem = lane;
    long long addr = w.base;
#pragma unroll
    for (int d = 0; d < MDV_MAX_DIMS; ++d) {
        if (d < w.ndims) {
            const unsigned len = w.dims[d];
            addr += (long long)(rem % len) * w.strides[d];
            rem /= len;
        }
    }
    return addr;
}

// Blocks along y for a kernel whose threads each loop over a slice of the
// batch: enough (x, y) blocks to fill every SM of the current device with
// MDV_BLOCKS_PER_SM blocks, and never more than the batch (or 65535).
#define MDV_BLOCKS_PER_SM 8     // 8 x 256 threads = an SM's 2048
static inline unsigned mdv_fill_grid_y(unsigned blocks_x, long long batch) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || sms <= 0) {
            (void)cudaGetLastError();   // not the launch's error to report
            sms = 132;                  // an H100 SXM
        }
    }
    const long long want = ((long long)sms * MDV_BLOCKS_PER_SM + blocks_x - 1)
                           / blocks_x;
    long long y = want < batch ? want : batch;
    y = y < 65535 ? y : 65535;
    return (unsigned)(y < 1 ? 1 : y);
}
