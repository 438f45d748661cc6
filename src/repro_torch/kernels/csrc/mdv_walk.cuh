// Shared address walk of the MVE multi-dimensional strided access
// (Algorithm 1): lane l < prod(dims) peels idx_d = rem % dims[d],
// rem /= dims[d] with dimension 0 fastest, and lands on
// base + sum_d idx_d * strides[d].  64-bit throughout: strides come from
// control registers and may be negative or large.
#pragma once

#define MDV_MAX_DIMS 4
#define MDV_THREADS 256

struct MdvWalk {
    long long dims[MDV_MAX_DIMS];
    long long strides[MDV_MAX_DIMS];
    long long base;
    long long total;   // prod(dims): lanes at or past it are inactive
    int ndims;
};

__device__ __forceinline__ long long mdv_address(const MdvWalk& w,
                                                 long long lane) {
    long long rem = lane;
    long long addr = w.base;
#pragma unroll
    for (int d = 0; d < MDV_MAX_DIMS; ++d) {
        if (d < w.ndims) {
            const long long len = w.dims[d];
            const long long idx = rem % len;
            rem = rem / len;
            addr += idx * w.strides[d];
        }
    }
    return addr;
}

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

// The batch axis rides on gridDim.y, which the hardware caps at 65535;
// larger batches loop inside the block.
static inline unsigned mdv_grid_y(long long batch) {
    return (unsigned)(batch < 65535 ? batch : 65535);
}
