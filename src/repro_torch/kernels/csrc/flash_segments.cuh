// Segment ids inside the flash kernels (flash_attention.cu,
// flash_attention_bwd.cu): the records of the segment pre-pass and what the
// kernels read of them.
//
// A call with segment ids hands every kernel the ids, int32 (B, Sq) for the
// queries and (B, Sk) for the keys, and the pre-pass's records,
// flash_seg_tiles_kernel's output: one record of FS_REC ints for each 64-row
// q tile of a row of the batch, then one for each 64-row K tile,
//
//   [least id, largest id, lo, hi, id, id, id, count]
//
// rows lo .. hi - 1 of the other side (keys for a q tile, q rows for a K
// tile) holding every pair of the two tiles that may be visible; the tile's
// distinct ids, at most FS_SLOTS of them (sorted, the least repeated in
// unused slots), and their count, FS_SLOTS + 1 where there are more (the
// slots then all hold the least).  kernels/ref.py::flash_segment_tiles_ref
// is the plain version.  A kernel loads the first four ints of a record as
// one int4.
#pragma once

#include <stdint.h>

#define FS_TILE 64                  // rows of a tile on either side
#define FS_REC 8                    // ints of a record
#define FS_SLOTS 3                  // distinct ids a record keeps

struct FsIds {
    const int* q;                   // (B, Sq), null without ids
    const int* k;                   // (B, Sk)
    const int* tiles;               // (B, nq + nk, FS_REC)
    long long nq, nk;               // 64-row tiles of Sq, Sk
};

// the first four ints of the record of q tile t / K tile t of row b
__device__ __forceinline__ int4 fs_q_rec(const FsIds& f, long long b,
                                         long long t) {
    return __ldg(reinterpret_cast<const int4*>(
        f.tiles + (b * (f.nq + f.nk) + t) * FS_REC));
}
__device__ __forceinline__ int4 fs_k_rec(const FsIds& f, long long b,
                                         long long t) {
    return __ldg(reinterpret_cast<const int4*>(
        f.tiles + (b * (f.nq + f.nk) + f.nq + t) * FS_REC));
}

// The kv tiles [lower, upper) of BK rows that a block of q tile q0 (64
// rows of row b of the batch) visits, in the forward and dQ kernels: the
// causal bound (keys up to the tile's last row's diagonal, at s.offset),
// with SEG inside it the pre-pass's range of keys.  Shape: FaShape or
// FbShape.
template <bool SEG, int BK, typename Shape>
__device__ __forceinline__ void fs_kv_range(const Shape& s, long long b,
                                            long long q0, long long& lower,
                                            long long& upper) {
    const long long nk = (s.sk + BK - 1) / BK;
    upper = nk;
    if (s.causal) {
        const long long last =
            (q0 + FS_TILE < s.sq ? q0 + FS_TILE : s.sq) - 1 + s.offset;
        upper = last < 0 ? 0 : (last / BK + 1 < nk ? last / BK + 1 : nk);
    }
    lower = 0;
    if constexpr (SEG) {
        const int4 rec = fs_q_rec(s.seg, b, q0 / FS_TILE);
        lower = rec.z / BK;
        const long long hi = (rec.w + BK - 1) / BK;
        upper = hi < upper ? hi : upper;
    }
}

// Extra shared memory of a segmented kernel for fs_rows: the block's 64
// ids and two bounds for each of its 4 warps.
#define FS_SMEM_INTS (FS_TILE + 8)

// The ids of rows row0 .. row0 + 63 of one row of the batch (ids, n rows)
// into ids_s (0 past n), then the least and largest id over each warp's
// valid rows into wb_s[2 * warp], wb_s[2 * warp + 1] (lo > hi for a warp
// with none, which meets no interval).  Called by the whole block (a
// barrier); the ids stay in shared memory, not in registers, which the
// tensor-core loops need.
__device__ __forceinline__ void fs_rows(int* ids_s, int* wb_s,
                                        const int* ids, long long n,
                                        long long row0, int tid) {
    if (tid < FS_TILE) ids_s[tid] = row0 + tid < n ? ids[row0 + tid] : 0;
    __syncthreads();
    const int lane = tid & 31, r = (tid >> 5) * 16 + (lane & 15);
    const bool valid = row0 + r < n;
    int lo = valid ? ids_s[r] : 0x7fffffff;
    int hi = valid ? ids_s[r] : (int)0x80000000;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
        wb_s[2 * (tid >> 5)] = lo;
        wb_s[2 * (tid >> 5) + 1] = hi;
    }
}

// A warp (its bounds wb[0], wb[1]) against a tile whose record is r (ids
// r.x .. r.y): whether it may see the tile (the intervals meet), and
// whether the tile crosses a segment edge for it (not one id on both
// sides), so that its pairs need the per-pair test of the ids.
__device__ __forceinline__ void fs_warp_tile(const int* wb, const int4& r,
                                             bool& sees, bool& split) {
    const int lo = wb[0], hi = wb[1];
    sees = sees && lo <= r.y && r.x <= hi;
    split = !(lo == hi && r.x == r.y && lo == r.x);
}
