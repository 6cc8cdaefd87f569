// What the deflate tokenize and assemble kernels share: the tile each block
// walks, the token encoding, and block-wide reductions and scans over one
// value per thread for blocks of BLOCK threads (common.cuh).  Each
// reduction or scan takes WARPS elements of the caller's shared memory as
// scratch and may be called again with the same scratch: it synchronises
// the block before it returns.
#pragma once

#include "common.cuh"

namespace {

// Stream bytes (tokenize) or tokens (assemble) per block; each thread owns
// TILE_PER_THREAD consecutive ones.
constexpr int TILE = 4096;
constexpr int TILE_PER_THREAD = TILE / BLOCK;
// Token LUT index: 0..255 a literal, 256..511 a distance-1 match of take
// 3..258; tokens travel inverted, NO_TOKEN - index, so that 0 is no token.
constexpr int NO_TOKEN = 512;

static_assert(TILE % BLOCK == 0, "a thread owns whole elements of its tile");

__host__ __device__ inline int64_t deflate_tiles(int64_t n) { return (n + TILE - 1) / TILE; }

struct MaxOp {
    template <class T>
    __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};

struct MinOp {
    template <class T>
    __device__ __forceinline__ T operator()(T a, T b) const { return a < b ? a : b; }
};

struct SumOp {
    template <class T>
    __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

// op over every thread's v, returned to every thread.
template <class T, class Op>
__device__ T block_all_reduce(T v, Op op, T* scratch) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    T r = scratch[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r = op(r, scratch[w]);
    __syncthreads();
    return r;
}

// Exclusive scan: thread t gets op over the v of threads < t (kForward) or
// of threads > t (!kForward); identity where there are none.
template <bool kForward, class T, class Op>
__device__ T block_exclusive_scan(T v, Op op, T identity, T* scratch) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T y = kForward ? __shfl_up_sync(kFullMask, x, d) : __shfl_down_sync(kFullMask, x, d);
        if (kForward ? lane >= d : lane + d < 32) x = op(x, y);
    }
    if (lane == (kForward ? 31 : 0)) scratch[warp] = x;
    __syncthreads();
    T excl = kForward ? __shfl_up_sync(kFullMask, x, 1) : __shfl_down_sync(kFullMask, x, 1);
    if (lane == (kForward ? 0 : 31)) excl = identity;
    T across = identity;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (kForward ? w < warp : w > warp) across = op(across, scratch[w]);
    }
    __syncthreads();
    return op(across, excl);
}

}  // namespace
