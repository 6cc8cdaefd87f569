// The butterfly left-pack probe: a stable compaction of each row's
// foreground values by an LSB-first log-shift ladder, in the four
// formulations of tools/probe_butterfly.py (replaces its kernel,
// pl.pallas_call at probe_butterfly.py:127).
//
// The TPU question was which formulation Mosaic miscompiled: the packed
// (dist << 16) | value carry with an add merge diverged on v5e at >= 25%
// foreground.  On the card the question is only whether each formulation
// is exact.  One block a row, the row in shared memory (two arrays for
// two_array); the prelude is a block scan of the mask, whose exclusive
// prefix is the rank, and dist = lane - rank at foreground lanes; then
// log2(sub) stages k = 1, 2, 4, ..., each reading the moved words of lane
// (i + k) % sub (pltpu.roll(x, sub - k, axis=1)), a __syncthreads() between
// a stage's move and its merge.  The work is a few integer operations per
// word of a row held in shared memory, bound by the stages' barriers.

#include "common.cuh"

namespace {

enum Variant { PACKED_ADD = 0, PACKED_OR = 1, TWO_ARRAY = 2, SELECT_MERGE = 3 };

// Exclusive prefix over the block of one int a thread (blockDim.x a
// multiple of 32, at most 1024).  Called once per kernel.
__device__ __forceinline__ int block_exclusive_scan(int x) {
    __shared__ int warp_sums[32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int incl = warp_inclusive_scan(x);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
        warp_sums[lane] = warp_inclusive_scan(v);
    }
    __syncthreads();
    return (warp > 0 ? warp_sums[warp - 1] : 0) + incl - x;
}

template <int V>
__global__ void butterfly_kernel(const int32_t* __restrict__ mask,
                                 const int32_t* __restrict__ vals, int32_t* __restrict__ out,
                                 int sub) {
    extern __shared__ int32_t sh[];
    int32_t* carry = sh;             // the packed carry (two_array: the values)
    int32_t* moved = sh + sub;       // what moves at this stage
    int32_t* dist = sh + 2 * sub;    // two_array: the distances
    int32_t* dmoved = sh + 3 * sub;  // two_array: the distances that move
    const int64_t row = blockIdx.x;
    const int32_t* m = mask + row * sub;
    const int32_t* v = vals + row * sub;
    const int per = sub / static_cast<int>(blockDim.x);
    const int first = threadIdx.x * per;

    int local = 0;
    for (int j = 0; j < per; ++j) local += m[first + j] > 0;
    int rank = block_exclusive_scan(local);   // foreground lanes before `first`
    for (int j = 0; j < per; ++j) {
        const int i = first + j;
        const bool fg = m[i] > 0;
        const int d = fg ? i - rank : 0;
        rank += fg;
        if constexpr (V == TWO_ARRAY) {
            carry[i] = fg ? v[i] : 0;
            dist[i] = d;
        } else {
            carry[i] = fg ? ((d << 16) | (v[i] & 0xFFFF)) : 0;
        }
    }
    __syncthreads();

    for (int k = 1; k < sub; k <<= 1) {
        for (int i = threadIdx.x; i < sub; i += blockDim.x) {
            const int32_t c = carry[i];
            if constexpr (V == TWO_ARRAY) {
                const bool mv = (dist[i] & k) != 0;
                moved[i] = mv ? c : 0;
                dmoved[i] = mv ? dist[i] - k : 0;
                if (mv) {
                    carry[i] = 0;
                    dist[i] = 0;
                }
            } else {
                const bool mv = ((c >> 16) & k) != 0;
                moved[i] = mv ? c - (k << 16) : 0;
                if (mv) carry[i] = 0;
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < sub; i += blockDim.x) {
            const int src = (i + k) & (sub - 1);
            const int32_t inc = moved[src];
            const int32_t stay = carry[i];
            if constexpr (V == PACKED_ADD) {
                carry[i] = stay + inc;
            } else if constexpr (V == PACKED_OR) {
                carry[i] = stay | inc;
            } else if constexpr (V == SELECT_MERGE) {
                carry[i] = inc != 0 ? inc : stay;
            } else {
                carry[i] = stay + inc;
                dist[i] += dmoved[src];
            }
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < sub; i += blockDim.x) out[row * sub + i] = carry[i] & 0xFFFF;
}

template <int V>
void launch_butterfly(const void* mask, const void* vals, void* out, int64_t rows, int sub,
                      cudaStream_t s) {
    const int threads = sub < 1024 ? sub : 1024;
    const size_t smem = (V == TWO_ARRAY ? 4 : 2) * static_cast<size_t>(sub) * sizeof(int32_t);
    butterfly_kernel<V><<<static_cast<unsigned>(rows), threads, smem, s>>>(
        static_cast<const int32_t*>(mask), static_cast<const int32_t*>(vals),
        static_cast<int32_t*>(out), sub);
}

}  // namespace

// mask, vals (rows, sub) i32 -> out (rows, sub) i32: each row's values at
// foreground lanes (mask > 0) packed to the row's front in lane order,
// zeros behind, each & 0xFFFF; variant 0 packed_add, 1 packed_or, 2
// two_array, 3 select_merge.  sub a power of two in 32..2048; values below
// 2**16.  Returns cudaGetLastError().
extern "C" int pr_probe_butterfly(const void* mask, const void* vals, void* out, int variant,
                                  int64_t rows, int64_t sub, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n = static_cast<int>(sub);
    switch (variant) {
        case PACKED_ADD: launch_butterfly<PACKED_ADD>(mask, vals, out, rows, n, s); break;
        case PACKED_OR: launch_butterfly<PACKED_OR>(mask, vals, out, rows, n, s); break;
        case TWO_ARRAY: launch_butterfly<TWO_ARRAY>(mask, vals, out, rows, n, s); break;
        case SELECT_MERGE: launch_butterfly<SELECT_MERGE>(mask, vals, out, rows, n, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
