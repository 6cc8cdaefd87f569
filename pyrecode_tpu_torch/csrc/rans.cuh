// What the interleaved-rANS kernels share: the format's constants and a
// block-wide exclusive scan.
//
// The scheme-12 format (codecs/rans.py): 12-bit quantized probabilities
// (the frequencies of a stream sum to 4096), states in [2^23, 2^31), byte
// renormalisation, symbols < 4096, and nways = 1024 or 8192 interleaved
// states: symbol i belongs to lane i % nways.  The decode's block codes
// one stream; the encode spreads a stream's lanes over several blocks and
// scans with block_exclusive_scan once a row, in its placing pass.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int RANS_THREADS = 1024;
constexpr int RANS_ALPHABET = 4096;
constexpr int RANS_PROB_BITS = 12;
constexpr uint32_t RANS_L = 1u << 23;
// encode: a lane emits while x >= f << 19, i.e. x >= ((RANS_L >> 12) << 8) * f
constexpr int RANS_XMAX_SHIFT = 19;

// Exclusive prefix of v over a block of THREADS threads in thread order,
// and the block total.  warp_sums is a __shared__ int[THREADS / 32]; every
// thread must call, and the call ends with the array free for the next one.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
    constexpr int WARPS = THREADS / 32;
    static_assert(THREADS % 32 == 0 && WARPS <= 32, "the scan's second level is one warp");
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int incl = warp_inclusive_scan(v);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int s = warp_inclusive_scan(lane < WARPS ? warp_sums[lane] : 0);
        if (lane < WARPS) warp_sums[lane] = s;
    }
    __syncthreads();
    const int excl = incl - v + (warp > 0 ? warp_sums[warp - 1] : 0);
    *total = warp_sums[WARPS - 1];
    __syncthreads();
    return excl;
}

}  // namespace
