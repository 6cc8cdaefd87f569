// Device helpers shared by the L1 encode and decode kernels.
//
// A frame of n_pixels pixels is cut into 32-pixel "words": word w covers
// pixels [32w, 32w + 32) and bitmap bytes [4w, 4w + 4), and its bitmap bits
// read as one little-endian u32 are exactly the foreground flags of those
// pixels, LSB first.  A tile is the TILE_WORDS words one block of BLOCK
// threads walks: each of its WARPS warps owns WORDS_PER_WARP consecutive
// words.  Tile counts are scanned by one block per frame (scan_tiles_kernel)
// into the global offset of each tile's first foreground pixel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int WORDS_PER_WARP = 16;
constexpr int TILE_WORDS = WARPS * WORDS_PER_WARP;
constexpr int TILE_PIXELS = TILE_WORDS * 32;
constexpr int SCAN_BLOCK = 1024;

static_assert(WORDS_PER_WARP <= 32, "one lane loads one word");
static_assert(SCAN_BLOCK / 32 == 32, "the scan's second level is one warp");

__host__ __device__ inline int64_t num_tiles(int64_t n_pixels) {
    int64_t n_words = (n_pixels + 31) / 32;
    return (n_words + TILE_WORDS - 1) / TILE_WORDS;
}

// Bitmap bits of pixels [32*word, 32*word + 32) of one frame's bitmap row,
// LSB first; bits at or past n_pixels read as 0.
__device__ __forceinline__ uint32_t load_bitmap_word(const uint8_t* row, int64_t n_bytes,
                                                     int64_t n_pixels, int64_t word) {
    int64_t valid = n_pixels - word * 32;
    if (valid <= 0) return 0u;
    int64_t byte0 = word * 4;
    uint32_t w = 0u;
    if (byte0 + 4 <= n_bytes && (reinterpret_cast<uintptr_t>(row + byte0) & 3u) == 0u) {
        w = *reinterpret_cast<const uint32_t*>(row + byte0);
    } else {
        for (int k = 0; k < 4; ++k) {
            if (byte0 + k < n_bytes) w |= static_cast<uint32_t>(row[byte0 + k]) << (8 * k);
        }
    }
    if (valid < 32) w &= (1u << valid) - 1u;
    return w;
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
    int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(kFullMask, x, d);
        if (lane >= d) x += y;
    }
    return x;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    return v;
}

// The block writes zeros into out[from, to), 16-byte stores where the row's
// alignment allows.
__device__ __forceinline__ void block_zero_range(int32_t* out, int64_t from, int64_t to) {
    if (from >= to) return;
    int64_t head = from;
    while (head < to && (reinterpret_cast<uintptr_t>(out + head) & 15u) != 0) ++head;
    const int64_t n4 = (to - head) / 4;
    for (int64_t i = from + threadIdx.x; i < head; i += blockDim.x) out[i] = 0;
    int4* vec = reinterpret_cast<int4*>(out + head);
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) vec[i] = make_int4(0, 0, 0, 0);
    for (int64_t i = head + 4 * n4 + threadIdx.x; i < to; i += blockDim.x) out[i] = 0;
}

// The calling warp's WORDS_PER_WARP words starting at first_word: lane j
// holds word j and the number of set bits in words [0, j); every lane gets
// the warp's total.
struct WarpWords {
    uint32_t word;
    int excl;
    int total;
};

__device__ __forceinline__ WarpWords warp_words(const uint8_t* row, int64_t n_bytes,
                                                int64_t n_pixels, int64_t first_word) {
    int lane = threadIdx.x & 31;
    uint32_t w = lane < WORDS_PER_WARP
                     ? load_bitmap_word(row, n_bytes, n_pixels, first_word + lane)
                     : 0u;
    int c = __popc(w);
    int incl = warp_inclusive_scan(c);
    return {w, incl - c, __shfl_sync(kFullMask, incl, 31)};
}

// Exclusive prefix of the warp-uniform value v over the block's warps, and
// the block total.  Called once per kernel (its shared array is not reused).
__device__ __forceinline__ int block_warp_prefix(int v, int* block_total) {
    __shared__ int sums[WARPS];
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    if (lane == 0) sums[warp] = v;
    __syncthreads();
    int excl = 0;
    int total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        int s = sums[i];
        if (i < warp) excl += s;
        total += s;
    }
    *block_total = total;
    return excl;
}

// One block per frame: tiles (B, n_tiles) of per-tile counts become their
// exclusive prefix, in place; totals[b] is the frame's count and
// overflow[b] = (capacity >= 0 && total > capacity).
__global__ void scan_tiles_kernel(int* tiles, int64_t n_tiles, int* totals, uint8_t* overflow,
                                  int64_t capacity) {
    __shared__ int warp_sums[SCAN_BLOCK / 32];
    int* row = tiles + static_cast<int64_t>(blockIdx.x) * n_tiles;
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    int64_t running = 0;
    for (int64_t base = 0; base < n_tiles; base += SCAN_BLOCK) {
        int64_t i = base + threadIdx.x;
        int v = i < n_tiles ? row[i] : 0;
        int x = warp_inclusive_scan(v);
        if (lane == 31) warp_sums[warp] = x;
        __syncthreads();
        if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane]);
        __syncthreads();
        int warp_excl = warp > 0 ? warp_sums[warp - 1] : 0;
        if (i < n_tiles) row[i] = static_cast<int>(running + warp_excl + x - v);
        running += warp_sums[SCAN_BLOCK / 32 - 1];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        totals[blockIdx.x] = static_cast<int>(running);
        overflow[blockIdx.x] = (capacity >= 0 && running > capacity) ? 1 : 0;
    }
}

}  // namespace
