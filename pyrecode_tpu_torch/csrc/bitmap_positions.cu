// Bitmap -> ascending set-bit positions: the front half of the scheme-12
// gap coder (codecs/rans.py:rans_gaps_batch_device) where no encode kernel
// gave the positions (L2 statistics, L3 and L4 bitmaps).
//
// Replaces pyrecode_tpu/ops/pallas_gaps.py:bitmap_positions_pallas (kernel
// built by _build_positions_kernel) with one capacity, out_size.  The TPU
// kernel spreads 8 KB chunks of bytes to a 0/1 mask with an MXU expansion
// matmul, compacts chunk-relative positions with the shared rank-match
// selection (at most C1 set bits per 512-bit sub-row, a VMEM bound escalated
// through CAPACITY_BUCKETS) and appends them through a 128-aligned window.
// Here the bitmap is read as 32-bit words, LSB first, which are exactly the
// words of common.cuh with bits in place of pixels, so the compaction is the
// L1 encode's two-level scan:
//
//   1. count_kernel: each tile's set bits (warp popcounts of the words);
//   2. scan_tiles_kernel (common.cuh): tile offsets, per-row totals and
//      overflow (total > out_size);
//   3. scatter_kernel: each set bit's index at its rank, zeros from the
//      total on, and the count clipped to out_size.
//
// No sub-row limit exists: any density fits as long as out_size does.  The
// work is memory-bound: the bitmap is read twice (1/8 B per bit each time)
// and 4 B are written per set bit; at scheme-12 densities the bitmap reads
// dominate.

#include "common.cuh"

namespace {

__global__ void count_kernel(const uint8_t* __restrict__ bitmaps, int* __restrict__ tiles,
                             int64_t n_bytes, int64_t n_bits, int64_t n_tiles) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    const WarpWords ww = warp_words(bitmaps + b * n_bytes, n_bytes, n_bits, first);
    int total;
    block_warp_prefix(ww.total, &total);
    if (threadIdx.x == 0) tiles[b * n_tiles + t] = total;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ bitmaps,
                               const int* __restrict__ tile_offsets,
                               const int* __restrict__ totals, int32_t* __restrict__ pos,
                               int32_t* __restrict__ counts, int64_t n_bytes, int64_t n_bits,
                               int64_t n_tiles, int64_t out_size) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t* out = pos + b * out_size;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;

    const WarpWords ww = warp_words(bitmaps + b * n_bytes, n_bytes, n_bits, first);
    int block_total;
    const int64_t base = static_cast<int64_t>(tile_offsets[b * n_tiles + t]) +
                         block_warp_prefix(ww.total, &block_total);
    const uint32_t below = (1u << lane) - 1u;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const uint32_t w = __shfl_sync(kFullMask, ww.word, k);
        const int before = __shfl_sync(kFullMask, ww.excl, k);
        if ((w >> lane) & 1u) {
            const int64_t dst = base + before + __popc(w & below);
            if (dst < out_size) out[dst] = static_cast<int32_t>((first + k) * 32 + lane);
        }
    }

    const int64_t total = totals[b];
    const int64_t stride = n_tiles * BLOCK;
    for (int64_t i = total + t * BLOCK + threadIdx.x; i < out_size; i += stride) out[i] = 0;
    if (t == 0 && threadIdx.x == 0) {
        counts[b] = static_cast<int32_t>(total < out_size ? total : out_size);
    }
}

}  // namespace

// bitmaps (batch, n_bytes) u8 -> pos (batch, out_size) i32 ascending set-bit
// indices (bit k of byte j is index 8j + k), zeros from the count on; counts
// (batch,) i32 clipped to out_size; overflow (batch,) u8 = set bits >
// out_size.  tiles (batch, pr_num_tiles(8 * n_bytes)) and totals (batch,)
// are i32 scratch.  Returns cudaGetLastError().
extern "C" int pr_bitmap_positions(const void* bitmaps, void* pos, void* counts, void* overflow,
                                   void* tiles, void* totals, int64_t batch, int64_t n_bytes,
                                   int64_t out_size, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bits = n_bytes * 8;
    const int64_t n_tiles = num_tiles(n_bits);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* bm = static_cast<const uint8_t*>(bitmaps);
    auto* tl = static_cast<int*>(tiles);
    count_kernel<<<grid, BLOCK, 0, s>>>(bm, tl, n_bytes, n_bits, n_tiles);
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        tl, n_tiles, static_cast<int*>(totals), static_cast<uint8_t*>(overflow), out_size);
    scatter_kernel<<<grid, BLOCK, 0, s>>>(bm, tl, static_cast<const int*>(totals),
                                          static_cast<int32_t*>(pos),
                                          static_cast<int32_t*>(counts), n_bytes, n_bits,
                                          n_tiles, out_size);
    return static_cast<int>(cudaGetLastError());
}
