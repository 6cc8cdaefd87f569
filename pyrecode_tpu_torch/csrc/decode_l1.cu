// L1 decode: bitmap + unpacked values -> dense residual frame.
//
// Replaces pyrecode_tpu/ops/pallas_decode.py:decode_l1_pallas (kernel
// built by _build_decode_kernel).  The TPU kernel spreads bitmap bytes with an
// MXU expansion matmul, ranks pixels with a matmul cumsum and places values
// by rank-match selection over capacity buckets; here the rank of a pixel is
// the popcount of the bitmap before it, from a two-level scan, and each
// foreground pixel reads its value directly: dense[p] = values[rank(p)].
//
// Three launches on the caller's stream:
//   1. decode_count_kernel: popcount per tile (reads 1/8 B/pixel);
//   2. scan_tiles_kernel (common.cuh): tile offsets, per-frame counts,
//      overflow = count > n_values;
//   3. decode_expand_kernel: writes every pixel of the dense u16 frame
//      (2 B/pixel, coalesced) and gathers one value per foreground pixel.
// Pass 3's dense store is the floor of this memory-bound decode; the bitmap
// is read twice because it is 1/16 of the output's bytes.
//
// pr_decode_l1_phases (the phase probe, pyrecode_tpu_torch/tools/
// probe_decode_phases.py; replaces the truncated kernels of tools/
// probe_decode_phases.py:build_phase_kernel) launches the passes above
// unchanged, cut after one of them, plus decode_store_kernel: the floor,
// the dense store of the bitmap's 0/1 mask alone.

#include "common.cuh"

namespace {

__global__ void decode_count_kernel(const uint8_t* __restrict__ bitmap, int* __restrict__ tiles,
                                    int64_t n_pixels, int64_t n_bytes, int64_t n_tiles) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    const WarpWords ww = warp_words(bitmap + b * n_bytes, n_bytes, n_pixels, first);
    int total;
    block_warp_prefix(ww.total, &total);
    if (threadIdx.x == 0) tiles[b * n_tiles + t] = total;
}

__global__ void decode_expand_kernel(const uint8_t* __restrict__ bitmap,
                                     const int* __restrict__ tile_offsets,
                                     const int32_t* __restrict__ values,
                                     uint16_t* __restrict__ dense, int64_t n_pixels,
                                     int64_t n_bytes, int64_t n_tiles, int64_t n_values) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int32_t* vals = values + b * n_values;
    uint16_t* out = dense + b * n_pixels;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;

    const WarpWords ww = warp_words(bitmap + b * n_bytes, n_bytes, n_pixels, first);
    int block_total;
    const int64_t base = static_cast<int64_t>(tile_offsets[b * n_tiles + t]) +
                         block_warp_prefix(ww.total, &block_total);
    const uint32_t below = (1u << lane) - 1u;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const uint32_t w = __shfl_sync(kFullMask, ww.word, k);
        const int before = __shfl_sync(kFullMask, ww.excl, k);
        const int64_t p = (first + k) * 32 + lane;
        if (p < n_pixels) {
            uint16_t v = 0;
            if ((w >> lane) & 1u) {
                const int64_t r = base + before + __popc(w & below);
                if (r < n_values) v = static_cast<uint16_t>(vals[r]);
            }
            out[p] = v;
        }
    }
}

// The probe's "store" phase (the TPU probe's "bitmap" phase): the dense u16
// 0/1 mask of the bitmap in decode_expand_kernel's grid and layout, without
// the tile offsets or the value gather.
__global__ void decode_store_kernel(const uint8_t* __restrict__ bitmap,
                                    uint16_t* __restrict__ dense, int64_t n_pixels,
                                    int64_t n_bytes) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint16_t* out = dense + b * n_pixels;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    const uint32_t word = lane < WORDS_PER_WARP
                              ? load_bitmap_word(bitmap + b * n_bytes, n_bytes, n_pixels,
                                                 first + lane)
                              : 0u;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const uint32_t w = __shfl_sync(kFullMask, word, k);
        const int64_t p = (first + k) * 32 + lane;
        if (p < n_pixels) out[p] = static_cast<uint16_t>((w >> lane) & 1u);
    }
}

}  // namespace

// bitmap (batch, ceil(n_pixels / 8)) u8, values (batch, n_values) i32 ->
// dense (batch, n_pixels) u16, overflow (batch,) u8; counts (batch,) i32 and
// tiles (batch, pr_num_tiles(n_pixels)) i32 are scratch.  Returns
// cudaGetLastError().
extern "C" int pr_decode_l1(const void* bitmap, const void* values, void* dense, void* overflow,
                            void* counts, void* tiles, int64_t batch, int64_t n_pixels,
                            int64_t n_values, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* bm = static_cast<const uint8_t*>(bitmap);
    decode_count_kernel<<<grid, BLOCK, 0, s>>>(bm, static_cast<int*>(tiles), n_pixels, n_bytes,
                                               n_tiles);
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        static_cast<int*>(tiles), n_tiles, static_cast<int*>(counts),
        static_cast<uint8_t*>(overflow), n_values);
    decode_expand_kernel<<<grid, BLOCK, 0, s>>>(
        bm, static_cast<const int*>(tiles), static_cast<const int32_t*>(values),
        static_cast<uint16_t*>(dense), n_pixels, n_bytes, n_tiles, n_values);
    return static_cast<int>(cudaGetLastError());
}

// The phase probe's cut-offs of pr_decode_l1.  stop_after 0 ("store"):
// decode_store_kernel alone, dense (batch, n_pixels) u16 0/1; 1 ("count"):
// decode_count_kernel, each tile's set bits in tiles; 2 ("scan"): then
// scan_tiles_kernel, the tile offsets in tiles, counts and overflow; 3
// ("full"): pr_decode_l1 itself.  Arguments as pr_decode_l1's.  Returns
// cudaGetLastError().
extern "C" int pr_decode_l1_phases(const void* bitmap, const void* values, void* dense,
                                   void* overflow, void* counts, void* tiles, int64_t batch,
                                   int64_t n_pixels, int64_t n_values, int stop_after,
                                   void* stream) {
    if (stop_after >= 3) {
        return pr_decode_l1(bitmap, values, dense, overflow, counts, tiles, batch, n_pixels,
                            n_values, stream);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* bm = static_cast<const uint8_t*>(bitmap);
    if (stop_after == 0) {
        decode_store_kernel<<<grid, BLOCK, 0, s>>>(bm, static_cast<uint16_t*>(dense), n_pixels,
                                                   n_bytes);
        return static_cast<int>(cudaGetLastError());
    }
    decode_count_kernel<<<grid, BLOCK, 0, s>>>(bm, static_cast<int*>(tiles), n_pixels, n_bytes,
                                               n_tiles);
    if (stop_after == 2) {
        scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
            static_cast<int*>(tiles), n_tiles, static_cast<int*>(counts),
            static_cast<uint8_t*>(overflow), n_values);
    }
    return static_cast<int>(cudaGetLastError());
}
