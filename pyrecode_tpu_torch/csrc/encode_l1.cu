// Fused L1/L3 encode: threshold -> foreground mask -> LSB-first bitmap ->
// raster-order compaction of the residuals frame - threshold, and
// optionally of each residual's pixel index.
//
// Replaces pyrecode_tpu/ops/pallas_encode.py:encode_l1_pallas (kernel
// built by _build_l1_kernel), plain path with and without values, and its
// with_positions output (_compact_chunk_dual_packed, _compact_chunk_dual):
// the frame's pixel index of every stored value, at the value's rank, with
// the values masked to their low pos_vbits bits as there.  The TPU
// kernel builds the bitmap with an MXU packing matmul and compacts through a
// rank-match selection, a triangular-matmul cumsum and a lane-aligned tail
// carry; here a warp ballot over 32 consecutive pixels is the bitmap word,
// and compaction is a two-level scan of popcounts followed by plain
// scattered stores.
//
// Three launches on the caller's stream:
//   1. encode_bitmap_kernel: reads frame and threshold (4 B/pixel), writes
//      the bitmap (1/8 B/pixel) and one foreground count per tile;
//   2. scan_tiles_kernel (common.cuh): tile counts -> tile offsets, per-frame
//      counts and overflow (count > out_size);
//   3. encode_scatter_kernel (with values only): re-reads the bitmap, not
//      the frame, and gathers frame and threshold only at foreground pixels,
//      so at ~1% occupancy it moves a small fraction of pass 1's bytes; it
//      also zero-fills comp[count, out_size).  With positions it stores
//      the pixel index beside each value (4 more bytes per foreground
//      pixel) and zero-fills pos[count, out_size) too.
// The work is memory-bound: pass 1's dense read of the frame and threshold
// is the floor, and the design keeps every other pass off the dense frame.

#include "common.cuh"

namespace {

__global__ void encode_bitmap_kernel(const uint16_t* __restrict__ frames,
                                     const uint16_t* __restrict__ thr,
                                     uint8_t* __restrict__ bitmap, int* __restrict__ tiles,
                                     int64_t n_pixels, int64_t n_bytes, int64_t n_tiles) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint16_t* f = frames + b * n_pixels;
    uint8_t* bm = bitmap + b * n_bytes;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    int count = 0;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const int64_t word = first + k;
        const int64_t p = word * 32 + lane;
        const bool fg = p < n_pixels && f[p] > thr[p];
        const uint32_t bits = __ballot_sync(kFullMask, fg);
        count += __popc(bits);
        const int64_t byte = word * 4 + lane;
        if (lane < 4 && byte < n_bytes) bm[byte] = static_cast<uint8_t>(bits >> (8 * lane));
    }
    int total;
    block_warp_prefix(count, &total);
    if (threadIdx.x == 0) tiles[b * n_tiles + t] = total;
}

__global__ void encode_scatter_kernel(const uint16_t* __restrict__ frames,
                                      const uint16_t* __restrict__ thr,
                                      const uint8_t* __restrict__ bitmap,
                                      const int* __restrict__ tile_offsets,
                                      const int* __restrict__ counts, int32_t* __restrict__ comp,
                                      int32_t* __restrict__ pos, int32_t vmask,
                                      int64_t n_pixels, int64_t n_bytes, int64_t n_tiles,
                                      int64_t out_size) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint16_t* f = frames + b * n_pixels;
    int32_t* out = comp + b * out_size;
    int32_t* out_pos = pos != nullptr ? pos + b * out_size : nullptr;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;

    const WarpWords ww = warp_words(bitmap + b * n_bytes, n_bytes, n_pixels, first);
    int block_total;
    const int64_t base = static_cast<int64_t>(tile_offsets[b * n_tiles + t]) +
                         block_warp_prefix(ww.total, &block_total);
    const uint32_t below = (1u << lane) - 1u;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const uint32_t w = __shfl_sync(kFullMask, ww.word, k);
        const int before = __shfl_sync(kFullMask, ww.excl, k);
        if ((w >> lane) & 1u) {
            const int64_t dst = base + before + __popc(w & below);
            if (dst < out_size) {
                const int64_t p = (first + k) * 32 + lane;
                out[dst] = (static_cast<int32_t>(f[p]) - static_cast<int32_t>(thr[p])) & vmask;
                if (out_pos != nullptr) out_pos[dst] = static_cast<int32_t>(p);
            }
        }
    }

    const int64_t stride = n_tiles * BLOCK;
    for (int64_t i = counts[b] + t * BLOCK + threadIdx.x; i < out_size; i += stride) {
        out[i] = 0;
        if (out_pos != nullptr) out_pos[i] = 0;
    }
}

}  // namespace

// frames (batch, n_pixels) u16, thr (n_pixels) u16 -> bitmap (batch,
// ceil(n_pixels / 8)) u8, comp (batch, out_size) i32 (with_values only),
// counts (batch,) i32, overflow (batch,) u8; pos (batch, out_size) i32 or
// null: the pixel index of each value, and then pos_vbits > 0 masks the
// values to that many bits.  tiles is (batch, pr_num_tiles(n_pixels)) i32
// scratch.  Returns cudaGetLastError().
extern "C" int pr_encode_l1(const void* frames, const void* thr, void* bitmap, void* comp,
                            void* counts, void* overflow, void* tiles, void* pos, int pos_vbits,
                            int64_t batch, int64_t n_pixels, int64_t out_size, int with_values,
                            void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* f = static_cast<const uint16_t*>(frames);
    auto* t = static_cast<const uint16_t*>(thr);
    encode_bitmap_kernel<<<grid, BLOCK, 0, s>>>(f, t, static_cast<uint8_t*>(bitmap),
                                                static_cast<int*>(tiles), n_pixels, n_bytes,
                                                n_tiles);
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        static_cast<int*>(tiles), n_tiles, static_cast<int*>(counts),
        static_cast<uint8_t*>(overflow), with_values ? out_size : -1);
    if (with_values) {
        encode_scatter_kernel<<<grid, BLOCK, 0, s>>>(
            f, t, static_cast<const uint8_t*>(bitmap), static_cast<const int*>(tiles),
            static_cast<const int*>(counts), static_cast<int32_t*>(comp),
            static_cast<int32_t*>(pos), pos_vbits > 0 ? (1 << pos_vbits) - 1 : -1, n_pixels,
            n_bytes, n_tiles, out_size);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_num_tiles(int64_t n_pixels) { return num_tiles(n_pixels); }
