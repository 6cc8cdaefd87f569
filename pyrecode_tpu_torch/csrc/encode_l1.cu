// Fused L1/L3 encode: threshold -> foreground mask -> LSB-first bitmap ->
// raster-order compaction of the residuals frame - threshold, and
// optionally of each residual's pixel index, or of the bitmap's nonzero
// bytes.
//
// Replaces pyrecode_tpu/ops/pallas_encode.py:encode_l1_pallas (kernel
// built by _build_l1_kernel), plain path with and without values, its
// with_positions output (_compact_chunk_dual_packed, _compact_chunk_dual):
// the frame's pixel index of every stored value, at the value's rank, with
// the values masked to their low pos_vbits bits as there, and its pairs_out
// output: (byte_index << 8) | byte_value of every nonzero bitmap byte in
// ascending byte order, the input of the pairs-driven deflate tokenizer
// (tokens_from_pairs.cu).  The TPU kernel builds the bitmap with an MXU
// packing matmul and compacts through a rank-match selection, a
// triangular-matmul cumsum and a lane-aligned tail carry (for the pairs, a
// second packing matmul at two sub-rows a lane row); here a warp ballot over
// 32 consecutive pixels is the bitmap word, and compaction is a two-level
// scan of popcounts (of nonzero bytes, for the pairs) followed by plain
// scattered stores.
//
// Launches on the caller's stream:
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
// With pairs, pass 1 also counts each tile's nonzero bitmap bytes (from
// the ballot words it holds), a second scan_tiles_kernel turns those into
// offsets and per-frame pair counts, and encode_pairs_kernel, a third pass
// over the bitmap only (1/8 B a pixel), stores the pairs, zero-fills
// pairs[pair_count, pairs_out) and ORs pair_count > pairs_out into the
// frame's overflow.  A tile's bitmap bytes are those of its own words, so a
// tile's count and its scatter walk the same bytes, in ascending order.
// The work is memory-bound: pass 1's dense read of the frame and threshold
// is the floor, and the design keeps every other pass off the dense frame.
//
// pr_encode_l1_phases (the phase probe, pyrecode_tpu_torch/tools/
// probe_phases.py; replaces the truncated kernels of tools/probe_phases.py:
// build_phase_kernel) launches the passes above unchanged, cut after one of
// them, plus encode_load_kernel: the floor of pass 1, its dense read alone.

#include "common.cuh"

namespace {

// Nonzero bytes of a bitmap word.
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
    return __popc(((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u));
}

// pair_tiles null: no pairs.  Otherwise it gets each tile's nonzero bitmap
// bytes beside the foreground count in tiles.  The count runs either way:
// with it nvcc unrolls the loop by 4 with 8 loads ahead of the ballots, and
// without it (a compile-time branch that drops it) unrolls it fully with
// each ballot behind its own loads, which takes twice as long on the H100
// (PERF.md findings).
__global__ void encode_bitmap_kernel(const uint16_t* __restrict__ frames,
                                     const uint16_t* __restrict__ thr,
                                     uint8_t* __restrict__ bitmap, int* __restrict__ tiles,
                                     int* __restrict__ pair_tiles, int64_t n_pixels,
                                     int64_t n_bytes, int64_t n_tiles) {
    __shared__ int pair_sums[WARPS];
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint16_t* f = frames + b * n_pixels;
    uint8_t* bm = bitmap + b * n_bytes;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    int count = 0;
    int nonzero = 0;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const int64_t word = first + k;
        const int64_t p = word * 32 + lane;
        const bool fg = p < n_pixels && f[p] > thr[p];
        const uint32_t bits = __ballot_sync(kFullMask, fg);
        count += __popc(bits);
        nonzero += nonzero_bytes(bits);   // bytes past n_bytes hold no pixel: they count 0
        const int64_t byte = word * 4 + lane;
        if (lane < 4 && byte < n_bytes) bm[byte] = static_cast<uint8_t>(bits >> (8 * lane));
    }
    if (lane == 0) pair_sums[warp] = nonzero;   // published by block_warp_prefix's barrier
    int total;
    block_warp_prefix(count, &total);
    if (threadIdx.x == 0) {
        tiles[b * n_tiles + t] = total;
        if (pair_tiles != nullptr) {
            int pairs = 0;
            for (int i = 0; i < WARPS; ++i) pairs += pair_sums[i];
            pair_tiles[b * n_tiles + t] = pairs;
        }
    }
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

// The pairs of each tile's nonzero bitmap bytes at the tile's offset
// (pair_offsets, from scan_tiles_kernel), then zeros from the frame's pair
// count to pairs_out; block (0, b) ORs the pairs' overflow into overflow[b].
__global__ void encode_pairs_kernel(const uint8_t* __restrict__ bitmap,
                                    const int* __restrict__ pair_offsets,
                                    const int* __restrict__ pair_counts,
                                    const uint8_t* __restrict__ pair_overflow,
                                    uint8_t* __restrict__ overflow, int32_t* __restrict__ pairs,
                                    int64_t n_pixels, int64_t n_bytes, int64_t n_tiles,
                                    int64_t pairs_out) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t* out = pairs + b * pairs_out;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;

    const uint32_t w = lane < WORDS_PER_WARP
                           ? load_bitmap_word(bitmap + b * n_bytes, n_bytes, n_pixels, first + lane)
                           : 0u;
    const int c = nonzero_bytes(w);
    const int incl = warp_inclusive_scan(c);
    int block_total;
    int64_t dst = static_cast<int64_t>(pair_offsets[b * n_tiles + t]) +
                  block_warp_prefix(__shfl_sync(kFullMask, incl, 31), &block_total) + incl - c;
    for (int k = 0; k < 4; ++k) {
        const uint32_t v = (w >> (8 * k)) & 0xFFu;
        if (v) {
            if (dst < pairs_out) {
                out[dst] = static_cast<int32_t>((((first + lane) * 4 + k) << 8) | v);
            }
            ++dst;
        }
    }

    const int64_t stride = n_tiles * BLOCK;
    for (int64_t i = pair_counts[b] + t * BLOCK + threadIdx.x; i < pairs_out; i += stride) {
        out[i] = 0;
    }
    if (t == 0 && threadIdx.x == 0) overflow[b] |= pair_overflow[b];
}

// The probe's "load" phase: frame and threshold read once in pass 1's grid
// and word layout, the loads of AHEAD words issued ahead of their use (pass
// 1's loop, unrolled by 4, issues 8 loads ahead of 4 ballots), and one int64
// sum of frame - threshold a tile, so that no load is dead.  It writes no
// bitmap and counts nothing: its time is the floor under pass 1.
__global__ void encode_load_kernel(const uint16_t* __restrict__ frames,
                                   const uint16_t* __restrict__ thr, int64_t* __restrict__ sums,
                                   int64_t n_pixels, int64_t n_tiles) {
    constexpr int AHEAD = 4;
    static_assert(WORDS_PER_WARP % AHEAD == 0, "whole groups of words");
    __shared__ int64_t warp_sums[WARPS];
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint16_t* f = frames + b * n_pixels;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    int64_t acc = 0;
    for (int k0 = 0; k0 < WORDS_PER_WARP; k0 += AHEAD) {
        int x[AHEAD], y[AHEAD];
#pragma unroll
        for (int j = 0; j < AHEAD; ++j) {
            const int64_t p = (first + k0 + j) * 32 + lane;
            x[j] = p < n_pixels ? f[p] : 0;
            y[j] = p < n_pixels ? thr[p] : 0;
        }
#pragma unroll
        for (int j = 0; j < AHEAD; ++j) acc += x[j] - y[j];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(kFullMask, acc, d);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t total = 0;
        for (int i = 0; i < WARPS; ++i) total += warp_sums[i];
        sums[b * n_tiles + t] = total;
    }
}

}  // namespace

// frames (batch, n_pixels) u16, thr (n_pixels) u16 -> bitmap (batch,
// ceil(n_pixels / 8)) u8, comp (batch, out_size) i32 (with_values only),
// counts (batch,) i32, overflow (batch,) u8; pos (batch, out_size) i32 or
// null: the pixel index of each value, and then pos_vbits > 0 masks the
// values to that many bits.  tiles is (batch, pr_num_tiles(n_pixels)) i32
// scratch.  pairs (batch, pairs_out) i32 or null: (byte_index << 8) |
// byte_value of each nonzero bitmap byte in byte order, zeros from the
// frame's count on, with pair_counts (batch,) i32 and overflow[b] also set
// when the count exceeds pairs_out; pair_tiles (batch, pr_num_tiles) i32
// and pair_overflow (batch,) u8 are their scratch.  Needs n_pixels / 8 <
// 2**23 with pairs.  Returns cudaGetLastError().
extern "C" int pr_encode_l1(const void* frames, const void* thr, void* bitmap, void* comp,
                            void* counts, void* overflow, void* tiles, void* pos, int pos_vbits,
                            int64_t batch, int64_t n_pixels, int64_t out_size, int with_values,
                            void* pairs, void* pair_counts, void* pair_tiles, void* pair_overflow,
                            int64_t pairs_out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* f = static_cast<const uint16_t*>(frames);
    auto* t = static_cast<const uint16_t*>(thr);
    int* ptiles = pairs != nullptr ? static_cast<int*>(pair_tiles) : nullptr;
    encode_bitmap_kernel<<<grid, BLOCK, 0, s>>>(f, t, static_cast<uint8_t*>(bitmap),
                                                static_cast<int*>(tiles), ptiles, n_pixels,
                                                n_bytes, n_tiles);
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
    if (pairs != nullptr) {
        scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
            ptiles, n_tiles, static_cast<int*>(pair_counts), static_cast<uint8_t*>(pair_overflow),
            pairs_out);
        encode_pairs_kernel<<<grid, BLOCK, 0, s>>>(
            static_cast<const uint8_t*>(bitmap), ptiles, static_cast<const int*>(pair_counts),
            static_cast<const uint8_t*>(pair_overflow), static_cast<uint8_t*>(overflow),
            static_cast<int32_t*>(pairs), n_pixels, n_bytes, n_tiles, pairs_out);
    }
    return static_cast<int>(cudaGetLastError());
}

// The phase probe's cut-offs of pr_encode_l1 without positions or pairs.
// stop_after 0 ("load"): encode_load_kernel alone, sums (batch,
// pr_num_tiles(n_pixels)) i64 of frame - threshold a tile; 1 ("bitmap"):
// pass 1, the bitmap and each tile's foreground count in tiles; 2 ("scan"):
// then scan_tiles_kernel, the tile offsets in tiles, counts and overflow;
// 3 ("full"): pr_encode_l1 itself.  Arguments as pr_encode_l1's; sums is
// read only at 0.  Returns cudaGetLastError().
extern "C" int pr_encode_l1_phases(const void* frames, const void* thr, void* bitmap, void* comp,
                                   void* counts, void* overflow, void* tiles, void* sums,
                                   int64_t batch, int64_t n_pixels, int64_t out_size,
                                   int with_values, int stop_after, void* stream) {
    if (stop_after >= 3) {
        return pr_encode_l1(frames, thr, bitmap, comp, counts, overflow, tiles, nullptr, 0, batch,
                            n_pixels, out_size, with_values, nullptr, nullptr, nullptr, nullptr, 0,
                            stream);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* f = static_cast<const uint16_t*>(frames);
    auto* t = static_cast<const uint16_t*>(thr);
    if (stop_after == 0) {
        encode_load_kernel<<<grid, BLOCK, 0, s>>>(f, t, static_cast<int64_t*>(sums), n_pixels,
                                                  n_tiles);
        return static_cast<int>(cudaGetLastError());
    }
    encode_bitmap_kernel<<<grid, BLOCK, 0, s>>>(f, t, static_cast<uint8_t*>(bitmap),
                                                static_cast<int*>(tiles), nullptr, n_pixels,
                                                n_bytes, n_tiles);
    if (stop_after == 2) {
        scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
            static_cast<int*>(tiles), n_tiles, static_cast<int*>(counts),
            static_cast<uint8_t*>(overflow), with_values ? out_size : -1);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_num_tiles(int64_t n_pixels) { return num_tiles(n_pixels); }
