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
// triangular-matmul cumsum and a lane-aligned tail carry; here the bitmap
// byte of 8 pixels falls out of one 16-byte load, a block scan of popcounts
// ranks a tile's values, and a second small kernel places them.
//
// The work is bound by device-memory bytes: each frame pixel (2 B) and
// each threshold pixel (2 B, once a call) is read once, the bitmap (1/8 B
// a pixel) written once; at ~1% foreground the values, their staging and
// the zeros after them are a few percent more.  Two launches:
//   1. encode_tile_kernel, the one dense pass: a block owns a tile of
//      TILE_PIXELS pixels, two halves of HALF_PIXELS; thread i owns pixels
//      [8i, 8i + 8) of each half, one 16-byte load each (scalar loads where
//      the frames are not 16-byte aligned, n_pixels % 8 != 0).  The block
//      holds its tile's threshold in registers and walks the frames of its
//      group, the next frame's loads issued before the current frame's
//      compare, so the threshold leaves device memory once a group and the
//      frames once a call.  For each frame: 8 halfword compares
//      (__vcmpgtu2) are exactly one bitmap byte, stored as it stands (a warp
//      stores 32 consecutive bytes); a block scan of the threads' popcounts
//      ranks the values in the tile, whose count (and, with pairs, its
//      nonzero bitmap bytes) goes to the tile's word in scratch; each thread
//      stages its residuals (__vsub2) with their pixel in the tile, (pixel
//      << 16) | residual, at their ranks in the tile's STAGE_CAP entries of
//      scratch.  No block waits on another.
//   2. encode_place_kernel: a block a chunk of CHUNK_TILES tiles of a frame
//      sums the counts of the tiles before the chunk (at most n_tiles ints
//      from L2) for its offset, scans its chunk's counts, and each warp
//      copies a tile's staged values (and pixel indices) to their place,
//      none at or past out_size; a tile of more than STAGE_CAP values is
//      re-read from the frame and compacted again by its warp instead.
//      With pairs the warp reads the tile's bitmap bytes back (from L2)
//      and stores a pair for each nonzero one.  The chunk holding the last
//      tile writes the frame's count and overflow (count > out_size,
//      pair_count > pairs_out); further blocks write the zeros from each
//      frame's count up to out_size in comp and pos, and from its pair
//      count up to pairs_out in pairs, with 16-byte stores, once.
// A decoupled look-back in the dense pass (lookback.cuh) was built and
// measured first, and left out: blocks that wait on their predecessors'
// counts couple the whole wave of resident blocks, and holding the frames'
// values in registers across the wait cuts the blocks an SM holds; each
// form of it stayed well above this design on an H100 (PERF.md findings).
// A group is the whole batch unless the batch's tiles are too few to fill
// the card (GROUP_BLOCKS): then smaller groups, each reading the (small)
// threshold once.
//
// pr_encode_l1_phases (the phase probe, pyrecode_tpu_torch/tools/
// probe_phases.py; replaces the truncated kernels of tools/probe_phases.py:
// build_phase_kernel) cuts the same launches: the dense read alone; the
// dense pass with the bitmap and its tile counts; then the placing
// kernel's offsets, counts and overflow without moving values; the full
// call is pr_encode_l1.

#include "common.cuh"

namespace {

constexpr int HALF_PIXELS = TILE_PIXELS / 2;   // pixels of one 16-byte load a thread
constexpr int TILE_BYTES = TILE_PIXELS / 8;    // bitmap bytes of a tile
constexpr int STAGE_CAP = 512;                 // staged values a tile (12.5%)
constexpr int CHUNK_TILES = 32;                // tiles an encode_place_kernel block places
constexpr int GROUP_BLOCKS = 2048;             // blocks a grid should hold: ~2 waves
constexpr int ZERO_CHUNK = BLOCK * 16;         // int32 entries a zero block owns
static_assert(HALF_PIXELS == 8 * BLOCK, "a thread owns 8 pixels of each half");
static_assert(TILE_PIXELS == 32 * 128, "a warp re-reads a tile as 128 pixels a lane");
static_assert(TILE_BYTES == 32 * 16, "a warp reads a tile's bitmap as 16 bytes a lane");
static_assert(CHUNK_TILES == 32, "a lane of one warp scans each tile's count of a chunk");

enum Cut { CUT_LOAD = 0, CUT_BITMAP = 1, CUT_SCAN = 2, CUT_FULL = 3 };

struct EncodeArgs {
    uint8_t* bitmap;
    int32_t* comp;         // with_values only
    int32_t* pos;          // null: no positions
    int32_t* pairs;        // null: no pairs
    int* counts;
    int* pair_counts;
    uint8_t* overflow;
    int* tiles;            // each (frame, tile)'s foreground count
    int* pair_tiles;       // null, or each (frame, tile)'s nonzero bitmap bytes
    int32_t* stage;        // null, or STAGE_CAP staged values a (frame, tile)
    int* tile_offsets;     // the scan cut's output
    int64_t* sums;         // the load cut's output
    int64_t n_pixels, n_bytes, n_tiles, batch, group, out_size, pairs_out;
    int32_t vmask;
    int with_values;       // 0: L3, counts only
};

// Pixels [q, q + 8) of a row as 8 halfwords, zeros at or past n.  kVec: the
// row is 16-byte aligned and n % 8 == 0, so q < n loads all 8 at once.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const uint16_t* row, int64_t q, int64_t n) {
    if constexpr (kVec) {
        return q < n ? *reinterpret_cast<const uint4*>(row + q) : make_uint4(0u, 0u, 0u, 0u);
    } else {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t lo = q + 2 * k < n ? row[q + 2 * k] : 0u;
            const uint32_t hi = q + 2 * k + 1 < n ? row[q + 2 * k + 1] : 0u;
            w[k] = lo | (hi << 16);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// Bit k of the result: halfword k of f > halfword k of t, unsigned.
__device__ __forceinline__ uint32_t mask8(uint4 f, uint4 t) {
    const uint32_t g0 = __vcmpgtu2(f.x, t.x), g1 = __vcmpgtu2(f.y, t.y);
    const uint32_t g2 = __vcmpgtu2(f.z, t.z), g3 = __vcmpgtu2(f.w, t.w);
    return ((g0 & 1u) | ((g0 >> 15) & 2u)) | (((g1 & 1u) | ((g1 >> 15) & 2u)) << 2) |
           (((g2 & 1u) | ((g2 >> 15) & 2u)) << 4) | (((g3 & 1u) | ((g3 >> 15) & 2u)) << 6);
}

// Halfwords f - t (mod 2**16): the residuals wherever f > t.
__device__ __forceinline__ uint4 residual8(uint4 f, uint4 t) {
    return make_uint4(__vsub2(f.x, t.x), __vsub2(f.y, t.y), __vsub2(f.z, t.z),
                      __vsub2(f.w, t.w));
}

// Halfword k (0..7) of v, by selects (no local memory).
__device__ __forceinline__ uint32_t halfword(uint4 v, int k) {
    const int w = k >> 1;
    const uint32_t word = (w & 2) ? ((w & 1) ? v.w : v.z) : ((w & 1) ? v.y : v.x);
    return (word >> ((k & 1) << 4)) & 0xFFFFu;
}

// (f - t) of every pixel of a half summed, for the load cut.
__device__ __forceinline__ int diff_sum(uint4 f, uint4 t) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        s += static_cast<int>(halfword(f, k)) - static_cast<int>(halfword(t, k));
    }
    return s;
}

// (pixel << 16) | residual of the set bits m of 8 pixels from pixel, at
// ranks rank, rank + 1, ... of a tile's stage; none at or past STAGE_CAP.
__device__ __forceinline__ void stage_values(int32_t* stage, int rank, uint32_t m, uint4 res,
                                             int pixel) {
    while (m && rank < STAGE_CAP) {
        const int k = __ffs(m) - 1;
        m &= m - 1u;
        stage[rank++] = static_cast<int32_t>((static_cast<uint32_t>(pixel + k) << 16) |
                                             halfword(res, k));
    }
}

// The residuals (and frame pixel indices) of the set bits m of 8 pixels
// from pixel, ranked from dst; none at or past out_size.
__device__ __forceinline__ void store_values(int32_t* out, int32_t* out_pos, int64_t dst,
                                             uint32_t m, uint4 res, int32_t pixel,
                                             int64_t out_size, int32_t vmask) {
    while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1u;
        if (dst < out_size) {
            out[dst] = static_cast<int32_t>(halfword(res, k)) & vmask;
            if (out_pos != nullptr) out_pos[dst] = pixel + k;
        }
        ++dst;
    }
}

// Blocks: (frame group, tile), tile-major within a group.  kCut: CUT_LOAD
// (sums), CUT_BITMAP (the bitmap and tile counts) or CUT_FULL (and the
// staged values and pair counts).
template <int kCut, bool kVec>
__global__ void __launch_bounds__(BLOCK)
encode_tile_kernel(const uint16_t* __restrict__ frames, const uint16_t* __restrict__ thr,
                   EncodeArgs a) {
    __shared__ int warp_counts[2][WARPS];   // by frame parity: one barrier a frame
    __shared__ int warp_pairs[2][WARPS];
    __shared__ long long warp_sums[WARPS];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t n = a.n_pixels;
    const bool pairs = kCut == CUT_FULL && a.pair_tiles != nullptr;
    const bool staged = kCut == CUT_FULL && a.stage != nullptr;

    const int t = static_cast<int>(blockIdx.x % a.n_tiles);
    const int64_t b0 = blockIdx.x / a.n_tiles * a.group;
    const int64_t b1 = b0 + a.group < a.batch ? b0 + a.group : a.batch;
    const int64_t q0 = static_cast<int64_t>(t) * TILE_PIXELS + 8 * tid;   // first half's pixels
    const int64_t q1 = q0 + HALF_PIXELS;
    const int64_t byte0 = static_cast<int64_t>(t) * TILE_BYTES + tid;     // their bitmap bytes
    const int64_t byte1 = byte0 + BLOCK;

    const uint4 t0 = load8<kVec>(thr, q0, n);
    const uint4 t1 = load8<kVec>(thr, q1, n);
    uint4 f0 = load8<kVec>(frames + b0 * n, q0, n);
    uint4 f1 = load8<kVec>(frames + b0 * n, q1, n);
    for (int64_t b = b0; b < b1; ++b) {
        const int par = static_cast<int>(b - b0) & 1;
        const int64_t tile = b * a.n_tiles + t;
        uint4 g0 = make_uint4(0u, 0u, 0u, 0u), g1 = g0;
        if (b + 1 < b1) {   // the next frame's loads, ahead of this frame's work
            g0 = load8<kVec>(frames + (b + 1) * n, q0, n);
            g1 = load8<kVec>(frames + (b + 1) * n, q1, n);
        }
        if constexpr (kCut == CUT_LOAD) {
            long long s = warp_sum(diff_sum(f0, t0) + diff_sum(f1, t1));
            if (lane == 0) warp_sums[warp] = s;
            __syncthreads();
            if (tid == 0) {
                s = 0;
#pragma unroll
                for (int i = 0; i < WARPS; ++i) s += warp_sums[i];
                a.sums[tile] = s;
            }
            __syncthreads();
        } else {
            const uint32_t m0 = mask8(f0, t0), m1 = mask8(f1, t1);
            uint8_t* row = a.bitmap + b * a.n_bytes;
            if (byte0 < a.n_bytes) row[byte0] = static_cast<uint8_t>(m0);
            if (byte1 < a.n_bytes) row[byte1] = static_cast<uint8_t>(m1);

            // ranks in the tile: the first halves of all threads, then the
            // second; a count of each half in each 16-bit field
            const int c = __popc(m0) | (__popc(m1) << 16);
            const int incl = warp_inclusive_scan(c);
            if (lane == 31) warp_counts[par][warp] = incl;
            if (pairs) {
                const int z = (m0 != 0u ? 1 : 0) + (m1 != 0u ? 1 : 0);
                const int zsum = __shfl_sync(kFullMask, warp_inclusive_scan(z), 31);
                if (lane == 0) warp_pairs[par][warp] = zsum;
            }
            __syncthreads();
            int before = 0, total = 0;
#pragma unroll
            for (int i = 0; i < WARPS; ++i) {
                const int v = warp_counts[par][i];
                before += i < warp ? v : 0;
                total += v;
            }
            if (tid == 0) {
                a.tiles[tile] = (total & 0xFFFF) + (total >> 16);
                if (pairs) {
                    int zt = 0;
#pragma unroll
                    for (int i = 0; i < WARPS; ++i) zt += warp_pairs[par][i];
                    a.pair_tiles[tile] = zt;
                }
            }
            if (staged) {
                const int excl = before + incl - c;
                int32_t* st = a.stage + tile * STAGE_CAP;
                stage_values(st, excl & 0xFFFF, m0, residual8(f0, t0), 8 * tid);
                stage_values(st, (total & 0xFFFF) + (excl >> 16), m1, residual8(f1, t1),
                             HALF_PIXELS + 8 * tid);
            }
        }
        f0 = g0;
        f1 = g1;
    }
}

// Sums of v[lo, hi) and w[lo, hi) (w may be null) over the block, to every
// thread.
__device__ __forceinline__ void block_sums(const int* v, const int* w, int64_t lo, int64_t hi,
                                           long long* sv, long long* sw) {
    __shared__ long long part[2][WARPS];
    long long x = 0, y = 0;
    for (int64_t i = lo + threadIdx.x; i < hi; i += BLOCK) {
        x += v[i];
        if (w != nullptr) y += w[i];
    }
    x = warp_sum(x);
    y = warp_sum(y);
    if ((threadIdx.x & 31) == 0) {
        part[0][threadIdx.x >> 5] = x;
        part[1][threadIdx.x >> 5] = y;
    }
    __syncthreads();
    x = y = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        x += part[0][i];
        y += part[1][i];
    }
    *sv = x;
    *sw = y;
}

// One warp: tile t of a frame compacted again from the frame and the
// threshold, its values (and pixel indices) stored from rank dst on; lane l
// owns pixels [128 l, 128 l + 128) of the tile.  For a tile of more than
// STAGE_CAP values.
template <bool kVec>
__device__ void warp_recompact_tile(const uint16_t* frame, const uint16_t* thr, int64_t n, int t,
                                    int32_t* out, int32_t* out_pos, int64_t dst, int64_t out_size,
                                    int32_t vmask) {
    const int lane = threadIdx.x & 31;
    const int64_t first = static_cast<int64_t>(t) * TILE_PIXELS + 128 * lane;
    int c = 0;
    for (int g = 0; g < 16; ++g) {
        const int64_t q = first + 8 * g;
        c += __popc(mask8(load8<kVec>(frame, q, n), load8<kVec>(thr, q, n)));
    }
    dst += warp_inclusive_scan(c) - c;
    for (int g = 0; g < 16; ++g) {
        const int64_t q = first + 8 * g;
        const uint4 f = load8<kVec>(frame, q, n);
        const uint4 th = load8<kVec>(thr, q, n);
        const uint32_t m = mask8(f, th);
        store_values(out, out_pos, dst, m, residual8(f, th), static_cast<int32_t>(q), out_size,
                     vmask);
        dst += __popc(m);
    }
}

// Grid (n_chunks + zero blocks, batch).  Block x < n_chunks: the chunk of
// CHUNK_TILES tiles from x * CHUNK_TILES; kMove false: their offsets to
// tile_offsets (the scan cut), true: their values and pairs to their place.
// The chunk of the last tile writes the frame's counts and overflow.  Block
// x >= n_chunks: the zeros of ZERO_CHUNK entries of each row past its count.
template <bool kMove, bool kVec>
__global__ void __launch_bounds__(BLOCK)
encode_place_kernel(const uint16_t* __restrict__ frames, const uint16_t* __restrict__ thr,
                    EncodeArgs a, int n_chunks) {
    __shared__ int offset_s[CHUNK_TILES + 1], pair_offset_s[CHUNK_TILES + 1];
    const int64_t b = blockIdx.y;
    const int x = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int* cnt = a.tiles + b * a.n_tiles;
    const int* pcnt = a.pair_tiles != nullptr ? a.pair_tiles + b * a.n_tiles : nullptr;
    long long base, pbase;

    if (x >= n_chunks) {   // zeros after the counts
        block_sums(cnt, pcnt, 0, a.n_tiles, &base, &pbase);
        const int64_t lo = static_cast<int64_t>(x - n_chunks) * ZERO_CHUNK;
        if (a.with_values) {
            const int64_t from = base > lo ? base : lo;
            const int64_t to = lo + ZERO_CHUNK < a.out_size ? lo + ZERO_CHUNK : a.out_size;
            block_zero_range(a.comp + b * a.out_size, from, to);
            if (a.pos != nullptr) block_zero_range(a.pos + b * a.out_size, from, to);
        }
        if (pcnt != nullptr) {
            const int64_t from = pbase > lo ? pbase : lo;
            const int64_t to = lo + ZERO_CHUNK < a.pairs_out ? lo + ZERO_CHUNK : a.pairs_out;
            block_zero_range(a.pairs + b * a.pairs_out, from, to);
        }
        return;
    }
    const bool last_chunk = x == n_chunks - 1;
    if (kMove && !last_chunk && !a.with_values && pcnt == nullptr) return;   // L3: counts only
    const int64_t first = static_cast<int64_t>(x) * CHUNK_TILES;
    const int n_here = static_cast<int>(a.n_tiles - first < CHUNK_TILES ? a.n_tiles - first
                                                                        : CHUNK_TILES);
    block_sums(cnt, pcnt, 0, first, &base, &pbase);
    if (warp == 0) {
        const int v = lane < n_here ? cnt[first + lane] : 0;
        const int pv = lane < n_here && pcnt != nullptr ? pcnt[first + lane] : 0;
        offset_s[lane + 1] = warp_inclusive_scan(v);
        pair_offset_s[lane + 1] = warp_inclusive_scan(pv);
        if (lane == 0) offset_s[0] = pair_offset_s[0] = 0;
    }
    __syncthreads();
    if (!kMove && tid < n_here) {
        a.tile_offsets[b * a.n_tiles + first + tid] = static_cast<int>(base + offset_s[tid]);
    }
    if (last_chunk && tid == 0) {
        const long long count = base + offset_s[n_here];
        bool over = a.with_values && count > a.out_size;
        a.counts[b] = static_cast<int>(count);
        if (pcnt != nullptr) {
            const long long pcount = pbase + pair_offset_s[n_here];
            a.pair_counts[b] = static_cast<int>(pcount);
            over |= pcount > a.pairs_out;
        }
        a.overflow[b] = over ? 1 : 0;
    }
    if constexpr (kMove) {
        for (int k = warp; k < n_here; k += WARPS) {   // a warp a tile
            const int t = static_cast<int>(first + k);
            if (a.with_values) {
                const int count = offset_s[k + 1] - offset_s[k];
                const int64_t dst = base + offset_s[k];
                int32_t* out = a.comp + b * a.out_size;
                int32_t* out_pos = a.pos != nullptr ? a.pos + b * a.out_size : nullptr;
                if (count <= STAGE_CAP) {
                    const int32_t* st = a.stage + (b * a.n_tiles + t) * STAGE_CAP;
                    for (int i = lane; i < count && dst + i < a.out_size; i += 32) {
                        const uint32_t e = static_cast<uint32_t>(st[i]);
                        out[dst + i] = static_cast<int32_t>(e & 0xFFFFu) & a.vmask;
                        if (out_pos != nullptr) {
                            out_pos[dst + i] = t * TILE_PIXELS + static_cast<int32_t>(e >> 16);
                        }
                    }
                } else if (dst < a.out_size) {
                    warp_recompact_tile<kVec>(frames + b * a.n_pixels, thr, a.n_pixels, t, out,
                                              out_pos, dst, a.out_size, a.vmask);
                }
            }
            if (pcnt != nullptr) {   // the tile's 512 bitmap bytes, 16 a lane, from L2
                const int64_t byte = static_cast<int64_t>(t) * TILE_BYTES + 16 * lane;
                const uint8_t* row = a.bitmap + b * a.n_bytes;
                const bool whole = byte + 16 <= a.n_bytes &&
                                   (reinterpret_cast<uintptr_t>(row + byte) & 15u) == 0;
                uint32_t v[16];
                if (whole) {
                    const uint4 w = *reinterpret_cast<const uint4*>(row + byte);
                    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int j = 0; j < 16; ++j) v[j] = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
                } else {
#pragma unroll
                    for (int j = 0; j < 16; ++j) v[j] = byte + j < a.n_bytes ? row[byte + j] : 0u;
                }
                int nz = 0;
#pragma unroll
                for (int j = 0; j < 16; ++j) nz += v[j] != 0u ? 1 : 0;
                int64_t dst = pbase + pair_offset_s[k] + warp_inclusive_scan(nz) - nz;
                int32_t* out = a.pairs + b * a.pairs_out;
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    if (v[j] != 0u) {
                        if (dst < a.pairs_out) {
                            out[dst] = static_cast<int32_t>(((byte + j) << 8) | v[j]);
                        }
                        ++dst;
                    }
                }
            }
        }
    }
}

// Frames a block walks: the whole batch when its tiles fill GROUP_BLOCKS
// blocks, else fewer, so that the grid still holds ~GROUP_BLOCKS blocks.
__host__ inline int64_t frame_group(int64_t batch, int64_t n_tiles) {
    const int64_t groups_wanted = (GROUP_BLOCKS + n_tiles - 1) / n_tiles;
    const int64_t groups = groups_wanted < batch ? groups_wanted : batch;
    return (batch + groups - 1) / groups;
}

__host__ inline bool vector_loads(const void* frames, const void* thr, int64_t n_pixels) {
    return n_pixels % 8 == 0 && (reinterpret_cast<uintptr_t>(frames) & 15u) == 0 &&
           (reinterpret_cast<uintptr_t>(thr) & 15u) == 0;
}

// a's sizes from n_pixels and batch.
__host__ inline void set_sizes(EncodeArgs& a) {
    a.n_bytes = (a.n_pixels + 7) / 8;
    a.n_tiles = num_tiles(a.n_pixels);
    a.group = frame_group(a.batch, a.n_tiles);
}

template <int kCut>
void launch_tiles(const void* frames, const void* thr, const EncodeArgs& a, cudaStream_t s) {
    const int64_t groups = (a.batch + a.group - 1) / a.group;
    const unsigned grid = static_cast<unsigned>(groups * a.n_tiles);
    auto* f = static_cast<const uint16_t*>(frames);
    auto* t = static_cast<const uint16_t*>(thr);
    if (vector_loads(frames, thr, a.n_pixels)) {
        encode_tile_kernel<kCut, true><<<grid, BLOCK, 0, s>>>(f, t, a);
    } else {
        encode_tile_kernel<kCut, false><<<grid, BLOCK, 0, s>>>(f, t, a);
    }
}

template <bool kMove>
void launch_place(const void* frames, const void* thr, const EncodeArgs& a, cudaStream_t s) {
    const int n_chunks = static_cast<int>((a.n_tiles + CHUNK_TILES - 1) / CHUNK_TILES);
    int64_t rows = 0;
    if (kMove) {
        rows = a.with_values ? a.out_size : 0;
        if (a.pairs != nullptr && a.pairs_out > rows) rows = a.pairs_out;
    }
    const dim3 grid(static_cast<unsigned>(n_chunks + (rows + ZERO_CHUNK - 1) / ZERO_CHUNK),
                    static_cast<unsigned>(a.batch));
    auto* f = static_cast<const uint16_t*>(frames);
    auto* t = static_cast<const uint16_t*>(thr);
    if (vector_loads(frames, thr, a.n_pixels)) {
        encode_place_kernel<kMove, true><<<grid, BLOCK, 0, s>>>(f, t, a, n_chunks);
    } else {
        encode_place_kernel<kMove, false><<<grid, BLOCK, 0, s>>>(f, t, a, n_chunks);
    }
}

}  // namespace

// int32 scratch entries of one pr_encode_l1 call: a count a (frame, tile),
// twice with pairs, and STAGE_CAP staged values a (frame, tile) with values.
extern "C" int64_t pr_encode_scratch_words(int64_t batch, int64_t n_pixels, int with_values,
                                           int pairs) {
    return batch * num_tiles(n_pixels) * ((pairs ? 2 : 1) + (with_values ? STAGE_CAP : 0));
}

// frames (batch, n_pixels) u16, thr (n_pixels) u16 -> bitmap (batch,
// ceil(n_pixels / 8)) u8, comp (batch, out_size) i32 (with_values only),
// counts (batch,) i32, overflow (batch,) u8; pos (batch, out_size) i32 or
// null: the pixel index of each value, and then pos_vbits > 0 masks the
// values to that many bits.  pairs (batch, pairs_out) i32 or null:
// (byte_index << 8) | byte_value of each nonzero bitmap byte in byte order,
// zeros from the frame's count on, with pair_counts (batch,) i32 and
// overflow[b] also set when the count exceeds pairs_out.  scratch:
// pr_encode_scratch_words(batch, n_pixels, with_values, pairs != null) i32.
// Needs n_pixels / 8 < 2**23 with pairs.  Returns the first CUDA error.
extern "C" int pr_encode_l1(const void* frames, const void* thr, void* bitmap, void* comp,
                            void* counts, void* overflow, void* scratch, void* pos, int pos_vbits,
                            int64_t batch, int64_t n_pixels, int64_t out_size, int with_values,
                            void* pairs, void* pair_counts, int64_t pairs_out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    EncodeArgs a{};
    a.n_pixels = n_pixels;
    a.batch = batch;
    set_sizes(a);
    int* words = static_cast<int*>(scratch);
    a.bitmap = static_cast<uint8_t*>(bitmap);
    a.comp = static_cast<int32_t*>(comp);
    a.pos = with_values ? static_cast<int32_t*>(pos) : nullptr;
    a.pairs = static_cast<int32_t*>(pairs);
    a.counts = static_cast<int*>(counts);
    a.pair_counts = static_cast<int*>(pair_counts);
    a.overflow = static_cast<uint8_t*>(overflow);
    a.tiles = words;
    a.pair_tiles = pairs != nullptr ? words + batch * a.n_tiles : nullptr;
    a.stage = with_values ? words + batch * a.n_tiles * (pairs != nullptr ? 2 : 1) : nullptr;
    a.out_size = with_values ? out_size : 0;
    a.pairs_out = pairs != nullptr ? pairs_out : 0;
    a.vmask = a.pos != nullptr && pos_vbits > 0 ? (1 << pos_vbits) - 1 : -1;
    a.with_values = with_values;
    launch_tiles<CUT_FULL>(frames, thr, a, s);
    launch_place<true>(frames, thr, a, s);
    return static_cast<int>(cudaGetLastError());
}

// The phase probe's cut-offs of pr_encode_l1 without positions or pairs.
// stop_after 0 ("load"): the dense pass's read alone, sums (batch,
// pr_num_tiles(n_pixels)) i64 of frame - threshold a tile; 1 ("bitmap"):
// the dense pass, the bitmap and each tile's foreground count in tiles
// (batch, pr_num_tiles) i32; 2 ("scan"): then the placing kernel's
// offsets, each tile's offset in its frame in tiles, counts and overflow
// (scratch: batch * pr_num_tiles i32, the counts); 3 ("full"): pr_encode_l1
// itself (scratch as there).  Arguments as pr_encode_l1's; sums is read
// only at 0, tiles at 1 and 2.  Returns the first CUDA error.
extern "C" int pr_encode_l1_phases(const void* frames, const void* thr, void* bitmap, void* comp,
                                   void* counts, void* overflow, void* tiles, void* sums,
                                   void* scratch, int64_t batch, int64_t n_pixels,
                                   int64_t out_size, int with_values, int stop_after,
                                   void* stream) {
    if (stop_after >= CUT_FULL) {
        return pr_encode_l1(frames, thr, bitmap, comp, counts, overflow, scratch, nullptr, 0,
                            batch, n_pixels, out_size, with_values, nullptr, nullptr, 0, stream);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    EncodeArgs a{};
    a.n_pixels = n_pixels;
    a.batch = batch;
    set_sizes(a);
    a.bitmap = static_cast<uint8_t*>(bitmap);
    a.comp = static_cast<int32_t*>(comp);
    a.counts = static_cast<int*>(counts);
    a.overflow = static_cast<uint8_t*>(overflow);
    a.tiles = static_cast<int*>(stop_after == CUT_SCAN ? scratch : tiles);
    a.tile_offsets = static_cast<int*>(tiles);
    a.sums = static_cast<int64_t*>(sums);
    a.out_size = with_values ? out_size : 0;
    a.vmask = -1;
    a.with_values = with_values;
    if (stop_after == CUT_LOAD) {
        launch_tiles<CUT_LOAD>(frames, thr, a, s);
    } else {
        launch_tiles<CUT_BITMAP>(frames, thr, a, s);
        if (stop_after == CUT_SCAN) launch_place<false>(frames, thr, a, s);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_num_tiles(int64_t n_pixels) { return num_tiles(n_pixels); }
