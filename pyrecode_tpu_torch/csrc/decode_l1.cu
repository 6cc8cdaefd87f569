// L1 decode: bitmap + unpacked values -> dense residual frame.
//
// Replaces pyrecode_tpu/ops/pallas_decode.py:decode_l1_pallas (kernel
// built by _build_decode_kernel).  The TPU kernel spreads bitmap bytes with an
// MXU expansion matmul, ranks pixels with a matmul cumsum and places values
// by rank-match selection over capacity buckets; here the rank of a pixel is
// the popcount of the bitmap before it and each foreground pixel reads its
// value directly: dense[p] = values[rank(p)].
//
// Bound by the dense store, 2 bytes a pixel written once (the bitmap is 1/16
// of it).  Two launches on the caller's stream, no memset and no scan launch:
//   1. decode_count_kernel: COUNT_BLOCKS blocks (a few an SM) walk every
//      4096-pixel tile of the batch, a warp a tile: one 16-byte load a lane
//      (the warp's 32 x 16 bytes are the tile's 512), __popc and a warp sum;
//      one count a tile;
//   2. decode_expand_kernel: a block EXPAND_TILES tiles of one frame.  It
//      sums the counts of the frame's tiles before its first (at most 4096
//      ints a frame, from L2), then each warp takes a tile: its bitmap words
//      and the set bits before each word in shared memory, its values
//      (a tile's ranks are consecutive) staged in shared memory, then 16
//      rounds in which a lane owns one bitmap byte, 8 pixels, and writes them
//      with one 16-byte streaming store (__stcs: nothing on the card reads
//      the frame back), so that a warp's store covers 512 contiguous bytes.
//      A zero byte stores zeros and gathers nothing; a set bit's rank is the
//      tile's offset, the set bits before its word in the tile and the
//      popcount of the word's lower bits.  A warp loads its next tile's
//      bitmap before it stores the one before.  The block of a frame's last
//      tile writes the frame's overflow flag.
// A dense row that does not start on a 16-byte boundary (frames of n % 8 != 0
// pixels) and a frame's last partial byte take 2-byte stores; bitmap bits at
// or past n read as zero.  Measured and left out (PERF.md §6): the tile
// offsets by scan_tiles_kernel (common.cuh) as a launch of its own, plain
// stores, 8 and 32 tiles a block, and the next tile's values prefetched into
// registers.
//
// pr_decode_l1_phases (the phase probe, pyrecode_tpu_torch/tools/
// probe_decode_phases.py; replaces the truncated kernels of tools/
// probe_decode_phases.py:build_phase_kernel) cuts the passes above: "store"
// is the expand pass's stores of the bitmap's 0/1 mask alone (the floor),
// "count" the count pass, "scan" the count pass and the expand pass's
// offsets step (the main path has no scan pass of its own: the offsets are
// written out, with each frame's count and overflow flag), "full"
// pr_decode_l1.

#include "common.cuh"

namespace {

constexpr int TILE_BYTES = TILE_PIXELS / 8;   // bitmap bytes of a tile
constexpr int COUNT_BLOCKS = 132 * 4;         // the count pass: a few blocks an H100 SM
constexpr int COUNT_UNROLL = 4;               // tiles a warp loads before it sums them
constexpr int EXPAND_TILES = 16;              // tiles an expand block walks
constexpr int STAGE = 256;                    // values a warp stages for its tile

static_assert(TILE_BYTES == 32 * 16, "a warp's 16-byte loads cover one tile");
static_assert(EXPAND_TILES <= 32, "a warp scans the block's tile counts");

enum class Cut { kStore, kScan, kFull };

// Bytes [16 * lane, 16 * lane + 16) of tile t of a frame's bitmap row as four
// little-endian words; bits at or past n_pixels read as 0.  One 16-byte load
// where the row starts on a 16-byte boundary and the bytes lie inside the
// frame's pixels, else a byte at a time.
__device__ __forceinline__ uint4 load_tile_bytes(const uint8_t* __restrict__ row, int64_t n_bytes,
                                                 int64_t n_pixels, int64_t t, int lane) {
    const int64_t byte0 = t * TILE_BYTES + 16 * lane;
    if ((byte0 + 16) * 8 <= n_pixels && (reinterpret_cast<uintptr_t>(row) & 15u) == 0) {
        return __ldg(reinterpret_cast<const uint4*>(row + byte0));
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        if (byte0 + k < n_bytes) w[k >> 2] |= static_cast<uint32_t>(row[byte0 + k]) << (8 * (k & 3));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int64_t valid = n_pixels - (byte0 + 4 * q) * 8;
        if (valid <= 0) {
            w[q] = 0u;
        } else if (valid < 32) {
            w[q] &= (1u << valid) - 1u;
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int popc4(uint4 q) {
    return __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
}

// Pass 1: each tile's set bits; tile g of the batch is frame g / n_tiles,
// tile g % n_tiles.
__global__ void __launch_bounds__(BLOCK)
decode_count_kernel(const uint8_t* __restrict__ bitmap, int* __restrict__ tiles, int64_t n_pixels,
                    int64_t n_bytes, int64_t n_tiles, int64_t all_tiles) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = static_cast<int64_t>(gridDim.x) * WARPS;
    for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
         g0 < all_tiles; g0 += COUNT_UNROLL * warps) {
        uint4 q[COUNT_UNROLL];
#pragma unroll
        for (int u = 0; u < COUNT_UNROLL; ++u) {
            const int64_t g = g0 + u * warps;
            q[u] = g < all_tiles ? load_tile_bytes(bitmap + g / n_tiles * n_bytes, n_bytes,
                                                   n_pixels, g % n_tiles, lane)
                                 : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < COUNT_UNROLL; ++u) {
            const int64_t g = g0 + u * warps;
            const int c = __reduce_add_sync(kFullMask, popc4(q[u]));
            if (lane == 0 && g < all_tiles) tiles[g] = c;
        }
    }
}

// Pass 2 (module note), cut as the phase probe asks: kStore stores the 0/1
// mask and reads no count; kScan writes the tile offsets, counts and overflow
// flags and stores nothing; kFull is the decode (counts and offsets unused).
template <Cut kCut>
__global__ void __launch_bounds__(BLOCK)
decode_expand_kernel(const uint8_t* __restrict__ bitmap, const int* __restrict__ tiles,
                     const int32_t* __restrict__ values, uint16_t* __restrict__ dense,
                     uint8_t* __restrict__ overflow, int* __restrict__ counts,
                     int* __restrict__ offsets, int64_t n_pixels, int64_t n_bytes,
                     int64_t n_tiles, int64_t n_values) {
    __shared__ __align__(16) uint32_t words_s[WARPS][32 * 4];   // a warp's tile: its words,
    __shared__ __align__(16) int pre_s[WARPS][32 * 4];          // the set bits before each,
    __shared__ uint16_t vals_s[WARPS][STAGE];                   // its first STAGE values
    const int64_t b = blockIdx.y;
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * EXPAND_TILES;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint8_t* row = bitmap + b * n_bytes;
    int64_t before = 0;   // the frame's set bits before tile t0
    int excl = 0;         // lane j: the set bits of tiles t0 .. t0 + j - 1
    if constexpr (kCut != Cut::kStore) {
        const int* tb = tiles + b * n_tiles;
        const int own = lane < EXPAND_TILES && t0 + lane < n_tiles ? tb[t0 + lane] : 0;
        int part = 0;
#pragma unroll 4
        for (int64_t j = threadIdx.x; j < t0; j += BLOCK) part += tb[j];
        const int incl = warp_inclusive_scan(own);
        const int block_bits = __shfl_sync(kFullMask, incl, 31);
        excl = incl - own;
        int sum;
        block_warp_prefix(__reduce_add_sync(kFullMask, part), &sum);
        before = sum;
        if (threadIdx.x == 0 && t0 + EXPAND_TILES >= n_tiles) {   // the frame's last tile
            const int64_t frame = before + block_bits;
            overflow[b] = frame > n_values ? 1 : 0;
            if constexpr (kCut == Cut::kScan) counts[b] = static_cast<int>(frame);
        }
        if constexpr (kCut == Cut::kScan) {
            if (warp == 0 && lane < EXPAND_TILES && t0 + lane < n_tiles) {
                offsets[b * n_tiles + t0 + lane] = static_cast<int>(before + excl);
            }
            return;
        }
    }
    const int32_t* vals = values + b * n_values;
    uint16_t* out = dense + b * n_pixels;
    const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    const int shift = 8 * (lane & 3);   // the lane's byte in the word it reads
    // each warp loads its next tile's bitmap while it stores the one before
    uint4 next = warp < EXPAND_TILES && t0 + warp < n_tiles
                     ? load_tile_bytes(row, n_bytes, n_pixels, t0 + warp, lane)
                     : make_uint4(0u, 0u, 0u, 0u);
    for (int j = warp; j < EXPAND_TILES && t0 + j < n_tiles; j += WARPS) {
        const int64_t t = t0 + j;
        const uint4 q = next;
        if (j + WARPS < EXPAND_TILES && t + WARPS < n_tiles) {
            next = load_tile_bytes(row, n_bytes, n_pixels, t + WARPS, lane);
        }
        const int c0 = __popc(q.x);
        const int c1 = __popc(q.y);
        const int c2 = __popc(q.z);
        const int c = popc4(q);
        const int lane_incl = warp_inclusive_scan(c);
        const int lp = lane_incl - c;
        reinterpret_cast<uint4*>(words_s[warp])[lane] = q;
        reinterpret_cast<int4*>(pre_s[warp])[lane] =
            make_int4(lp, lp + c0, lp + c0 + c1, lp + c0 + c1 + c2);
        int64_t base = 0;   // the tile's first rank
        if constexpr (kCut == Cut::kFull) {
            base = before + __shfl_sync(kFullMask, excl, j);
            const int n_tile = __shfl_sync(kFullMask, lane_incl, 31);
            for (int k = lane; k < n_tile && k < STAGE; k += 32) {
                vals_s[warp][k] = base + k < n_values ? static_cast<uint16_t>(vals[base + k]) : 0;
            }
        }
        __syncwarp();
        const int64_t first = t * TILE_PIXELS;
#pragma unroll 4
        for (int r = 0; r < TILE_BYTES / 32; ++r) {
            const int64_t p0 = first + 8 * (32 * r + lane);   // the lane's byte's first pixel
            if (p0 >= n_pixels) break;
            const int idx = 8 * r + (lane >> 2);
            const uint32_t w = words_s[warp][idx];
            const uint32_t byte = (w >> shift) & 0xFFu;
            unsigned long long lo = 0ull;   // pixels 0..3 of the byte, 16 bits each
            unsigned long long hi = 0ull;   // pixels 4..7
            if constexpr (kCut == Cut::kStore) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    lo |= static_cast<unsigned long long>((byte >> i) & 1u) << (16 * i);
                    hi |= static_cast<unsigned long long>((byte >> (i + 4)) & 1u) << (16 * i);
                }
            } else if (byte) {
                int k = pre_s[warp][idx] + __popc(w & ((1u << shift) - 1u));   // rank in the tile
                for (uint32_t m = byte; m; m &= m - 1u, ++k) {
                    const int bit = __ffs(m) - 1;
                    const unsigned long long v =
                        k < STAGE ? vals_s[warp][k]
                                  : base + k < n_values ? static_cast<uint16_t>(vals[base + k]) : 0u;
                    if (bit < 4) {
                        lo |= v << (16 * bit);
                    } else {
                        hi |= v << (16 * (bit - 4));
                    }
                }
            }
            uint16_t* dst = out + p0;
            if (aligned && p0 + 8 <= n_pixels) {
                __stcs(reinterpret_cast<uint4*>(dst),
                       make_uint4(static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
                                  static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32)));
            } else {
                for (int i = 0; i < 8 && p0 + i < n_pixels; ++i) {
                    dst[i] = static_cast<uint16_t>((i < 4 ? lo >> (16 * i) : hi >> (16 * (i - 4))));
                }
            }
        }
        __syncwarp();   // the next tile's shared writes after this one's reads
    }
}

void launch_count(const uint8_t* bitmap, int* tiles, int64_t batch, int64_t n_pixels,
                  int64_t n_bytes, int64_t n_tiles, cudaStream_t s) {
    const int64_t all_tiles = batch * n_tiles;
    if (all_tiles == 0) return;
    const int64_t need = (all_tiles + WARPS - 1) / WARPS;
    const unsigned blocks = static_cast<unsigned>(need < COUNT_BLOCKS ? need : COUNT_BLOCKS);
    decode_count_kernel<<<blocks, BLOCK, 0, s>>>(bitmap, tiles, n_pixels, n_bytes, n_tiles,
                                                 all_tiles);
}

template <Cut kCut>
void launch_expand(const void* bitmap, const int* tiles, const void* values, void* dense,
                   void* overflow, int* counts, int* offsets, int64_t batch, int64_t n_pixels,
                   int64_t n_bytes, int64_t n_tiles, int64_t n_values, cudaStream_t s) {
    // one block at least a frame, so that a frame of no pixels gets its flag
    const int64_t cols = n_tiles > 0 ? (n_tiles + EXPAND_TILES - 1) / EXPAND_TILES : 1;
    const dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(batch));
    decode_expand_kernel<kCut><<<grid, BLOCK, 0, s>>>(
        static_cast<const uint8_t*>(bitmap), tiles, static_cast<const int32_t*>(values),
        static_cast<uint16_t*>(dense), static_cast<uint8_t*>(overflow), counts, offsets,
        n_pixels, n_bytes, n_tiles, n_values);
}

}  // namespace

// bitmap (batch, ceil(n_pixels / 8)) u8, values (batch, n_values) i32 ->
// dense (batch, n_pixels) u16, overflow (batch,) u8; tiles (batch,
// pr_num_tiles(n_pixels)) i32 is scratch.  Returns cudaGetLastError().
extern "C" int pr_decode_l1(const void* bitmap, const void* values, void* dense, void* overflow,
                            void* tiles, int64_t batch, int64_t n_pixels, int64_t n_values,
                            void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    auto* tl = static_cast<int*>(tiles);
    launch_count(static_cast<const uint8_t*>(bitmap), tl, batch, n_pixels, n_bytes, n_tiles, s);
    launch_expand<Cut::kFull>(bitmap, tl, values, dense, overflow, nullptr, nullptr, batch,
                              n_pixels, n_bytes, n_tiles, n_values, s);
    return static_cast<int>(cudaGetLastError());
}

// The phase probe's cut-offs of pr_decode_l1.  stop_after 0 ("store"): the
// expand pass storing the 0/1 mask, dense (batch, n_pixels) u16; 1 ("count"):
// the count pass, each tile's set bits in tiles; 2 ("scan"): then the expand
// pass's offsets step, the tile offsets in offsets (batch, pr_num_tiles), the
// counts (batch,) i32 and overflow; 3 ("full"): pr_decode_l1 itself.  Other
// arguments as pr_decode_l1's.  Returns cudaGetLastError().
extern "C" int pr_decode_l1_phases(const void* bitmap, const void* values, void* dense,
                                   void* overflow, void* counts, void* tiles, void* offsets,
                                   int64_t batch, int64_t n_pixels, int64_t n_values,
                                   int stop_after, void* stream) {
    if (stop_after >= 3) {
        return pr_decode_l1(bitmap, values, dense, overflow, tiles, batch, n_pixels, n_values,
                            stream);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_bytes = (n_pixels + 7) / 8;
    const int64_t n_tiles = num_tiles(n_pixels);
    auto* tl = static_cast<int*>(tiles);
    if (stop_after == 0) {
        launch_expand<Cut::kStore>(bitmap, tl, values, dense, overflow, nullptr, nullptr, batch,
                                   n_pixels, n_bytes, n_tiles, n_values, s);
        return static_cast<int>(cudaGetLastError());
    }
    launch_count(static_cast<const uint8_t*>(bitmap), tl, batch, n_pixels, n_bytes, n_tiles, s);
    if (stop_after == 2) {
        launch_expand<Cut::kScan>(bitmap, tl, values, dense, overflow, static_cast<int*>(counts),
                                  static_cast<int*>(offsets), batch, n_pixels, n_bytes, n_tiles,
                                  n_values, s);
    }
    return static_cast<int>(cudaGetLastError());
}
