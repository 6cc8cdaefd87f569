// Fused L2/L4 encode: threshold -> 8-connected puddle labels in scipy's
// raster order -> L2 per-puddle statistics or L4 centroids and their bitmap.
//
// Replaces pyrecode_tpu/ops/pallas_label.py:encode_l2l4_pallas (kernel
// built by _build_l2l4_kernel), all five modes (l2max, l2sum, l4w, l4u,
// l4m).  The TPU kernel labels each chunk of rows by K rounds of a 3x3
// box-min inside a K-row halo and gathers each puddle's members through
// (2K+1)-wide window taps around its root, so a puddle taller or wider than
// the halo overflows and the caller escalates K or falls back to XLA.  Here
// the labels come from a union-find over the whole frame, so any puddle size
// and shape is exact and the only overflow is count > out_size.
//
// Bound on this card: one read of frame and threshold (4 B a pixel) plus the
// bitmap and stats writes.  The frames are read once, by pass 1; every later
// pass reads the 1-bit mask and touches parent (the union-find scratch, 4 B
// a pixel, never filled) only at foreground pixels, ~1% of a detector frame:
//
//   1. label_mask_kernel, the one dense pass: a block covers TILE_H rows of
//      TILE_W pixels (a warp a row, 16-byte loads of 8 pixels a lane where
//      W % 8 == 0; the batch's frames of one tile in neighbouring blocks, so
//      the threshold tile comes from L2).  mask = frame > threshold
//      (unsigned) into the LSB-first bitmap (the output at L2; scratch at L4,
//      whose output bitmap gets its zeros here), and each foreground pixel's
//      parent = the first pixel of its run of set bits in the row's TILE_W
//      segment, from a max-scan of the lanes' last clear bits.  Labelling
//      the tile in shared memory in this pass, with barriers between its
//      steps, kept the loads from overlapping and took several times the
//      dense read; runs need no barrier;
//   2. label_link_kernel: the unions between runs (the rule below), with
//      the global unite below; it also zeroes the accumulator slots;
//   3. label_rank_kernel: each root (a set bit with parent[p] == p), in
//      raster order within its linear tile, gets parent[root] = -(its rank
//      in the tile) - 2, and each tile's roots are counted;
//   4. scan_tiles_kernel (common.cuh): tile offsets, puddle counts, overflow
//      (count > out_size);
//   5. label_accumulate_kernel: every foreground pixel follows its chain to
//      the root's code and adds its RAW frame value to its puddle's slot
//      (rank = the root tile's offset + its rank in the tile) with 64-bit
//      integer atomics: max or sum (L2); sums of w, w*row and w*col (L4
//      weighted_average, w = 1 for unweighted); the largest (value << 32 |
//      0xFFFFFFFF - lin) for L4 max, which keeps the first raster-order
//      maximum;
//   6. label_finalize_kernel: one thread a slot.  L2: min(acc, stat_limit)
//      below the count, 0 from it on.  L4: the centroid by exact
//      round-half-even integer division, clipped to the frame, OR-ed into the
//      bitmap with a 32-bit atomicOr on the aligned word of the whole buffer
//      (a frame's row of ceil(H*W/8) bytes need not be 4-aligned; the bit
//      touches only its own byte).
// Passes 2, 3 and 5 visit only set bits, over linear raster tiles of
// LIN_PIXELS pixels: each warp deals its set bits out one a lane a round,
// so a lane waits on one chain of parent reads a round.
//
// Union-find: a union hooks the larger root under the smaller with atomicCAS
// on the root and re-finds both after a failed hook, so parent[x] <= x
// always holds and each tree's root is its component's smallest linear
// index: scipy.ndimage.label's first pixel.  A run's first pixel is its
// smallest index, so pass 1 keeps that too.  The 8-neighbour pairs pass 2
// unites, for a foreground pixel p with W, NW, N, NE, E its neighbours: W
// only where p starts a row segment (inside one, pass 1's runs join W); N if
// set, unless W and NW both are (W's chain to NW joins them); else NW unless
// W is set (W joins it), and NE unless E is set (E's N pair joins it).
// Every other neighbour pair is joined through those.  Puddles are 1-9
// pixels, ~2 runs each, so pass 2 makes ~1-2 unions a puddle.  Reads of
// parent in pass 2 are volatile: other SMs relink the trees while a block
// walks them, and a stale L1 line would make a failed hook repeat forever.
//
// All arithmetic is integer, so the results are exact whatever order the
// atomics land in.

#include "common.cuh"

namespace {

enum Mode { L2MAX = 0, L2SUM = 1, L4W = 2, L4U = 3, L4M = 4 };

constexpr int TILE_W = 256;                  // pass 1: a warp's row of 16-byte loads
constexpr int TILE_H = 32;
constexpr int ROWS_PER_WARP = TILE_H / WARPS;
constexpr int LANE_WORDS = 2;                // passes 2, 3 and 5: mask words a lane
constexpr int LIN_WORDS = BLOCK * LANE_WORDS;
constexpr int64_t LIN_PIXELS = LIN_WORDS * 32;

static_assert(TILE_W == 8 * 32, "a warp loads one tile row, 8 pixels a lane");
static_assert(TILE_H % WARPS == 0, "the warps share the tile rows evenly");

__device__ __forceinline__ int load_parent(const int* parent, int i) {
    return *reinterpret_cast<const volatile int*>(parent + i);
}

__device__ __forceinline__ void store_parent(int* parent, int i, int v) {
    *reinterpret_cast<volatile int*>(parent + i) = v;
}

// Join the trees of a and b.  Both roots are found side by side, halving
// each path on the way: only non-roots are rewritten, and only to an
// ancestor, so a tree never loses a member; roots change only by the hook's
// atomicCAS, which fails (and the union starts again) if a is no root by
// then.
__device__ void unite(int* parent, int a, int b) {
    while (true) {
        bool root_a = false;
        bool root_b = false;
        while (!(root_a && root_b)) {
            const int pa = root_a ? a : load_parent(parent, a);
            const int pb = root_b ? b : load_parent(parent, b);
            root_a = pa == a;
            root_b = pb == b;
            if (!root_a) {
                const int ga = load_parent(parent, pa);
                if (ga != pa) store_parent(parent, a, ga);
                root_a = ga == pa;   // then a's parent is its root
                a = ga;
            }
            if (!root_b) {
                const int gb = load_parent(parent, pb);
                if (gb != pb) store_parent(parent, b, gb);
                root_b = gb == pb;
                b = gb;
            }
        }
        if (a == b) return;
        if (a < b) {
            const int t = a;
            a = b;
            b = t;
        }
        if (atomicCAS(parent + a, a, b) == a) return;   // a was still a root
    }
}

__device__ __forceinline__ bool mask_bit(const uint8_t* mask, int p) {
    return (mask[p >> 3] >> (p & 7)) & 1;
}

// 8 bits, LSB first: f > t in each of the 8 u16 lanes of two 16-byte vectors
__device__ __forceinline__ uint32_t greater8(uint4 f, uint4 t) {
    const uint32_t a[4] = {f.x, f.y, f.z, f.w};
    const uint32_t b[4] = {t.x, t.y, t.z, t.w};
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t gt = __vcmpgtu2(a[i], b[i]);   // 0xffff in each halfword where a > b
        m |= ((gt & 1u) | ((gt >> 15) & 2u)) << (2 * i);
    }
    return m;
}

// The 8 pixels [c, c + 8) of row r of a frame (width % 8 == 0) as a 16-byte
// vector, read once (evict-first in L2, which keeps parent and the mask
// there for the later passes); zeros outside the frame.
__device__ __forceinline__ uint4 load8(const uint16_t* frame, int r, int c, int height,
                                       int width) {
    if (r >= height || c >= width) return make_uint4(0, 0, 0, 0);
    return __ldcs(reinterpret_cast<const uint4*>(frame + static_cast<int64_t>(r) * width + c));
}

// Bits of frame > threshold at pixels [c, c + 8) of row r (any width), 0
// outside the frame.
__device__ __forceinline__ uint32_t greater_scalar(const uint16_t* frame, const uint16_t* thr,
                                                   int r, int c, int height, int width) {
    uint32_t v = 0;
    if (r < height) {
        for (int j = 0; j < 8 && c + j < width; ++j) {
            const int64_t q = static_cast<int64_t>(r) * width + c + j;
            v |= static_cast<uint32_t>(frame[q] > thr[q]) << j;
        }
    }
    return v;
}

__global__ void __launch_bounds__(BLOCK)
label_mask_kernel(const uint16_t* __restrict__ frames, const uint16_t* __restrict__ thr,
                  uint8_t* __restrict__ mask, uint8_t* __restrict__ zero_out,
                  int* __restrict__ parent, int batch, int height, int width, int tiles_x,
                  int64_t n_bytes, bool vec) {
    const int b = static_cast<int>(blockIdx.x % batch);
    const int tile = static_cast<int>(blockIdx.x / batch);
    const int r0 = tile / tiles_x * TILE_H;
    const int c0 = tile % tiles_x * TILE_W;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t n = static_cast<int64_t>(height) * width;
    const uint16_t* f = frames + b * n;
    uint8_t* m = mask + b * n_bytes;
    uint8_t* z = zero_out == nullptr ? nullptr : zero_out + b * n_bytes;
    int* par = parent + b * n;
    const int c = c0 + 8 * lane;   // this lane's first pixel of each of its rows
    uint32_t bits[ROWS_PER_WARP];
    if (vec) {
        uint4 fv[ROWS_PER_WARP];
        uint4 tv[ROWS_PER_WARP];
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k) {
            fv[k] = load8(f, r0 + warp + WARPS * k, c, height, width);
            tv[k] = load8(thr, r0 + warp + WARPS * k, c, height, width);
        }
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k) bits[k] = greater8(fv[k], tv[k]);
    } else {
#pragma unroll
        for (int k = 0; k < ROWS_PER_WARP; ++k) {
            bits[k] = greater_scalar(f, thr, r0 + warp + WARPS * k, c, height, width);
        }
    }
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
        const int r = r0 + warp + WARPS * k;
        if (r >= height) break;   // warp-uniform
        const int64_t row = static_cast<int64_t>(r) * width;
        if (vec) {
            // width % 8 == 0: a lane's 8 pixels are one bitmap byte
            if (c < width) {
                m[(row + c) >> 3] = static_cast<uint8_t>(bits[k]);
                if (z != nullptr) z[(row + c) >> 3] = 0;
            }
        } else {
            // the bitmap bytes whose first pixel lies in this row segment:
            // lane j takes the j-th, from its own bits and the next lane's,
            // and past the segment's end (a row's end, the next tile) from
            // the frame
            const int64_t seg1 = row + min(c0 + TILE_W, width);
            const int64_t byte = (row + c0 + 7) / 8 + lane;
            const int d = static_cast<int>(8 * byte - row - c0 - 8 * lane);   // 0..7
            const uint32_t next = __shfl_down_sync(kFullMask, bits[k], 1);
            uint32_t v = ((bits[k] | (lane < 31 ? next << 8 : 0u)) >> d) & 0xFFu;
            if (8 * byte < seg1) {
                for (int j = 0; j < 8 && 8 * byte + j < n; ++j) {
                    const int64_t q = 8 * byte + j;
                    if (q >= seg1 && f[q] > thr[q]) v |= 1u << j;
                }
                m[byte] = static_cast<uint8_t>(v);
                if (z != nullptr) z[byte] = 0;
            }
        }
        // each set bit's parent: the first pixel of its run in the segment,
        // one past the last clear bit before it (in this lane's byte or,
        // by an inclusive max-scan, in an earlier lane's)
        const uint32_t clear = ~bits[k] & 0xFFu;
        int last_clear = clear != 0u ? 8 * lane + 31 - __clz(clear) : -1;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kFullMask, last_clear, d);
            if (lane >= d) last_clear = max(last_clear, up);
        }
        const int before = __shfl_up_sync(kFullMask, last_clear, 1);   // lanes below this one
        for (uint32_t v = bits[k]; v != 0u; v &= v - 1u) {
            const int j = __ffs(v) - 1;
            const uint32_t below = clear & ((1u << j) - 1u);
            const int start = below != 0u ? 8 * lane + 32 - __clz(below)
                                           : (lane > 0 ? before + 1 : 0);
            par[row + c + j] = static_cast<int>(row + c0 + start);
        }
    }
}

// The set bits of a warp's mask words of a linear tile (lane j loads words
// LANE_WORDS * j ..), in raster order, dealt out one a lane a round: bit i
// goes to lane i % 32 in round i / 32, so a puddle's pixels are spread over
// lanes and a lane waits on one chain of parent reads a round.
struct WarpBits {
    int64_t first_word;
    uint32_t words[LANE_WORDS];   // this lane's words
    int excl;                     // set bits in the warp's words before this lane's
    int total;                    // set bits in the warp's words
};

__device__ __forceinline__ WarpBits warp_bits(const uint8_t* mask, int64_t n_bytes,
                                              int64_t n_pixels) {
    const int lane = threadIdx.x & 31;
    WarpBits wb;
    wb.first_word = static_cast<int64_t>(blockIdx.x) * LIN_WORDS +
                    (threadIdx.x >> 5) * 32 * LANE_WORDS;
    int c = 0;
#pragma unroll
    for (int s = 0; s < LANE_WORDS; ++s) {
        wb.words[s] = load_bitmap_word(mask, n_bytes, n_pixels,
                                       wb.first_word + LANE_WORDS * lane + s);
        c += __popc(wb.words[s]);
    }
    const int incl = warp_inclusive_scan(c);
    wb.excl = incl - c;
    wb.total = __shfl_sync(kFullMask, incl, 31);
    return wb;
}

// The pixel of the warp's set bit i (every lane calls it, i < total or not).
__device__ __forceinline__ int warp_bit_pixel(const WarpBits& wb, int i) {
    int owner = 0;   // the last lane whose preceding bits are at most i
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFullMask, wb.excl, owner + step) <= i) owner += step;
    }
    int k = i - __shfl_sync(kFullMask, wb.excl, owner);
    int64_t word = 0;
    int bit = 0;
#pragma unroll
    for (int s = 0; s < LANE_WORDS; ++s) {
        const uint32_t w = __shfl_sync(kFullMask, wb.words[s], owner);
        const int cnt = __popc(w);
        if (k >= 0 && k < cnt) {
            word = wb.first_word + LANE_WORDS * owner + s;
            bit = __fns(w, 0, k + 1);
        }
        k -= cnt;
    }
    return static_cast<int>(word * 32 + bit);
}

// Pass 2: the pairs of the rule above that no run joins, for every set bit;
// the block also zeroes its share of the frame's acc_words accumulator words
// for pass 5.
__global__ void __launch_bounds__(BLOCK)
label_link_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                  unsigned long long* __restrict__ acc, int64_t acc_words, int64_t n_pixels,
                  int64_t n_bytes, int64_t n_tiles, int width) {
    const int64_t b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const uint8_t* m = mask + b * n_bytes;
    int* par = parent + b * n_pixels;
    const int64_t share = (acc_words + n_tiles - 1) / n_tiles;
    const int64_t end = (blockIdx.x + 1) * share < acc_words ? (blockIdx.x + 1) * share : acc_words;
    for (int64_t i = blockIdx.x * share + threadIdx.x; i < end; i += BLOCK) {
        acc[b * acc_words + i] = 0ull;
    }
    const WarpBits wb = warp_bits(m, n_bytes, n_pixels);
    for (int i = lane; i - lane < wb.total; i += 32) {
        const int p = warp_bit_pixel(wb, i);
        if (i >= wb.total) continue;
        const int r = p / width;
        const int c = p - r * width;
        const bool w = c > 0 && mask_bit(m, p - 1);
        const bool e = c + 1 < width && mask_bit(m, p + 1);
        if (w && c % TILE_W == 0) unite(par, p, p - 1);
        if (r == 0) continue;
        const int up = p - width;
        const bool nw = c > 0 && mask_bit(m, up - 1);
        if (mask_bit(m, up)) {
            if (!(w && nw)) unite(par, p, up);
            continue;
        }
        if (!w && nw) unite(par, p, up - 1);
        if (c + 1 < width && !e && mask_bit(m, up + 1)) unite(par, p, up + 1);
    }
}

// Pass 3: each root (a set bit with parent[p] == p), in raster order within
// its linear tile, gets parent[root] = -(rank in the tile) - 2; the tile's
// root count goes to tiles.
__global__ void __launch_bounds__(BLOCK)
label_rank_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                  int* __restrict__ tiles, int64_t n_pixels, int64_t n_bytes, int64_t n_tiles) {
    __shared__ uint32_t root_rounds[WARPS][32 * LANE_WORDS];   // a round's roots, as a ballot
    const int64_t b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int* par = parent + b * n_pixels;
    const WarpBits wb = warp_bits(mask + b * n_bytes, n_bytes, n_pixels);
    int roots = 0;
    for (int i = lane, round = 0; i - lane < wb.total; i += 32, ++round) {
        const int p = warp_bit_pixel(wb, i);
        const uint32_t ballot = __ballot_sync(kFullMask, i < wb.total && par[p] == p);
        if (lane == 0) root_rounds[warp][round] = ballot;
        roots += __popc(ballot);
    }
    int total;
    int rank = block_warp_prefix(roots, &total);
    const uint32_t below = (1u << lane) - 1u;
    for (int i = lane, round = 0; i - lane < wb.total; i += 32, ++round) {
        const int p = warp_bit_pixel(wb, i);
        const uint32_t ballot = root_rounds[warp][round];
        if ((ballot >> lane) & 1u) par[p] = -(rank + __popc(ballot & below)) - 2;
        rank += __popc(ballot);
    }
    if (threadIdx.x == 0) tiles[b * n_tiles + blockIdx.x] = total;
}

// Pass 5: a pixel's puddle rank is its root's tile offset (pass 4) plus the
// rank in the tile that pass 3 left at the root, the end of its chain.
__global__ void __launch_bounds__(BLOCK)
label_accumulate_kernel(const uint16_t* __restrict__ frames, const uint8_t* __restrict__ mask,
                        const int* __restrict__ parent, const int* __restrict__ tile_offsets,
                        unsigned long long* __restrict__ acc, int mode, int64_t n_pixels,
                        int64_t n_bytes, int64_t n_tiles, int64_t out_size, int width) {
    const int64_t b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int* par = parent + b * n_pixels;
    const uint16_t* f = frames + b * n_pixels;
    const WarpBits wb = warp_bits(mask + b * n_bytes, n_bytes, n_pixels);
    const int own_offset = tile_offsets[b * n_tiles + blockIdx.x];
    for (int i = lane; i - lane < wb.total; i += 32) {
        const int p = warp_bit_pixel(wb, i);
        if (i >= wb.total) continue;
        int root = p;
        int code = par[p];
        while (code >= 0) {
            root = code;
            code = par[root];
        }
        const int64_t rank = (root / LIN_PIXELS == blockIdx.x
                                  ? own_offset
                                  : tile_offsets[b * n_tiles + root / LIN_PIXELS]) -
                             static_cast<int64_t>(code) - 2;
        if (rank >= out_size) continue;
        unsigned long long* slot = acc + b * out_size + rank;
        const unsigned long long val = f[p];
        switch (mode) {
            case L2MAX:
                atomicMax(slot, val);
                break;
            case L2SUM:
                atomicAdd(slot, val);
                break;
            case L4M:
                atomicMax(slot, (val << 32) | (0xFFFFFFFFull - static_cast<unsigned long long>(p)));
                break;
            default: {  // L4W, L4U: three words a slot
                const unsigned long long wt = mode == L4W ? val : 1ull;
                const int r = p / width;
                slot = acc + (b * out_size + rank) * 3;
                atomicAdd(slot, wt);
                atomicAdd(slot + 1, wt * static_cast<unsigned long long>(r));
                atomicAdd(slot + 2, wt * static_cast<unsigned long long>(p - r * width));
            }
        }
    }
}

// round-half-even(num / den), exact (the oracle's round_div)
__device__ __forceinline__ int64_t round_div(unsigned long long num, unsigned long long den) {
    if (den == 0) den = 1;
    const unsigned long long q = num / den;
    const unsigned long long rem = num - q * den;
    const unsigned long long down = den - rem;
    const bool up = rem > down || (rem == down && (q & 1ull));
    return static_cast<int64_t>(q + (up ? 1ull : 0ull));
}

__global__ void label_finalize_kernel(const unsigned long long* __restrict__ acc,
                                      const int* __restrict__ counts,
                                      int32_t* __restrict__ stats,
                                      uint32_t* __restrict__ bitmap_words, int mode,
                                      int64_t out_size, int64_t stat_limit, int height,
                                      int width, int64_t n_bytes) {
    const int64_t b = blockIdx.y;
    const int64_t k = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (k >= out_size) return;
    const bool live = k < counts[b];
    if (mode == L2MAX || mode == L2SUM) {
        const unsigned long long a = live ? acc[b * out_size + k] : 0ull;
        const unsigned long long lim = static_cast<unsigned long long>(stat_limit);
        stats[b * out_size + k] = static_cast<int32_t>(a < lim ? a : lim);
        return;
    }
    if (!live) return;
    int64_t r;
    int64_t c;
    if (mode == L4M) {
        const unsigned long long low = acc[b * out_size + k] & 0xFFFFFFFFull;
        const int64_t lin = 0xFFFFFFFFll - static_cast<int64_t>(low);
        r = lin / width;
        c = lin - r * width;
    } else {
        const unsigned long long* slot = acc + (b * out_size + k) * 3;
        r = round_div(slot[1], slot[0]);
        c = round_div(slot[2], slot[0]);
    }
    r = r < 0 ? 0 : (r >= height ? height - 1 : r);
    c = c < 0 ? 0 : (c >= width ? width - 1 : c);
    const int64_t lin = r * width + c;
    const int64_t byte = b * n_bytes + (lin >> 3);
    atomicOr(bitmap_words + (byte >> 2), 1u << ((byte & 3) * 8 + (lin & 7)));
}

}  // namespace

// Linear tiles of passes 3-6 in a frame of n_pixels: the length of a row of
// the tiles scratch.
extern "C" int64_t pr_label_tiles(int64_t n_pixels) {
    return (n_pixels + LIN_PIXELS - 1) / LIN_PIXELS;
}

// frames (batch, height * width) u16, thr (height * width) u16.  mask
// (batch, ceil(n / 8)) u8 receives the foreground bitmap: the output bitmap
// at L2, scratch at L4, where bitmap is the output buffer of at least
// ceil(batch * ceil(n / 8) / 4) u32 words (pass 1 zeroes its first batch *
// ceil(n / 8) bytes).  parent (batch, n) i32, tiles (batch, pr_label_tiles(n))
// i32 and acc, u64 of (batch, out_size, 3) for L4 weighted_average /
// unweighted and (batch, out_size) otherwise, are scratch that needs no fill.
// stats (batch, out_size) i32 (L2 only, else null), counts (batch,) i32
// puddles, overflow (batch,) u8 = count > out_size.  Returns
// cudaGetLastError().
extern "C" int pr_label_l2l4(const void* frames, const void* thr, void* mask, void* bitmap,
                             void* parent, void* tiles, void* acc, void* stats, void* counts,
                             void* overflow, int mode, int64_t batch, int64_t height,
                             int64_t width, int64_t out_size, int64_t stat_limit, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n = height * width;
    const int64_t n_bytes = (n + 7) / 8;
    const int64_t n_tiles = pr_label_tiles(n);
    const int64_t tiles_x = (width + TILE_W - 1) / TILE_W;
    const int64_t mask_blocks = batch * tiles_x * ((height + TILE_H - 1) / TILE_H);
    if (mask_blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = width % 8 == 0 && (reinterpret_cast<uintptr_t>(frames) & 15u) == 0 &&
                     (reinterpret_cast<uintptr_t>(thr) & 15u) == 0;
    const dim3 lin_grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* f = static_cast<const uint16_t*>(frames);
    auto* m = static_cast<uint8_t*>(mask);
    auto* par = static_cast<int*>(parent);
    auto* tl = static_cast<int*>(tiles);
    auto* a = static_cast<unsigned long long*>(acc);
    const int b = static_cast<int>(batch);
    const int h = static_cast<int>(height);
    const int w = static_cast<int>(width);
    const int tx = static_cast<int>(tiles_x);
    const bool l4 = mode == L4W || mode == L4U || mode == L4M;
    const int64_t acc_words = out_size * (mode == L4W || mode == L4U ? 3 : 1);
    label_mask_kernel<<<static_cast<unsigned>(mask_blocks), BLOCK, 0, s>>>(
        f, static_cast<const uint16_t*>(thr), m, l4 ? static_cast<uint8_t*>(bitmap) : nullptr,
        par, b, h, w, tx, n_bytes, vec);
    label_link_kernel<<<lin_grid, BLOCK, 0, s>>>(m, par, a, acc_words, n, n_bytes, n_tiles, w);
    label_rank_kernel<<<lin_grid, BLOCK, 0, s>>>(m, par, tl, n, n_bytes, n_tiles);
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        tl, n_tiles, static_cast<int*>(counts), static_cast<uint8_t*>(overflow), out_size);
    label_accumulate_kernel<<<lin_grid, BLOCK, 0, s>>>(f, m, par, tl, a, mode, n, n_bytes,
                                                       n_tiles, out_size, w);
    if (out_size > 0) {
        const dim3 slot_grid(static_cast<unsigned>((out_size + BLOCK - 1) / BLOCK),
                             static_cast<unsigned>(batch));
        label_finalize_kernel<<<slot_grid, BLOCK, 0, s>>>(
            a, static_cast<const int*>(counts), static_cast<int32_t*>(stats),
            static_cast<uint32_t*>(bitmap), mode, out_size, stat_limit, h, w, n_bytes);
    }
    return static_cast<int>(cudaGetLastError());
}
