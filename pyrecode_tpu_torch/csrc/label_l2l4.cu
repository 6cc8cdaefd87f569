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
// and shape is exact and the only overflow is count > out_size:
//
//   1. mask_kernel: mask = frame > threshold (unsigned) as an LSB-first
//      bitmap by warp ballot (the output bitmap at L2, scratch at L4);
//      parent[p] = p on the foreground, -1 elsewhere;
//   2. link_kernel: each foreground pixel unites with its earlier
//      8-neighbours (W, NW, N, NE; NW and NE only where no shared neighbour
//      links them already).  A union hooks the larger root under the smaller
//      with atomicCAS on the root and re-finds both after a failed hook, so
//      parent[x] <= x always holds and each tree's root is its component's
//      smallest linear index: scipy.ndimage.label's first pixel;
//   3. flatten_kernel: parent[p] = root for every foreground pixel (found
//      without rewriting the path, so no thread's store lands after another's
//      final one); one count of roots per tile;
//   4. scan_tiles_kernel (common.cuh): tile offsets, puddle counts and
//      overflow (count > out_size);
//   5. rank_kernel: each root's raster rank (ballot / popcount over the tile
//      scan), stored in place as parent[root] = -rank - 2;
//   6. accumulate_kernel: every foreground pixel adds its RAW frame value to
//      its puddle's slot with 64-bit integer atomics: max or sum (L2); sums
//      of w, w*row and w*col (L4 weighted_average, w = 1 for unweighted);
//      the largest (value << 32 | 0xFFFFFFFF - lin) for L4 max, which keeps
//      the first raster-order maximum;
//   7. finalize_kernel: one thread per slot.  L2: min(acc, stat_limit), so
//      slots from the count on are zero.  L4: the centroid by exact
//      round-half-even integer division, clipped to the frame, OR-ed into the
//      zeroed bitmap with a 32-bit atomicOr on the aligned word of the whole
//      buffer (a frame's row of ceil(H*W/8) bytes need not be 4-aligned; the
//      bit touches only its own byte).
//
// All arithmetic is integer, so the results are exact whatever order the
// atomics land in.  Bound on this card: the dense read of frame and
// threshold (4 B/pixel) plus the bitmap and stats writes; the union-find
// passes touch 4 B/pixel of parent scratch several times more, which is
// where the design spends its bytes.  The parent reads go through volatile
// loads: other SMs relink the trees while a block walks them, and a stale
// L1 line would make a failed hook repeat forever.

#include "common.cuh"

namespace {

enum Mode { L2MAX = 0, L2SUM = 1, L4W = 2, L4U = 3, L4M = 4 };

__device__ __forceinline__ int load_parent(const int* parent, int i) {
    return *reinterpret_cast<const volatile int*>(parent + i);
}

__device__ __forceinline__ void store_parent(int* parent, int i, int v) {
    *reinterpret_cast<volatile int*>(parent + i) = v;
}

// Root of x, halving the path on the way.  Only non-roots are rewritten, and
// only to an ancestor, so a tree never loses a member; roots change only by
// the hook's atomicCAS.
__device__ int find_root(int* parent, int x) {
    while (true) {
        const int p = load_parent(parent, x);
        if (p == x) return x;
        const int gp = load_parent(parent, p);
        if (gp == p) return p;
        store_parent(parent, x, gp);
        x = gp;
    }
}

// Root of x without rewriting the path: the flatten pass stores each
// pixel's final root, which a concurrent halving store could overwrite with
// an ancestor below the root.
__device__ int find_root_readonly(const int* parent, int x) {
    int p = load_parent(parent, x);
    while (p != x) {
        x = p;
        p = load_parent(parent, x);
    }
    return x;
}

__device__ void unite(int* parent, int a, int b) {
    while (true) {
        a = find_root(parent, a);
        b = find_root(parent, b);
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

__global__ void mask_kernel(const uint16_t* __restrict__ frames, const uint16_t* __restrict__ thr,
                            uint8_t* __restrict__ mask, int* __restrict__ parent,
                            int64_t n_pixels, int64_t n_bytes) {
    const int64_t b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint16_t* f = frames + b * n_pixels;
    uint8_t* m = mask + b * n_bytes;
    int* par = parent + b * n_pixels;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * TILE_WORDS + warp * WORDS_PER_WARP;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const int64_t word = first + k;
        const int64_t p = word * 32 + lane;
        const bool fg = p < n_pixels && f[p] > thr[p];
        const uint32_t bits = __ballot_sync(kFullMask, fg);
        const int64_t byte = word * 4 + lane;
        if (lane < 4 && byte < n_bytes) m[byte] = static_cast<uint8_t>(bits >> (8 * lane));
        if (p < n_pixels) par[p] = fg ? static_cast<int>(p) : -1;
    }
}

__global__ void link_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                            int64_t n_pixels, int64_t n_bytes, int width) {
    const int64_t b = blockIdx.y;
    const int64_t p64 = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (p64 >= n_pixels) return;
    const uint8_t* m = mask + b * n_bytes;
    const int p = static_cast<int>(p64);
    if (!mask_bit(m, p)) return;
    int* par = parent + b * n_pixels;
    const int r = p / width;
    const int c = p - r * width;
    const bool has_w = c > 0 && mask_bit(m, p - 1);
    if (has_w) unite(par, p, p - 1);
    if (r == 0) return;
    const int up = p - width;
    if (mask_bit(m, up)) {
        // N links NW (its W) and NE (NE's W is N)
        unite(par, p, up);
        return;
    }
    if (c > 0 && !has_w && mask_bit(m, up - 1)) unite(par, p, up - 1);   // W links NW
    if (c + 1 < width && mask_bit(m, up + 1)) unite(par, p, up + 1);
}

__global__ void flatten_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                               int* __restrict__ tiles, int64_t n_pixels, int64_t n_bytes,
                               int64_t n_tiles) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int* par = parent + b * n_pixels;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    const uint8_t* m = mask + b * n_bytes;
    int count = 0;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const int64_t p = (first + k) * 32 + lane;
        bool root = false;
        if (p < n_pixels && mask_bit(m, static_cast<int>(p))) {
            const int r = find_root_readonly(par, static_cast<int>(p));
            if (r != p) store_parent(par, static_cast<int>(p), r);
            root = r == p;
        }
        count += __popc(__ballot_sync(kFullMask, root));
    }
    int total;
    block_warp_prefix(count, &total);
    if (threadIdx.x == 0) tiles[b * n_tiles + t] = total;
}

__global__ void rank_kernel(int* __restrict__ parent, const int* __restrict__ tile_offsets,
                            int64_t n_pixels, int64_t n_tiles) {
    const int64_t b = blockIdx.y;
    const int64_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int* par = parent + b * n_pixels;
    const int64_t first = t * TILE_WORDS + warp * WORDS_PER_WARP;
    // lane k keeps the root flags of word k of the warp
    uint32_t mine = 0u;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const int64_t p = (first + k) * 32 + lane;
        const bool root = p < n_pixels && par[p] == p;
        const uint32_t bits = __ballot_sync(kFullMask, root);
        if (lane == k) mine = bits;
    }
    const int c = __popc(mine);
    const int incl = warp_inclusive_scan(c);
    const int excl = incl - c;
    int block_total;
    const int64_t base = static_cast<int64_t>(tile_offsets[b * n_tiles + t]) +
                         block_warp_prefix(__shfl_sync(kFullMask, incl, 31), &block_total);
    const uint32_t below = (1u << lane) - 1u;
    for (int k = 0; k < WORDS_PER_WARP; ++k) {
        const uint32_t w = __shfl_sync(kFullMask, mine, k);
        const int before = __shfl_sync(kFullMask, excl, k);
        if ((w >> lane) & 1u) {
            const int64_t rank = base + before + __popc(w & below);
            par[(first + k) * 32 + lane] = static_cast<int>(-rank - 2);
        }
    }
}

__global__ void accumulate_kernel(const uint16_t* __restrict__ frames,
                                  const int* __restrict__ parent,
                                  unsigned long long* __restrict__ acc, int mode,
                                  int64_t n_pixels, int64_t out_size, int width) {
    const int64_t b = blockIdx.y;
    const int64_t p64 = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (p64 >= n_pixels) return;
    const int* par = parent + b * n_pixels;
    const int v = par[p64];
    if (v == -1) return;
    const int code = v < -1 ? v : par[v];
    const int64_t rank = -static_cast<int64_t>(code) - 2;
    if (rank >= out_size) return;
    const unsigned long long val = frames[b * n_pixels + p64];
    const int p = static_cast<int>(p64);
    switch (mode) {
        case L2MAX:
            atomicMax(acc + b * out_size + rank, val);
            break;
        case L2SUM:
            atomicAdd(acc + b * out_size + rank, val);
            break;
        case L4M:
            atomicMax(acc + b * out_size + rank,
                      (val << 32) | (0xFFFFFFFFull - static_cast<unsigned long long>(p)));
            break;
        default: {  // L4W, L4U
            const unsigned long long w = mode == L4W ? val : 1ull;
            const int r = p / width;
            unsigned long long* slot = acc + (b * out_size + rank) * 3;
            atomicAdd(slot, w);
            atomicAdd(slot + 1, w * static_cast<unsigned long long>(r));
            atomicAdd(slot + 2, w * static_cast<unsigned long long>(p - r * width));
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

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                const int* __restrict__ counts, int32_t* __restrict__ stats,
                                uint32_t* __restrict__ bitmap_words, int mode, int64_t out_size,
                                int64_t stat_limit, int height, int width, int64_t n_bytes) {
    const int64_t b = blockIdx.y;
    const int64_t k = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (k >= out_size) return;
    if (mode == L2MAX || mode == L2SUM) {
        const unsigned long long a = acc[b * out_size + k];
        const unsigned long long lim = static_cast<unsigned long long>(stat_limit);
        stats[b * out_size + k] = static_cast<int32_t>(a < lim ? a : lim);
        return;
    }
    if (k >= counts[b]) return;
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

// frames (batch, height * width) u16, thr (height * width) u16.  mask
// (batch, ceil(n / 8)) u8 receives the foreground bitmap: the output bitmap
// at L2, scratch at L4, where bitmap is the zeroed output buffer of at least
// ceil(batch * ceil(n / 8) / 4) u32 words.  parent (batch, n) i32 and tiles
// (batch, pr_num_tiles(n)) i32 are scratch; acc is zeroed u64 scratch of
// (batch, out_size, 3) for L4 weighted_average / unweighted, (batch,
// out_size) otherwise.  stats (batch, out_size) i32 (L2 only, else null),
// counts (batch,) i32 puddles, overflow (batch,) u8 = count > out_size.
// Returns cudaGetLastError().
extern "C" int pr_label_l2l4(const void* frames, const void* thr, void* mask, void* bitmap,
                             void* parent, void* tiles, void* acc, void* stats, void* counts,
                             void* overflow, int mode, int64_t batch, int64_t height,
                             int64_t width, int64_t out_size, int64_t stat_limit, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n = height * width;
    const int64_t n_bytes = (n + 7) / 8;
    const int64_t n_tiles = num_tiles(n);
    const dim3 tile_grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    const dim3 pixel_grid(static_cast<unsigned>((n + BLOCK - 1) / BLOCK),
                          static_cast<unsigned>(batch));
    auto* f = static_cast<const uint16_t*>(frames);
    auto* m = static_cast<uint8_t*>(mask);
    auto* par = static_cast<int*>(parent);
    auto* tl = static_cast<int*>(tiles);
    auto* a = static_cast<unsigned long long*>(acc);
    const int w = static_cast<int>(width);
    mask_kernel<<<tile_grid, BLOCK, 0, s>>>(f, static_cast<const uint16_t*>(thr), m, par, n,
                                            n_bytes);
    link_kernel<<<pixel_grid, BLOCK, 0, s>>>(m, par, n, n_bytes, w);
    flatten_kernel<<<tile_grid, BLOCK, 0, s>>>(m, par, tl, n, n_bytes, n_tiles);
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        tl, n_tiles, static_cast<int*>(counts), static_cast<uint8_t*>(overflow), out_size);
    rank_kernel<<<tile_grid, BLOCK, 0, s>>>(par, tl, n, n_tiles);
    accumulate_kernel<<<pixel_grid, BLOCK, 0, s>>>(f, par, a, mode, n, out_size, w);
    if (out_size > 0) {
        const dim3 slot_grid(static_cast<unsigned>((out_size + BLOCK - 1) / BLOCK),
                             static_cast<unsigned>(batch));
        finalize_kernel<<<slot_grid, BLOCK, 0, s>>>(
            a, static_cast<const int*>(counts), static_cast<int32_t*>(stats),
            static_cast<uint32_t*>(bitmap), mode, out_size, stat_limit,
            static_cast<int>(height), w, n_bytes);
    }
    return static_cast<int>(cudaGetLastError());
}
