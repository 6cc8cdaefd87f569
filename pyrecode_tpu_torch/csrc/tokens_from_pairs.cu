// Pairs-driven deflate tokenizer: the nonzero bytes of a bitmap, as
// (byte_index << 8) | value pairs, -> the dense inverted token stream of the
// dynamic-Huffman encoder, its 286-symbol histogram, a run flag and adler32.
//
// Replaces pyrecode_tpu/ops/pallas_tokens.py:tokens_from_pairs_device
// (kernel built by _build_tokens_kernel), with the contract of
// pyrecode_tpu/codecs/dyndeflate.py:tokens_from_pairs_np: the element list
// is every pair, preceded by its zero gap G (the bytes since the pair
// before), plus one sentinel for the tail gap up to the stream's length n.
// An element emits gap_token_count(G) tokens of the zero run in closed form
// (G <= 3: G literal zeros; else one literal zero, j258 take-258 matches,
// then a take of rem = G - 1 - 258 * j258, or 255 and rem - 255 when rem is
// 259 or 260), then its literal.  A nonzero run of 4 or more equal bytes at
// consecutive indices sets the frame's flag: such runs emit matches, which
// the pairs formulation does not model, and the caller takes the byte
// tokenizer (tokenize.cu) for that frame.  adler32 is a closed form over the
// pairs: A = 1 + sum v, B = n + sum (n - idx) v (mod 65521).
//
// The TPU kernel gives each element 8 token slots, broadcasts the element's
// quantities to them by an expansion matmul, left-packs the slots with a
// butterfly of rolls and histograms by a one-hot matmul; its slot layout
// limits gaps to 1549 bytes and the pairs to fewer than NP.  Here a block
// takes EL_TILE elements, each thread EL_PER_THREAD consecutive ones by one
// 16-byte load (the pairs before them from the lane before, by a shuffle):
//   1. tfp_count_kernel: each tile's token count (a closed form an element)
//      and adler32 sums; the first block of each stream zeroes the stream's
//      histogram row and flag;
//   2. scan_tiles_kernel (common.cuh): tile counts -> tile offsets and each
//      frame's token count;
//   3. tfp_scatter_kernel: a block scan gives each element its offset; the
//      thread writes its gap's tokens (integer division, no compare ladder)
//      and its literal into the block's staging buffer in shared memory,
//      which goes out with coalesced stores (a gap's tokens past the buffer,
//      which only gaps of thousands of bytes reach, go straight to device
//      memory); then the block zero-fills its share of the rest of the row.
//      The same pass histograms (shared atomics, with literal 0 and take-258
//      counted in registers and added once a warp), and checks the run gate:
//      pass 1 zeroes what they add to.  The first block of each stream adds
//      the tiles' adler32 sums (adler_from_parts, deflate.cuh).
// No gap limit and any number of pairs.  Counts and the histogram stay exact
// when the tokens overflow tok_bound (only the stores are cut).  Bound by
// device-memory bytes (4 B a pair read twice, 4 B a token written).

#include "deflate.cuh"

namespace {

constexpr int EL_PER_THREAD = 4;
constexpr int EL_TILE = BLOCK * EL_PER_THREAD;   // elements per block
constexpr int STAGE = 2 * TILE;                  // tokens a block stages (32 KiB)

static_assert(EL_PER_THREAD == 4, "a thread's pairs are one 16-byte load");

// The token schedule of a zero run of G bytes: count, take-258 matches and
// the remainder after them.
struct Gap {
    int count;
    int j258;
    int rem;
};

__device__ __forceinline__ Gap gap_schedule(int G) {
    Gap g;
    g.j258 = G >= 262 ? (G - 262) / 258 + 1 : 0;
    g.rem = G - 1 - 258 * g.j258;
    g.count = G <= 0 ? 0 : (G <= 3 ? G : 1 + g.j258 + (g.rem >= 259 ? 2 : 1));
    return g;
}

// LUT index of token j of a G-byte gap (0 <= j < count).
__device__ __forceinline__ int gap_token(int G, const Gap& g, int j) {
    if (G <= 3 || j == 0) return 0;
    const int take = j <= g.j258 ? 258 : (g.rem >= 259 ? (j == g.j258 + 1 ? 255 : g.rem - 255)
                                                        : g.rem);
    return 256 + take - 3;
}

__device__ __forceinline__ int frame_pairs(const int* counts, int b, int64_t np) {
    const int64_t c = counts[b];
    return static_cast<int>(c < 0 ? 0 : (c > np ? np : c));
}

// The thread's pairs e0 .. e0 + 3 in w[3..6] and the three before them in
// w[0..2] (0 where there is no pair: before the row or at or past cnt).
// Every lane of the warp calls it.
__device__ __forceinline__ void load_pairs(const int32_t* row, int e0, int cnt, int64_t np,
                                           int32_t w[7]) {
    int4 v;
    if (e0 + 4 <= np && (reinterpret_cast<uintptr_t>(row + e0) & 15u) == 0u) {
        v = __ldg(reinterpret_cast<const int4*>(row + e0));
    } else {
        v.x = e0 < np ? row[e0] : 0;
        v.y = e0 + 1 < np ? row[e0 + 1] : 0;
        v.z = e0 + 2 < np ? row[e0 + 2] : 0;
        v.w = e0 + 3 < np ? row[e0 + 3] : 0;
    }
    w[3] = e0 < cnt ? v.x : 0;
    w[4] = e0 + 1 < cnt ? v.y : 0;
    w[5] = e0 + 2 < cnt ? v.z : 0;
    w[6] = e0 + 3 < cnt ? v.w : 0;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int32_t up = __shfl_up_sync(kFullMask, w[4 + k], 1);
        const int e = e0 - 3 + k;
        w[k] = lane != 0 ? up : (e >= 0 && e < cnt ? row[e] : 0);
    }
}

// Element e0 + k: its gap G and literal value (0 for the sentinel, e == cnt);
// G = 0 for e > cnt, which is no element.
__device__ __forceinline__ void element(const int32_t w[7], int k, int e0, int cnt, int n, int* G,
                                        int* val) {
    const int e = e0 + k;
    if (e > cnt) {
        *G = 0;
        *val = 0;
        return;
    }
    const int idx = e < cnt ? static_cast<int>(static_cast<uint32_t>(w[3 + k]) >> 8) : n;
    const int prev = e > 0 ? static_cast<int>(static_cast<uint32_t>(w[2 + k]) >> 8) : -1;
    *G = idx - prev - 1;
    *val = e < cnt ? (w[3 + k] & 0xFF) : 0;
}

// pair b continues a run of equal nonzero bytes from pair a
__device__ __forceinline__ bool continues(int32_t a, int32_t b) {
    const uint32_t x = static_cast<uint32_t>(a);
    const uint32_t y = static_cast<uint32_t>(b);
    return (y >> 8) == (x >> 8) + 1 && (y & 0xFFu) == (x & 0xFFu) && (y & 0xFFu) != 0u;
}

__global__ void __launch_bounds__(BLOCK)
tfp_count_kernel(const int32_t* __restrict__ pairs, const int* __restrict__ counts, int64_t np,
                 int n, int n_tiles, int* __restrict__ tile_counts, int* __restrict__ part,
                 int* __restrict__ hist, uint8_t* __restrict__ flag) {
    __shared__ int warp_sums[WARPS];
    __shared__ long long ws1[WARPS], wsn[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int64_t tile = static_cast<int64_t>(b) * n_tiles + t;
    if (t == 0) {
        for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) hist[b * HIST_BINS + k] = 0;
        if (threadIdx.x == 0) flag[b] = 0;
    }
    const int32_t* row = pairs + static_cast<int64_t>(b) * np;
    const int cnt = frame_pairs(counts, b, np);
    const int e0 = t * EL_TILE + threadIdx.x * EL_PER_THREAD;
    int32_t w[7];
    load_pairs(row, e0, cnt, np, w);
    int sum = 0;
    long long s1 = 0, sn = 0;
#pragma unroll
    for (int k = 0; k < EL_PER_THREAD; ++k) {
        int G, val;
        element(w, k, e0, cnt, n, &G, &val);
        sum += gap_schedule(G).count + (val > 0);
        s1 += val;
        sn += static_cast<long long>(n - static_cast<int>(static_cast<uint32_t>(w[3 + k]) >> 8)) * val;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
    s1 = warp_sum(s1);
    sn = warp_sum(sn);
    if ((threadIdx.x & 31) == 0) {
        warp_sums[threadIdx.x >> 5] = sum;
        ws1[threadIdx.x >> 5] = s1;
        wsn[threadIdx.x >> 5] = sn;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        long long a = 0, c = 0;
#pragma unroll
        for (int wi = 0; wi < WARPS; ++wi) {
            total += warp_sums[wi];
            a += ws1[wi];
            c += wsn[wi];
        }
        tile_counts[tile] = total;
        part[2 * tile] = adler_mod(a);
        part[2 * tile + 1] = adler_mod(c);
    }
}

__global__ void __launch_bounds__(BLOCK)
tfp_scatter_kernel(const int32_t* __restrict__ pairs, const int* __restrict__ counts, int64_t np,
                   int n, int n_tiles, const int* __restrict__ tile_offsets,
                   const int* __restrict__ part, const int* __restrict__ totals,
                   int32_t* __restrict__ tok, int64_t tok_bound, int* __restrict__ hist,
                   uint8_t* __restrict__ flag, long long* __restrict__ adler) {
    __shared__ int hist_s[HIST_BINS];
    __shared__ int32_t staged[STAGE];
    __shared__ int warp_tok[WARPS];
    __shared__ long long lscratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int k = tid; k < HIST_BINS; k += BLOCK) hist_s[k] = 0;
    const int32_t* row = pairs + static_cast<int64_t>(b) * np;
    const int cnt = frame_pairs(counts, b, np);
    const int e0 = t * EL_TILE + tid * EL_PER_THREAD;
    int32_t w[7];
    load_pairs(row, e0, cnt, np, w);

    int G[EL_PER_THREAD], val[EL_PER_THREAD];
    Gap g[EL_PER_THREAD];
    int sum = 0;
    bool run4 = false;
#pragma unroll
    for (int k = 0; k < EL_PER_THREAD; ++k) {
        element(w, k, e0, cnt, n, &G[k], &val[k]);
        g[k] = gap_schedule(G[k]);
        sum += g[k].count + (val[k] > 0);
        if (e0 + k < cnt && e0 + k >= 3) {
            run4 |= continues(w[k], w[k + 1]) && continues(w[k + 1], w[k + 2]) &&
                    continues(w[k + 2], w[k + 3]);
        }
    }
    if (run4) flag[b] = 1;
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_tok[warp] = incl;
    __syncthreads();

    int local = incl - sum;   // the thread's first token, from the tile's first
    int tile_tok = 0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) {
        if (wi < warp) local += warp_tok[wi];
        tile_tok += warp_tok[wi];
    }
    const int64_t base = tile_offsets[static_cast<int64_t>(b) * n_tiles + t];
    int32_t* out = tok + static_cast<int64_t>(b) * tok_bound;
    int n_lit0 = 0, n_258 = 0;
#pragma unroll
    for (int k = 0; k < EL_PER_THREAD; ++k) {
        for (int j = 0; j < g[k].count; ++j) {
            const int32_t v = NO_TOKEN - gap_token(G[k], g[k], j);
            if (local + j < STAGE) {
                staged[local + j] = v;
            } else if (base + local + j < tok_bound) {
                out[base + local + j] = v;
            }
        }
        local += g[k].count;
        if (G[k] >= 1 && G[k] <= 3) {
            n_lit0 += G[k];
        } else if (G[k] >= 4) {
            n_lit0 += 1;
            n_258 += g[k].j258;
            if (g[k].rem >= 259) {
                atomicAdd(&hist_s[length_symbol(255)], 1);
                atomicAdd(&hist_s[length_symbol(g[k].rem - 255)], 1);
            } else {
                atomicAdd(&hist_s[length_symbol(g[k].rem)], 1);
            }
        }
        if (val[k] > 0) {
            atomicAdd(&hist_s[val[k]], 1);
            if (local < STAGE) {
                staged[local] = NO_TOKEN - val[k];
            } else if (base + local < tok_bound) {
                out[base + local] = NO_TOKEN - val[k];
            }
            ++local;
        }
    }
    warp_add(&hist_s[0], n_lit0);
    warp_add(&hist_s[SYM_TAKE258], n_258);
    __syncthreads();

    for (int k = tid; k < min(tile_tok, STAGE) && base + k < tok_bound; k += BLOCK) {
        out[base + k] = staged[k];
    }
    flush_hist(hist_s, hist + static_cast<int64_t>(b) * HIST_BINS);
    const int64_t stride = static_cast<int64_t>(n_tiles) * BLOCK;
    for (int64_t i = totals[b] + static_cast<int64_t>(t) * BLOCK + tid; i < tok_bound; i += stride) {
        out[i] = 0;
    }
    if (t == 0) {   // block-uniform: the stream's adler32 from its tiles' sums
        adler_from_parts(part + 2 * static_cast<int64_t>(b) * n_tiles, n_tiles, n, lscratch,
                         adler + b);
    }
}

}  // namespace

// pairs (batch, np) i32 (byte_index << 8) | value, ascending, of which the
// first counts[b] (clamped to [0, np]) are valid; n the byte stream's length
// -> tok (batch, tok_bound) i32 inverted tokens NO_TOKEN - LUT index, zeros
// from the count on; hist (batch, 512) i32, bins 0..285 the literal/length
// symbols (end of block not counted), the rest 0; tok_counts (batch,) i32,
// exact even past tok_bound; flag (batch,) u8, a nonzero run of 4 or more
// equal bytes; adler (batch,) i64.  scratch: 3 * batch *
// pr_pairs_tiles(np) i32, then batch bytes.  Returns the first CUDA error.
extern "C" int pr_tokens_from_pairs(const void* pairs, const void* counts, void* tok, void* hist,
                                    void* tok_counts, void* flag, void* adler, void* scratch,
                                    int64_t batch, int64_t np, int64_t n, int64_t tok_bound,
                                    void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = static_cast<int>((np + 1 + EL_TILE - 1) / EL_TILE);
    auto* p = static_cast<const int32_t*>(pairs);
    auto* c = static_cast<const int*>(counts);
    int* tiles = static_cast<int*>(scratch);
    int* part = tiles + batch * n_tiles;
    auto* tok_overflow = reinterpret_cast<uint8_t*>(part + 2 * batch * n_tiles);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    tfp_count_kernel<<<grid, BLOCK, 0, s>>>(p, c, np, static_cast<int>(n), n_tiles, tiles, part,
                                            static_cast<int*>(hist), static_cast<uint8_t*>(flag));
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        tiles, n_tiles, static_cast<int*>(tok_counts), tok_overflow, tok_bound);
    tfp_scatter_kernel<<<grid, BLOCK, 0, s>>>(p, c, np, static_cast<int>(n), n_tiles, tiles, part,
                                              static_cast<const int*>(tok_counts),
                                              static_cast<int32_t*>(tok), tok_bound,
                                              static_cast<int*>(hist),
                                              static_cast<uint8_t*>(flag),
                                              static_cast<long long*>(adler));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_pairs_tiles(int64_t np) { return (np + 1 + EL_TILE - 1) / EL_TILE; }
