// Pairs-driven deflate tokenizer: the nonzero bytes of a bitmap, as
// (byte_index << 8) | value pairs, -> the dense inverted token stream of the
// dynamic-Huffman encoder, its 286-symbol histogram and a run flag.
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
// tokenizer (tokenize.cu) for that frame.
//
// The TPU kernel gives each element 8 token slots, broadcasts the element's
// quantities to them by an expansion matmul, left-packs the slots with a
// butterfly of rolls and histograms by a one-hot matmul; its slot layout
// limits gaps to 1549 bytes and the pairs to fewer than NP.  Here:
//   1. tfp_count_kernel: each block takes EL_TILE elements; each thread
//      sums its elements' token counts, adds their symbols to a shared
//      histogram in closed form (integer atomics; then one global atomic a
//      bin and block) and checks the run gate;
//   2. scan_tiles_kernel (common.cuh): tile counts -> tile offsets and each
//      frame's token count;
//   3. tfp_scatter_kernel: a block scan gives each element its offset; the
//      thread writes its gap's tokens (integer division, no compare ladder;
//      the length code from kLenBase in constant memory) and its literal,
//      then the block zero-fills the rest of the row.
// No gap limit and any number of pairs.  Counts and the histogram stay exact
// when the tokens overflow tok_bound (only the stores are cut).  Bound by
// device-memory bytes (4 B a pair read twice, 4 B a token written); a long
// gap is written by one thread, ~G / 258 stores.

#include "deflate.cuh"

namespace {

constexpr int EL_PER_THREAD = 4;
constexpr int EL_TILE = BLOCK * EL_PER_THREAD;   // elements per block
constexpr int HIST_BINS = 512;

__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,  15,  17,  19,  23, 27,
                                 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};

__device__ __forceinline__ int length_symbol(int take) {
    int c = 0;
#pragma unroll
    for (int k = 1; k < 29; ++k) c += take >= kLenBase[k];
    return 257 + c;
}

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

// Element e of a frame with cnt pairs: its gap G and literal value (0 for
// the sentinel e == cnt).  Needs e <= cnt.
__device__ __forceinline__ void element(const int32_t* row, int e, int cnt, int n, int* G,
                                        int* val) {
    const int idx = e < cnt ? static_cast<int>(static_cast<uint32_t>(row[e]) >> 8) : n;
    const int prev = e > 0 ? static_cast<int>(static_cast<uint32_t>(row[e - 1]) >> 8) : -1;
    *G = idx - prev - 1;
    *val = e < cnt ? (row[e] & 0xFF) : 0;
}

__device__ __forceinline__ int frame_pairs(const int* counts, int b, int64_t np) {
    const int64_t c = counts[b];
    return static_cast<int>(c < 0 ? 0 : (c > np ? np : c));
}

// pair e continues a run of equal nonzero bytes from pair e - 1
__device__ __forceinline__ bool continues(const int32_t* row, int e) {
    const uint32_t a = static_cast<uint32_t>(row[e - 1]);
    const uint32_t c = static_cast<uint32_t>(row[e]);
    return (c >> 8) == (a >> 8) + 1 && (c & 0xFFu) == (a & 0xFFu) && (c & 0xFFu) != 0u;
}

__global__ void tfp_count_kernel(const int32_t* __restrict__ pairs, const int* __restrict__ counts,
                                 int64_t np, int n, int n_tiles, int* __restrict__ tile_counts,
                                 int* __restrict__ hist, uint8_t* __restrict__ flag) {
    __shared__ int hist_s[HIST_BINS];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int32_t* row = pairs + static_cast<int64_t>(b) * np;
    const int cnt = frame_pairs(counts, b, np);
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) hist_s[k] = 0;
    __syncthreads();

    int sum = 0;
    bool run4 = false;
    const int e0 = t * EL_TILE + threadIdx.x * EL_PER_THREAD;
    for (int k = 0; k < EL_PER_THREAD; ++k) {
        const int e = e0 + k;
        if (e > cnt) break;
        int G, val;
        element(row, e, cnt, n, &G, &val);
        const Gap g = gap_schedule(G);
        sum += g.count + (val > 0);
        if (G >= 1 && G <= 3) {
            atomicAdd(&hist_s[0], G);
        } else if (G >= 4) {
            atomicAdd(&hist_s[0], 1);
            if (g.j258) atomicAdd(&hist_s[285], g.j258);
            if (g.rem >= 259) {
                atomicAdd(&hist_s[length_symbol(255)], 1);
                atomicAdd(&hist_s[length_symbol(g.rem - 255)], 1);
            } else {
                atomicAdd(&hist_s[length_symbol(g.rem)], 1);
            }
        }
        if (val > 0) atomicAdd(&hist_s[val], 1);
        if (e >= 3 && e < cnt) {
            run4 |= continues(row, e) && continues(row, e - 1) && continues(row, e - 2);
        }
    }
    if (run4) flag[b] = 1;
    sum = block_all_reduce(sum, SumOp(), scratch);   // its barrier publishes hist_s
    if (threadIdx.x == 0) tile_counts[static_cast<int64_t>(b) * n_tiles + t] = sum;
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) {
        if (hist_s[k]) atomicAdd(&hist[b * HIST_BINS + k], hist_s[k]);
    }
}

__global__ void tfp_scatter_kernel(const int32_t* __restrict__ pairs,
                                   const int* __restrict__ counts, int64_t np, int n, int n_tiles,
                                   const int* __restrict__ tile_offsets,
                                   const int* __restrict__ totals, int32_t* __restrict__ tok,
                                   int64_t tok_bound) {
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int32_t* row = pairs + static_cast<int64_t>(b) * np;
    const int cnt = frame_pairs(counts, b, np);
    int32_t* out = tok + static_cast<int64_t>(b) * tok_bound;

    int G[EL_PER_THREAD], val[EL_PER_THREAD];
    int sum = 0;
    const int e0 = t * EL_TILE + threadIdx.x * EL_PER_THREAD;
#pragma unroll
    for (int k = 0; k < EL_PER_THREAD; ++k) {
        G[k] = 0;
        val[k] = 0;
        if (e0 + k <= cnt) {
            element(row, e0 + k, cnt, n, &G[k], &val[k]);
            sum += gap_schedule(G[k]).count + (val[k] > 0);
        }
    }
    int64_t dst = static_cast<int64_t>(tile_offsets[static_cast<int64_t>(b) * n_tiles + t]) +
                  block_exclusive_scan<true>(sum, SumOp(), 0, scratch);
#pragma unroll
    for (int k = 0; k < EL_PER_THREAD; ++k) {
        const Gap g = gap_schedule(G[k]);
        for (int j = 0; j < g.count && dst + j < tok_bound; ++j) {
            out[dst + j] = NO_TOKEN - gap_token(G[k], g, j);
        }
        dst += g.count;
        if (val[k] > 0) {
            if (dst < tok_bound) out[dst] = NO_TOKEN - val[k];
            ++dst;
        }
    }

    const int64_t stride = static_cast<int64_t>(n_tiles) * BLOCK;
    for (int64_t i = totals[b] + static_cast<int64_t>(t) * BLOCK + threadIdx.x; i < tok_bound;
         i += stride) {
        out[i] = 0;
    }
}

}  // namespace

// pairs (batch, np) i32 (byte_index << 8) | value, ascending, of which the
// first counts[b] (clamped to [0, np]) are valid; n the byte stream's length
// -> tok (batch, tok_bound) i32 inverted tokens NO_TOKEN - LUT index, zeros
// from the count on; hist (batch, 512) i32, bins 0..285 the literal/length
// symbols (end of block not counted), the rest 0; tok_counts (batch,) i32,
// exact even past tok_bound; flag (batch,) u8, a nonzero run of 4 or more
// equal bytes.  tile_counts (batch, pr_pairs_tiles(np)) i32 and
// tok_overflow (batch,) u8 are scratch.  Returns the first CUDA error.
extern "C" int pr_tokens_from_pairs(const void* pairs, const void* counts, void* tok, void* hist,
                                    void* tok_counts, void* flag, void* tile_counts,
                                    void* tok_overflow, int64_t batch, int64_t np, int64_t n,
                                    int64_t tok_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = static_cast<int>((np + 1 + EL_TILE - 1) / EL_TILE);
    auto* p = static_cast<const int32_t*>(pairs);
    auto* c = static_cast<const int*>(counts);
    auto* tiles = static_cast<int*>(tile_counts);
    cudaError_t err = cudaMemsetAsync(hist, 0, batch * HIST_BINS * sizeof(int), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(flag, 0, batch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    tfp_count_kernel<<<grid, BLOCK, 0, s>>>(p, c, np, static_cast<int>(n), n_tiles, tiles,
                                            static_cast<int*>(hist), static_cast<uint8_t*>(flag));
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        tiles, n_tiles, static_cast<int*>(tok_counts), static_cast<uint8_t*>(tok_overflow),
        tok_bound);
    tfp_scatter_kernel<<<grid, BLOCK, 0, s>>>(p, c, np, static_cast<int>(n), n_tiles, tiles,
                                              static_cast<const int*>(tok_counts),
                                              static_cast<int32_t*>(tok), tok_bound);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_pairs_tiles(int64_t np) { return (np + 1 + EL_TILE - 1) / EL_TILE; }
