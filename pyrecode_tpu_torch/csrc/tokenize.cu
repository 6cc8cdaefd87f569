// Deflate tokenizer: the per-byte tokens of the dynamic-Huffman encoder, the
// 286-symbol literal/length histogram and adler32, for a batch of streams.
//
// Replaces pyrecode_tpu/ops/pallas_deflate.py:tokenize_pallas and
// tokenize_compact_pallas (kernel built by _build_tokenize_kernel).  The
// rules are those of pyrecode_tpu/codecs/dyndeflate.py:tokenize_bytes_np:
// byte i of a run [s, e) of equal bytes, with p = i - s and
// d = min(e - i, 522), is
//   * a literal when p == 0 or e - s < 4;
//   * a distance-1 match of take 258 / 255 / d when (p - 1) % 258 == 0 and
//     d >= 261 / d in {259, 260} / 3 <= d <= 258;
//   * a match of take d when (p - 1) % 258 == 255 and d in {4, 5};
//   * covered by a match otherwise.
// Bytes at or past the stream's length end every run and are no token.
//
// The TPU kernel walks a stream in order, carries the run start in SMEM from
// one grid step to the next, takes run ends from a one-tile halo and
// histograms through a one-hot matmul.  Blocks on the GPU run in no order,
// and one run may span the whole stream, so:
//   1. tok_last_change_kernel: the last run start in each TILE-byte tile;
//   2. tok_decide_kernel: the run start carried into a tile is the last run
//      start of the nearest earlier tile that has one (a backward search over
//      pass 1's output, one step unless a run spans whole tiles); run starts
//      inside the tile by a block prefix-max, run ends by a block suffix-min
//      and the first run end in the 522 bytes past the tile (which the block
//      holds as a halo in shared memory).  The histogram takes integer
//      shared-memory atomics, then one global atomic per bin and block;
//      adler32 takes the block sums of x and i * x, reduced mod 65521;
//   3. tok_finish_kernel: adler32 of each stream from those sums.
// The compact form runs pass 2 twice, once counting each tile's tokens (with
// the histogram and the sums) and, after scan_tiles_kernel (common.cuh) has
// turned the counts into offsets, once storing each token at its place, so
// that the per-byte token stream never reaches device memory.
//
// The work is bound by device-memory bytes: the stream is read twice (three
// times compacted) and the dense form writes 2 bytes per stream byte.
// Counts are integer-exact; nothing goes through a matmul.

#include "deflate.cuh"

namespace {

constexpr int MAX_D = 522;                 // run-end lookahead that can change a token
constexpr int WIN = TILE + MAX_D + 2;      // bytes [start - 1, start + TILE + MAX_D]
constexpr int SYM_NONE = 287;              // histogram slot of covered and pad bytes
constexpr int HIST_BINS = 512;
constexpr unsigned long long ADLER_MOD = 65521;
constexpr int INF = 0x7fffffff;

__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,  15,  17,  19,  23, 27,
                                 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};

enum Mode { kDense, kCount, kScatter };

__device__ __forceinline__ int stream_length(const int* lengths, int b, int64_t npad) {
    const int64_t n = lengths[b];
    return static_cast<int>(n < 0 ? 0 : (n > npad ? npad : n));
}

__device__ __forceinline__ int length_code(int take) {
    int c = 0;
#pragma unroll
    for (int k = 1; k < 29; ++k) c += take >= kLenBase[k];
    return c;
}

// LUT index of byte value x at position i of the run [s, e), and its
// histogram symbol.
__device__ __forceinline__ int decide(int x, int i, int s, int e, int* sym) {
    const int p = i - s;
    if (p == 0 || e - s < 4) {
        *sym = x;
        return x;
    }
    const int d = min(e - i, MAX_D);
    const int qm = (p - 1) % 258;
    int take;
    if (qm == 255 && (d == 4 || d == 5)) {
        take = d;
    } else if (qm == 0 && d >= 3) {
        take = d >= 261 ? 258 : (d >= 259 ? 255 : d);
    } else {
        *sym = SYM_NONE;
        return NO_TOKEN;
    }
    *sym = 257 + length_code(take);
    return 256 + take - 3;
}

__global__ void tok_last_change_kernel(const uint8_t* __restrict__ streams,
                                       const int* __restrict__ lengths, int* __restrict__ last,
                                       int64_t npad, int n_tiles) {
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int n = stream_length(lengths, b, npad);
    const uint8_t* row = streams + static_cast<int64_t>(b) * npad;
    const int start = t * TILE;
    const int stop = min(start + TILE, n);
    int best = -1;
    for (int i = start + threadIdx.x; i < stop; i += BLOCK) {
        if (i == 0 || row[i] != row[i - 1]) best = i;
    }
    best = block_all_reduce(best, MaxOp(), scratch);
    if (threadIdx.x == 0) last[static_cast<int64_t>(b) * n_tiles + t] = best;
}

// kDense: tok, hist, sums.  kCount: hist, sums, tile_counts.  kScatter:
// comp, from the tile offsets that scan_tiles_kernel left in tile_counts.
template <int kMode>
__global__ void tok_decide_kernel(const uint8_t* __restrict__ streams,
                                  const int* __restrict__ lengths, const int* __restrict__ last,
                                  int64_t npad, int n_tiles, uint16_t* __restrict__ tok,
                                  int* __restrict__ hist, unsigned long long* __restrict__ sums,
                                  int* __restrict__ tile_counts, int32_t* __restrict__ comp,
                                  int64_t out_bound) {
    __shared__ uint8_t win[WIN];
    __shared__ int hist_s[HIST_BINS];
    __shared__ int iscratch[WARPS];
    __shared__ long long lscratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int n = stream_length(lengths, b, npad);
    const uint8_t* row = streams + static_cast<int64_t>(b) * npad;
    const int start = t * TILE;
    const int p0 = start + tid * TILE_PER_THREAD;
    const int64_t tile = static_cast<int64_t>(b) * n_tiles + t;

    if (start >= n) {  // pad bytes only (block-uniform)
        if constexpr (kMode == kDense) {
            for (int k = 0; k < TILE_PER_THREAD; ++k) {
                if (p0 + k < npad) tok[static_cast<int64_t>(b) * npad + p0 + k] = 0;
            }
        }
        if constexpr (kMode != kScatter) {
            if (tid == 0) {
                const int64_t rest = npad - start;
                atomicAdd(&hist[b * HIST_BINS + SYM_NONE], static_cast<int>(rest < TILE ? rest : TILE));
            }
        }
        if constexpr (kMode == kCount) {
            if (tid == 0) tile_counts[tile] = 0;
        }
        return;
    }

    for (int k = tid; k < WIN; k += BLOCK) {
        const int64_t j = static_cast<int64_t>(start) - 1 + k;
        win[k] = (j >= 0 && j < n) ? row[j] : 0;
    }
    if constexpr (kMode != kScatter) {
        for (int k = tid; k < HIST_BINS; k += BLOCK) hist_s[k] = 0;
    }
    __syncthreads();

    int carry = -1;
    for (int base = t - 1; base >= 0; base -= BLOCK) {
        const int j = base - tid;
        const int m = block_all_reduce(j >= 0 ? last[static_cast<int64_t>(b) * n_tiles + j] : -1,
                                       MaxOp(), iscratch);
        if (m >= 0) {
            carry = m;
            break;
        }
    }

    // this thread's bytes; bit k of `changed`: byte k differs from the one
    // before it (or is byte 0 of the stream)
    const int w0 = 1 + tid * TILE_PER_THREAD;
    int x[TILE_PER_THREAD];
    unsigned changed = 0u;
    int my_start = -1;
    int my_end = INF;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        x[k] = win[w0 + k];
        const int p = p0 + k;
        if (p == 0 || x[k] != win[w0 + k - 1]) changed |= 1u << k;
        if (p < n && ((changed >> k) & 1u)) my_start = p;
    }
#pragma unroll
    for (int k = TILE_PER_THREAD - 1; k >= 0; --k) {
        const int p = p0 + k;
        if (p >= n || ((changed >> k) & 1u)) my_end = p;
    }
    const int s_before =
        max(carry, block_exclusive_scan<true>(my_start, MaxOp(), -1, iscratch));
    int e_after = block_exclusive_scan<false>(my_end, MinOp(), INF, iscratch);
    int halo_end = INF;
    for (int k = tid; k <= MAX_D; k += BLOCK) {
        const int j = start + TILE + k;
        const int wi = TILE + 1 + k;
        if (j >= n || win[wi] != win[wi - 1]) {
            halo_end = j;
            break;
        }
    }
    e_after = min(e_after, block_all_reduce(halo_end, MinOp(), iscratch));

    int ends[TILE_PER_THREAD];
#pragma unroll
    for (int k = TILE_PER_THREAD - 1; k >= 0; --k) {
        ends[k] = e_after;
        const int p = p0 + k;
        if (p >= n || ((changed >> k) & 1u)) e_after = p;
    }

    int lut[TILE_PER_THREAD];
    int s = s_before;
    int n_tok = 0;
    int n_none = 0;
    long long s1 = 0;
    long long s2 = 0;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        const int p = p0 + k;
        int li = NO_TOKEN;
        if (p < n) {
            if ((changed >> k) & 1u) s = p;
            int sym;
            li = decide(x[k], p, s, ends[k], &sym);
            if constexpr (kMode != kScatter) {
                s1 += x[k];
                s2 += static_cast<long long>(p) * x[k];
                if (li != NO_TOKEN) {
                    atomicAdd(&hist_s[sym], 1);
                } else {
                    ++n_none;
                }
            }
        } else if (p < npad) {
            ++n_none;
        }
        lut[k] = li;
        n_tok += li != NO_TOKEN;
    }

    if constexpr (kMode == kDense) {
        uint16_t* out = tok + static_cast<int64_t>(b) * npad;
#pragma unroll
        for (int k = 0; k < TILE_PER_THREAD; ++k) {
            if (p0 + k < npad) out[p0 + k] = static_cast<uint16_t>(NO_TOKEN - lut[k]);
        }
    }
    if constexpr (kMode != kScatter) {
        if (n_none) atomicAdd(&hist_s[SYM_NONE], n_none);
        s1 = block_all_reduce(s1, SumOp(), lscratch);
        s2 = block_all_reduce(s2, SumOp(), lscratch);
        if (tid == 0) {
            atomicAdd(&sums[2 * b], static_cast<unsigned long long>(s1) % ADLER_MOD);
            atomicAdd(&sums[2 * b + 1], static_cast<unsigned long long>(s2) % ADLER_MOD);
        }
        for (int k = tid; k < HIST_BINS; k += BLOCK) {
            if (hist_s[k]) atomicAdd(&hist[b * HIST_BINS + k], hist_s[k]);
        }
    }
    if constexpr (kMode == kCount) {
        const int total = block_all_reduce(n_tok, SumOp(), iscratch);
        if (tid == 0) tile_counts[tile] = total;
    }
    if constexpr (kMode == kScatter) {
        int64_t dst = static_cast<int64_t>(tile_counts[tile]) +
                      block_exclusive_scan<true>(n_tok, SumOp(), 0, iscratch);
        int32_t* out = comp + static_cast<int64_t>(b) * out_bound;
#pragma unroll
        for (int k = 0; k < TILE_PER_THREAD; ++k) {
            if (lut[k] != NO_TOKEN) {
                if (dst < out_bound) out[dst] = NO_TOKEN - lut[k];
                ++dst;
            }
        }
    }
}

// adler32 = B << 16 | A with A = 1 + S1, B = n + n * S1 - S2 (mod 65521),
// S1 = sum of x_i and S2 = sum of i * x_i over the stream's bytes.
__global__ void tok_finish_kernel(const int* __restrict__ lengths,
                                  const unsigned long long* __restrict__ sums,
                                  long long* __restrict__ adler, int64_t batch, int64_t npad) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const unsigned long long n =
        static_cast<unsigned long long>(stream_length(lengths, static_cast<int>(b), npad)) % ADLER_MOD;
    const unsigned long long s1 = sums[2 * b] % ADLER_MOD;
    const unsigned long long s2 = sums[2 * b + 1] % ADLER_MOD;
    const unsigned long long a = (1 + s1) % ADLER_MOD;
    const unsigned long long bb = (n + n * s1 % ADLER_MOD + ADLER_MOD - s2) % ADLER_MOD;
    adler[b] = static_cast<long long>((bb << 16) | a);
}

}  // namespace

// streams (batch, npad) u8, lengths (batch,) i32 -> tok (batch, npad) u16
// inverted tokens, hist (batch, 512) i32 ((sym >> 5, sym & 31) row-major,
// end of block not counted, slot 287 the covered and pad bytes), adler
// (batch,) i64.  last (batch, pr_deflate_tiles(npad)) i32 and sums (batch, 2)
// u64 are scratch.  Returns the first CUDA error.
extern "C" int pr_tokenize(const void* streams, const void* lengths, void* tok, void* hist,
                           void* adler, void* last, void* sums, int64_t batch, int64_t npad,
                           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = static_cast<int>(deflate_tiles(npad));
    auto* x = static_cast<const uint8_t*>(streams);
    auto* len = static_cast<const int*>(lengths);
    auto* sm = static_cast<unsigned long long*>(sums);
    cudaError_t err = cudaMemsetAsync(hist, 0, batch * HIST_BINS * sizeof(int), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(sums, 0, batch * 2 * sizeof(*sm), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_tiles > 0) {
        const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
        tok_last_change_kernel<<<grid, BLOCK, 0, s>>>(x, len, static_cast<int*>(last), npad,
                                                      n_tiles);
        tok_decide_kernel<kDense><<<grid, BLOCK, 0, s>>>(
            x, len, static_cast<const int*>(last), npad, n_tiles, static_cast<uint16_t*>(tok),
            static_cast<int*>(hist), sm, nullptr, nullptr, 0);
    }
    tok_finish_kernel<<<static_cast<unsigned>((batch + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
        len, sm, static_cast<long long*>(adler), batch, npad);
    return static_cast<int>(cudaGetLastError());
}

// As pr_tokenize, but the tokens come out compacted: comp (batch, out_bound)
// i32, each stream's inverted tokens in order and zeros after them; counts
// (batch,) i32 tokens per stream; overflow (batch,) u8 = count > out_bound
// (comp then holds the first out_bound tokens).  tile_counts (batch,
// pr_deflate_tiles(npad)) i32 is scratch.
extern "C" int pr_tokenize_compact(const void* streams, const void* lengths, void* comp,
                                   void* hist, void* adler, void* counts, void* overflow,
                                   void* last, void* tile_counts, void* sums, int64_t batch,
                                   int64_t npad, int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = static_cast<int>(deflate_tiles(npad));
    auto* x = static_cast<const uint8_t*>(streams);
    auto* len = static_cast<const int*>(lengths);
    auto* sm = static_cast<unsigned long long*>(sums);
    auto* tiles = static_cast<int*>(tile_counts);
    cudaError_t err = cudaMemsetAsync(hist, 0, batch * HIST_BINS * sizeof(int), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(sums, 0, batch * 2 * sizeof(*sm), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(comp, 0, batch * out_bound * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    if (n_tiles > 0) {
        tok_last_change_kernel<<<grid, BLOCK, 0, s>>>(x, len, static_cast<int*>(last), npad,
                                                      n_tiles);
        tok_decide_kernel<kCount><<<grid, BLOCK, 0, s>>>(
            x, len, static_cast<const int*>(last), npad, n_tiles, nullptr,
            static_cast<int*>(hist), sm, tiles, nullptr, 0);
    }
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(
        tiles, n_tiles, static_cast<int*>(counts), static_cast<uint8_t*>(overflow), out_bound);
    if (n_tiles > 0) {
        tok_decide_kernel<kScatter><<<grid, BLOCK, 0, s>>>(
            x, len, static_cast<const int*>(last), npad, n_tiles, nullptr, nullptr, nullptr,
            tiles, static_cast<int32_t*>(comp), out_bound);
    }
    tok_finish_kernel<<<static_cast<unsigned>((batch + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
        len, sm, static_cast<long long*>(adler), batch, npad);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_deflate_tiles(int64_t n) { return deflate_tiles(n); }
