// Deflate bit assembly: inverted tokens -> (value, bit count) from each
// stream's Huffman LUT -> the LSB-first body of a dynamic block.
//
// Replaces pyrecode_tpu/ops/pallas_deflate.py:assemble_pallas (kernel built
// by _build_assemble_kernel), with the contract of
// pyrecode_tpu/codecs/dyndeflate.py:assemble_bits_np: token k starts at bit
// phase + (bits of tokens 0..k-1) of the body, the header's partial last
// byte is ORed into body byte 0, and the total counts the phase.
//
// The TPU kernel looks tokens up through a one-hot LUT matmul, carries the
// bit offset from one grid step to the next and scatters each step's bytes
// through one-hot matmuls into a VMEM window.  Here a call is two kernels,
// no memset and no scan launch:
//   1. asm_count_kernel: a block a TILE of tokens reads them once (16-byte
//      loads, shifted into place in rows that start off a 16-byte
//      boundary), sums their bit counts from a shared copy of the LUT and
//      stores the tile's sum; the same grid zeroes the body with 16-byte
//      stores;
//   2. asm_place_kernel: a block a tile sums the bit counts of the tiles
//      before it in its stream (a few hundred ints at most), re-reads its
//      tokens (from L2 by now) and builds the tile's bits in a shared
//      window laid on the body's 32-bit word grid.  A thread owns
//      TILE_PER_THREAD consecutive tokens and gathers their bits in a 64-bit
//      register, ORing each finished word into the window once.  The
//      window's interior words go out as plain stores, 16 bytes where
//      aligned; only its first and last word, which may hold bits of other
//      tiles (of several, past tiles of no tokens), take a global atomicOr.
//      Tile 0's block ORs in the header's partial byte; the block of a
//      stream's last tile stores the total and the overflow flag.
// The LUT is read as exact integers (values <= 21 bits are exact in f32)
// into shared memory; no matmul.  Bound by device-memory bytes: the tokens
// read once, the body written once (and zeroed once).  Measured and left
// out (PERF.md §6): one pass that takes tiles by ticket and finds
// their offsets by the decoupled look-back of lookback.cuh, after a memset
// of the body (no faster).

// The split form (pr_assemble_split) replaces
// pyrecode_tpu/ops/pallas_deflate.py:assemble_pallas_split (kernels built by
// _build_assemble_par_kernel and _build_assemble_cat_kernel), with the same
// contract and bytes.  The TPU scatters each grid step's tokens at bit phase
// 0 into the step's own VMEM window by one-hot matmuls, then a serial grid
// shifts each window into its phase and appends it.  Here:
//   1. split_par_kernel: each block reads its TILE tokens once, sums their
//      bits, gives each token its phase-0 offset in the tile by a block scan,
//      ORs the token bytes into the tile's window in shared memory (32-bit
//      atomicOr) and writes the window (WIN_WORDS words, TILE * 21 / 8 + 8
//      bytes) to scratch and the tile's bit count;
//   2. scan_tiles_kernel (common.cuh): each tile's bit offset;
//   3. split_cat_kernel: each block shifts its tile's window left by
//      offset & 7, carrying bits from byte to byte as the TPU's
//      (w << p) | (wprev >> (8 - p)), and stores it at byte offset >> 3 of
//      the body.  The first and the last 32-bit word of that span may hold
//      bits of neighbouring tiles: they take atomicOr; the words between
//      belong to the tile alone and take plain stores;
//   4. asm_finish_kernel: total bits, overflow, the header's partial byte.
// The windows are scratch outside the bound (as the label kernel's are).

#include "deflate.cuh"

namespace {

constexpr int LUT_BITS = 768;  // (48, 32) f32: values at [0, 768), bit counts at [768, 1536)
constexpr int LUT_SIZE = 2 * LUT_BITS;
constexpr int MAX_TOKEN_BITS = 21;
constexpr int WIN_WORDS = (TILE * MAX_TOKEN_BITS / 8 + 8) / 4;   // a tile's phase-0 window

static_assert((TILE * MAX_TOKEN_BITS / 8 + 8) % 4 == 0, "the window is whole words");
static_assert(((TILE * MAX_TOKEN_BITS - 1) >> 5) + 1 < WIN_WORDS, "a token's high word fits");
static_assert((TILE * MAX_TOKEN_BITS + 62) / 32 <= WIN_WORDS, "the place window fits");
static_assert(MAX_TOKEN_BITS < 24, "a packed LUT entry holds the value below bit 24");

// LUT index of an inverted token, -1 for no token.
template <class Tok>
__device__ __forceinline__ int token_index(Tok v) {
    const int inv = static_cast<int>(v);
    return (inv >= 1 && inv <= NO_TOKEN) ? NO_TOKEN - inv : -1;
}

// The TILE_PER_THREAD tokens of one thread from p0 on as ints (0 past
// ncols): 16-byte loads from the 16-byte boundary at or before the first
// token, shifted into place, where the row holds all of them (the bytes
// read past them lie in the granule of the last one); else one at a time.
template <class Tok>
__device__ __forceinline__ void load_tokens(const Tok* __restrict__ row, int64_t ncols,
                                            int64_t p0, int (&inv)[TILE_PER_THREAD]) {
    constexpr int V = static_cast<int>(sizeof(Tok));   // 16-byte vectors of a thread's tokens
    const Tok* p = row + p0;
    if (p0 + TILE_PER_THREAD <= ncols) {
        const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
        const uint4* a = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(p) - off);
        uint32_t w[4 * (V + 1)];
#pragma unroll
        for (int v = 0; v <= V; ++v) {
            const uint4 q = v < V || off ? a[v] : make_uint4(0u, 0u, 0u, 0u);
            w[4 * v] = q.x;
            w[4 * v + 1] = q.y;
            w[4 * v + 2] = q.z;
            w[4 * v + 3] = q.w;
        }
        const int qw = off >> 2;
        const int rb = (off & 3) * 8;
        uint32_t x[4 * V];
#pragma unroll
        for (int j = 0; j < 4 * V; ++j) {
            const uint32_t lo = qw == 0 ? w[j] : qw == 1 ? w[j + 1] : qw == 2 ? w[j + 2] : w[j + 3];
            const uint32_t hi = qw == 0 ? w[j + 1] : qw == 1 ? w[j + 2] : qw == 2 ? w[j + 3] : w[j + 4];
            x[j] = __funnelshift_r(lo, hi, rb);
        }
#pragma unroll
        for (int k = 0; k < TILE_PER_THREAD; ++k) {
            inv[k] = sizeof(Tok) == 2 ? static_cast<int>((x[k / 2] >> (16 * (k % 2))) & 0xFFFFu)
                                      : static_cast<int>(x[k]);
        }
    } else {
#pragma unroll
        for (int k = 0; k < TILE_PER_THREAD; ++k) {
            inv[k] = p0 + k < ncols ? static_cast<int>(p[k]) : 0;
        }
    }
}

// Pass 1: each tile's bit count; the grid also zeroes the body (body16_n
// 16-byte words of every stream), an equal share a block.
template <class Tok>
__global__ void __launch_bounds__(BLOCK)
asm_count_kernel(const Tok* __restrict__ tok, const float* __restrict__ lut, int64_t ncols,
                 int n_tiles, int* __restrict__ tile_bits, uint4* __restrict__ body16,
                 int64_t body16_n) {
    __shared__ int bits_s[NO_TOKEN];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    int inv[TILE_PER_THREAD];   // the loads first, the zeros while they are in flight
    load_tokens(tok + static_cast<int64_t>(b) * ncols, ncols,
                static_cast<int64_t>(t) * TILE + threadIdx.x * TILE_PER_THREAD, inv);
    const int64_t blocks = static_cast<int64_t>(gridDim.x) * gridDim.y;
    const int64_t share = (body16_n + blocks - 1) / blocks;
    const int64_t z0 = (static_cast<int64_t>(b) * gridDim.x + t) * share;
    const int64_t z1 = z0 + share < body16_n ? z0 + share : body16_n;
    for (int64_t i = z0 + threadIdx.x; i < z1; i += BLOCK) body16[i] = make_uint4(0u, 0u, 0u, 0u);
    if (t >= n_tiles) return;   // a stream of no columns: only the zeros
    const float* l = lut + static_cast<int64_t>(b) * LUT_SIZE + LUT_BITS;
    for (int k = threadIdx.x; k < NO_TOKEN; k += BLOCK) bits_s[k] = static_cast<int>(l[k]);
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        const int idx = token_index(inv[k]);
        if (idx >= 0) sum += bits_s[idx];
    }
    sum = block_all_reduce(sum, SumOp(), scratch);
    if (threadIdx.x == 0) tile_bits[static_cast<int64_t>(b) * n_tiles + t] = sum;
}

// Pass 2: the tile's bits at their place in the body (module note).  A grid
// of max(n_tiles, 1) x batch blocks, so that a stream of no columns still
// gets its partial byte, total and overflow flag.
template <class Tok>
__global__ void __launch_bounds__(BLOCK)
asm_place_kernel(const Tok* __restrict__ tok, const float* __restrict__ lut,
                 const int* __restrict__ phase, const int* __restrict__ partial,
                 const int* __restrict__ tile_bits, int64_t ncols, int n_tiles,
                 uint32_t* __restrict__ words, int64_t n_words, int64_t out_bound,
                 int* __restrict__ totbits, uint8_t* __restrict__ overflow) {
    __shared__ int lut_s[NO_TOKEN];   // value | bit count << 24
    __shared__ uint32_t win_s[WIN_WORDS];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    // every global load first, so that they overlap one another and the sum
    int inv[TILE_PER_THREAD];
    load_tokens(tok + static_cast<int64_t>(b) * ncols, ncols,
                static_cast<int64_t>(t) * TILE + threadIdx.x * TILE_PER_THREAD, inv);
    const int* tb = tile_bits + static_cast<int64_t>(b) * n_tiles;
    const int own = t < n_tiles ? tb[t] : 0;
    const int ph = phase[b];
    const float* l = lut + static_cast<int64_t>(b) * LUT_SIZE;
    for (int k = threadIdx.x; k < NO_TOKEN; k += BLOCK) {
        lut_s[k] = static_cast<int>(l[k]) | static_cast<int>(l[LUT_BITS + k]) << 24;
    }
    int before = 0;
    for (int j = threadIdx.x; j < t; j += BLOCK) before += tb[j];
    // the window's words: at most (31 + own + 31) / 32, whatever the tile's phase
    for (int k = threadIdx.x; k < (own + 62) >> 5; k += BLOCK) win_s[k] = 0u;
    before = block_all_reduce(before, SumOp(), scratch);
    const int64_t start = static_cast<int64_t>(ph) + before;   // the tile's first bit
    uint32_t* out = words + static_cast<int64_t>(b) * n_words;
    if (threadIdx.x == 0) {
        if (t + 1 >= n_tiles) {
            const int64_t total = start + own;
            totbits[b] = static_cast<int>(total);
            overflow[b] = (total + 7) / 8 > out_bound ? 1 : 0;
        }
        const uint32_t p = static_cast<uint32_t>(partial[b]) & 0xFFu;
        if (t == 0 && p && n_words > 0) atomicOr(out, p);
    }
    if (own == 0) return;   // no bits: nothing to place
    const int lead = static_cast<int>(start & 31);
    const int n_win = (lead + own + 31) >> 5;   // window words the tile touches
    int val[TILE_PER_THREAD];
    int nb[TILE_PER_THREAD];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        const int idx = token_index(inv[k]);
        const int e = idx >= 0 ? lut_s[idx] : 0;
        val[k] = e & 0xFFFFFF;
        nb[k] = e >> 24;
        sum += nb[k];
    }
    // the thread's bits from window bit pos on, gathered a word at a time
    int pos = lead + block_exclusive_scan<true>(sum, SumOp(), 0, scratch);
    int word = pos >> 5;
    unsigned long long acc = 0ull;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        acc |= static_cast<unsigned long long>(static_cast<uint32_t>(val[k])) << (pos - 32 * word);
        pos += nb[k];
        if (pos - 32 * word >= 32) {   // at most one word finishes a token (<= 21 bits)
            atomicOr(win_s + word, static_cast<uint32_t>(acc));
            acc >>= 32;
            ++word;
        }
    }
    if (sum && pos > 32 * word) atomicOr(win_s + word, static_cast<uint32_t>(acc));
    __syncthreads();
    // out: the first and the last word may be shared with other tiles
    const int64_t w0 = start >> 5;
    if (threadIdx.x == 0 && w0 < n_words && win_s[0]) atomicOr(out + w0, win_s[0]);
    if (threadIdx.x == 1 && n_win > 1 && w0 + n_win - 1 < n_words && win_s[n_win - 1]) {
        atomicOr(out + w0 + n_win - 1, win_s[n_win - 1]);
    }
    // the interior words [1, n_win - 1) belong to this tile: plain stores,
    // 16 bytes from the first body word at a multiple of 4 on
    if (n_win <= 2) return;
    int head = 1 + static_cast<int>((4 - ((w0 + 1) & 3)) & 3);
    if (head > n_win - 1) head = n_win - 1;
    const int n_vec = (n_win - 1 - head) / 4;
    const int tail = head + 4 * n_vec;
    for (int k = 1 + threadIdx.x; k < head; k += BLOCK) {
        if (w0 + k < n_words) out[w0 + k] = win_s[k];
    }
    for (int v = threadIdx.x; v < n_vec; v += BLOCK) {
        const int k = head + 4 * v;
        if (w0 + k < n_words) {   // n_words is a multiple of 4: the whole vector fits
            *reinterpret_cast<uint4*>(out + w0 + k) =
                make_uint4(win_s[k], win_s[k + 1], win_s[k + 2], win_s[k + 3]);
        }
    }
    for (int k = tail + threadIdx.x; k < n_win - 1; k += BLOCK) {
        if (w0 + k < n_words) out[w0 + k] = win_s[k];
    }
}

// Pass 1 of the split form: the tile's tokens at phase 0 in its own window.
template <class Tok>
__global__ void split_par_kernel(const Tok* __restrict__ tok, const float* __restrict__ lut,
                                 int64_t ncols, int n_tiles, int* __restrict__ tile_bits,
                                 uint32_t* __restrict__ windows) {
    __shared__ int vals_s[NO_TOKEN];
    __shared__ int bits_s[NO_TOKEN];
    __shared__ uint32_t win_s[WIN_WORDS];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const float* l = lut + static_cast<int64_t>(b) * LUT_SIZE;
    for (int k = threadIdx.x; k < NO_TOKEN; k += BLOCK) {
        vals_s[k] = static_cast<int>(l[k]);
        bits_s[k] = static_cast<int>(l[LUT_BITS + k]);
    }
    for (int k = threadIdx.x; k < WIN_WORDS; k += BLOCK) win_s[k] = 0u;
    __syncthreads();
    const Tok* row = tok + static_cast<int64_t>(b) * ncols;
    const int64_t p0 = static_cast<int64_t>(t) * TILE + threadIdx.x * TILE_PER_THREAD;
    int val[TILE_PER_THREAD];
    int nb[TILE_PER_THREAD];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        const int idx = p0 + k < ncols ? token_index(row[p0 + k]) : -1;
        val[k] = idx >= 0 ? vals_s[idx] : 0;
        nb[k] = idx >= 0 ? bits_s[idx] : 0;
        sum += nb[k];
    }
    int off = block_exclusive_scan<true>(sum, SumOp(), 0, scratch);
    const int total = block_all_reduce(sum, SumOp(), scratch);
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        if (nb[k]) {
            const unsigned long long sv = static_cast<unsigned long long>(static_cast<uint32_t>(val[k]))
                                          << (off & 31);
            const uint32_t lo = static_cast<uint32_t>(sv);
            const uint32_t hi = static_cast<uint32_t>(sv >> 32);
            if (lo) atomicOr(win_s + (off >> 5), lo);
            if (hi) atomicOr(win_s + (off >> 5) + 1, hi);
            off += nb[k];
        }
    }
    __syncthreads();
    const int64_t tile = static_cast<int64_t>(b) * n_tiles + t;
    if (threadIdx.x == 0) tile_bits[tile] = total;
    uint32_t* out = windows + tile * WIN_WORDS;
    for (int k = threadIdx.x; k < (total + 31) / 32; k += BLOCK) out[k] = win_s[k];
}

// Pass 3 of the split form: the tile's window shifted into its bit phase
// and placed at its byte offset in the body.
__global__ void split_cat_kernel(const uint32_t* __restrict__ windows,
                                 const int* __restrict__ tile_offsets,
                                 const int* __restrict__ totals, const int* __restrict__ phase,
                                 int n_tiles, uint32_t* __restrict__ words, int64_t n_words) {
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int64_t tile = static_cast<int64_t>(b) * n_tiles + t;
    const int bits = (t + 1 < n_tiles ? tile_offsets[tile + 1] : totals[b]) - tile_offsets[tile];
    if (bits == 0) return;
    const int64_t o = static_cast<int64_t>(phase[b]) + tile_offsets[tile];
    const int p = static_cast<int>(o & 7);
    const int64_t base = o >> 3;
    const int64_t nwin = (bits + 7) / 8;                 // window bytes
    const int64_t nout = (p + bits + 7) / 8;             // body bytes of the shifted window
    const uint8_t* win = reinterpret_cast<const uint8_t*>(windows + tile * WIN_WORDS);
    uint32_t* out = words + static_cast<int64_t>(b) * n_words;
    const int64_t w_first = base >> 2;
    const int64_t w_last = (base + nout - 1) >> 2;
    for (int64_t w = w_first + threadIdx.x; w <= w_last && w < n_words; w += BLOCK) {
        uint32_t word = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int64_t k = w * 4 + q - base;
            if (k < 0 || k >= nout) continue;
            const uint32_t cur = k < nwin ? win[k] : 0u;
            const uint32_t prev = k > 0 ? win[k - 1] : 0u;
            word |= (((cur << p) | (prev >> (8 - p))) & 0xFFu) << (8 * q);
        }
        if (w == w_first || w == w_last) {
            if (word) atomicOr(out + w, word);
        } else {
            out[w] = word;
        }
    }
}

__global__ void asm_finish_kernel(const int* __restrict__ phase, const int* __restrict__ partial,
                                  const int* __restrict__ totals, int* __restrict__ totbits,
                                  uint8_t* __restrict__ overflow, uint32_t* __restrict__ words,
                                  int64_t n_words, int64_t out_bound, int64_t batch) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const int64_t total = static_cast<int64_t>(phase[b]) + totals[b];
    totbits[b] = static_cast<int>(total);
    overflow[b] = (total + 7) / 8 > out_bound ? 1 : 0;
    if (n_words > 0) words[b * n_words] |= static_cast<uint32_t>(partial[b] & 0xFF);
}

template <class Tok>
void launch_assemble(const void* tok, const float* lut, const int* phase, const int* partial,
                     int* tile_bits, int* totbits, uint8_t* overflow, uint32_t* words,
                     int64_t batch, int64_t ncols, int64_t n_words, int64_t out_bound,
                     cudaStream_t s) {
    const int n_tiles = static_cast<int>(deflate_tiles(ncols));
    const dim3 grid(static_cast<unsigned>(n_tiles > 0 ? n_tiles : 1),
                    static_cast<unsigned>(batch));
    auto* t = static_cast<const Tok*>(tok);
    asm_count_kernel<Tok><<<grid, BLOCK, 0, s>>>(t, lut, ncols, n_tiles, tile_bits,
                                                 reinterpret_cast<uint4*>(words),
                                                 batch * n_words / 4);
    asm_place_kernel<Tok><<<grid, BLOCK, 0, s>>>(t, lut, phase, partial, tile_bits, ncols,
                                                 n_tiles, words, n_words, out_bound, totbits,
                                                 overflow);
}

template <class Tok>
void launch_split(const void* tok, const float* lut, const int* phase, int* tile_bits, int* totals,
                  uint8_t* overflow, uint32_t* windows, uint32_t* words, int64_t batch,
                  int64_t ncols, int64_t n_words, cudaStream_t s) {
    const int n_tiles = static_cast<int>(deflate_tiles(ncols));
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    if (n_tiles > 0) {
        split_par_kernel<Tok><<<grid, BLOCK, 0, s>>>(static_cast<const Tok*>(tok), lut, ncols,
                                                     n_tiles, tile_bits, windows);
    }
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(tile_bits, n_tiles,
                                                                         totals, overflow, -1);
    if (n_tiles > 0) {
        split_cat_kernel<<<grid, BLOCK, 0, s>>>(windows, tile_bits, totals, phase, n_tiles, words,
                                                n_words);
    }
}

}  // namespace

// tok (batch, ncols) inverted tokens, u16 or (tok_i32) i32; lut (batch, 48,
// 32) f32 as codecs/dyndeflate.luts_as_radix lays it out; phase, partial
// (batch,) i32 -> body (batch, out_bound) u8 with out_bound % 16 == 0 (bytes
// past out_bound are dropped), totbits (batch,) i32 counting the phase,
// overflow (batch,) u8 = ceil(totbits / 8) > out_bound.  tile_bits (batch,
// pr_deflate_tiles(ncols)) i32 is scratch.  Two kernel launches; returns
// the first CUDA error.
extern "C" int pr_assemble(const void* tok, int tok_i32, const void* lut, const void* phase,
                           const void* partial, void* body, void* totbits, void* overflow,
                           void* tile_bits, int64_t batch, int64_t ncols, int64_t out_bound,
                           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* l = static_cast<const float*>(lut);
    auto* ph = static_cast<const int*>(phase);
    auto* pa = static_cast<const int*>(partial);
    auto* tiles = static_cast<int*>(tile_bits);
    auto* bits = static_cast<int*>(totbits);
    auto* ovf = static_cast<uint8_t*>(overflow);
    auto* words = static_cast<uint32_t*>(body);
    if (tok_i32) {
        launch_assemble<int32_t>(tok, l, ph, pa, tiles, bits, ovf, words, batch, ncols,
                                 out_bound / 4, out_bound, s);
    } else {
        launch_assemble<uint16_t>(tok, l, ph, pa, tiles, bits, ovf, words, batch, ncols,
                                  out_bound / 4, out_bound, s);
    }
    return static_cast<int>(cudaGetLastError());
}

// pr_assemble's contract and bytes by the split form; windows (batch,
// pr_deflate_tiles(ncols), pr_split_window_words()) u32 is scratch beside
// tile_bits and totals.
extern "C" int pr_assemble_split(const void* tok, int tok_i32, const void* lut, const void* phase,
                                 const void* partial, void* body, void* totbits, void* overflow,
                                 void* tile_bits, void* totals, void* windows, int64_t batch,
                                 int64_t ncols, int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_words = out_bound / 4;
    auto* words = static_cast<uint32_t*>(body);
    auto* l = static_cast<const float*>(lut);
    auto* ph = static_cast<const int*>(phase);
    auto* tiles = static_cast<int*>(tile_bits);
    auto* tot = static_cast<int*>(totals);
    auto* ovf = static_cast<uint8_t*>(overflow);
    auto* win = static_cast<uint32_t*>(windows);
    const cudaError_t err = cudaMemsetAsync(body, 0, batch * out_bound, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tok_i32) {
        launch_split<int32_t>(tok, l, ph, tiles, tot, ovf, win, words, batch, ncols, n_words, s);
    } else {
        launch_split<uint16_t>(tok, l, ph, tiles, tot, ovf, win, words, batch, ncols, n_words, s);
    }
    asm_finish_kernel<<<static_cast<unsigned>((batch + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
        ph, static_cast<const int*>(partial), tot, static_cast<int*>(totbits), ovf, words, n_words,
        out_bound, batch);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_split_window_words() { return WIN_WORDS; }
