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
// shifts each window into its phase and appends it.  Here each tile's tokens
// go into a window of their own, with no dependence on any other tile, and
// the windows are then shifted into place.  Two kernels, no memset, no scan
// launch:
//   1. split_par_kernel: a block a TILE of tokens reads them once (16-byte
//      loads, as asm_count_kernel), gives each thread's codes their phase-0
//      offset in the tile by a block scan, builds the window in shared memory
//      as asm_place_kernel builds its own, and writes it out with 16-byte
//      stores (its words rounded up to 4; WIN_WORDS words of scratch a tile)
//      and the tile's bit count; the same grid zeroes the body;
//   2. split_cat_kernel: a block a tile sums the bit counts of the tiles
//      before it in its stream, reads its window (16-byte loads) into shared
//      memory and places it at bit o = phase + offset on the body's 32-bit
//      word grid: output word j is __funnelshift_l(win[j - 1], win[j], o & 31).
//      The span's interior words go out as plain stores, 16 bytes where
//      aligned, its first and last word by atomicOr, as asm_place_kernel's.
//      Tile 0's block ORs in the header's partial byte; the block of a
//      stream's last tile stores the total and the overflow flag.
// The windows are scratch outside the bound (as the label kernel's are).
// Measured and left out (PERF.md §6): pass 1 zeroing its share of the body
// after its window rather than while its token loads are in flight.

#include "deflate.cuh"

namespace {

constexpr int LUT_BITS = 768;  // (48, 32) f32: values at [0, 768), bit counts at [768, 1536)
constexpr int LUT_SIZE = 2 * LUT_BITS;
constexpr int MAX_TOKEN_BITS = 21;
// a tile's window: TILE * 21 / 8 + 8 bytes in whole 16-byte vectors
constexpr int WIN_WORDS = ((TILE * MAX_TOKEN_BITS / 8 + 8) / 4 + 3) / 4 * 4;

static_assert((TILE * MAX_TOKEN_BITS / 8 + 8) % 4 == 0, "the window is whole words");
static_assert((TILE * MAX_TOKEN_BITS + 62) / 32 <= WIN_WORDS, "the place window fits");
static_assert(MAX_TOKEN_BITS < 24, "a packed LUT entry holds the value below bit 24");

// The block's equal share of the zeroing of body16_n 16-byte words, over a
// grid of any shape.
__device__ __forceinline__ void zero_share(uint4* __restrict__ body16, int64_t body16_n) {
    const int64_t blocks = static_cast<int64_t>(gridDim.x) * gridDim.y;
    const int64_t share = (body16_n + blocks - 1) / blocks;
    const int64_t z0 = (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * share;
    const int64_t z1 = z0 + share < body16_n ? z0 + share : body16_n;
    for (int64_t i = z0 + threadIdx.x; i < z1; i += BLOCK) body16[i] = make_uint4(0u, 0u, 0u, 0u);
}

// A stream's LUT in shared memory, an entry a token index: value | bit count << 24.
__device__ __forceinline__ void load_lut(int* lut_s, const float* __restrict__ l) {
    for (int k = threadIdx.x; k < NO_TOKEN; k += BLOCK) {
        lut_s[k] = static_cast<int>(l[k]) | static_cast<int>(l[LUT_BITS + k]) << 24;
    }
}

// The codes of the thread's tokens from the packed LUT; returns their bits.
__device__ __forceinline__ int lookup_codes(const int* lut_s, const int (&inv)[TILE_PER_THREAD],
                                            int (&val)[TILE_PER_THREAD],
                                            int (&nb)[TILE_PER_THREAD]) {
    int sum = 0;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        const int idx = token_index(inv[k]);
        const int e = idx >= 0 ? lut_s[idx] : 0;
        val[k] = e & 0xFFFFFF;
        nb[k] = e >> 24;
        sum += nb[k];
    }
    return sum;
}

// ORs the thread's codes, laid end to end from bit pos of a shared window,
// into the window: gathered in a 64-bit register, each finished word ORed in
// once (at most one word finishes a code of <= 21 bits).
__device__ __forceinline__ void or_codes(uint32_t* win_s, int pos,
                                         const int (&val)[TILE_PER_THREAD],
                                         const int (&nb)[TILE_PER_THREAD]) {
    int word = pos >> 5;
    unsigned long long acc = 0ull;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        acc |= static_cast<unsigned long long>(static_cast<uint32_t>(val[k])) << (pos - 32 * word);
        pos += nb[k];
        if (pos - 32 * word >= 32) {
            if (static_cast<uint32_t>(acc)) atomicOr(win_s + word, static_cast<uint32_t>(acc));
            acc >>= 32;
            ++word;
        }
    }
    if (static_cast<uint32_t>(acc)) atomicOr(win_s + word, static_cast<uint32_t>(acc));
}

// Stores the n_win words of a tile's span from body word w0 on, word k as
// word(k): the first and the last may hold bits of other tiles (of several,
// past tiles of no tokens) and take atomicOr; the interior words belong to
// the tile alone and take plain stores, 16 bytes from the first body word at
// a multiple of 4 on.  Words at or past n_words are dropped.
template <class Word>
__device__ __forceinline__ void store_span(uint32_t* __restrict__ out, int64_t w0, int n_win,
                                           int64_t n_words, Word word) {
    if (threadIdx.x == 0 && w0 < n_words) {
        const uint32_t v = word(0);
        if (v) atomicOr(out + w0, v);
    }
    if (threadIdx.x == 1 && n_win > 1 && w0 + n_win - 1 < n_words) {
        const uint32_t v = word(n_win - 1);
        if (v) atomicOr(out + w0 + n_win - 1, v);
    }
    if (n_win <= 2) return;
    int head = 1 + static_cast<int>((4 - ((w0 + 1) & 3)) & 3);
    if (head > n_win - 1) head = n_win - 1;
    const int n_vec = (n_win - 1 - head) / 4;
    const int tail = head + 4 * n_vec;
    for (int k = 1 + threadIdx.x; k < head; k += BLOCK) {
        if (w0 + k < n_words) out[w0 + k] = word(k);
    }
    for (int v = threadIdx.x; v < n_vec; v += BLOCK) {
        const int k = head + 4 * v;
        if (w0 + k < n_words) {   // n_words is a multiple of 4: the whole vector fits
            *reinterpret_cast<uint4*>(out + w0 + k) =
                make_uint4(word(k), word(k + 1), word(k + 2), word(k + 3));
        }
    }
    for (int k = tail + threadIdx.x; k < n_win - 1; k += BLOCK) {
        if (w0 + k < n_words) out[w0 + k] = word(k);
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
    zero_share(body16, body16_n);
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
    __shared__ int lut_s[NO_TOKEN];
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
    load_lut(lut_s, lut + static_cast<int64_t>(b) * LUT_SIZE);
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
    int val[TILE_PER_THREAD];
    int nb[TILE_PER_THREAD];
    const int sum = lookup_codes(lut_s, inv, val, nb);
    or_codes(win_s, lead + block_exclusive_scan<true>(sum, SumOp(), 0, scratch), val, nb);
    __syncthreads();
    store_span(out, start >> 5, (lead + own + 31) >> 5, n_words,
               [&](int k) { return win_s[k]; });
}

// Pass 1 of the split form: the body's zeros, then the tile's tokens at
// phase 0 in its own window and its bit count.  A grid of max(n_tiles, 1) x
// batch blocks, so that the zeros cover a batch of no columns.
template <class Tok>
__global__ void __launch_bounds__(BLOCK)
split_par_kernel(const Tok* __restrict__ tok, const float* __restrict__ lut, int64_t ncols,
                 int n_tiles, int* __restrict__ tile_bits, uint32_t* __restrict__ windows,
                 uint4* __restrict__ body16, int64_t body16_n) {
    __shared__ int lut_s[NO_TOKEN];
    __shared__ __align__(16) uint32_t win_s[WIN_WORDS];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    int inv[TILE_PER_THREAD];   // the loads first, the zeros while they are in flight
    load_tokens(tok + static_cast<int64_t>(b) * ncols, ncols,
                static_cast<int64_t>(t) * TILE + threadIdx.x * TILE_PER_THREAD, inv);
    zero_share(body16, body16_n);
    if (t >= n_tiles) return;   // a stream of no columns: only the zeros
    load_lut(lut_s, lut + static_cast<int64_t>(b) * LUT_SIZE);
    __syncthreads();
    int val[TILE_PER_THREAD];
    int nb[TILE_PER_THREAD];
    const int sum = lookup_codes(lut_s, inv, val, nb);
    const int off = block_exclusive_scan<true>(sum, SumOp(), 0, scratch);
    const int total = block_all_reduce(sum, SumOp(), scratch);
    const int n_vec = (((total + 31) >> 5) + 3) >> 2;   // the window's 16-byte vectors
    uint4* win4 = reinterpret_cast<uint4*>(win_s);
    for (int k = threadIdx.x; k < n_vec; k += BLOCK) win4[k] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    or_codes(win_s, off, val, nb);
    __syncthreads();
    const int64_t tile = static_cast<int64_t>(b) * n_tiles + t;
    if (threadIdx.x == 0) tile_bits[tile] = total;
    uint4* out = reinterpret_cast<uint4*>(windows + tile * WIN_WORDS);
    for (int k = threadIdx.x; k < n_vec; k += BLOCK) out[k] = win4[k];
}

// Pass 2 of the split form: the tile's window shifted into its bit phase and
// placed in the body (module note).  A grid of max(n_tiles, 1) x batch
// blocks, so that a stream of no columns still gets its partial byte, total
// and overflow flag.
__global__ void __launch_bounds__(BLOCK)
split_cat_kernel(const uint32_t* __restrict__ windows, const int* __restrict__ tile_bits,
                 const int* __restrict__ phase, const int* __restrict__ partial, int n_tiles,
                 uint32_t* __restrict__ words, int64_t n_words, int64_t out_bound,
                 int* __restrict__ totbits, uint8_t* __restrict__ overflow) {
    // window word k at 4 + k, zeros before it and after its last vector
    __shared__ __align__(16) uint32_t win_s[4 + WIN_WORDS + 4];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const int* tb = tile_bits + static_cast<int64_t>(b) * n_tiles;
    const int own = t < n_tiles ? tb[t] : 0;
    const int ph = phase[b];
    const int n_vec = (((own + 31) >> 5) + 3) >> 2;   // as split_par_kernel wrote them
    const uint4* src = reinterpret_cast<const uint4*>(
        windows + (static_cast<int64_t>(b) * n_tiles + t) * WIN_WORDS);
    uint4* dst = reinterpret_cast<uint4*>(win_s + 4);
    for (int k = threadIdx.x; k < n_vec; k += BLOCK) dst[k] = src[k];
    if (threadIdx.x < 4) win_s[threadIdx.x] = 0u;
    if (threadIdx.x == 4) win_s[4 + 4 * n_vec] = 0u;
    int before = 0;
    for (int j = threadIdx.x; j < t; j += BLOCK) before += tb[j];
    before = block_all_reduce(before, SumOp(), scratch);   // and the window is in place
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
    store_span(out, start >> 5, (lead + own + 31) >> 5, n_words,
               [&](int k) { return __funnelshift_l(win_s[3 + k], win_s[4 + k], lead); });
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
void launch_split(const void* tok, const float* lut, const int* phase, const int* partial,
                  int* tile_bits, int* totbits, uint8_t* overflow, uint32_t* windows,
                  uint32_t* words, int64_t batch, int64_t ncols, int64_t n_words,
                  int64_t out_bound, cudaStream_t s) {
    const int n_tiles = static_cast<int>(deflate_tiles(ncols));
    const dim3 grid(static_cast<unsigned>(n_tiles > 0 ? n_tiles : 1),
                    static_cast<unsigned>(batch));
    split_par_kernel<Tok><<<grid, BLOCK, 0, s>>>(static_cast<const Tok*>(tok), lut, ncols,
                                                 n_tiles, tile_bits, windows,
                                                 reinterpret_cast<uint4*>(words),
                                                 batch * n_words / 4);
    split_cat_kernel<<<grid, BLOCK, 0, s>>>(windows, tile_bits, phase, partial, n_tiles, words,
                                            n_words, out_bound, totbits, overflow);
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
// tile_bits.  Two kernel launches; returns the first CUDA error.
extern "C" int pr_assemble_split(const void* tok, int tok_i32, const void* lut, const void* phase,
                                 const void* partial, void* body, void* totbits, void* overflow,
                                 void* tile_bits, void* windows, int64_t batch, int64_t ncols,
                                 int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* l = static_cast<const float*>(lut);
    auto* ph = static_cast<const int*>(phase);
    auto* pa = static_cast<const int*>(partial);
    auto* tiles = static_cast<int*>(tile_bits);
    auto* bits = static_cast<int*>(totbits);
    auto* ovf = static_cast<uint8_t*>(overflow);
    auto* win = static_cast<uint32_t*>(windows);
    auto* words = static_cast<uint32_t*>(body);
    if (tok_i32) {
        launch_split<int32_t>(tok, l, ph, pa, tiles, bits, ovf, win, words, batch, ncols,
                              out_bound / 4, out_bound, s);
    } else {
        launch_split<uint16_t>(tok, l, ph, pa, tiles, bits, ovf, win, words, batch, ncols,
                               out_bound / 4, out_bound, s);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_split_window_words() { return WIN_WORDS; }
