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
// through one-hot matmuls into a VMEM window.  Here:
//   1. asm_bits_kernel: each block sums the bit counts of its TILE tokens;
//   2. scan_tiles_kernel (common.cuh): tile sums -> each tile's bit offset,
//      and each stream's total;
//   3. asm_scatter_kernel: a block scan gives each thread the bit offset of
//      its tokens; value << (offset & 31) is ORed into the 32-bit words
//      offset >> 5 and the next with atomicOr.  Bit ranges are disjoint, so
//      the ORs are exact in any order;
//   4. asm_finish_kernel: total bits, overflow, the header's partial byte.
// The LUT is read as exact integers (values <= 21 bits are exact in f32)
// into shared memory; no matmul.  Bound by device-memory bytes for the
// token reads and by the atomics on the body, a few bytes per token.
//
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

// LUT index of an inverted token, -1 for no token.
template <class Tok>
__device__ __forceinline__ int token_index(Tok v) {
    const int inv = static_cast<int>(v);
    return (inv >= 1 && inv <= NO_TOKEN) ? NO_TOKEN - inv : -1;
}

template <class Tok>
__global__ void asm_bits_kernel(const Tok* __restrict__ tok, const float* __restrict__ lut,
                                int64_t ncols, int n_tiles, int* __restrict__ tile_bits) {
    __shared__ int bits_s[NO_TOKEN];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const float* l = lut + static_cast<int64_t>(b) * LUT_SIZE;
    for (int k = threadIdx.x; k < NO_TOKEN; k += BLOCK) bits_s[k] = static_cast<int>(l[LUT_BITS + k]);
    __syncthreads();
    const Tok* row = tok + static_cast<int64_t>(b) * ncols;
    int sum = 0;
    for (int k = threadIdx.x; k < TILE; k += BLOCK) {
        const int64_t i = static_cast<int64_t>(t) * TILE + k;
        if (i < ncols) {
            const int idx = token_index(row[i]);
            if (idx >= 0) sum += bits_s[idx];
        }
    }
    sum = block_all_reduce(sum, SumOp(), scratch);
    if (threadIdx.x == 0) tile_bits[static_cast<int64_t>(b) * n_tiles + t] = sum;
}

template <class Tok>
__global__ void asm_scatter_kernel(const Tok* __restrict__ tok, const float* __restrict__ lut,
                                   const int* __restrict__ phase,
                                   const int* __restrict__ tile_offsets, int64_t ncols,
                                   int n_tiles, uint32_t* __restrict__ words, int64_t n_words) {
    __shared__ int vals_s[NO_TOKEN];
    __shared__ int bits_s[NO_TOKEN];
    __shared__ int scratch[WARPS];
    const int b = blockIdx.y;
    const int t = blockIdx.x;
    const float* l = lut + static_cast<int64_t>(b) * LUT_SIZE;
    for (int k = threadIdx.x; k < NO_TOKEN; k += BLOCK) {
        vals_s[k] = static_cast<int>(l[k]);
        bits_s[k] = static_cast<int>(l[LUT_BITS + k]);
    }
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
    int64_t off = static_cast<int64_t>(phase[b]) +
                  tile_offsets[static_cast<int64_t>(b) * n_tiles + t] +
                  block_exclusive_scan<true>(sum, SumOp(), 0, scratch);
    uint32_t* out = words + static_cast<int64_t>(b) * n_words;
#pragma unroll
    for (int k = 0; k < TILE_PER_THREAD; ++k) {
        if (nb[k]) {
            const int64_t w = off >> 5;
            const unsigned long long sv = static_cast<unsigned long long>(static_cast<uint32_t>(val[k]))
                                          << (off & 31);
            const uint32_t lo = static_cast<uint32_t>(sv);
            const uint32_t hi = static_cast<uint32_t>(sv >> 32);
            if (lo && w < n_words) atomicOr(out + w, lo);
            if (hi && w + 1 < n_words) atomicOr(out + w + 1, hi);
            off += nb[k];
        }
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
void launch_tiles(const void* tok, const float* lut, const int* phase, int* tile_bits,
                  int* totals, uint8_t* overflow, uint32_t* words, int64_t batch, int64_t ncols,
                  int64_t n_words, cudaStream_t s) {
    const int n_tiles = static_cast<int>(deflate_tiles(ncols));
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    auto* t = static_cast<const Tok*>(tok);
    if (n_tiles > 0) asm_bits_kernel<Tok><<<grid, BLOCK, 0, s>>>(t, lut, ncols, n_tiles, tile_bits);
    scan_tiles_kernel<<<static_cast<unsigned>(batch), SCAN_BLOCK, 0, s>>>(tile_bits, n_tiles,
                                                                         totals, overflow, -1);
    if (n_tiles > 0) {
        asm_scatter_kernel<Tok><<<grid, BLOCK, 0, s>>>(t, lut, phase, tile_bits, ncols, n_tiles,
                                                       words, n_words);
    }
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
// (batch,) i32 -> body (batch, out_bound) u8 with out_bound % 4 == 0 (bytes
// past out_bound are dropped), totbits (batch,) i32 counting the phase,
// overflow (batch,) u8 = ceil(totbits / 8) > out_bound.  tile_bits (batch,
// pr_deflate_tiles(ncols)) and totals (batch,) i32 are scratch.  Returns the
// first CUDA error.
extern "C" int pr_assemble(const void* tok, int tok_i32, const void* lut, const void* phase,
                           const void* partial, void* body, void* totbits, void* overflow,
                           void* tile_bits, void* totals, int64_t batch, int64_t ncols,
                           int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_words = out_bound / 4;
    auto* words = static_cast<uint32_t*>(body);
    auto* l = static_cast<const float*>(lut);
    auto* ph = static_cast<const int*>(phase);
    auto* tiles = static_cast<int*>(tile_bits);
    auto* tot = static_cast<int*>(totals);
    auto* ovf = static_cast<uint8_t*>(overflow);
    const cudaError_t err = cudaMemsetAsync(body, 0, batch * out_bound, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tok_i32) {
        launch_tiles<int32_t>(tok, l, ph, tiles, tot, ovf, words, batch, ncols, n_words, s);
    } else {
        launch_tiles<uint16_t>(tok, l, ph, tiles, tot, ovf, words, batch, ncols, n_words, s);
    }
    asm_finish_kernel<<<static_cast<unsigned>((batch + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
        ph, static_cast<const int*>(partial), tot, static_cast<int*>(totbits), ovf, words, n_words,
        out_bound, batch);
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
