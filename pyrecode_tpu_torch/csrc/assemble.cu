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

#include "deflate.cuh"

namespace {

constexpr int LUT_BITS = 768;  // (48, 32) f32: values at [0, 768), bit counts at [768, 1536)
constexpr int LUT_SIZE = 2 * LUT_BITS;

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
