// 12-bit LSB-first pack and unpack: two values <-> three bytes, and the
// word form of the pack: eight values -> three little-endian u32 words.
//
// Replace pyrecode_tpu/ops/pallas_bitpack.py:bitpack12_pallas (kernel
// _kernel_bytes), bitunpack12_pallas (kernel _kernel_unpack) and
// bitpack12_words_pallas (kernel _kernel).  The TPU
// kernels transpose 2048-value segments in VMEM so that the members of each
// 8-value group share a lane, which ties them to n % 262144 == 0; on the GPU
// one thread owns one 2-value / 3-byte group (8-value / 3-word group for
// the word form), so any even n (any multiple of 8) is taken.
//
// All are streaming passes bound by device-memory bytes (8 B in, 3 B out
// per pair to pack; 3 B in, 8 B out to unpack; 32 B in, 12 B out per group
// for the word form).  Neighbouring threads touch
// neighbouring groups, so a warp's loads and stores each cover one
// contiguous span.  The byte formulas are those of
// pyrecode_tpu/ops/bitpack.py:bitpack_values / bitunpack_values at 12 bits,
// including for pack inputs of 4096 and above (bits past the 12th spill
// into the neighbouring byte exactly as there).  The word form follows
// pyrecode_tpu/ops/bitpack.py:bitpack_values_words at 12 bits: values are
// read as uint32 and ORed unmasked into their words (the same bytes as the
// byte form for values below 4096).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACK_BLOCK = 256;
constexpr int64_t PACK_MAX_BLOCKS = 132 * 32;

unsigned pack_grid(int64_t n) {
    int64_t blocks = (n + PACK_BLOCK - 1) / PACK_BLOCK;
    return static_cast<unsigned>(blocks < PACK_MAX_BLOCKS ? blocks : PACK_MAX_BLOCKS);
}

__global__ void bitpack12_kernel(const int32_t* __restrict__ values, uint8_t* __restrict__ out,
                                 int64_t n_pairs) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_pairs;
         p += stride) {
        const uint32_t u = static_cast<uint32_t>(values[2 * p]);
        const uint32_t w = static_cast<uint32_t>(values[2 * p + 1]);
        out[3 * p] = static_cast<uint8_t>(u & 0xFFu);
        out[3 * p + 1] = static_cast<uint8_t>(((u >> 8) | (w << 4)) & 0xFFu);
        out[3 * p + 2] = static_cast<uint8_t>((w >> 4) & 0xFFu);
    }
}

__global__ void bitunpack12_kernel(const uint8_t* __restrict__ packed,
                                   int32_t* __restrict__ values, int64_t n_triples) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_triples;
         p += stride) {
        const int32_t b0 = packed[3 * p];
        const int32_t b1 = packed[3 * p + 1];
        const int32_t b2 = packed[3 * p + 2];
        values[2 * p] = b0 | ((b1 & 0xF) << 8);
        values[2 * p + 1] = (b1 >> 4) | (b2 << 4);
    }
}

__global__ void bitpack12_words_kernel(const int32_t* __restrict__ values,
                                       uint32_t* __restrict__ words, int64_t n_groups) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < n_groups;
         g += stride) {
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = static_cast<uint32_t>(values[8 * g + k]);
        words[3 * g] = v[0] | (v[1] << 12) | (v[2] << 24);
        words[3 * g + 1] = (v[2] >> 8) | (v[3] << 4) | (v[4] << 16) | (v[5] << 28);
        words[3 * g + 2] = (v[5] >> 4) | (v[6] << 8) | (v[7] << 20);
    }
}

}  // namespace

// values (n_pairs * 2) i32 -> out (n_pairs * 3) u8.  Returns cudaGetLastError().
extern "C" int pr_bitpack12(const void* values, void* out, int64_t n_pairs, void* stream) {
    if (n_pairs > 0) {
        bitpack12_kernel<<<pack_grid(n_pairs), PACK_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(values), static_cast<uint8_t*>(out), n_pairs);
    }
    return static_cast<int>(cudaGetLastError());
}

// packed (n_triples * 3) u8 -> values (n_triples * 2) i32.  Returns cudaGetLastError().
extern "C" int pr_bitunpack12(const void* packed, void* values, int64_t n_triples,
                              void* stream) {
    if (n_triples > 0) {
        bitunpack12_kernel<<<pack_grid(n_triples), PACK_BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(packed), static_cast<int32_t*>(values), n_triples);
    }
    return static_cast<int>(cudaGetLastError());
}

// values (n_groups * 8) i32 -> words (n_groups * 3) u32, little-endian: the
// byte view is the 12-bit stream.  Returns cudaGetLastError().
extern "C" int pr_bitpack12_words(const void* values, void* words, int64_t n_groups,
                                  void* stream) {
    if (n_groups > 0) {
        bitpack12_words_kernel<<<pack_grid(n_groups), PACK_BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(values), static_cast<uint32_t*>(words), n_groups);
    }
    return static_cast<int>(cudaGetLastError());
}
