// L1 decode from set-bit positions: positions + rank-aligned values ->
// dense residual frame, with no bitmap anywhere (the scheme-12 gap read
// chain).
//
// Replaces pyrecode_tpu/ops/pallas_decode.py:decode_l1_from_positions
// (kernel built by _build_posdecode_kernel).  The TPU kernel packs
// (position, value) pairs into chunk-relative words, counts them per chunk
// with a searchsorted, and places them by rank-match passes over capacity
// buckets that escalate on overflow; here the frame is zero-filled and one
// thread per stored value writes dense[pos[k]] = val[k].  One capacity, the
// positions' width, replaces the bucket ladder.  overflow flags a frame
// whose count exceeds that width, or one of whose positions lies outside
// the frame or does not ascend (a corrupt stream: the caller raises).
//
// Bound: the zero fill writes every pixel once (2 B each); the scatter
// reads 8 B per foreground pixel and writes 2 B, at ~1% occupancy a small
// fraction.  The fill is the floor, and it is a plain memset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int POS_BLOCK = 256;

__global__ void posdecode_scatter_kernel(const int32_t* __restrict__ positions,
                                         const int32_t* __restrict__ values,
                                         const int32_t* __restrict__ counts,
                                         uint16_t* __restrict__ dense,
                                         uint8_t* __restrict__ overflow, int64_t width,
                                         int64_t n_pixels) {
    const int64_t b = blockIdx.y;
    const int64_t k = static_cast<int64_t>(blockIdx.x) * POS_BLOCK + threadIdx.x;
    const int64_t count = counts[b];
    if (k == 0 && (count > width || count < 0)) overflow[b] = 1;
    if (k >= count || k >= width) return;
    const int32_t* pos = positions + b * width;
    const int32_t p = pos[k];
    if (p < 0 || p >= n_pixels || (k > 0 && p <= pos[k - 1])) {
        overflow[b] = 1;
        return;
    }
    dense[b * n_pixels + p] = static_cast<uint16_t>(values[b * width + k]);
}

}  // namespace

// positions and values (batch, width) i32, counts (batch,) i32 -> dense
// (batch, n_pixels) u16, overflow (batch,) u8.  Returns cudaGetLastError().
extern "C" int pr_posdecode(const void* positions, const void* values, const void* counts,
                            void* dense, void* overflow, int64_t batch, int64_t width,
                            int64_t n_pixels, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(dense, 0, static_cast<size_t>(batch * n_pixels) * sizeof(uint16_t), s);
    cudaMemsetAsync(overflow, 0, static_cast<size_t>(batch), s);
    const int64_t blocks = width / POS_BLOCK + 1;  // >= 1: thread 0 checks the count
    if (batch > 0) {
        const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
        posdecode_scatter_kernel<<<grid, POS_BLOCK, 0, s>>>(
            static_cast<const int32_t*>(positions), static_cast<const int32_t*>(values),
            static_cast<const int32_t*>(counts), static_cast<uint16_t*>(dense),
            static_cast<uint8_t*>(overflow), width, n_pixels);
    }
    return static_cast<int>(cudaGetLastError());
}
