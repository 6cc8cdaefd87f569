// 4096-bin symbol histogram of each stream (scheme 12).
//
// Replaces pyrecode_tpu/ops/pallas_rans.py:hist_symbols_pallas (kernel
// built by _build_hist_kernel).  The TPU kernel counts through a one-hot
// NT matmul per grid step; here one block takes one chunk of one stream,
// counts its symbols with integer shared-memory atomics into 4096 bins
// (16 KB), then adds each nonzero bin to the stream's histogram with one
// global atomic.  Exact by construction: no matmul, no float.  Entries at
// or beyond the stream's m count nowhere, and neither do symbols outside
// 0..4095 (the TPU's one-hot matches no bin for them).
//
// Bound: the symbols are read once (4 B each) and the histogram written
// once (16 KB a stream), so the kernel is bound by device-memory bytes;
// the 4096-bin flush per block is why a chunk holds 16384 symbols, four
// per bin.  Peaked data (gaps at ~1% occupancy, detector residuals) puts
// most symbols on a few bins, so the shared atomics contend there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HIST_BINS = 4096;
constexpr int HIST_BLOCK = 512;
constexpr int64_t HIST_CHUNK = 16384;

__global__ void __launch_bounds__(HIST_BLOCK)
rans_hist_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ m_arr,
                 int32_t* __restrict__ hist, int64_t npad) {
    __shared__ int bins[HIST_BINS];
    const int64_t b = blockIdx.y;
    const int64_t start = static_cast<int64_t>(blockIdx.x) * HIST_CHUNK;
    int64_t end = start + HIST_CHUNK;
    const int64_t m = m_arr[b] < npad ? m_arr[b] : npad;
    if (end > m) end = m;
    if (start >= end) return;
    for (int i = threadIdx.x; i < HIST_BINS; i += HIST_BLOCK) bins[i] = 0;
    __syncthreads();
    const int32_t* v = values + b * npad;
    for (int64_t i = start + threadIdx.x; i < end; i += HIST_BLOCK) {
        const int32_t s = v[i];
        if (s >= 0 && s < HIST_BINS) atomicAdd(&bins[s], 1);
    }
    __syncthreads();
    int32_t* h = hist + b * HIST_BINS;
    for (int i = threadIdx.x; i < HIST_BINS; i += HIST_BLOCK) {
        if (bins[i]) atomicAdd(&h[i], bins[i]);
    }
}

}  // namespace

// values (batch, npad) i32, m (batch,) i32 -> hist (batch, 4096) i32, which
// the caller zeroes.  Returns cudaGetLastError().
extern "C" int pr_rans_hist(const void* values, const void* m, void* hist, int64_t batch,
                            int64_t npad, void* stream) {
    const int64_t chunks = (npad + HIST_CHUNK - 1) / HIST_CHUNK;
    if (batch > 0 && chunks > 0) {
        const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(batch));
        rans_hist_kernel<<<grid, HIST_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(values), static_cast<const int32_t*>(m),
            static_cast<int32_t*>(hist), npad);
    }
    return static_cast<int>(cudaGetLastError());
}
