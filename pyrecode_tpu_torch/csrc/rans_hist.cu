// 4096-bin symbol histogram of each stream (scheme 12).
//
// Replaces pyrecode_tpu/ops/pallas_rans.py:hist_symbols_pallas (kernel
// built by _build_hist_kernel).  The TPU kernel counts through a one-hot
// NT matmul per grid step.  Here a stream is one thread-block cluster of
// HIST_CLUSTER blocks, and a call is one launch, with no fill and no global
// atomic:
//   1. each block walks its share of the stream's live symbols (up to m,
//      16-byte loads; the unaligned head and tail of a row one symbol at a
//      time) and counts them with shared atomics into its own 4096-bin
//      table (16 KB; 1024 threads a block, four loads each in flight);
//   2. after a cluster barrier, block r sums bins [r * 4096 / C, (r + 1) *
//      4096 / C) over the cluster's C tables through distributed shared
//      memory and stores them, zeros included, with plain stores; a second
//      barrier keeps every table alive until its last reader is done.
// Exact by construction: no matmul, no float.  Entries at or beyond the
// stream's m count nowhere, and neither do symbols outside 0..4095 (the
// TPU's one-hot matches no bin for them).
//
// Bound: the symbols are read once (4 B each) and the histogram written
// once (16 KB a stream), so the kernel is bound by device-memory bytes; a
// stream gets HIST_CLUSTER SMs.  Measured and left out (PERF.md §6):
// combining a warp's equal symbols with __match_any_sync before the atomic
// (1.6-3.4x slower, peaked streams included), clusters of 8, and k clusters a
// stream whose partial tables the last one to arrive sums behind a ticket.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int HIST_BINS = 4096;
constexpr int HIST_BLOCK = 1024;
constexpr int HIST_CLUSTER = 16;     // blocks a stream: the largest (non-portable) cluster
constexpr int HIST_UNROLL = 4;       // 16-byte loads a thread keeps in flight

static_assert(HIST_BINS % HIST_CLUSTER == 0, "a block sums whole bins");

// symbol s counted in its bin; nothing for s outside 0..4095
__device__ __forceinline__ void count_symbol(int* bins, int s) {
    if (static_cast<unsigned>(s) < static_cast<unsigned>(HIST_BINS)) atomicAdd(bins + s, 1);
}

__global__ void __launch_bounds__(HIST_BLOCK)
rans_hist_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ m_arr,
                 int32_t* __restrict__ hist, int64_t npad) {
    __shared__ int bins[HIST_BINS];
    cg::cluster_group cluster = cg::this_cluster();
    const int r = static_cast<int>(cluster.block_rank());
    const int64_t b = blockIdx.y;
    for (int i = threadIdx.x; i < HIST_BINS; i += HIST_BLOCK) bins[i] = 0;
    __syncthreads();
    int64_t m = m_arr[b];
    m = m < 0 ? 0 : (m < npad ? m : npad);
    const int32_t* v = values + b * npad;
    // symbols [0, head) precede the row's first 16-byte boundary
    int64_t head = static_cast<int64_t>((16u - (reinterpret_cast<uintptr_t>(v) & 15u)) & 15u) / 4;
    head = head < m ? head : m;
    const int64_t n4 = (m - head) / 4;
    const int64_t tail = head + 4 * n4;
    const int4* v4 = reinterpret_cast<const int4*>(v + head);
    // vector i goes to block (i / HIST_BLOCK) % C
    const int64_t stride = static_cast<int64_t>(HIST_CLUSTER) * HIST_BLOCK;
    for (int64_t base = static_cast<int64_t>(r) * HIST_BLOCK + threadIdx.x; base < n4;
         base += HIST_UNROLL * stride) {
        int4 q[HIST_UNROLL];
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u) {
            const int64_t i = base + u * stride;
            q[u] = i < n4 ? v4[i] : make_int4(-1, -1, -1, -1);
        }
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u) {
            count_symbol(bins, q[u].x);
            count_symbol(bins, q[u].y);
            count_symbol(bins, q[u].z);
            count_symbol(bins, q[u].w);
        }
    }
    // the head (block 0) and the tail (the last block), three symbols at most
    if (r == 0 && threadIdx.x < head) count_symbol(bins, v[threadIdx.x]);
    if (r == HIST_CLUSTER - 1 && threadIdx.x < m - tail) count_symbol(bins, v[tail + threadIdx.x]);
    cluster.sync();
    // block r: bins [r * PER_BLOCK, (r + 1) * PER_BLOCK) over the cluster's tables
    constexpr int PER_BLOCK = HIST_BINS / HIST_CLUSTER;
    const int lo = r * PER_BLOCK;
    for (int i = threadIdx.x; i < PER_BLOCK; i += HIST_BLOCK) {
        int total = 0;
#pragma unroll
        for (int q = 0; q < HIST_CLUSTER; ++q) total += cluster.map_shared_rank(bins, q)[lo + i];
        hist[b * HIST_BINS + lo + i] = total;
    }
    cluster.sync();   // every table read: the blocks may leave
}

}  // namespace

// values (batch, npad) i32, m (batch,) i32 -> hist (batch, 4096) i32, every
// bin written.  One cluster launch; returns the first CUDA error.
extern "C" int pr_rans_hist(const void* values, const void* m, void* hist, int64_t batch,
                            int64_t npad, void* stream) {
    if (batch <= 0) return static_cast<int>(cudaGetLastError());
    // a cluster of 16 is allowed per device, so on the calling thread's one
    const cudaError_t allowed = cudaFuncSetAttribute(
        rans_hist_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(HIST_CLUSTER, static_cast<unsigned>(batch));
    cfg.blockDim = dim3(HIST_BLOCK);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = HIST_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, rans_hist_kernel,
                                               static_cast<const int32_t*>(values),
                                               static_cast<const int32_t*>(m),
                                               static_cast<int32_t*>(hist), npad);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
