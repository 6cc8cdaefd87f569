// L1 decode from set-bit positions: positions + rank-aligned values ->
// dense residual frame, with no bitmap anywhere (the scheme-12 gap read
// chain).
//
// Replaces pyrecode_tpu/ops/pallas_decode.py:decode_l1_from_positions
// (kernel built by _build_posdecode_kernel).  The TPU kernel packs
// (position, value) pairs into chunk-relative words, counts them per chunk
// with a searchsorted, and places them by rank-match passes over capacity
// buckets that escalate on overflow.  Here one kernel writes every output
// byte once: each block owns a span of SPAN pixels of one frame, finds the
// positions that fall in it by a warp-cooperative search of the ascending
// positions (32 probes and one ballot a round, so ~4 dependent loads at
// 168k positions), drops their values into a zeroed copy of the span in
// shared memory, and writes the span out with 16-byte stores.  A frame
// starts at element b * n_pixels, 16-byte aligned only when n_pixels % 8 ==
// 0, so the span is kept in shared memory at the frame's alignment and its
// partial first and last 16-byte units are stored element by element.  One
// capacity, the positions' width, replaces the bucket ladder.
//
// overflow (bool bytes, written by the kernel) flags a frame whose count
// exceeds that width or is negative, or one of whose positions lies outside
// the frame or does not ascend (a corrupt stream: the caller raises, and the
// dense frame is then unspecified).  The checks go by k, not by span: each
// block checks its share of [0, count), so positions that do not ascend, on
// which the span search is meaningless, are flagged all the same.  Beside
// the kernel only the B flag bytes are reset.
//
// Bound: the dense output written once (2 B a pixel) plus 8 B read per
// stored value; at ~1% occupancy the output is the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int POS_BLOCK = 256;
constexpr int SPAN = 8192;              // output pixels a block owns: 16 KiB of u16
constexpr int SPAN_UNITS = SPAN / 8 + 1;  // 16-byte units of a span shifted by < 8 elements

static_assert(SPAN % 8 == 0, "a span starts at the frame's 16-byte alignment");

// First k in [0, cnt) with pos[k] >= target, cnt if none, for ascending pos:
// each round the warp's 32 lanes probe evenly spaced entries and the ballot's
// count of probes below the target narrows the range ~32-fold.  Any pos
// gives a result in [0, cnt].
__device__ int64_t warp_lower_bound(const int32_t* pos, int64_t cnt, int64_t target) {
    const int lane = threadIdx.x & 31;
    int64_t lo = 0;
    int64_t hi = cnt;   // the answer lies in [lo, hi]
    while (lo < hi) {
        const int64_t stride = (hi - lo + 31) / 32;
        const int64_t k = lo + lane * stride;
        const int below = __popc(__ballot_sync(kFullMask, k < hi && pos[k] < target));
        if (below == 0) return lo;
        const int64_t base = lo;
        lo = base + (below - 1) * stride + 1;
        if (base + below * stride < hi) hi = base + below * stride;
    }
    return lo;
}

__global__ void __launch_bounds__(POS_BLOCK)
posdecode_kernel(const int32_t* __restrict__ positions, const int32_t* __restrict__ values,
                 const int32_t* __restrict__ counts, uint16_t* __restrict__ dense,
                 bool* __restrict__ overflow, int64_t width, int64_t n_pixels, int64_t n_spans) {
    __shared__ uint4 span_units[SPAN_UNITS];
    __shared__ int64_t range[2];
    uint16_t* span_buf = reinterpret_cast<uint16_t*>(span_units);
    const int64_t b = blockIdx.y;
    const int64_t s = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int64_t count = counts[b];
    const int64_t cnt = count < 0 ? 0 : (count > width ? width : count);
    const int32_t* pos = positions + b * width;
    const int32_t* val = values + b * width;
    const int64_t first = s * SPAN;
    const int64_t len = n_pixels - first < SPAN ? n_pixels - first : SPAN;
    const int64_t g = b * n_pixels + first;   // the span's first element in dense
    const int shift = static_cast<int>(g & 7);
    const int units = static_cast<int>((shift + len + 7) / 8);

    if (warp < 2) {
        const int64_t at = warp_lower_bound(pos, cnt, warp == 0 ? first : first + len);
        if ((threadIdx.x & 31) == 0) range[warp] = at;
    }
    for (int u = threadIdx.x; u < units; u += POS_BLOCK) span_units[u] = make_uint4(0, 0, 0, 0);
    // this block's share of the checks
    bool bad = s == 0 && threadIdx.x == 0 && (count < 0 || count > width);
    const int64_t share = (cnt + n_spans - 1) / n_spans;
    const int64_t k1 = (s + 1) * share < cnt ? (s + 1) * share : cnt;
    for (int64_t k = s * share + threadIdx.x; k < k1; k += POS_BLOCK) {
        const int32_t p = pos[k];
        bad |= p < 0 || p >= n_pixels || (k > 0 && p <= pos[k - 1]);
    }
    if (__syncthreads_or(bad) && threadIdx.x == 0) overflow[b] = true;

    for (int64_t k = range[0] + threadIdx.x; k < range[1]; k += POS_BLOCK) {
        const int64_t q = pos[k] - first;
        if (q >= 0 && q < len) span_buf[shift + q] = static_cast<uint16_t>(val[k]);
    }
    __syncthreads();
    uint16_t* out = dense + (g - shift);   // 16-byte aligned
    for (int u = threadIdx.x; u < units; u += POS_BLOCK) {
        const int e0 = 8 * u;
        const int lo = e0 > shift ? e0 : shift;
        const int hi = e0 + 8 < shift + len ? e0 + 8 : static_cast<int>(shift + len);
        if (lo == e0 && hi == e0 + 8) {
            __stcs(reinterpret_cast<uint4*>(out) + u, span_units[u]);   // streamed: not read again here
        } else {
            for (int e = lo; e < hi; ++e) out[e] = span_buf[e];
        }
    }
}

}  // namespace

// positions and values (batch, width) i32, counts (batch,) i32 -> dense
// (batch, n_pixels) u16 (16-byte aligned), overflow (batch,) bool.  Returns
// cudaGetLastError().
extern "C" int pr_posdecode(const void* positions, const void* values, const void* counts,
                            void* dense, void* overflow, int64_t batch, int64_t width,
                            int64_t n_pixels, void* stream) {
    if (reinterpret_cast<uintptr_t>(dense) & 15u) {
        return static_cast<int>(cudaErrorMisalignedAddress);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(overflow, 0, static_cast<size_t>(batch), s);
    const int64_t n_spans = n_pixels > SPAN ? (n_pixels + SPAN - 1) / SPAN : 1;
    if (batch > 0) {
        const dim3 grid(static_cast<unsigned>(n_spans), static_cast<unsigned>(batch));
        posdecode_kernel<<<grid, POS_BLOCK, 0, s>>>(
            static_cast<const int32_t*>(positions), static_cast<const int32_t*>(values),
            static_cast<const int32_t*>(counts), static_cast<uint16_t*>(dense),
            static_cast<bool*>(overflow), width, n_pixels, n_spans);
    }
    return static_cast<int>(cudaGetLastError());
}
