// Interleaved-rANS encode of symbol streams (scheme 12, symbol and gap
// modes).
//
// Replaces pyrecode_tpu/ops/pallas_rans.py:rans_encode_symbols_pallas
// (kernel built by _build_rans_encode_kernel with direct=True), groups 1
// and 8, to the contract of codecs/rans.py:rans_encode_interleaved at
// nways = 1024 * groups: rows of nways symbols are walked from the last;
// in a row every active lane emits its low byte, then once more, while
// x >= f << 19, and a row's bytes follow in DESCENDING lane order, low byte
// first per lane; then x = (x / f << 12) + x % f + cum.  The body comes out
// in emit order (the decoder reads it backward).
//
// The TPU kernel fetches f and cum through radix LUT matmuls, divides with
// an f32-reciprocal digit ladder and scatters bytes with one-hot matmuls,
// all Mosaic workarounds; here f and cum sit in shared memory, the division
// is the integer one, and each byte's place is a block-wide exclusive scan
// of the lanes' byte counts, taken in descending lane order.
//
// One block of 1024 threads codes one stream; thread t owns the G lanes
// G * (1023 - t) ... + G - 1, so ascending threads walk descending lanes.
// The chain of rows is serial by construction (each row's byte offsets
// depend on every earlier row), so this kernel is bound by the latency of
// one row step (a scan and a division per lane), not by bytes or
// arithmetic: at the slice's ~168k symbols a stream takes ~164 row steps.
// Streams run side by side, one block each; groups = 8 quarters the row
// count for streams of 2^21 symbols and more.

#include "rans.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(RANS_THREADS)
rans_encode_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ freq,
                   const int32_t* __restrict__ cum, const int32_t* __restrict__ m_arr,
                   uint8_t* __restrict__ body, int32_t* __restrict__ states,
                   int32_t* __restrict__ counts, int64_t npad, int64_t out_bound) {
    __shared__ uint16_t s_freq[RANS_ALPHABET];
    __shared__ uint16_t s_cum[RANS_ALPHABET];
    __shared__ int warp_sums[RANS_WARPS];
    const int64_t b = blockIdx.x;
    for (int i = threadIdx.x; i < RANS_ALPHABET; i += RANS_THREADS) {
        const int32_t f = freq[b * RANS_ALPHABET + i];
        s_freq[i] = static_cast<uint16_t>(f > 0 ? f : 1);  // a symbol that never occurs
        s_cum[i] = static_cast<uint16_t>(cum[b * RANS_ALPHABET + i]);
    }
    __syncthreads();

    constexpr int64_t NWAYS = static_cast<int64_t>(G) * RANS_THREADS;
    const int base = G * (RANS_THREADS - 1 - static_cast<int>(threadIdx.x));
    const int64_t m = m_arr[b];
    const int32_t* vals = values + b * npad;
    uint8_t* out = body + b * out_bound;
    uint32_t x[G];
#pragma unroll
    for (int k = 0; k < G; ++k) x[k] = RANS_L;

    int64_t cursor = 0;
    for (int64_t row0 = m > 0 ? ((m - 1) / NWAYS) * NWAYS : -1; row0 >= 0; row0 -= NWAYS) {
        uint8_t bytes[2 * G];
        int n_bytes = 0;
#pragma unroll
        for (int k = G - 1; k >= 0; --k) {
            const int64_t idx = row0 + base + k;
            if (idx < m) {
                const int s = vals[idx] & (RANS_ALPHABET - 1);
                const uint32_t f = s_freq[s];
                const uint32_t xmax = f << RANS_XMAX_SHIFT;
                uint32_t xv = x[k];
                if (xv >= xmax) {
                    bytes[n_bytes++] = static_cast<uint8_t>(xv & 0xFFu);
                    xv >>= 8;
                    if (xv >= xmax) {
                        bytes[n_bytes++] = static_cast<uint8_t>(xv & 0xFFu);
                        xv >>= 8;
                    }
                }
                x[k] = ((xv / f) << RANS_PROB_BITS) + xv % f + s_cum[s];
            }
        }
        int total;
        const int64_t at = cursor + block_exclusive_scan(n_bytes, warp_sums, &total);
        for (int j = 0; j < n_bytes; ++j) {
            if (at + j < out_bound) out[at + j] = bytes[j];
        }
        cursor += total;
    }
#pragma unroll
    for (int k = 0; k < G; ++k) states[b * NWAYS + base + k] = static_cast<int32_t>(x[k]);
    if (threadIdx.x == 0) counts[b] = static_cast<int32_t>(cursor);
}

}  // namespace

// values (batch, npad) i32 symbols < 4096, freq and cum (batch, 4096) i32
// (the stream's quantized frequencies, summing to 4096, and their
// exclusive prefix), m (batch,) i32 symbols to code -> body (batch,
// out_bound) u8 in emit order (bytes past out_bound are dropped), states
// (batch, 1024 * groups) i32, counts (batch,) i32 body bytes (more than
// out_bound: the body did not fit).  groups is 1 or 8.  Returns
// cudaGetLastError().
extern "C" int pr_rans_encode(const void* values, const void* freq, const void* cum,
                              const void* m, void* body, void* states, void* counts,
                              int64_t batch, int64_t npad, int64_t out_bound, int groups,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* v = static_cast<const int32_t*>(values);
    auto* f = static_cast<const int32_t*>(freq);
    auto* c = static_cast<const int32_t*>(cum);
    auto* mm = static_cast<const int32_t*>(m);
    auto* bo = static_cast<uint8_t*>(body);
    auto* st = static_cast<int32_t*>(states);
    auto* cn = static_cast<int32_t*>(counts);
    if (groups == 8) {
        rans_encode_kernel<8><<<static_cast<unsigned>(batch), RANS_THREADS, 0, s>>>(
            v, f, c, mm, bo, st, cn, npad, out_bound);
    } else if (groups == 1) {
        rans_encode_kernel<1><<<static_cast<unsigned>(batch), RANS_THREADS, 0, s>>>(
            v, f, c, mm, bo, st, cn, npad, out_bound);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
