// Interleaved-rANS encode of symbol streams (scheme 12, symbol and gap
// modes) and of deflate token streams (byte mode).
//
// Replaces pyrecode_tpu/ops/pallas_rans.py:rans_encode_symbols_pallas
// (kernel built by _build_rans_encode_kernel with direct=True), groups 1
// and 8, and rans_encode_pallas (_build_rans_encode_kernel in byte mode, groups 1),
// to the contract of codecs/rans.py:rans_encode_interleaved at
// nways = 1024 * groups: rows of nways symbols are walked from the last;
// in a row every active lane emits its low byte, then once more, while
// x >= f << 19, and a row's bytes follow in DESCENDING lane order, low byte
// first per lane; then x = (x / f << 12) + x % f + cum.  The body comes out
// in emit order (the decoder reads it backward).
//
// Byte mode takes the deflate kernels' inverted tokens (idx = NO_TOKEN -
// tok): index idx < 256 is literal symbol idx, 256 <= idx < 512 a match of
// take = idx - 253 and symbol 257 + its length code, as
// codecs/rans.py:_token_syms_and_extras maps them; any other index (pad)
// codes as f = 1, cum = 0, as the TPU kernel's LUT gives it.  The block
// folds that map into its shared tables: entry idx holds the freq and cum
// of idx's symbol, so a token costs the same one lookup as a symbol.  The
// threshold f << 19 is unsigned here: at f = 4096 (a one-symbol alphabet)
// the TPU kernel's int32 wraps and emits two bytes a symbol, where the
// contract emits none.
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

constexpr int NO_TOKEN = 512;   // token indices below it: literals and matches
__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};

// Symbol of token index idx (0 <= idx < 512): the literal, or 257 + the
// length code of take = idx - 253.
__device__ int token_symbol(int idx) {
    if (idx < 256) return idx;
    const int take = idx - 253;
    int code = 0;
    while (code + 1 < 29 && kLenBase[code + 1] <= take) ++code;
    return 257 + code;
}

// kTokens: In holds inverted tokens (uint16 or int32) and s_freq / s_cum
// are indexed by token index; else In is int32 symbols < 4096.
template <int G, typename In, bool kTokens>
__global__ void __launch_bounds__(RANS_THREADS)
rans_encode_kernel(const In* __restrict__ values, const int32_t* __restrict__ freq,
                   const int32_t* __restrict__ cum, const int32_t* __restrict__ m_arr,
                   uint8_t* __restrict__ body, int32_t* __restrict__ states,
                   int32_t* __restrict__ counts, int64_t npad, int64_t out_bound) {
    __shared__ uint16_t s_freq[RANS_ALPHABET];
    __shared__ uint16_t s_cum[RANS_ALPHABET];
    __shared__ int warp_sums[RANS_WARPS];
    const int64_t b = blockIdx.x;
    const int entries = kTokens ? NO_TOKEN : RANS_ALPHABET;
    for (int i = threadIdx.x; i < entries; i += RANS_THREADS) {
        const int s = kTokens ? token_symbol(i) : i;
        const int32_t f = freq[b * RANS_ALPHABET + s];
        s_freq[i] = static_cast<uint16_t>(f > 0 ? f : 1);  // a symbol that never occurs
        s_cum[i] = static_cast<uint16_t>(cum[b * RANS_ALPHABET + s]);
    }
    __syncthreads();

    constexpr int64_t NWAYS = static_cast<int64_t>(G) * RANS_THREADS;
    const int base = G * (RANS_THREADS - 1 - static_cast<int>(threadIdx.x));
    const int64_t m = m_arr[b];
    const In* vals = values + b * npad;
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
                uint32_t f = 1u, c = 0u;
                if constexpr (kTokens) {
                    const int t = NO_TOKEN - static_cast<int>(vals[idx]);
                    if (t >= 0 && t < NO_TOKEN) {
                        f = s_freq[t];
                        c = s_cum[t];
                    }
                } else {
                    const int s = static_cast<int>(vals[idx]) & (RANS_ALPHABET - 1);
                    f = s_freq[s];
                    c = s_cum[s];
                }
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
                x[k] = ((xv / f) << RANS_PROB_BITS) + xv % f + c;
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
    const unsigned grid = static_cast<unsigned>(batch);
    if (groups == 8) {
        rans_encode_kernel<8, int32_t, false><<<grid, RANS_THREADS, 0, s>>>(
            v, f, c, mm, bo, st, cn, npad, out_bound);
    } else if (groups == 1) {
        rans_encode_kernel<1, int32_t, false><<<grid, RANS_THREADS, 0, s>>>(
            v, f, c, mm, bo, st, cn, npad, out_bound);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// tok (batch, npad) inverted deflate tokens, uint16 (tok_is_i32 = 0) or
// int32, as tokenize / compact_tokens give them; freq and cum (batch, 4096)
// i32 of the 286-symbol byte-mode alphabet (rest zero); m (batch,) i32
// tokens to code -> body, states (batch, 1024) and counts as
// pr_rans_encode at groups 1.  Returns cudaGetLastError().
extern "C" int pr_rans_encode_tokens(const void* tok, int tok_is_i32, const void* freq,
                                     const void* cum, const void* m, void* body, void* states,
                                     void* counts, int64_t batch, int64_t npad,
                                     int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* f = static_cast<const int32_t*>(freq);
    auto* c = static_cast<const int32_t*>(cum);
    auto* mm = static_cast<const int32_t*>(m);
    auto* bo = static_cast<uint8_t*>(body);
    auto* st = static_cast<int32_t*>(states);
    auto* cn = static_cast<int32_t*>(counts);
    const unsigned grid = static_cast<unsigned>(batch);
    if (tok_is_i32) {
        rans_encode_kernel<1, int32_t, true><<<grid, RANS_THREADS, 0, s>>>(
            static_cast<const int32_t*>(tok), f, c, mm, bo, st, cn, npad, out_bound);
    } else {
        rans_encode_kernel<1, uint16_t, true><<<grid, RANS_THREADS, 0, s>>>(
            static_cast<const uint16_t*>(tok), f, c, mm, bo, st, cn, npad, out_bound);
    }
    return static_cast<int>(cudaGetLastError());
}
