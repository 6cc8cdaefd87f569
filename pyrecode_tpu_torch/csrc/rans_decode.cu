// Interleaved-rANS decode of symbol streams (scheme 12).
//
// Replaces pyrecode_tpu/ops/pallas_rans.py:rans_decode_pallas (kernels
// built by _build_rans_decode_kernel, the fused 8-group step _fused_step),
// groups 1 and 8, to the contract of codecs/rans.py:rans_decode_interleaved
// at nways = 1024 * groups: rows are walked from the first; a lane's slot
// x & 4095 gives its symbol s, x' = f(s) * (x >> 12) + slot - cum(s), and
// the lane then takes 0, 1 or 2 bytes (x' < 2^23, x' < 2^15) from the
// reversed body, the row's bytes in ASCENDING lane order.
//
// The TPU kernel looks the slot up through radix one-hot matmuls and
// gathers bytes from a narrow word window with an overflow flag and a wide
// rerun; here the 4096-slot table (symbol, frequency, slot - cum) sits in
// shared memory, a block-wide exclusive scan of the lanes' byte counts gives
// each lane its offset from the row's cursor, and the lane reads its bytes
// straight from the body.  A body too short for a row sets underflow and
// stops the stream before any read past the body's length.
//
// One block of 1024 threads decodes one stream; thread t owns lanes
// G*t ... G*t + G - 1.  As in the encode the row chain is serial (each
// row's cursor needs every earlier row's byte count), so the kernel is
// bound by the latency of one row step, not by bytes or arithmetic.

#include "rans.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(RANS_THREADS)
rans_decode_kernel(const uint8_t* __restrict__ body_rev, const int32_t* __restrict__ blen,
                   const int32_t* __restrict__ states, const int32_t* __restrict__ m_arr,
                   const int32_t* __restrict__ tables, int32_t* __restrict__ syms,
                   uint8_t* __restrict__ underflow, int64_t body_width, int64_t npad) {
    __shared__ uint16_t s_sym[RANS_ALPHABET];
    __shared__ uint16_t s_freq[RANS_ALPHABET];
    __shared__ uint16_t s_rem[RANS_ALPHABET];
    __shared__ int warp_sums[RANS_WARPS];
    const int64_t b = blockIdx.x;
    const int32_t* tab = tables + b * 3 * RANS_ALPHABET;
    for (int i = threadIdx.x; i < RANS_ALPHABET; i += RANS_THREADS) {
        s_sym[i] = static_cast<uint16_t>(tab[i]);
        s_freq[i] = static_cast<uint16_t>(tab[RANS_ALPHABET + i]);
        s_rem[i] = static_cast<uint16_t>(tab[2 * RANS_ALPHABET + i]);
    }
    __syncthreads();

    constexpr int64_t NWAYS = static_cast<int64_t>(G) * RANS_THREADS;
    const int base = G * static_cast<int>(threadIdx.x);
    const int64_t m = m_arr[b];
    const int64_t n_body = blen[b] < body_width ? blen[b] : body_width;
    const uint8_t* in = body_rev + b * body_width;
    int32_t* out = syms + b * npad;
    uint32_t x[G];
#pragma unroll
    for (int k = 0; k < G; ++k) x[k] = static_cast<uint32_t>(states[b * NWAYS + base + k]);

    int64_t cursor = 0;
    for (int64_t row0 = 0; row0 < m; row0 += NWAYS) {
        uint32_t xp[G];
        int take[G];
        int n_bytes = 0;
#pragma unroll
        for (int k = 0; k < G; ++k) {
            const int64_t idx = row0 + base + k;
            take[k] = 0;
            if (idx < m) {
                const uint32_t slot = x[k] & (RANS_ALPHABET - 1);
                out[idx] = s_sym[slot];
                xp[k] = s_freq[slot] * (x[k] >> RANS_PROB_BITS) + s_rem[slot];
                take[k] = (xp[k] < RANS_L) + (xp[k] < (RANS_L >> 8));
                n_bytes += take[k];
            }
        }
        int total;
        int64_t at = cursor + block_exclusive_scan(n_bytes, warp_sums, &total);
        if (cursor + total > n_body) {  // the same for every thread
            if (threadIdx.x == 0) underflow[b] = 1;
            break;
        }
#pragma unroll
        for (int k = 0; k < G; ++k) {
            if (row0 + base + k < m) {
                uint32_t xv = xp[k];
                if (take[k] >= 1) xv = (xv << 8) | in[at++];
                if (take[k] == 2) xv = (xv << 8) | in[at++];
                x[k] = xv;
            }
        }
        cursor += total;
    }
}

}  // namespace

// body_rev (batch, body_width) u8: each stream's body REVERSED, blen[b] of
// its bytes valid; states (batch, 1024 * groups) i32 initial states; m
// (batch,) i32 symbols; tables (batch, 3, 4096) i32: per slot the symbol,
// its frequency and slot - cum -> syms (batch, npad) i32 (the caller zeroes
// it: entries from m on are not written), underflow (batch,) u8 (the caller
// zeroes it).  groups is 1 or 8.  Returns cudaGetLastError().
extern "C" int pr_rans_decode(const void* body_rev, const void* blen, const void* states,
                              const void* m, const void* tables, void* syms, void* underflow,
                              int64_t batch, int64_t body_width, int64_t npad, int groups,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* bo = static_cast<const uint8_t*>(body_rev);
    auto* bl = static_cast<const int32_t*>(blen);
    auto* st = static_cast<const int32_t*>(states);
    auto* mm = static_cast<const int32_t*>(m);
    auto* tb = static_cast<const int32_t*>(tables);
    auto* sy = static_cast<int32_t*>(syms);
    auto* uf = static_cast<uint8_t*>(underflow);
    if (groups == 8) {
        rans_decode_kernel<8><<<static_cast<unsigned>(batch), RANS_THREADS, 0, s>>>(
            bo, bl, st, mm, tb, sy, uf, body_width, npad);
    } else if (groups == 1) {
        rans_decode_kernel<1><<<static_cast<unsigned>(batch), RANS_THREADS, 0, s>>>(
            bo, bl, st, mm, tb, sy, uf, body_width, npad);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
