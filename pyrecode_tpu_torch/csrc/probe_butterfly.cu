// The butterfly left-pack probe: a stable compaction of each row's
// foreground values by an LSB-first log-shift ladder, in the four
// formulations of tools/probe_butterfly.py (replaces its kernel,
// pl.pallas_call at probe_butterfly.py:127).
//
// The TPU question was which formulation Mosaic miscompiled: the packed
// (dist << 16) | value carry with an add merge diverged on v5e at >= 25%
// foreground.  On the card the question is only whether each formulation
// is exact.  Each formulation runs the ladder as the JAX probe writes it:
// dist = lane - rank at foreground lanes, then log2(SUB) stages k = 1, 2,
// 4, ..., each moving the words whose distance has bit k and merging lane
// i with the moved word of lane (i + k) % SUB (pltpu.roll(x, SUB - k,
// axis=1)) by add, or, select, or (two_array) two adds.
//
// What bounds it: a row of SUB words is a few KB, so bytes are nothing;
// the work is a few integer operations a word a stage, and latency.  The
// design: a block a (formulation, row), the row in registers, spread over
// W = SUB / 32E warps of E <= MAX_WORDS words a thread (SUB is a template
// argument, so every loop over a thread's words unrolls).  Warp w, lane t,
// word j holds lane (w*E + j)*32 + t: loads and stores are coalesced, 128
// bytes a warp a word.  The rank is a running count of __ballot_sync over
// the mask within a warp plus the counts of the warps before it.  A stage
// k >= 32 takes word j + k/32 of the same thread, a renaming of registers,
// or a word another warp holds; a stage k < 32 takes word j (or j + 1,
// past the warp's last lane) of lane (t + k) % 32 by one __shfl_sync a
// word.  Only the words that cross to another warp go through shared
// memory, with one __syncthreads a stage; a row of at most 32 * MAX_WORDS
// lanes is one warp, with no barrier and no shared memory.  One warp a row
// at SUB 2048 (64 words a thread) issued the row's ~4k instructions alone,
// spilled, and took 5-7x the time of 16 warps of 4 words (PERF.md).
// One launch runs one formulation or several (butterfly_all: the four).

#include "common.cuh"

namespace {

enum Variant { PACKED_ADD = 0, PACKED_OR = 1, TWO_ARRAY = 2, SELECT_MERGE = 3 };
constexpr int N_VARIANTS = 4;
constexpr int MAX_WORDS = 4;   // words a thread holds at most

// A row of SUB lanes: W warps, each holding E words a thread; warp w,
// lane t, word j is lane (w*E + j)*32 + t of the row.
template <int SUB>
struct RowShape {
    static constexpr int E = SUB / 32 < MAX_WORDS ? SUB / 32 : MAX_WORDS;
    static constexpr int W = SUB / (32 * E);
};

// x[j] <- the word of lane (i + K) % SUB: pltpu.roll(x, SUB - K), in two
// steps with a barrier between them.  publish writes the words of this
// warp that another warp takes into xbuf ([W][E][32], this stage's half
// of the exchange buffer); take reads them from there and the rest from
// the thread's own registers (for K < 32, x was shuffled first: x[j] is
// word j of lane (t + K) % 32).
template <int E, int W, int K>
__device__ __forceinline__ void publish(const uint32_t (&x)[E], uint32_t* xbuf, int w, int t) {
    constexpr int L = 32 * E;
    constexpr int N = K < 32 ? 1 : (K < L ? K / 32 : E);   // words the other warp takes
#pragma unroll
    for (int q = 0; q < N; ++q) xbuf[(w * E + q) * 32 + t] = x[q];
}

template <int E, int W, int K>
__device__ __forceinline__ void take(uint32_t (&x)[E], const uint32_t* xbuf, int w, int t) {
    constexpr int L = 32 * E;
    uint32_t y[E];
    const int next = (w + 1) % W;
    if constexpr (K < 32) {
        const bool same_j = t + K < 32;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            uint32_t after;
            if (j + 1 < E) {
                after = x[j + 1];
            } else if constexpr (W > 1) {
                after = xbuf[next * E * 32 + t];
            } else {
                after = x[0];
            }
            y[j] = same_j ? x[j] : after;
        }
    } else if constexpr (K < L) {
        constexpr int D = K / 32;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            if (j + D < E) {
                y[j] = x[j + D];
            } else if constexpr (W > 1) {
                y[j] = xbuf[(next * E + j + D - E) * 32 + t];
            } else {
                y[j] = x[j + D - E];
            }
        }
    } else {
        const int from = (w + K / L) % W;
#pragma unroll
        for (int j = 0; j < E; ++j) y[j] = xbuf[(from * E + j) * 32 + t];
    }
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = y[j];
}

// One stage of the ladder on a thread's E words.  Arithmetic is modulo
// 2**32, as the int32 twin's; the packed formulations read the distance
// from the high half of the carry.  xbuf: this stage's exchange buffer,
// [2][W][E][32] (values, distances).
template <int V, int E, int W, int K>
__device__ __forceinline__ void stage(uint32_t (&carry)[E], uint32_t (&dist)[E], uint32_t* xbuf,
                                      int w, int t) {
    uint32_t moved[E], dmoved[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        if constexpr (V == TWO_ARRAY) {
            const bool mv = (dist[j] & K) != 0;
            moved[j] = mv ? carry[j] : 0u;
            dmoved[j] = mv ? dist[j] - K : 0u;
            carry[j] = mv ? 0u : carry[j];
            dist[j] = mv ? 0u : dist[j];
        } else {
            const bool mv = ((carry[j] >> 16) & K) != 0;
            moved[j] = mv ? carry[j] - (static_cast<uint32_t>(K) << 16) : 0u;
            carry[j] = mv ? 0u : carry[j];
        }
    }
    if constexpr (K < 32) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
            moved[j] = __shfl_sync(kFullMask, moved[j], t + K);   // lane mod 32
            if constexpr (V == TWO_ARRAY) dmoved[j] = __shfl_sync(kFullMask, dmoved[j], t + K);
        }
    }
    if constexpr (W > 1) {
        publish<E, W, K>(moved, xbuf, w, t);
        if constexpr (V == TWO_ARRAY) publish<E, W, K>(dmoved, xbuf + W * E * 32, w, t);
        __syncthreads();
    }
    take<E, W, K>(moved, xbuf, w, t);
    if constexpr (V == TWO_ARRAY) take<E, W, K>(dmoved, xbuf + W * E * 32, w, t);
#pragma unroll
    for (int j = 0; j < E; ++j) {
        if constexpr (V == PACKED_ADD) {
            carry[j] += moved[j];
        } else if constexpr (V == PACKED_OR) {
            carry[j] |= moved[j];
        } else if constexpr (V == SELECT_MERGE) {
            carry[j] = moved[j] != 0u ? moved[j] : carry[j];
        } else {
            carry[j] += moved[j];
            dist[j] += dmoved[j];
        }
    }
}

// Stages K, 2K, ... below SUB; consecutive stages use the two halves of
// the exchange buffer in turn, so one barrier a stage is enough.
template <int V, int E, int W, int K>
__device__ __forceinline__ void ladder(uint32_t (&carry)[E], uint32_t (&dist)[E], uint32_t* xbuf,
                                       int w, int t, int half) {
    if constexpr (K < 32 * E * W) {
        stage<V, E, W, K>(carry, dist, xbuf + half * 2 * W * E * 32, w, t);
        ladder<V, E, W, 2 * K>(carry, dist, xbuf, w, t, half ^ 1);
    }
}

// One row of SUB lanes by formulation V, on the calling block.
template <int V, int SUB>
__device__ __forceinline__ void pack_row(const int32_t* __restrict__ m,
                                         const int32_t* __restrict__ v, int32_t* __restrict__ o,
                                         uint32_t* xbuf, int* counts) {
    constexpr int E = RowShape<SUB>::E, W = RowShape<SUB>::W;
    const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int base = w * E * 32 + t;
    uint32_t carry[E], dist[E];
    bool fg[E];
    const unsigned below = (1u << t) - 1u;
    int before = 0;   // foreground lanes of this warp before this j's 32
#pragma unroll
    for (int j = 0; j < E; ++j) {
        fg[j] = m[base + 32 * j] > 0;
        const unsigned ballot = __ballot_sync(kFullMask, fg[j]);
        dist[j] = static_cast<uint32_t>(base + 32 * j - before - __popc(ballot & below));
        before += __popc(ballot);
        carry[j] = static_cast<uint32_t>(v[base + 32 * j]);
    }
    if constexpr (W > 1) {   // the foreground lanes of the warps before this one
        if (t == 0) counts[w] = before;
        __syncthreads();
        before = 0;
        for (int u = 0; u < w; ++u) before += counts[u];
    } else {
        before = 0;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const uint32_t d = fg[j] ? dist[j] - before : 0u;
        if constexpr (V == TWO_ARRAY) {
            carry[j] = fg[j] ? carry[j] : 0u;
            dist[j] = d;
        } else {
            carry[j] = fg[j] ? (d << 16) | (carry[j] & 0xFFFFu) : 0u;
        }
    }
    ladder<V, E, W, 1>(carry, dist, xbuf, w, t, 0);
#pragma unroll
    for (int j = 0; j < E; ++j) o[base + 32 * j] = static_cast<int32_t>(carry[j] & 0xFFFFu);
}

// Block b packs row b % rows by formulation first + b / rows into out[b]
// (out is (count, rows, SUB)); a block is the row's W warps.
template <int SUB>
__global__ void __launch_bounds__(32 * RowShape<SUB>::W)
butterfly_kernel(const int32_t* __restrict__ mask, const int32_t* __restrict__ vals,
                 int32_t* __restrict__ out, int64_t rows, int first) {
    constexpr int W = RowShape<SUB>::W;
    __shared__ uint32_t xbuf[W > 1 ? 4 * SUB : 1];   // 2 stages x (values, distances)
    __shared__ int counts[W];
    const int64_t b = blockIdx.x;
    const int64_t row = b % rows;
    const int32_t* m = mask + row * SUB;
    const int32_t* v = vals + row * SUB;
    int32_t* o = out + b * SUB;
    switch (first + static_cast<int>(b / rows)) {
        case PACKED_ADD: pack_row<PACKED_ADD, SUB>(m, v, o, xbuf, counts); break;
        case PACKED_OR: pack_row<PACKED_OR, SUB>(m, v, o, xbuf, counts); break;
        case TWO_ARRAY: pack_row<TWO_ARRAY, SUB>(m, v, o, xbuf, counts); break;
        default: pack_row<SELECT_MERGE, SUB>(m, v, o, xbuf, counts); break;
    }
}

template <int SUB>
void launch_butterfly(const void* mask, const void* vals, void* out, int64_t rows, int first,
                      int count, cudaStream_t s) {
    butterfly_kernel<SUB><<<static_cast<unsigned>(rows * count), 32 * RowShape<SUB>::W, 0, s>>>(
        static_cast<const int32_t*>(mask), static_cast<const int32_t*>(vals),
        static_cast<int32_t*>(out), rows, first);
}

}  // namespace

// mask, vals (rows, sub) i32 -> out (count, rows, sub) i32: for each
// formulation first .. first + count - 1 (0 packed_add, 1 packed_or, 2
// two_array, 3 select_merge), each row's values at foreground lanes
// (mask > 0) packed to the row's front in lane order, zeros behind, each
// & 0xFFFF.  rows >= 1; sub a power of two in 32..2048; values below 2**16.
// Returns cudaGetLastError().
extern "C" int pr_probe_butterfly(const void* mask, const void* vals, void* out, int first,
                                  int count, int64_t rows, int64_t sub, void* stream) {
    if (first < 0 || count < 1 || first + count > N_VARIANTS || rows < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (sub) {
        case 32: launch_butterfly<32>(mask, vals, out, rows, first, count, s); break;
        case 64: launch_butterfly<64>(mask, vals, out, rows, first, count, s); break;
        case 128: launch_butterfly<128>(mask, vals, out, rows, first, count, s); break;
        case 256: launch_butterfly<256>(mask, vals, out, rows, first, count, s); break;
        case 512: launch_butterfly<512>(mask, vals, out, rows, first, count, s); break;
        case 1024: launch_butterfly<1024>(mask, vals, out, rows, first, count, s); break;
        case 2048: launch_butterfly<2048>(mask, vals, out, rows, first, count, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
