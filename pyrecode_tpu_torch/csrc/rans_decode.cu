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
// rerun.  Here one block decodes one stream.  The chain of rows is serial
// by the format (each row's byte cursor needs every earlier row's byte
// counts), so the latency and the instruction count of one row step set the
// time, not bytes or arithmetic; the kernel keeps everything the step waits
// on out of device memory and behind one barrier:
//   * the 4096-slot table sits in shared memory as one 64-bit entry a slot
//     (the frequency, and symbol << 16 | slot - cum), one load a lane;
//   * the body comes through a ring in dynamic shared memory, filled with
//     16-byte cp.async copies up to RING bytes ahead of the cursor, one
//     commit group a row; a row waits only for the group committed AHEAD
//     rows before it (which held every byte it can take: a row takes at
//     most 2 * nways bytes).  Copies are 16-byte aligned in device memory,
//     so the chunks that straddle the body's ends take byte loads; nothing
//     is read past min(blen, body_width);
//   * a thread owns LANES consecutive lanes and sums their byte counts in
//     registers; a warp's prefix of those counts comes from one ballot a
//     bit of the count (independent ballots, no chain of shuffles), the
//     warps' totals go through a shared array double-buffered by the row's
//     parity, and after the row's one __syncthreads each warp adds up the
//     totals before it and the block's total by itself (two warp
//     reductions);
//   * every row but the last is full (no per-lane end test), and a lane
//     reads both bytes it may take and keeps what its take says (selects,
//     not branches).
// The row step costs more with more warps (H100, groups 1, a row of 1024
// lanes: 0.56 / 0.49 / 0.72 / 1.39 us at 128 / 256 / 512 / 1024 threads;
// PERF.md), so groups 1 runs 256 threads of 4 lanes and groups 8 512
// threads of 16 lanes (1024 threads of 8 spill at their 64 registers).
// A body too short for a row sets underflow and stops the stream before any
// read past the body's length.  The kernel writes every output: the
// symbols (16-byte stores where a thread's lanes allow), zeros from the
// last decoded row on to npad, and the underflow flag (0 or 1) of each
// stream.

#include <type_traits>

#include "rans.cuh"

namespace {

constexpr int G1_THREADS = 256;   // groups 1: 1024 / G1_THREADS lanes a thread
constexpr int G8_THREADS = 512;   // groups 8: 8192 / G8_THREADS lanes a thread
constexpr int TABLE_BYTES = RANS_ALPHABET * 8;

__device__ __forceinline__ void cp_async16(uint8_t* smem_dst, const uint8_t* gmem_src) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Exclusive prefix of v (0 <= v < 2^BITS) over the calling warp's lanes,
// from one ballot a bit, and the warp's total.
template <int BITS>
__device__ __forceinline__ int warp_prefix_bits(int v, int* total) {
    const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
    int excl = 0;
#pragma unroll
    for (int j = 0; j < BITS; ++j) {
        excl += __popc(__ballot_sync(kFullMask, (v >> j) & 1) & lt) << j;
    }
    *total = static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(v)));
    return excl;
}

template <int THREADS, int LANES, int RING>
__global__ void __launch_bounds__(THREADS)
rans_decode_kernel(const uint8_t* __restrict__ body_rev, const int32_t* __restrict__ blen,
                   const int32_t* __restrict__ states, const int32_t* __restrict__ m_arr,
                   const int32_t* __restrict__ tables, int32_t* __restrict__ syms,
                   uint8_t* __restrict__ underflow, int64_t body_width, int64_t npad) {
    constexpr int NWAYS = THREADS * LANES;
    constexpr int WARPS = THREADS / 32;
    constexpr int MAX_ROW = 2 * NWAYS;                  // bytes a row takes at most
    constexpr int AHEAD = (RING - 16) / MAX_ROW - 1;    // rows between a copy and its use
    constexpr int BITS = LANES == 1 ? 2 : LANES <= 4 ? 4 : LANES <= 8 ? 5 : 6;
    static_assert(AHEAD >= 2, "the ring must hold three rows and a chunk");
    static_assert((2 * LANES) >> BITS == 0, "a thread's byte count fits its bits");
    extern __shared__ __align__(16) uint8_t smem[];
    uint2* s_tab = reinterpret_cast<uint2*>(smem);
    uint8_t* ring = smem + TABLE_BYTES;
    __shared__ int warp_tot[2][WARPS];

    const int64_t b = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int32_t* tab = tables + b * 3 * RANS_ALPHABET;
    for (int i = threadIdx.x; i < RANS_ALPHABET; i += THREADS) {
        s_tab[i] = make_uint2(static_cast<unsigned>(tab[RANS_ALPHABET + i]),
                              static_cast<unsigned>(tab[2 * RANS_ALPHABET + i]) |
                                  (static_cast<unsigned>(tab[i]) << 16));
    }

    // body byte i is virtual byte i + a0 of the 16-byte aligned view `base`;
    // counts and byte positions of a stream fit 32 bits (blen and m are i32)
    const uint32_t m = static_cast<uint32_t>(max(m_arr[b], 0));
    const uint32_t m_out = static_cast<uint32_t>(min(static_cast<int64_t>(m), npad));
    const uint32_t n_body = static_cast<uint32_t>(
        max(min(static_cast<int64_t>(blen[b]), body_width), int64_t{0}));
    const uint8_t* in = body_rev + b * body_width;
    const uint32_t a0 = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(in) & 15u);
    const uint8_t* base = in - a0;
    const uint32_t v_end = n_body + a0;
    const uint32_t v_stop = (v_end + 15u) & ~15u;
    uint32_t issued = 0;   // virtual bytes [0, issued) are requested, block-uniform
    auto issue = [&](uint32_t limit) {   // request up to min(limit, v_stop), a multiple of 16
        const uint32_t stop = min(limit & ~15u, v_stop);
        for (; issued < stop; issued = min(issued + 16u * THREADS, stop)) {
            const uint32_t c0 = issued + 16u * threadIdx.x;
            if (c0 >= stop) continue;
            uint8_t* dst = ring + (c0 & (RING - 1));
            if (c0 >= a0 && c0 + 16u <= v_end) {
                cp_async16(dst, base + c0);
            } else {
                for (uint32_t k = 0; k < 16; ++k) {
                    if (c0 + k >= a0 && c0 + k < v_end) dst[k] = base[c0 + k];
                }
            }
        }
        cp_async_commit();
    };
    issue(a0 + RING);
    cp_async_wait<0>();

    const uint32_t base_lane = LANES * threadIdx.x;
    uint32_t x[LANES];
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
        x[k] = static_cast<uint32_t>(states[b * NWAYS + base_lane + k]);
    }
    int32_t* out = syms + b * npad;
    const bool out16 = (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    const bool full_stores = LANES % 4 == 0 && out16 && m_out == m;   // 16-byte, unguarded
    __syncthreads();

    uint32_t cursor = 0;
    int parity = 0;
    // the row from row0; in a full row every lane holds a symbol.  Returns
    // false, with the row's symbols stored, where the body ran out.
    auto step = [&](uint32_t row0, auto full) -> bool {
        constexpr bool FULL = decltype(full)::value;
        cp_async_wait<AHEAD - 1>();
        uint32_t xp[LANES];
        int take[LANES];
        int32_t sym[LANES];
        int n_bytes = 0;
        const uint32_t idx0 = row0 + base_lane;
#pragma unroll
        for (int k = 0; k < LANES; ++k) {
            const uint2 e = s_tab[x[k] & (RANS_ALPHABET - 1)];
            sym[k] = static_cast<int32_t>(e.y >> 16);
            xp[k] = e.x * (x[k] >> RANS_PROB_BITS) + (e.y & 0xFFFFu);
            take[k] = (xp[k] < RANS_L) + (xp[k] < (RANS_L >> 8));
            if (!FULL && idx0 + k >= m) take[k] = 0;
            n_bytes += take[k];
        }
        if (FULL ? full_stores : LANES % 4 == 0 && out16 && idx0 + LANES <= m_out) {
#pragma unroll
            for (int k = 0; k < LANES; k += 4) {
                *reinterpret_cast<int4*>(out + idx0 + k) =
                    make_int4(sym[k], sym[k + 1], sym[k + 2], sym[k + 3]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < LANES; ++k) {
                if (idx0 + k < m_out) out[idx0 + k] = sym[k];
            }
        }

        int warp_total;
        const int excl_lane = warp_prefix_bits<BITS>(n_bytes, &warp_total);
        if (lane == 0) warp_tot[parity][warp] = warp_total;
        __syncthreads();
        const unsigned v = lane < WARPS ? static_cast<unsigned>(warp_tot[parity][lane]) : 0u;
        const int total = static_cast<int>(__reduce_add_sync(kFullMask, v));
        const int before = static_cast<int>(__reduce_add_sync(kFullMask, lane < warp ? v : 0u));
        parity ^= 1;
        if (total > n_body - cursor) return false;   // the same for every thread
        // every byte below the cursor was read before this row's barrier
        issue(cursor + a0 + RING);
        uint32_t at = cursor + before + excl_lane + a0;
#pragma unroll
        for (int k = 0; k < LANES; ++k) {   // both bytes read, the lane's take kept
            const uint32_t b0 = ring[at & (RING - 1)];
            const uint32_t b1 = ring[(at + 1) & (RING - 1)];
            x[k] = take[k] == 2 ? (xp[k] << 16) | (b0 << 8) | b1
                                : take[k] == 1 ? (xp[k] << 8) | b0 : xp[k];
            at += take[k];
        }
        cursor += total;
        return true;
    };
    uint32_t row0 = 0;
    bool ok = true;
    while (ok && row0 + NWAYS <= m) {
        ok = step(row0, std::true_type{});
        if (ok) row0 += NWAYS;
    }
    if (ok && row0 < m) ok = step(row0, std::false_type{});
    // symbols are stored up to the end of the last row, or of the row that ran out
    const uint32_t written = ok ? m_out : min(row0 + NWAYS, m_out);
    const uint8_t flag = ok ? 0 : 1;
    cp_async_wait<0>();
    block_zero_range(out, written, npad);
    if (threadIdx.x == 0) underflow[b] = flag;
}

template <int THREADS, int LANES, int RING>
int launch_decode(const uint8_t* bo, const int32_t* bl, const int32_t* st, const int32_t* mm,
                  const int32_t* tb, int32_t* sy, uint8_t* uf, int64_t batch,
                  int64_t body_width, int64_t npad, cudaStream_t s) {
    constexpr int smem = TABLE_BYTES + RING;
    auto* kernel = rans_decode_kernel<THREADS, LANES, RING>;
    cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel<<<static_cast<unsigned>(batch), THREADS, smem, s>>>(bo, bl, st, mm, tb, sy, uf,
                                                               body_width, npad);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// body_rev (batch, body_width) u8: each stream's body REVERSED, blen[b] of
// its bytes valid; states (batch, 1024 * groups) i32 initial states; m
// (batch,) i32 symbols; tables (batch, 3, 4096) i32: per slot the symbol,
// its frequency and slot - cum -> syms (batch, npad) i32, zeros from m (or
// from the end of the row that underflowed) on, none stored at or past
// npad, and underflow (batch,) u8 (0 or 1; a bool tensor's bytes).  Every
// output entry is written.  groups is 1 or 8.  Returns cudaGetLastError().
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
    if (batch == 0) return static_cast<int>(cudaGetLastError());
    if (groups == 8) {
        return launch_decode<G8_THREADS, 8 * RANS_THREADS / G8_THREADS, 1 << 17>(
            bo, bl, st, mm, tb, sy, uf, batch, body_width, npad, s);
    }
    if (groups == 1) {
        return launch_decode<G1_THREADS, RANS_THREADS / G1_THREADS, 1 << 14>(
            bo, bl, st, mm, tb, sy, uf, batch, body_width, npad, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
