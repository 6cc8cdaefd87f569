// Bitmap -> ascending set-bit positions: the front half of the scheme-12
// gap coder (codecs/rans.py:rans_gaps_batch_device) where no encode kernel
// gave the positions (L2 statistics, L3 and L4 bitmaps).
//
// Replaces pyrecode_tpu/ops/pallas_gaps.py:bitmap_positions_pallas (kernel
// built by _build_positions_kernel) with one capacity, out_size.  The TPU
// kernel spreads 8 KB chunks of bytes to a 0/1 mask with an MXU expansion
// matmul, compacts chunk-relative positions with the shared rank-match
// selection (at most C1 set bits per 512-bit sub-row, a VMEM bound escalated
// through CAPACITY_BUCKETS) and appends them through a 128-aligned window.
//
// The work is bound by device-memory bytes, and at the writer's capacity
// (two positions a bitmap byte) almost all of them are the zeros past the
// count: a 2 MiB bitmap at 1% has ~170k positions in a row of 4M.  So the
// bitmap is read once and every output word written once:
//   1. (the caller's memset) the status words and the ticket are zeroed;
//   2. pos_tile_kernel: blocks take tiles of TILE_BYTES in the order of a
//      ticket counter; each thread loads its 32 bytes with 16-byte loads
//      (byte loads where the row is not 16-byte aligned or ends) and
//      popcounts them, a block scan gives each thread its rank in the tile,
//      the threads stage their set bits' indices in shared memory while
//      warp 0 publishes the tile's count and finds its offset by a
//      decoupled look-back (lookback.cuh), and the staged positions go out
//      with contiguous stores (STAGE at a time: a denser tile takes several
//      rounds); none at or past out_size;
//   3. pos_tail_kernel: from the last tile's inclusive status word, each
//      stream's count (clipped to out_size) and overflow (set bits >
//      out_size), and the zeros of [count, out_size) with 16-byte stores,
//      written once.
// Any n_bytes and any out_size, including 0, work; no sub-row limit exists.

#include "lookback.cuh"

namespace {

constexpr int TILE_BYTES = BLOCK * 32;        // a thread's 32 bytes: two 16-byte loads
constexpr int STAGE = 4096;                   // positions staged a round
constexpr int ZERO_CHUNK = BLOCK * 16 * 8;    // int32 entries a tail block owns

__global__ void __launch_bounds__(BLOCK)
pos_tile_kernel(const uint8_t* __restrict__ bitmaps, int32_t* __restrict__ pos,
                unsigned long long* __restrict__ status, int64_t n_bytes, int n_tiles, int batch,
                int64_t out_size) {
    __shared__ int ticket_s;
    __shared__ int warp_tot[WARPS];
    __shared__ long long offset_s;
    __shared__ int32_t staged[STAGE];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) {
        ticket_s = static_cast<int>(
            atomicAdd(&status[static_cast<int64_t>(batch) * n_tiles], 1ull));
    }
    __syncthreads();
    const int b = ticket_s / n_tiles;
    const int t = ticket_s % n_tiles;
    const uint8_t* row = bitmaps + static_cast<int64_t>(b) * n_bytes;
    const int64_t p0 = static_cast<int64_t>(t) * TILE_BYTES + 32 * tid;

    uint32_t w[8];
    if ((reinterpret_cast<uintptr_t>(row) & 15u) == 0 && p0 + 32 <= n_bytes) {
        const uint4 lo = *reinterpret_cast<const uint4*>(row + p0);
        const uint4 hi = *reinterpret_cast<const uint4*>(row + p0 + 16);
        w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
        w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            uint32_t v = 0u;
            for (int q = 0; q < 4; ++q) {
                const int64_t i = p0 + 4 * k + q;
                if (i < n_bytes) v |= static_cast<uint32_t>(row[i]) << (8 * q);
            }
            w[k] = v;
        }
    }
    int c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) c += __popc(w[k]);

    const int incl = warp_inclusive_scan(c);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = 0, tile_total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        const int v = warp_tot[i];
        before += i < warp ? v : 0;
        tile_total += v;
    }
    const int rank0 = before + incl - c;   // the thread's first set bit's rank in the tile

    int32_t* out = pos + static_cast<int64_t>(b) * out_size;
    const int32_t bit0 = static_cast<int32_t>(p0 * 8);
    int r0 = 0;
    do {
        if (rank0 < r0 + STAGE && rank0 + c > r0) {
            int rank = rank0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                uint32_t v = w[k];
                while (v) {
                    if (rank >= r0 && rank < r0 + STAGE) staged[rank - r0] = bit0 + 32 * k + __ffs(v) - 1;
                    v &= v - 1u;
                    ++rank;
                }
            }
        }
        if (r0 == 0 && warp == 0) {
            const long long excl = look_back(status + static_cast<int64_t>(b) * n_tiles, t,
                                              tile_total);
            if (lane == 0) offset_s = excl;
        }
        __syncthreads();
        const long long first = offset_s + r0;
        const int n = min(STAGE, tile_total - r0);
        for (int i = tid; i < n && first + i < out_size; i += BLOCK) out[first + i] = staged[i];
        __syncthreads();
        r0 += STAGE;
    } while (r0 < tile_total);
}

__global__ void pos_tail_kernel(int32_t* __restrict__ pos, int32_t* __restrict__ counts,
                                uint8_t* __restrict__ overflow,
                                const unsigned long long* __restrict__ status, int n_tiles,
                                int64_t out_size) {
    const int64_t b = blockIdx.y;
    const long long total = static_cast<long long>(
        status[b * n_tiles + n_tiles - 1] & 0xFFFFFFFFull);
    const int64_t count = total < out_size ? total : out_size;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        counts[b] = static_cast<int32_t>(count);
        overflow[b] = total > out_size ? 1 : 0;
    }
    const int64_t lo = static_cast<int64_t>(blockIdx.x) * ZERO_CHUNK;
    const int64_t hi = lo + ZERO_CHUNK < out_size ? lo + ZERO_CHUNK : out_size;
    block_zero_range(pos + b * out_size, lo > count ? lo : count, hi);
}

}  // namespace

__host__ __device__ inline int64_t positions_tiles(int64_t n_bytes) {
    return (n_bytes + TILE_BYTES - 1) / TILE_BYTES;
}

// Status words of one call: a word a tile of each stream, then the ticket.
extern "C" int64_t pr_positions_status_words(int64_t batch, int64_t n_bytes) {
    return batch * positions_tiles(n_bytes) + 1;
}

// bitmaps (batch, n_bytes) u8 -> pos (batch, out_size) i32 ascending set-bit
// indices (bit k of byte j is index 8j + k), zeros from the count on; counts
// (batch,) i32 clipped to out_size; overflow (batch,) u8 = set bits >
// out_size.  status: pr_positions_status_words(batch, n_bytes) u64 scratch,
// zeroed here.  Returns cudaGetLastError().
extern "C" int pr_bitmap_positions(const void* bitmaps, void* pos, void* counts, void* overflow,
                                   void* status, int64_t batch, int64_t n_bytes,
                                   int64_t out_size, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t n_tiles = positions_tiles(n_bytes);
    auto* st = static_cast<unsigned long long*>(status);
    const int64_t words = batch * n_tiles + 1;
    cudaError_t rc = cudaMemsetAsync(st, 0, static_cast<size_t>(words) * sizeof(*st), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    pos_tile_kernel<<<static_cast<unsigned>(batch * n_tiles), BLOCK, 0, s>>>(
        static_cast<const uint8_t*>(bitmaps), static_cast<int32_t*>(pos), st, n_bytes,
        static_cast<int>(n_tiles), static_cast<int>(batch), out_size);
    const dim3 tail(static_cast<unsigned>(out_size > 0 ? (out_size + ZERO_CHUNK - 1) / ZERO_CHUNK
                                                       : 1),
                    static_cast<unsigned>(batch));
    pos_tail_kernel<<<tail, BLOCK, 0, s>>>(static_cast<int32_t*>(pos),
                                           static_cast<int32_t*>(counts),
                                           static_cast<uint8_t*>(overflow), st,
                                           static_cast<int>(n_tiles), out_size);
    return static_cast<int>(cudaGetLastError());
}
