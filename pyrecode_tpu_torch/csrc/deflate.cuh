// What the deflate tokenize and assemble kernels share: the tile each block
// walks, the token encoding and the assemblers' token loads, and block-wide
// reductions and scans over one value per thread for blocks of BLOCK
// threads (common.cuh).  Each reduction or scan takes WARPS elements of the
// caller's shared memory as
// scratch and may be called again with the same scratch: it synchronises
// the block before it returns.  The two tokenizers (tokenize.cu,
// tokens_from_pairs.cu) also share the histogram row, the length symbols
// and the adler32 of a stream from its blocks' sums.
#pragma once

#include "common.cuh"

namespace {

// Stream bytes (tokenize) or tokens (assemble) per block; each thread owns
// TILE_PER_THREAD consecutive ones.
constexpr int TILE = 4096;
constexpr int TILE_PER_THREAD = TILE / BLOCK;
// Token LUT index: 0..255 a literal, 256..511 a distance-1 match of take
// 3..258; tokens travel inverted, NO_TOKEN - index, so that 0 is no token.
constexpr int NO_TOKEN = 512;

static_assert(TILE % BLOCK == 0, "a thread owns whole elements of its tile");

__host__ __device__ inline int64_t deflate_tiles(int64_t n) { return (n + TILE - 1) / TILE; }

// LUT index of an inverted token, -1 for no token.
template <class Tok>
__device__ __forceinline__ int token_index(Tok v) {
    const int inv = static_cast<int>(v);
    return (inv >= 1 && inv <= NO_TOKEN) ? NO_TOKEN - inv : -1;
}

// The TILE_PER_THREAD tokens of one thread from p0 on as ints (0 past
// ncols): 16-byte loads from the 16-byte boundary at or before the first
// token, shifted into place, where the row holds all of them (the bytes
// read past them lie in the granule of the last one); else one at a time.
template <class Tok>
__device__ __forceinline__ void load_tokens(const Tok* __restrict__ row, int64_t ncols,
                                            int64_t p0, int (&inv)[TILE_PER_THREAD]) {
    constexpr int V = static_cast<int>(sizeof(Tok));   // 16-byte vectors of a thread's tokens
    const Tok* p = row + p0;
    if (p0 + TILE_PER_THREAD <= ncols) {
        const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
        const uint4* a = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(p) - off);
        uint32_t w[4 * (V + 1)];
#pragma unroll
        for (int v = 0; v <= V; ++v) {
            const uint4 q = v < V || off ? a[v] : make_uint4(0u, 0u, 0u, 0u);
            w[4 * v] = q.x;
            w[4 * v + 1] = q.y;
            w[4 * v + 2] = q.z;
            w[4 * v + 3] = q.w;
        }
        const int qw = off >> 2;
        const int rb = (off & 3) * 8;
        uint32_t x[4 * V];
#pragma unroll
        for (int j = 0; j < 4 * V; ++j) {
            const uint32_t lo = qw == 0 ? w[j] : qw == 1 ? w[j + 1] : qw == 2 ? w[j + 2] : w[j + 3];
            const uint32_t hi = qw == 0 ? w[j + 1] : qw == 1 ? w[j + 2] : qw == 2 ? w[j + 3] : w[j + 4];
            x[j] = __funnelshift_r(lo, hi, rb);
        }
#pragma unroll
        for (int k = 0; k < TILE_PER_THREAD; ++k) {
            inv[k] = sizeof(Tok) == 2 ? static_cast<int>((x[k / 2] >> (16 * (k % 2))) & 0xFFFFu)
                                      : static_cast<int>(x[k]);
        }
    } else {
#pragma unroll
        for (int k = 0; k < TILE_PER_THREAD; ++k) {
            inv[k] = p0 + k < ncols ? static_cast<int>(p[k]) : 0;
        }
    }
}

struct SumOp {
    template <class T>
    __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

// op over every thread's v, returned to every thread.
template <class T, class Op>
__device__ T block_all_reduce(T v, Op op, T* scratch) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    T r = scratch[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r = op(r, scratch[w]);
    __syncthreads();
    return r;
}

// Exclusive scan: thread t gets op over the v of threads < t (kForward) or
// of threads > t (!kForward); identity where there are none.
template <bool kForward, class T, class Op>
__device__ T block_exclusive_scan(T v, Op op, T identity, T* scratch) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T y = kForward ? __shfl_up_sync(kFullMask, x, d) : __shfl_down_sync(kFullMask, x, d);
        if (kForward ? lane >= d : lane + d < 32) x = op(x, y);
    }
    if (lane == (kForward ? 31 : 0)) scratch[warp] = x;
    __syncthreads();
    T excl = kForward ? __shfl_up_sync(kFullMask, x, 1) : __shfl_down_sync(kFullMask, x, 1);
    if (lane == (kForward ? 0 : 31)) excl = identity;
    T across = identity;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (kForward ? w < warp : w > warp) across = op(across, scratch[w]);
    }
    __syncthreads();
    return op(across, excl);
}

// Tokenizer histogram row: symbol s in slot s ((s >> 5, s & 31) row-major);
// 0..285 the literal/length symbols, end of block not counted.
constexpr int HIST_BINS = 512;
constexpr int SYM_TAKE258 = 285;   // length symbol of a take-258 match

// Length symbol (257..285) of a distance-1 match of take 3..258, in closed
// form: codes 0..7 take one length each, then four codes a power of two.
__device__ __forceinline__ int length_symbol(int take) {
    if (take == 258) return SYM_TAKE258;
    const int l = take - 3;
    if (l < 8) return 257 + l;
    const int e = 29 - __clz(l);   // floor(log2 l) - 2
    return 257 + 4 * e + (l >> e);
}

// One shared-memory atomic a warp for a count every lane holds.
__device__ __forceinline__ void warp_add(int* bin, int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(bin, v);
}

// Adds a block's shared histogram to its stream's row, nonzero bins only.
// Call after a barrier that follows the block's last shared atomic.
__device__ __forceinline__ void flush_hist(const int* hist_s, int* hist_row) {
    for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) {
        if (hist_s[k]) atomicAdd(&hist_row[k], hist_s[k]);
    }
}

// adler32 of an n-byte stream x from its tiles' partial sums: each tile
// stores S1 = sum x_i and SN = sum (n - i) x_i over its bytes, mod 65521,
// as int32 at part[2 * tile] and part[2 * tile + 1]; then one block of the
// next pass adds them: adler32 = B << 16 | A, A = 1 + S1, B = n + SN
// (mod 65521).
constexpr long long ADLER_MOD = 65521;

__device__ __forceinline__ int adler_mod(long long v) {
    return static_cast<int>((v % ADLER_MOD + ADLER_MOD) % ADLER_MOD);
}

// The whole block adds a stream's n_tiles partial pairs; thread 0 writes
// its adler32.  scratch: WARPS elements of the caller's shared memory.
__device__ __forceinline__ void adler_from_parts(const int* part, int n_tiles, int64_t n,
                                                 long long* scratch, long long* adler) {
    long long a = 0, c = 0;
    for (int j = threadIdx.x; j < n_tiles; j += BLOCK) {
        a += part[2 * j];
        c += part[2 * j + 1];
    }
    a = block_all_reduce(a, SumOp(), scratch);
    c = block_all_reduce(c, SumOp(), scratch);
    if (threadIdx.x == 0) {
        *adler = (static_cast<long long>((n % ADLER_MOD + c) % ADLER_MOD) << 16) |
                 ((1 + a) % ADLER_MOD);
    }
}

}  // namespace
