// Deflate tokenizer: the per-byte tokens of the dynamic-Huffman encoder, the
// 286-symbol literal/length histogram and adler32, for a batch of streams.
//
// Replaces pyrecode_tpu/ops/pallas_deflate.py:tokenize_pallas and
// tokenize_compact_pallas (kernel built by _build_tokenize_kernel).  The
// rules are those of pyrecode_tpu/codecs/dyndeflate.py:tokenize_bytes_np:
// byte i of a run [s, e) of equal bytes, with p = i - s and
// d = min(e - i, 522), is
//   * a literal when p == 0 or e - s < 4;
//   * a distance-1 match of take 258 / 255 / d when (p - 1) % 258 == 0 and
//     d >= 261 / d in {259, 260} / 3 <= d <= 258;
//   * a match of take d when (p - 1) % 258 == 255 and d in {4, 5};
//   * covered by a match otherwise.
// Bytes at or past the stream's length end every run and are no token.
//
// The TPU kernel walks a stream in order, carries the run start in SMEM from
// one grid step to the next, takes run ends from a one-tile halo and
// histograms through a one-hot matmul.  Blocks on the GPU run in no order,
// and one run may span the whole stream.  A block of BLOCK threads takes a
// TILE of 4096 bytes, each thread 16 consecutive bytes by one 16-byte load
// (the byte before them from the lane before, by a shuffle), whose run
// starts and ends come out as 16-bit masks from 32-bit word operations:
//   1. tok_carry_kernel: the last run start in each tile, and the tile's
//      adler32 sums (dp4a), two tiles a block; the first block of each
//      stream zeroes its histogram row, and in the compact form each block
//      its tiles' status words.
//   2. tok_decide_kernel: the run start carried into a tile is the last run
//      start of the nearest earlier tile that has one, found by warp 0 alone
//      (32 tiles and a ballot a round, no barrier; a run may span any number
//      of tiles).  Run starts and ends beyond a thread's bytes come from warp
//      scans and one exchange across the warps, and past the tile from a
//      512-byte halo that one warp reads with 16-byte loads: an end more
//      than 260 bytes past a byte changes none of its tokens (every d >= 261
//      takes 258).  The integer work is the limit, so a thread does not
//      decide byte by byte: its tokens are its run starts, the bytes of
//      runs shorter than 4, the byte after the start of a longer run, and in
//      the run carried into its bytes at most the two bytes where
//      (p - 1) % 258 is 0 or 255; the thread builds that mask with bit
//      operations and one modulo.  Its literals come out for all 16 bytes
//      at once (byte permutes into 16-bit halves); only the matches, and
//      the nonzero literals for the histogram, are visited one by one.
//      Histogram: shared atomics, with the covered bytes, literal 0 and
//      take-258 matches counted in registers and added once a warp, then
//      one global atomic a nonzero bin and block.  The first block of each
//      stream adds the tiles' adler32 sums.
//      Dense form: each thread stores its 16 tokens as two 16-byte stores.
//      Compact form: blocks take tiles in the order of a ticket counter, so
//      that a tile only waits on tiles whose blocks already run.  A tile
//      publishes its token count, then warp 0 looks back over the earlier
//      tiles' status words, 128 a round (decoupled look-back), for the
//      tile's offset while the block stages its tokens in shared memory;
//      they go out with coalesced stores.  The last tile of a stream writes
//      its count.
//   3. tok_zero_tail_kernel (compact form): the zeros after each stream's
//      count, written once.
// Rows that are not 16-byte aligned (npad % 16 != 0) and the ends of rows
// take byte loads and element stores.  Any npad, length and out_bound work.
//
// The work is bound by device-memory bytes: the stream is read twice, the
// dense form writes 2 bytes a stream byte, the compact form 4 a token.
// Counts are integer-exact; nothing goes through a matmul.

#include <climits>

#include "deflate.cuh"
#include "lookback.cuh"

namespace {

constexpr int MAX_D = 522;                 // run-end lookahead of the rules above
constexpr int HALO = 32 * 16;              // bytes past a tile, one 16-byte load a lane
constexpr int SYM_NONE = 287;              // histogram slot of covered and pad bytes
constexpr int INF = 0x7fffffff;
constexpr int ZERO_CHUNK = BLOCK * 16;     // comp entries a tok_zero_tail_kernel block owns
constexpr int CARRY_TILES = 2;             // tiles a tok_carry_kernel block takes
constexpr int DECIDE_BLOCKS_PER_SM = 8;    // blocks an SM: the decide pass hides its latencies
constexpr int WARP_TOKENS = TILE / WARPS;  // tokens of a warp's bytes, at most

static_assert(TILE_PER_THREAD == 16, "a thread's bytes are one 16-byte load");
static_assert(HALO >= 260, "the halo holds every run end that can change a token");

__device__ __forceinline__ int stream_length(const int* lengths, int b, int64_t npad) {
    const int64_t n = lengths[b];
    return static_cast<int>(n < 0 ? 0 : (n > npad ? npad : n));
}

// Bytes [p, p + 16) of a row of npad bytes; bytes at or past npad read as 0.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int p, int64_t npad) {
    if (p + 16 <= npad && (reinterpret_cast<uintptr_t>(row + p) & 15u) == 0u) {
        return __ldg(reinterpret_cast<const uint4*>(row + p));
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        if (p + k < npad) w[k >> 2] |= static_cast<uint32_t>(row[p + k]) << (8 * (k & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte k (0..15, not known at compile time) of v.
__device__ __forceinline__ int byte_at(const uint4& v, int k) {
    const uint32_t lo = (k & 4) ? v.y : v.x;
    const uint32_t hi = (k & 4) ? v.w : v.z;
    return static_cast<int>((((k & 8) ? hi : lo) >> (8 * (k & 3))) & 255u);
}

// The byte before the thread's 16 at p0: the lane before's last one, or one
// load for lane 0.  Every lane of the warp calls it.
__device__ __forceinline__ uint32_t byte_before(const uint4& v, const uint8_t* row, int p0,
                                                int64_t npad) {
    const uint32_t up = __shfl_up_sync(kFullMask, v.w >> 24, 1);
    if ((threadIdx.x & 31) != 0) return up;
    return (p0 > 0 && p0 - 1 < npad) ? row[p0 - 1] : 0u;
}

// Bit k (0..3) set where byte k of w differs from the byte before it (the
// low byte of prev before byte 0).
__device__ __forceinline__ unsigned changed4(uint32_t w, uint32_t prev) {
    const uint32_t x = w ^ ((w << 8) | prev);
    const uint32_t nz = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
    return ((nz >> 7) * 0x10204080u) >> 28;   // the four high bits, gathered
}

// Word j (0..7) of a thread's tokens: the inverted literals of bytes 2j and
// 2j + 1 (in w, the bytes' 32-bit word) where lits has their bits, else 0.
__device__ __forceinline__ uint32_t literal_word(uint32_t w, unsigned lits, int j) {
    const uint32_t pair = __byte_perm(w, 0u, (j & 1) ? 0x4342u : 0x4140u);   // 16 bits a byte
    const uint32_t keep = (((lits >> (2 * j)) & 1u) ? 0x0000FFFFu : 0u) |
                          (((lits >> (2 * j + 1)) & 1u) ? 0xFFFF0000u : 0u);
    return ((static_cast<uint32_t>(NO_TOKEN) << 16 | NO_TOKEN) - pair) & keep;
}

// Token k (0..15, known at compile time) of the words lo, hi.
__device__ __forceinline__ int32_t token_of(const uint4& lo, const uint4& hi, int k) {
    const uint4& q = k < 8 ? lo : hi;
    const uint32_t w = (k & 6) == 0 ? q.x : ((k & 6) == 2 ? q.y : ((k & 6) == 4 ? q.z : q.w));
    return static_cast<int32_t>((w >> (16 * (k & 1))) & 0xFFFFu);
}

// Bit k set where byte k of v is 0.
__device__ __forceinline__ unsigned zero_bytes(const uint4& v) {
    unsigned z = 0u;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t hi = ~((((w[j] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w[j]) | 0x7F7F7F7Fu);
        z |= (((hi >> 7) * 0x10204080u) >> 28) << (4 * j);
    }
    return z;
}

// Bit k of starts: byte p0 + k (< n) starts a run; of ends: it ends the run
// before it (it starts a run, or lies at or past n).
struct Runs {
    unsigned starts;
    unsigned ends;
};

__device__ __forceinline__ Runs runs_of(const uint4& v, uint32_t prev, int p0, int n) {
    const unsigned changed = changed4(v.x, prev) | (changed4(v.y, v.x >> 24) << 4) |
                             (changed4(v.z, v.y >> 24) << 8) | (changed4(v.w, v.z >> 24) << 12) |
                             (p0 == 0 ? 1u : 0u);
    const int valid = min(max(n - p0, 0), 16);
    const unsigned live = (1u << valid) - 1u;
    return {changed & live, (changed | ~live) & 0xFFFFu};
}

// The bytes of w at or past byte `valid` (relative to w's first), zeroed.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int valid) {
    return valid >= 4 ? w : (valid <= 0 ? 0u : w & ((1u << (8 * valid)) - 1u));
}

// Two tiles a block (CARRY_TILES), their loads in flight together.
__global__ void __launch_bounds__(BLOCK)
tok_carry_kernel(const uint8_t* __restrict__ streams, const int* __restrict__ lengths,
                 int* __restrict__ last, int* __restrict__ part, int* __restrict__ hist,
                 unsigned long long* __restrict__ status, int64_t npad, int n_tiles) {
    __shared__ int warp_best[CARRY_TILES][WARPS];
    __shared__ long long ws1[CARRY_TILES][WARPS], wsn[CARRY_TILES][WARPS];
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * CARRY_TILES;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (blockIdx.x == 0) {
        for (int k = threadIdx.x; k < HIST_BINS; k += BLOCK) hist[b * HIST_BINS + k] = 0;
    }
    if (status != nullptr && threadIdx.x < CARRY_TILES && t0 + threadIdx.x < n_tiles) {
        const int64_t tile = static_cast<int64_t>(b) * n_tiles + t0 + threadIdx.x;
        status[tile] = 0ull;
        if (tile == 0) status[static_cast<int64_t>(gridDim.y) * n_tiles] = 0ull;   // the ticket
    }
    const int n = stream_length(lengths, b, npad);
    const uint8_t* row = streams + static_cast<int64_t>(b) * npad;
    uint4 v[CARRY_TILES];
#pragma unroll
    for (int q = 0; q < CARRY_TILES; ++q) {
        const int p0 = (t0 + q) * TILE + threadIdx.x * 16;
        v[q] = (t0 + q) * TILE < n ? load16(row, p0, npad) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < CARRY_TILES; ++q) {
        const int start = (t0 + q) * TILE;
        const int p0 = start + threadIdx.x * 16;
        int best = -1;
        long long s1 = 0, sn = 0;
        if (start < n) {   // block-uniform
            const Runs r = runs_of(v[q], byte_before(v[q], row, p0, npad), p0, n);
            if (r.starts) best = p0 + 31 - __clz(r.starts);
            const int valid = min(max(n - p0, 0), 16);
            const uint32_t w0 = keep_bytes(v[q].x, valid), w1 = keep_bytes(v[q].y, valid - 4);
            const uint32_t w2 = keep_bytes(v[q].z, valid - 8), w3 = keep_bytes(v[q].w, valid - 12);
            const unsigned x = __dp4a(w0, 0x01010101u, __dp4a(w1, 0x01010101u,
                               __dp4a(w2, 0x01010101u, __dp4a(w3, 0x01010101u, 0u))));
            const unsigned kx = __dp4a(w0, 0x03020100u, __dp4a(w1, 0x07060504u,
                                __dp4a(w2, 0x0B0A0908u, __dp4a(w3, 0x0F0E0D0Cu, 0u))));
            s1 = x;   // sum x_i; sum (n - i) x_i = (n - p0) sum x_i - sum k x_(p0 + k)
            sn = static_cast<long long>(n - p0) * x - kx;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFullMask, best, o));
        s1 = warp_sum(s1);
        sn = warp_sum(sn);
        if (lane == 0) {
            warp_best[q][warp] = best;
            ws1[q][warp] = s1;
            wsn[q][warp] = sn;
        }
    }
    __syncthreads();
    const int q = threadIdx.x;
    if (q < CARRY_TILES && t0 + q < n_tiles) {
        int best = -1;
        long long s1 = 0, sn = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            best = max(best, warp_best[q][w]);
            s1 += ws1[q][w];
            sn += wsn[q][w];
        }
        const int64_t tile = static_cast<int64_t>(b) * n_tiles + t0 + q;
        last[tile] = best;
        part[2 * tile] = adler_mod(s1);
        part[2 * tile + 1] = adler_mod(sn);
    }
}

// kCompact == false: tok.  kCompact == true: comp, counts and overflow, the
// tiles taken in ticket order (status: a word a tile, then the ticket).
template <bool kCompact>
__global__ void __launch_bounds__(BLOCK, DECIDE_BLOCKS_PER_SM)
tok_decide_kernel(const uint8_t* __restrict__ streams, const int* __restrict__ lengths,
                  const int* __restrict__ last, const int* __restrict__ part, int64_t npad,
                  int n_tiles, int batch, uint16_t* __restrict__ tok, int32_t* __restrict__ comp,
                  int64_t out_bound, int* __restrict__ counts, uint8_t* __restrict__ overflow,
                  unsigned long long* __restrict__ status, int* __restrict__ hist,
                  long long* __restrict__ adler) {
    __shared__ int hist_s[HIST_BINS];
    __shared__ int warp_start[WARPS], warp_end[WARPS], warp_tok[WARPS];
    __shared__ long long lscratch[WARPS];
    __shared__ int carry_s, halo_s, ticket_s;
    __shared__ long long offset_s;
    __shared__ int32_t staged[kCompact ? TILE : 1];   // each warp's tokens in its own region
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    int b, t;
    if constexpr (kCompact) {
        if (tid == 0) {
            ticket_s = static_cast<int>(
                atomicAdd(&status[static_cast<int64_t>(batch) * n_tiles], 1ull));
        }
        __syncthreads();
        b = ticket_s / n_tiles;
        t = ticket_s % n_tiles;
    } else {
        b = blockIdx.y;
        t = blockIdx.x;
    }
    for (int k = tid; k < HIST_BINS; k += BLOCK) hist_s[k] = 0;
    const int n = stream_length(lengths, b, npad);
    const uint8_t* row = streams + static_cast<int64_t>(b) * npad;
    const int start = t * TILE;
    const int p0 = start + tid * 16;

    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    Runs r = {0u, 0xFFFFu};
    int s_lane = -1;     // last run start in the warp's earlier lanes
    int e_lane = INF;    // first run end in the warp's later lanes
    if (start < n) {     // block-uniform: a tile at or past n holds pad bytes only
        // warp 0's first carry candidates and the last warp's halo load with the tile
        const int j0 = t - 1 - lane;
        int m = -1;
        if (warp == 0 && j0 >= 0) m = last[static_cast<int64_t>(b) * n_tiles + j0];
        const int h0 = start + TILE + lane * 16;
        uint4 hv = make_uint4(0u, 0u, 0u, 0u);
        if (warp == WARPS - 1) hv = load16(row, h0, npad);
        v = load16(row, p0, npad);
        r = runs_of(v, byte_before(v, row, p0, npad), p0, n);
        int smax = r.starts ? p0 + 31 - __clz(r.starts) : -1;
        int emin = r.ends ? p0 + __ffs(r.ends) - 1 : INF;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFullMask, smax, d);
            const int z = __shfl_down_sync(kFullMask, emin, d);
            if (lane >= d) smax = max(smax, y);
            if (lane + d < 32) emin = min(emin, z);
        }
        s_lane = __shfl_up_sync(kFullMask, smax, 1);
        e_lane = __shfl_down_sync(kFullMask, emin, 1);
        if (lane == 0) {
            s_lane = -1;
            warp_end[warp] = emin;
        }
        if (lane == 31) {
            e_lane = INF;
            warp_start[warp] = smax;
        }
        if (warp == 0) {   // the run start carried in from earlier tiles
            int carry = -1;
            for (int base = t - 1; base >= 0; base -= 32) {
                if (base != t - 1) {
                    const int j = base - lane;
                    m = j >= 0 ? last[static_cast<int64_t>(b) * n_tiles + j] : -1;
                }
                const unsigned hit = __ballot_sync(kFullMask, m >= 0);
                if (hit) {
                    carry = __shfl_sync(kFullMask, m, __ffs(hit) - 1);
                    break;
                }
            }
            if (lane == 0) carry_s = carry;
        }
        if (warp == WARPS - 1) {   // the first run end past the tile
            const uint32_t tile_last = __shfl_sync(kFullMask, v.w >> 24, 31);
            const uint32_t up = __shfl_up_sync(kFullMask, hv.w >> 24, 1);
            const Runs hr = runs_of(hv, lane == 0 ? tile_last : up, h0, n);
            int he = hr.ends ? h0 + __ffs(hr.ends) - 1 : INF;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) he = min(he, __shfl_xor_sync(kFullMask, he, o));
            if (lane == 0) halo_s = he;
        }
    }
    __syncthreads();

    // The token mask of the thread's bytes: T, of which Mk are matches (the
    // rest literals); kd the carried run's take-d match, if any.
    unsigned T = 0u, Mk = 0u, ext = 0u;
    int kd = -1;
    int e_after = INF;
    if (start < n && p0 < n) {
        int s_before = max(carry_s, s_lane);
        e_after = min(halo_s, e_lane);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            if (w < warp) s_before = max(s_before, warp_start[w]);
            if (w > warp) e_after = min(e_after, warp_end[w]);
        }
        const int ea = e_after - p0;   // >= 16
        ext = r.ends | (ea < 20 ? 1u << ea : 0u);   // run ends at bytes 0..19
        const unsigned S = r.starts;
        const unsigned short_starts = S & ((ext >> 1) | (ext >> 2) | (ext >> 3));
        const unsigned long_starts = S & ~short_starts;
        // runs of 1..3 bytes are all literals; a longer run's second byte is
        // a match (p == 1), and its next candidates lie 255 bytes further on
        T = S | short_starts | ((short_starts << 1) & ~ext) |
            ((short_starts << 2) & ~ext & ~(ext << 1)) | (long_starts << 1);
        Mk = long_starts << 1;
        const int f = r.ends ? __ffs(r.ends) - 1 : 16;   // bytes [0, f): the carried run
        if (f > 0) {
            const int e = f < 16 ? p0 + f : e_after;
            if (e - s_before < 4) {
                T |= (1u << f) - 1u;
            } else {
                const int c0 = (p0 - s_before - 1) % 258;      // (p - 1) % 258 of byte 0
                const int ka = c0 == 0 ? 0 : 258 - c0;         // where it is 0
                const int kb = c0 <= 255 ? 255 - c0 : 513 - c0;  // where it is 255
                if (ka < f && e - (p0 + ka) >= 3) {
                    T |= 1u << ka;
                    Mk |= 1u << ka;
                }
                const int db = e - (p0 + kb);
                if (kb < f && (db == 4 || db == 5)) {
                    T |= 1u << kb;
                    Mk |= 1u << kb;
                    kd = kb;
                }
            }
        }
        T &= 0xFFFFu;
        Mk &= 0xFFFFu;
    }

    const int n_tok = __popc(T);
    int incl = n_tok;   // tokens of the warp's lanes up to this one
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_tok[warp] = incl;

    // the tokens as eight words of two 16-bit inverted tokens, in lo and hi
    // (named, never indexed at run time, so they stay in registers):
    // literals (NO_TOKEN - x) for all 16 bytes at once, then each match
    const unsigned lits = T & ~Mk;
    uint4 lo = make_uint4(literal_word(v.x, lits, 0), literal_word(v.x, lits, 1),
                          literal_word(v.y, lits, 2), literal_word(v.y, lits, 3));
    uint4 hi = make_uint4(literal_word(v.z, lits, 4), literal_word(v.z, lits, 5),
                          literal_word(v.w, lits, 6), literal_word(v.w, lits, 7));
    int n_258 = 0;
    for (unsigned rest = Mk; rest; rest &= rest - 1u) {
        const int k = __ffs(rest) - 1;
        const unsigned after = ext & (0xFFFFFFFEu << k);
        const int e = after ? p0 + __ffs(after) - 1 : e_after;
        const int d = min(e - (p0 + k), MAX_D);
        const int take = k == kd ? d : (d >= 261 ? 258 : (d >= 259 ? 255 : d));
        const uint32_t inv = static_cast<uint32_t>(NO_TOKEN - (256 + take - 3)) << (16 * (k & 1));
        const int j = k >> 1;
        lo.x |= j == 0 ? inv : 0u;
        lo.y |= j == 1 ? inv : 0u;
        lo.z |= j == 2 ? inv : 0u;
        lo.w |= j == 3 ? inv : 0u;
        hi.x |= j == 4 ? inv : 0u;
        hi.y |= j == 5 ? inv : 0u;
        hi.z |= j == 6 ? inv : 0u;
        hi.w |= j == 7 ? inv : 0u;
        if (take == 258) {
            ++n_258;
        } else {
            atomicAdd(&hist_s[length_symbol(take)], 1);
        }
    }
    const unsigned zero = zero_bytes(v);
    for (unsigned rest = lits & ~zero; rest; rest &= rest - 1u) {
        atomicAdd(&hist_s[byte_at(v, __ffs(rest) - 1)], 1);
    }
    const int in_row = min(max(static_cast<int>(npad - p0), 0), 16);
    warp_add(&hist_s[SYM_NONE], in_row - n_tok);
    warp_add(&hist_s[0], __popc(lits & zero));
    warp_add(&hist_s[SYM_TAKE258], n_258);

    if constexpr (kCompact) {
        // in order, into the warp's region of the staging buffer
        int32_t* mine = staged + warp * WARP_TOKENS + incl - n_tok;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if ((T >> k) & 1u) {
                mine[__popc(T & ((1u << k) - 1u))] = token_of(lo, hi, k);
            }
        }
    } else {
        uint16_t* out = tok + static_cast<int64_t>(b) * npad;
        if (p0 + 16 <= npad && (reinterpret_cast<uintptr_t>(out + p0) & 15u) == 0u) {
            reinterpret_cast<uint4*>(out + p0)[0] = lo;
            reinterpret_cast<uint4*>(out + p0)[1] = hi;
        } else {
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                if (p0 + k < npad) out[p0 + k] = static_cast<uint16_t>(token_of(lo, hi, k));
            }
        }
    }
    __syncthreads();

    flush_hist(hist_s, hist + static_cast<int64_t>(b) * HIST_BINS);
    if constexpr (kCompact) {
        int tile_tok = 0, before = 0;   // the tile's tokens, the earlier warps' tokens
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            if (w < warp) before += warp_tok[w];
            tile_tok += warp_tok[w];
        }
        if (warp == 0) {
            const long long excl = look_back(status + static_cast<int64_t>(b) * n_tiles, t,
                                             tile_tok);
            if (lane == 0) {
                offset_s = excl;
                if (t == n_tiles - 1) {
                    counts[b] = static_cast<int>(excl + tile_tok);
                    overflow[b] = excl + tile_tok > out_bound ? 1 : 0;
                }
            }
        }
        __syncthreads();
        // each warp writes out its own region of staged tokens
        const long long dst = offset_s + before;
        int32_t* out = comp + static_cast<int64_t>(b) * out_bound;
        for (int j = lane; j < warp_tok[warp] && dst + j < out_bound; j += 32) {
            out[dst + j] = staged[warp * WARP_TOKENS + j];
        }
    }
    if (t == 0) {   // block-uniform: the stream's adler32 from its tiles' sums
        adler_from_parts(part + 2 * static_cast<int64_t>(b) * n_tiles, n_tiles, n, lscratch,
                         adler + b);
    }
}

// Zeros of comp from each stream's count up to out_bound.
__global__ void __launch_bounds__(BLOCK)
tok_zero_tail_kernel(int32_t* __restrict__ comp, const int* __restrict__ counts,
                     int64_t out_bound) {
    const int64_t b = blockIdx.y;
    const int64_t count = counts[b];
    const int64_t chunk = static_cast<int64_t>(blockIdx.x) * ZERO_CHUNK;
    const int64_t lo = count > chunk ? count : chunk;
    const int64_t hi = chunk + ZERO_CHUNK < out_bound ? chunk + ZERO_CHUNK : out_bound;
    int32_t* row = comp + b * out_bound;
    for (int64_t i = lo + threadIdx.x; i < hi; i += BLOCK) row[i] = 0;
}

// Tiles a row: deflate_tiles(npad), and one for an empty row, whose block
// still zeroes the stream's histogram and writes its adler32.
__host__ inline int tokenize_tiles(int64_t npad) {
    return static_cast<int>(npad > 0 ? deflate_tiles(npad) : 1);
}

__host__ inline dim3 carry_grid(int n_tiles, int64_t batch) {
    return dim3(static_cast<unsigned>((n_tiles + CARRY_TILES - 1) / CARRY_TILES),
                static_cast<unsigned>(batch));
}

}  // namespace

// streams (batch, npad) u8, lengths (batch,) i32 -> tok (batch, npad) u16
// inverted tokens, hist (batch, 512) i32 ((sym >> 5, sym & 31) row-major,
// end of block not counted, slot 287 the covered and pad bytes), adler
// (batch,) i64.  scratch (3 * batch * pr_tokenize_tiles(npad)) i32.  Returns
// the first CUDA error.
extern "C" int pr_tokenize(const void* streams, const void* lengths, void* tok, void* hist,
                           void* adler, void* scratch, int64_t batch, int64_t npad,
                           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = tokenize_tiles(npad);
    auto* x = static_cast<const uint8_t*>(streams);
    auto* len = static_cast<const int*>(lengths);
    int* last = static_cast<int*>(scratch);
    int* part = last + batch * n_tiles;
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
    tok_carry_kernel<<<carry_grid(n_tiles, batch), BLOCK, 0, s>>>(
        x, len, last, part, static_cast<int*>(hist), nullptr, npad, n_tiles);
    tok_decide_kernel<false><<<grid, BLOCK, 0, s>>>(
        x, len, last, part, npad, n_tiles, static_cast<int>(batch), static_cast<uint16_t*>(tok),
        nullptr, 0, nullptr, nullptr, nullptr, static_cast<int*>(hist),
        static_cast<long long*>(adler));
    return static_cast<int>(cudaGetLastError());
}

// As pr_tokenize, but the tokens come out compacted: comp (batch, out_bound)
// i32, each stream's inverted tokens in order and zeros after them; counts
// (batch,) i32 tokens per stream; overflow (batch,) u8 = count > out_bound
// (comp then holds the first out_bound tokens).  status (batch *
// pr_tokenize_tiles(npad) + 1) u64 is scratch too.
extern "C" int pr_tokenize_compact(const void* streams, const void* lengths, void* comp,
                                   void* hist, void* adler, void* counts, void* overflow,
                                   void* scratch, void* status, int64_t batch, int64_t npad,
                                   int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = tokenize_tiles(npad);
    if (static_cast<int64_t>(n_tiles) * batch > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    auto* x = static_cast<const uint8_t*>(streams);
    auto* len = static_cast<const int*>(lengths);
    auto* st = static_cast<unsigned long long*>(status);
    int* last = static_cast<int*>(scratch);
    int* part = last + batch * n_tiles;
    tok_carry_kernel<<<carry_grid(n_tiles, batch), BLOCK, 0, s>>>(
        x, len, last, part, static_cast<int*>(hist), st, npad, n_tiles);
    tok_decide_kernel<true><<<static_cast<unsigned>(n_tiles * batch), BLOCK, 0, s>>>(
        x, len, last, part, npad, n_tiles, static_cast<int>(batch), nullptr,
        static_cast<int32_t*>(comp), out_bound, static_cast<int*>(counts),
        static_cast<uint8_t*>(overflow), st, static_cast<int*>(hist),
        static_cast<long long*>(adler));
    if (out_bound > 0) {
        const dim3 zgrid(static_cast<unsigned>((out_bound + ZERO_CHUNK - 1) / ZERO_CHUNK),
                         static_cast<unsigned>(batch));
        tok_zero_tail_kernel<<<zgrid, BLOCK, 0, s>>>(static_cast<int32_t*>(comp),
                                                     static_cast<const int*>(counts), out_bound);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t pr_deflate_tiles(int64_t n) { return deflate_tiles(n); }
extern "C" int64_t pr_tokenize_tiles(int64_t npad) { return tokenize_tiles(npad); }
