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
// folds that map into its shared table: entry idx holds the freq and cum
// of idx's symbol, so a token costs the same one lookup as a symbol.  The
// threshold f << 19 is unsigned here: at f = 4096 (a one-symbol alphabet)
// the TPU kernel's int32 wraps and emits two bytes a symbol, where the
// contract emits none.
//
// The TPU kernel fetches f and cum through radix LUT matmuls, divides with
// an f32-reciprocal digit ladder and scatters bytes with one-hot matmuls,
// all Mosaic workarounds.  Here a symbol's table entry sits in shared
// memory with its exact integer reciprocal (ryg_rans's RansEncSymbol), so
// a step divides with a multiply-high and a shift: on an H100 the
// hardware division's conversions and reciprocal took a fifth to a third
// of the chain pass (PERF.md findings).
//
// A lane's new state and the bytes it emits depend only on its old state
// and its symbol; only where those bytes land depends on every byte
// emitted before them.  So the arithmetic and the placement are apart, and
// no block waits on another (two launches, no memset):
//   1. rans_chain_kernel: a thread owns one lane of one stream, a block
//      CHAIN_THREADS lanes, so a stream's lanes spread over nways /
//      CHAIN_THREADS blocks.  The thread walks its lane from the stream's
//      last row (the only one with idle lanes, taken first) to row 0 with
//      no barrier and no branch: the symbols of the next AHEAD rows are in
//      flight (a warp's loads are contiguous), the lookup is one 8-byte
//      shared entry, and the step is selects, shifts, a multiply-high and
//      a multiply-add.  Each (row, lane) stores one record n << 16 | b1
//      << 8 | b0 of its n bytes (a row's records are contiguous), each warp
//      its running byte total from the last row down to this one (one warp
//      reduction, a plain store), and the thread its final state.  The
//      time is the rows times one step of one warp: a lane's steps are a
//      chain, and more lanes a thread only lengthened the step.
//   2. rans_place_kernel: a block a (stream, row) sums the warps' running
//      totals of the row above for the row's offset (and of row 0 for the
//      stream's count), scans the row's records in descending lane order
//      (one block scan), puts the row's bytes together in shared memory at
//      the body's alignment and copies them out with 16-byte stores, none
//      at or past out_bound; every block of the stream, also those past its
//      last row, writes its share of the zeros from the count to out_bound.
// The records take 4 bytes a symbol in scratch, read back from L2.  The
// design before this one ran one block a stream and a block-wide scan with
// three barriers in every row step (PERF.md findings).

#include "rans.cuh"

namespace {

constexpr int NO_TOKEN = 512;   // token indices below it: literals and matches
constexpr int CHAIN_THREADS = 128;
constexpr int PLACE_THREADS = 256;
constexpr int AHEAD = 8;        // rows of symbols in flight ahead of the chain
// a stream takes at least out_bound / ZERO_SPAN placing blocks, for its zeros
constexpr int64_t ZERO_SPAN = 65536;
__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

static_assert(CHAIN_THREADS % 32 == 0 && RANS_THREADS % CHAIN_THREADS == 0 &&
                  RANS_ALPHABET % (4 * CHAIN_THREADS) == 0,
              "a chain block holds whole warps of one stream and loads whole int4s of a table");

// Symbol of token index idx (0 <= idx < 512): the literal, or 257 + the
// length code of take = idx - 253.
__device__ int token_symbol(int idx) {
    if (idx < 256) return idx;
    const int take = idx - 253;
    int code = 0;
    while (code + 1 < 29 && kLenBase[code + 1] <= take) ++code;
    return 257 + code;
}

// A symbol's table entry: {rcp, f | shift << 13 | bias << 18} with f = 0
// (never met) coded as 1, for code_state.  ryg_rans's reciprocal
// (RansEncSymbol): for f >= 2, shift = ceil(log2 f) and rcp = ceil(2^(shift
// + 31) / f), computed in double: the quotient lies in [2^31, 2^32), so its
// rounding error (at most 2^-22) is below its distance to the next integer
// (at least 1 / f), and the ceiling is exact.  For f = 1, rcp = 2^32 - 1
// gives x - 1 for the quotient and the bias takes the 4095 back.  The
// fields hold f <= 4096 and cum <= 4096, as quantized tables do.
__device__ __forceinline__ uint2 table_entry(int32_t freq, int32_t cum) {
    const uint32_t f = static_cast<uint32_t>(freq > 0 ? freq : 1) & 0x1FFFu;
    const uint32_t c = static_cast<uint32_t>(cum) & 0x1FFFu;
    if (f < 2) return make_uint2(~0u, f | (c + 4095u) << 18);
    const uint32_t shift = 32 - __clz(f - 1);
    const uint32_t rcp =
        static_cast<uint32_t>(ceil(static_cast<double>(1ull << (shift + 31)) / f));
    return make_uint2(rcp, f | (shift - 1) << 13 | c << 18);
}

// (x / f << 12) + x % f + cum for x < 2^31 and entry e of (f, cum), without
// a division: x + bias + (umulhi(x, rcp) >> shift) * (4096 - f).
__device__ __forceinline__ uint32_t code_state(uint32_t x, uint2 e) {
    const uint32_t f = e.y & 0x1FFFu;
    const uint32_t q = __umulhi(x, e.x) >> ((e.y >> 13) & 31u);
    return x + (e.y >> 18) + q * ((1u << RANS_PROB_BITS) - f);
}

// The lane's table entry of one symbol or inverted token; a pad or
// out-of-range token codes as f = 1, cum = 0.
template <typename In, bool kTokens>
__device__ __forceinline__ uint2 lookup(const uint2* s_tab, In v) {
    if constexpr (kTokens) {
        const uint32_t t = static_cast<uint32_t>(NO_TOKEN) - static_cast<uint32_t>(v);
        return t < static_cast<uint32_t>(NO_TOKEN) ? s_tab[t] : make_uint2(~0u, 1u | 4095u << 18);
    } else {
        return s_tab[static_cast<uint32_t>(v) & (RANS_ALPHABET - 1)];
    }
}

// One step of a lane's chain for table entry e: its record n << 16 | b1 <<
// 8 | b0 of the n bytes it emits, and its new state; selects, no branches.
// After the bytes x < f << 19 <= 2^31, inside code_state's domain.
__device__ __forceinline__ uint32_t encode_step(uint32_t& x, uint2 e) {
    const uint32_t xmax = (e.y & 0x1FFFu) << RANS_XMAX_SHIFT;
    const uint32_t e0 = x >= xmax;
    const uint32_t x1 = e0 ? x >> 8 : x;
    const uint32_t e1 = x1 >= xmax;   // only where e0
    const uint32_t x2 = e1 ? x1 >> 8 : x1;
    const uint32_t record = (x & 0xFFu) | (x1 & 0xFFu) << 8 | (e0 + e1) << 16;
    x = code_state(x2, e);
    return record;
}

// kTokens: In holds inverted tokens (uint16 or int32) and the table is
// indexed by token index; else In is int32 symbols, masked to 12 bits.
template <typename In, bool kTokens>
__global__ void __launch_bounds__(CHAIN_THREADS)
rans_chain_kernel(const In* __restrict__ values, const int32_t* __restrict__ freq,
                  const int32_t* __restrict__ cum, const int32_t* __restrict__ m_arr,
                  uint32_t* __restrict__ records, int32_t* __restrict__ warp_bytes,
                  int32_t* __restrict__ states, int64_t npad, int64_t rows, int nways) {
    __shared__ __align__(16) uint2 s_tab[RANS_ALPHABET];
    const int blocks = nways / CHAIN_THREADS;
    const int64_t b = blockIdx.x / blocks;
    const int lane = static_cast<int>(blockIdx.x % blocks) * CHAIN_THREADS + threadIdx.x;
    const int32_t* fb = freq + b * RANS_ALPHABET;
    const int32_t* cb = cum + b * RANS_ALPHABET;
    const bool aligned = ((reinterpret_cast<uintptr_t>(fb) | reinterpret_cast<uintptr_t>(cb)) &
                          15u) == 0;
    if (kTokens || !aligned) {
        for (int i = threadIdx.x; i < (kTokens ? NO_TOKEN : RANS_ALPHABET); i += CHAIN_THREADS) {
            const int s = kTokens ? token_symbol(i) : i;
            s_tab[i] = table_entry(fb[s], cb[s]);
        }
    } else {   // every 16-byte load of both tables in flight at once
        constexpr int N4 = RANS_ALPHABET / 4 / CHAIN_THREADS;
        int4 f4[N4], c4[N4];
#pragma unroll
        for (int k = 0; k < N4; ++k) {
            f4[k] = reinterpret_cast<const int4*>(fb)[threadIdx.x + k * CHAIN_THREADS];
            c4[k] = reinterpret_cast<const int4*>(cb)[threadIdx.x + k * CHAIN_THREADS];
        }
#pragma unroll
        for (int k = 0; k < N4; ++k) {
            uint2* t = s_tab + 4 * (threadIdx.x + k * CHAIN_THREADS);
            t[0] = table_entry(f4[k].x, c4[k].x);
            t[1] = table_entry(f4[k].y, c4[k].y);
            t[2] = table_entry(f4[k].z, c4[k].z);
            t[3] = table_entry(f4[k].w, c4[k].w);
        }
    }
    __syncthreads();

    const int64_t m = m_arr[b];
    uint32_t x = RANS_L;
    if (m > 0) {
        const bool leader = (threadIdx.x & 31) == 0;
        const In* vals = values + b * npad + lane;
        uint32_t* rec = records + b * rows * nways + lane;
        int32_t* wb = warp_bytes + b * rows * (nways / 32) + lane / 32;
        // the last row: the lanes at or past m idle (record 0, state kept)
        const int last = static_cast<int>((m - 1) / nways);
        const int64_t top = static_cast<int64_t>(last) * nways;
        const uint32_t rc_top =
            top + lane < m ? encode_step(x, lookup<In, kTokens>(s_tab, vals[top])) : 0u;
        rec[top] = rc_top;
        unsigned run = __reduce_add_sync(kFullMask, rc_top >> 16);   // the warp's bytes so far
        if (leader) wb[top / 32] = static_cast<int32_t>(run);
        auto row = [&](int r, uint2 e) {
            const int64_t at = static_cast<int64_t>(r) * nways;
            const uint32_t rc = encode_step(x, e);
            rec[at] = rc;
            run += __reduce_add_sync(kFullMask, rc >> 16);
            if (leader) wb[at / 32] = static_cast<int32_t>(run);
        };

        // the full rows last - 1 ... 0, the symbols of AHEAD rows in flight;
        // AHEAD rows a round are straight-line code, so a row's lookup goes
        // ahead of the step before it
        In ahead[AHEAD];
#pragma unroll
        for (int k = 0; k < AHEAD; ++k) {
            ahead[k] = last > 0 ? vals[static_cast<int64_t>(max(last - 1 - k, 0)) * nways]
                                : In(0);
        }
        int r0 = last - 1;
        for (; r0 >= AHEAD - 1; r0 -= AHEAD) {
#pragma unroll
            for (int k = 0; k < AHEAD; ++k) {
                const uint2 e = lookup<In, kTokens>(s_tab, ahead[k]);
                ahead[k] = vals[static_cast<int64_t>(max(r0 - k - AHEAD, 0)) * nways];
                row(r0 - k, e);
            }
        }
#pragma unroll
        for (int k = 0; k < AHEAD - 1; ++k) {   // the last r0 + 1 < AHEAD rows
            if (k > r0) break;
            row(r0 - k, lookup<In, kTokens>(s_tab, ahead[k]));
        }
    }
    states[b * nways + lane] = static_cast<int32_t>(x);
}

// The calling block zeroes bytes [from, to) of row, 16-byte stores where
// the row's alignment allows.
__device__ __forceinline__ void block_zero_bytes(uint8_t* row, int64_t from, int64_t to) {
    if (from >= to) return;
    const uint32_t misalign = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row + from) & 15u);
    const int64_t head = min64(to, from + ((16u - misalign) & 15u));
    for (int64_t i = from + threadIdx.x; i < head; i += blockDim.x) row[i] = 0;
    const int64_t n16 = (to - head) / 16;
    uint4* vec = reinterpret_cast<uint4*>(row + head);
    for (int64_t i = threadIdx.x; i < n16; i += blockDim.x) vec[i] = make_uint4(0, 0, 0, 0);
    for (int64_t i = head + 16 * n16 + threadIdx.x; i < to; i += blockDim.x) row[i] = 0;
}

// Block (b, r) of `blocks` a stream: row r's bytes at their place, its
// share of stream b's zeros, and (block 0) the stream's count.  The row's
// offset is the sum of the warps' bytes from row r + 1 up, the count their
// sum from row 0 up (warp_bytes holds each warp's running sum from the
// last row).  Thread t owns the LT lanes LT * (THREADS - 1 - t) ... + LT -
// 1, so ascending threads walk descending lanes.  The row's bytes are put
// together in shared memory at the body's alignment, then copied out with
// 16-byte stores.
template <int THREADS, int LT>
__global__ void __launch_bounds__(THREADS)
rans_place_kernel(const uint32_t* __restrict__ records, const int32_t* __restrict__ warp_bytes,
                  const int32_t* __restrict__ m_arr, int32_t* __restrict__ counts,
                  uint8_t* __restrict__ body, int64_t rows, int64_t blocks, int64_t out_bound) {
    constexpr int NWAYS = THREADS * LT;
    constexpr int ROW_WARPS = NWAYS / 32;   // warp sums of a row
    constexpr int WARPS = THREADS / 32;
    static_assert(LT % 4 == 0, "a thread loads its records 16 bytes at a time");
    static_assert(ROW_WARPS <= THREADS, "a thread reads one warp sum of a row");
    __shared__ int warp_sums[WARPS];
    __shared__ int part[2][WARPS];
    __shared__ __align__(16) uint8_t s_row[2 * NWAYS + 16];
    const int64_t b = blockIdx.x / blocks;
    const int64_t r = blockIdx.x % blocks;
    const int64_t m = m_arr[b];
    const int64_t n_rows = m > 0 ? (m - 1) / NWAYS + 1 : 0;
    const int32_t* wb = warp_bytes + b * rows * ROW_WARPS + threadIdx.x;
    const bool reads = threadIdx.x < ROW_WARPS;
    unsigned count = reads && n_rows > 0 ? wb[0] : 0;
    unsigned start = reads && r + 1 < n_rows ? wb[(r + 1) * ROW_WARPS] : 0;
    count = __reduce_add_sync(kFullMask, count);
    start = __reduce_add_sync(kFullMask, start);
    if ((threadIdx.x & 31) == 0) {
        part[0][threadIdx.x >> 5] = static_cast<int>(count);
        part[1][threadIdx.x >> 5] = static_cast<int>(start);
    }
    __syncthreads();
    int64_t total_bytes = 0, off = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        total_bytes += part[0][w];
        off += part[1][w];
    }
    if (r == 0 && threadIdx.x == 0) counts[b] = static_cast<int32_t>(total_bytes);
    uint8_t* out = body + b * out_bound;
    const int64_t from = min64(total_bytes, out_bound);
    const int64_t share = ((out_bound - from + blocks - 1) / blocks + 15) / 16 * 16;
    block_zero_bytes(out, min64(from + r * share, out_bound),
                     min64(from + (r + 1) * share, out_bound));
    if (r >= n_rows) return;   // past the stream's last row

    const int base = LT * (THREADS - 1 - static_cast<int>(threadIdx.x));
    const uint4* rec = reinterpret_cast<const uint4*>(records + (b * rows + r) * NWAYS + base);
    uint32_t v[LT];
#pragma unroll
    for (int k = 0; k < LT; k += 4) {
        const uint4 q = rec[k / 4];
        v[k] = q.x;
        v[k + 1] = q.y;
        v[k + 2] = q.z;
        v[k + 3] = q.w;
    }
    int n = 0;
#pragma unroll
    for (int k = 0; k < LT; ++k) n += static_cast<int>(v[k] >> 16);
    int total;
    const int excl = block_exclusive_scan<THREADS>(n, warp_sums, &total);
    const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(out + off) & 15u);
    int at = shift + excl;
#pragma unroll
    for (int k = LT - 1; k >= 0; --k) {
        const int c = static_cast<int>(v[k] >> 16);
        if (c >= 1) s_row[at] = static_cast<uint8_t>(v[k]);
        if (c == 2) s_row[at + 1] = static_cast<uint8_t>(v[k] >> 8);
        at += c;
    }
    __syncthreads();
    // s_row[shift + i] is body byte off + i: the same address mod 16
    const int len = static_cast<int>(min64(off + total, out_bound) - off);
    if (len <= 0) return;
    uint8_t* dst = out + off - shift;
    for (int i = threadIdx.x; i * 16 < shift + len; i += THREADS) {
        const int lo = i * 16;
        if (lo >= shift && lo + 16 <= shift + len) {
            *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(s_row + lo);
        } else {
            for (int j = max(lo, shift); j < min(lo + 16, shift + len); ++j) dst[j] = s_row[j];
        }
    }
}

// out[i] = code_state(x[i], the entry of (f[i], c[i])): the tests hold the
// reciprocal against the division with it.
__global__ void rans_state_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ f,
                                  const int32_t* __restrict__ c, uint32_t* __restrict__ out,
                                  int64_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < n) out[i] = code_state(x[i], table_entry(f[i], c[i]));
}

// The two launches of one encode; scratch as pr_rans_encode_scratch_words
// lays it out: records (batch, rows, nways) u32, then the warps' running
// byte sums (batch, rows, nways / 32) i32.
template <typename In, bool kTokens>
int launch_encode(const In* values, const void* freq, const void* cum, const void* m, void* body,
                  void* states, void* counts, void* scratch, int64_t batch, int64_t npad,
                  int64_t rows, int64_t out_bound, int groups, cudaStream_t s) {
    const int nways = groups * RANS_THREADS;
    auto* mm = static_cast<const int32_t*>(m);
    auto* records = static_cast<uint32_t*>(scratch);
    auto* warp_bytes = reinterpret_cast<int32_t*>(records + batch * rows * nways);
    const int64_t blocks = max64(max64(rows, 1), (out_bound + ZERO_SPAN - 1) / ZERO_SPAN);
    if (batch * blocks > INT32_MAX || batch * (nways / CHAIN_THREADS) > INT32_MAX ||
        rows > INT32_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* f = static_cast<const int32_t*>(freq);
    auto* c = static_cast<const int32_t*>(cum);
    auto* st = static_cast<int32_t*>(states);
    rans_chain_kernel<In, kTokens>
        <<<static_cast<unsigned>(batch * (nways / CHAIN_THREADS)), CHAIN_THREADS, 0, s>>>(
            values, f, c, mm, records, warp_bytes, st, npad, rows, nways);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid = static_cast<unsigned>(batch * blocks);
    auto* cn = static_cast<int32_t*>(counts);
    auto* bo = static_cast<uint8_t*>(body);
    if (groups == 8) {
        rans_place_kernel<PLACE_THREADS, 8 * RANS_THREADS / PLACE_THREADS>
            <<<grid, PLACE_THREADS, 0, s>>>(records, warp_bytes, mm, cn, bo, rows, blocks,
                                            out_bound);
    } else {
        rans_place_kernel<PLACE_THREADS, RANS_THREADS / PLACE_THREADS>
            <<<grid, PLACE_THREADS, 0, s>>>(records, warp_bytes, mm, cn, bo, rows, blocks,
                                            out_bound);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 words of the encode's scratch for a batch of streams of at most
// rows * nways symbols.
extern "C" int64_t pr_rans_encode_scratch_words(int64_t batch, int64_t rows, int nways) {
    return batch * rows * (nways + nways / 32);
}

// values (batch, npad) i32 symbols < 4096, freq and cum (batch, 4096) i32
// (the stream's quantized frequencies, summing to 4096, and their
// exclusive prefix), m (batch,) i32 symbols to code, at most rows * 1024 *
// groups -> body (batch, out_bound) u8 in emit order (bytes past
// out_bound are dropped, zeros after the count), states (batch, 1024 *
// groups) i32, counts (batch,) i32 body bytes (more than out_bound: the
// body did not fit).  groups is 1 or 8; scratch holds
// pr_rans_encode_scratch_words(batch, rows, 1024 * groups) words.  Returns
// cudaGetLastError().
extern "C" int pr_rans_encode(const void* values, const void* freq, const void* cum,
                              const void* m, void* body, void* states, void* counts,
                              void* scratch, int64_t batch, int64_t npad, int64_t rows,
                              int64_t out_bound, int groups, void* stream) {
    if (groups != 1 && groups != 8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_encode<int32_t, false>(static_cast<const int32_t*>(values), freq, cum, m, body,
                                         states, counts, scratch, batch, npad, rows, out_bound,
                                         groups, static_cast<cudaStream_t>(stream));
}

// tok (batch, npad) inverted deflate tokens, uint16 (tok_is_i32 = 0) or
// int32, as tokenize / compact_tokens give them; freq and cum (batch, 4096)
// i32 of the 286-symbol byte-mode alphabet (rest zero); m (batch,) i32
// tokens to code -> body, states (batch, 1024), counts and scratch as
// pr_rans_encode at groups 1.  Returns cudaGetLastError().
extern "C" int pr_rans_encode_tokens(const void* tok, int tok_is_i32, const void* freq,
                                     const void* cum, const void* m, void* body, void* states,
                                     void* counts, void* scratch, int64_t batch, int64_t npad,
                                     int64_t rows, int64_t out_bound, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tok_is_i32) {
        return launch_encode<int32_t, true>(static_cast<const int32_t*>(tok), freq, cum, m, body,
                                            states, counts, scratch, batch, npad, rows, out_bound,
                                            1, s);
    }
    return launch_encode<uint16_t, true>(static_cast<const uint16_t*>(tok), freq, cum, m, body,
                                         states, counts, scratch, batch, npad, rows, out_bound, 1,
                                         s);
}

// x (n,) u32 states below 2^31, f and c (n,) i32 a symbol's frequency (0
// codes as 1) and cum, at most 4096 -> out (n,) u32 = (x / f << 12) + x % f
// + c, as one encode step computes it (by a reciprocal).  Returns
// cudaGetLastError().
extern "C" int pr_rans_encode_state(const void* x, const void* f, const void* c, void* out,
                                    int64_t n, void* stream) {
    if (n <= 0) return static_cast<int>(cudaSuccess);
    if ((n + 255) / 256 > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    rans_state_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<const int32_t*>(f),
        static_cast<const int32_t*>(c), static_cast<uint32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
