// The f32-dot probe: out (m, n) = lut (m, k) . oh (n, k)^T in float32,
// computed in the kernel's own body in the card's three ways of running an
// f32 product (replaces the kernel of tools/probe_f32dot.py:build, whose
// precisions DEFAULT / HIGH / HIGHEST map to these modes):
//
//   0 tf32:   operands rounded by cvt.rna.tf32.f32, one
//             mma.sync.m16n8k8 .tf32 pass on the tensor cores;
//   1 3xtf32: big = rna(x), small = rna(x - big), and three mma.sync
//             products big.big + big.small + small.big (CUTLASS's 3xTF32);
//   2 fp32:   an FMA loop, no tensor core.
//
// The TPU question was whether Mosaic honours a multi-pass f32 matmul, so
// that 21-bit integers survive a one-hot gather through the MXU.  On the
// card it is the precision lesson: TF32 keeps 11 significant bits, so a
// one-pass product rounds integers of 21 bits; 3xTF32 and FP32 keep them.
//
// What bounds it: the probe's shape (48 x 2048 x 32) moves 6 KB of lut,
// 256 KB of oh and 384 KB of out, 0.0002 ms at the card's memory rate, and
// its 3 x 6.3 MFLOP of TF32 take less; so the kernel is bound by latency:
// the launch, one round trip of loads, the dependent steps of a warp, the
// stores.  The design shortens that chain:
//
// * one block a strip of STRIP = 16 output columns and up to 64 rows:
//   128 blocks of six warps for the probe's n = 2048, one wave on 132 SMs.
//   16 columns are two n8 tiles, so a block's warps share each lut row
//   through L1 and a row of out is written in whole 32-byte sectors;
// * mma modes: warp w computes the 16x8 tile (m16 w / 2, n8 w % 2) from
//   fragments it loads itself, with no shared memory and no barrier.  The
//   k order within 32 columns is permuted (step s takes column 4q + s as
//   its q and 16 + 4q + s as its q + 4; a sum may take its terms in any
//   order, A and B being permuted alike), so a lane's fragments for four
//   k-steps are six 16-byte loads in place of 24 scalar ones.  The TF32
//   split is a few ALU operations a fragment in registers, and every
//   k-step and product has its own accumulator, so no mma waits on
//   another; they are summed at the end.  Each lane stores its 2 x 2
//   outputs as two 8-byte stores;
// * fp32: the block copies its rows of lut and oh into shared memory with
//   16-byte cp.async (4-byte copies where k % 4 != 0 or a base is not
//   16-byte aligned), KC = 32 of depth at a time, rows padded to 36
//   floats; a block stages ~8 KB, too little for TMA's descriptor and
//   barrier set-up to pay.  Thread t computes the 4 outputs (row t / 4,
//   columns 4 (t % 4) ..) by FMA and stores them as one 16-byte store.
//
// Staging the mma operands through shared memory, with the TF32 split done
// there once an element and the outputs staged for 16-byte row stores, was
// measured first at this shape and was the slowest form (PERF.md).
//
// The mma modes take m % 16 == 0, n % 8 == 0 and k % 8 == 0 (an n8 tile past
// n, in the last strip, is skipped); fp32 takes any shape.  On one-hot
// operands every output is one lut value whatever the order of the sums, so
// each mode equals its plain twin bit for bit there; on dense operands the
// order of the sums differs.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { TF32 = 0, TF32X3 = 1, FP32 = 2 };

constexpr int STRIP = 16;        // output columns a block
constexpr int MAX_ROWS = 64;     // output rows a block: four m16 tiles
constexpr int KC = 32;           // depth a step of the loops
constexpr int LD = KC + 4;       // a staged operand row (fp32), in floats

// Round to TF32, nearest with ties away from zero; the result as f32 bits.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// d += a . b for one m16n8k8 tile (a row-major 16x8, b col-major 8x8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

// One k-step of 8: acc[0] += big(a) . big(b); with TF32X3 also acc[1] +=
// big(a) . small(b) and acc[2] += small(a) . big(b).
template <int MODE>
__device__ __forceinline__ void mma_step(float (*acc)[4], const float (&af)[4],
                                         const float (&bf)[2]) {
    uint32_t ab[4], bb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ab[i] = rna_tf32(af[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) bb[i] = rna_tf32(bf[i]);
    mma_tf32(acc[0], ab, bb);
    if constexpr (MODE == TF32X3) {
        uint32_t as[4], bs[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) as[i] = rna_tf32(af[i] - __uint_as_float(ab[i]));
#pragma unroll
        for (int i = 0; i < 2; ++i) bs[i] = rna_tf32(bf[i] - __uint_as_float(bb[i]));
        mma_tf32(acc[1], ab, bs);
        mma_tf32(acc[2], as, bb);
    }
}

// Grid (ceil(n / STRIP), ceil(m / rows)) of rows * 4 threads, rows =
// blockDim.x / 4 a multiple of 16 up to MAX_ROWS.  Warp w computes the 16x8
// tile (m16 w / 2, n8 w % 2).  Fragment layouts of m16n8k8 .tf32 (PTX ISA), g = lane
// / 4, q = lane % 4: a = (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); b =
// (k q, n g), (k q + 4, n g); d = (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8,
// 2q + 1).  VEC: the operands 16-byte aligned.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(MAX_ROWS * 4)
    f32dot_mma_kernel(const float* __restrict__ lut, const float* __restrict__ oh,
                      float* __restrict__ out, int m_rows, int n_cols, int depth,
                      bool vec_out) {
    constexpr int P = MODE == TF32X3 ? 3 : 1;   // accumulators a k-step
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int m0 = blockIdx.y * (blockDim.x / 4) + (warp >> 1) * 16;
    const int n0 = blockIdx.x * STRIP + (warp & 1) * 8;
    // a tile past m (the last row of blocks) or past n (the last strip's
    // second n8 tile)
    if (m0 >= m_rows || n0 >= n_cols) return;
    const float* a = lut + static_cast<int64_t>(m0 + g) * depth;
    const float* a8 = a + static_cast<int64_t>(8) * depth;
    const float* b = oh + static_cast<int64_t>(n0 + g) * depth;

    float acc[P * KC / 8][4] = {};
    int k0 = 0;
    for (; VEC && k0 + KC <= depth; k0 += KC) {   // 32 columns, k permuted
        const float4 a_lo = ldg4(a + k0 + 4 * q), a_hi = ldg4(a + k0 + 16 + 4 * q);
        const float4 c_lo = ldg4(a8 + k0 + 4 * q), c_hi = ldg4(a8 + k0 + 16 + 4 * q);
        const float4 b_lo = ldg4(b + k0 + 4 * q), b_hi = ldg4(b + k0 + 16 + 4 * q);
        const float af[4][4] = {{a_lo.x, c_lo.x, a_hi.x, c_hi.x},
                                {a_lo.y, c_lo.y, a_hi.y, c_hi.y},
                                {a_lo.z, c_lo.z, a_hi.z, c_hi.z},
                                {a_lo.w, c_lo.w, a_hi.w, c_hi.w}};
        const float bf[4][2] = {{b_lo.x, b_hi.x}, {b_lo.y, b_hi.y}, {b_lo.z, b_hi.z},
                                {b_lo.w, b_hi.w}};
#pragma unroll
        for (int s = 0; s < KC / 8; ++s) mma_step<MODE>(acc + s * P, af[s], bf[s]);
    }
    for (; k0 < depth; k0 += 8) {   // the rest, 8 columns a step in the PTX order
        const float af[4] = {__ldg(a + k0 + q), __ldg(a8 + k0 + q), __ldg(a + k0 + q + 4),
                             __ldg(a8 + k0 + q + 4)};
        const float bf[2] = {__ldg(b + k0 + q), __ldg(b + k0 + q + 4)};
        mma_step<MODE>(acc, af, bf);
    }
#pragma unroll
    for (int i = 1; i < P * KC / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0][j] += acc[i][j];
    }
    float* d = out + static_cast<int64_t>(m0 + g) * n_cols + n0 + 2 * q;
    float* d8 = d + static_cast<int64_t>(8) * n_cols;
    if (vec_out) {
        *reinterpret_cast<float2*>(d) = make_float2(acc[0][0], acc[0][1]);
        *reinterpret_cast<float2*>(d8) = make_float2(acc[0][2], acc[0][3]);
    } else {
        d[0] = acc[0][0];
        d[1] = acc[0][1];
        d8[0] = acc[0][2];
        d8[1] = acc[0][3];
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy columns [k0, k0 + kc) of `rows` rows of a (., depth) matrix into
// shared rows of LD floats, 16 bytes a copy when VEC (kc % 4 == 0, the rows
// 16-byte aligned), else 4.
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows, int depth, int k0,
                                      int kc) {
    constexpr int W = VEC ? 4 : 1;
    constexpr int PER_ROW = KC / W;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
        const int r = i / PER_ROW, c = (i % PER_ROW) * W;
        if (c >= kc) continue;
        const float* g = src + static_cast<int64_t>(r) * depth + k0 + c;
        if constexpr (VEC) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(smem_addr(dst + r * LD + c)), "l"(g));
        } else {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"(smem_addr(dst + r * LD + c)), "l"(g));
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Grid (ceil(n / STRIP), ceil(m / rows)) of rows * 4 threads, rows =
// blockDim.x / 4 up to MAX_ROWS; thread t computes the 4 outputs (row t / 4,
// columns 4 (t % 4) ..) of the block's rows and strip.
template <bool VEC_IN>
__global__ void __launch_bounds__(MAX_ROWS * 4)
    f32dot_fma_kernel(const float* __restrict__ lut, const float* __restrict__ oh,
                      float* __restrict__ out, int m_rows, int n_cols, int depth, bool vec_out) {
    __shared__ __align__(16) float a_tile[MAX_ROWS * LD];
    __shared__ __align__(16) float b_tile[STRIP * LD];
    const int block_rows = blockDim.x / 4;
    const int m_base = blockIdx.y * block_rows;
    const int n_base = blockIdx.x * STRIP;
    const int rows_a = min(block_rows, m_rows - m_base);
    const int rows_b = min(STRIP, n_cols - n_base);
    const int row = threadIdx.x >> 2, col = (threadIdx.x & 3) * 4;

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < depth; k0 += KC) {
        const int kc = min(KC, depth - k0);
        if (k0) __syncthreads();   // the previous chunk's readers are done
        stage<VEC_IN>(a_tile, lut + static_cast<int64_t>(m_base) * depth, rows_a, depth, k0, kc);
        stage<VEC_IN>(b_tile, oh + static_cast<int64_t>(n_base) * depth, rows_b, depth, k0, kc);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        if (row >= rows_a) continue;
        const float* a = a_tile + row * LD;
        const float* b = b_tile + col * LD;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
            if (k >= kc) break;
            const float x = a[k];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = fmaf(x, b[j * LD + k], acc[j]);
        }
    }
    if (row >= rows_a || col >= rows_b) return;
    float* d = out + static_cast<int64_t>(m_base + row) * n_cols + n_base + col;
    if (vec_out && col + 4 <= rows_b) {
        *reinterpret_cast<float4*>(d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
        for (int j = 0; j < 4 && col + j < rows_b; ++j) d[j] = acc[j];
    }
}

template <int MODE>
void launch_mma(const float* a, const float* b, float* o, int m, int n, int k, dim3 grid,
                int threads, bool vec_in, bool vec_out, cudaStream_t s) {
    if (vec_in) {
        f32dot_mma_kernel<MODE, true><<<grid, threads, 0, s>>>(a, b, o, m, n, k, vec_out);
    } else {
        f32dot_mma_kernel<MODE, false><<<grid, threads, 0, s>>>(a, b, o, m, n, k, vec_out);
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// lut (m_rows, depth) f32, oh (n_cols, depth) f32 -> out (m_rows, n_cols)
// f32 = lut . oh^T in mode 0 tf32, 1 3xtf32 or 2 fp32.  The mma modes need
// m_rows % 16 == 0, n_cols % 8 == 0 and depth % 8 == 0.  One launch (none
// for an empty out).  Returns cudaGetLastError().
extern "C" int pr_probe_f32dot(const void* lut, const void* oh, void* out, int mode,
                               int64_t m_rows, int64_t n_cols, int64_t depth, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* a = static_cast<const float*>(lut);
    auto* b = static_cast<const float*>(oh);
    auto* o = static_cast<float*>(out);
    const int m = static_cast<int>(m_rows), n = static_cast<int>(n_cols),
              k = static_cast<int>(depth);
    const bool mma = mode == TF32 || mode == TF32X3;
    if ((mode != FP32 && !mma) || (mma && (m % 16 || n % 8 || k % 8))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
    const bool vec_in = k % 4 == 0 && aligned16(a) && aligned16(b);
    const bool vec_out = n % 4 == 0 && aligned16(o);
    // rows a block: m rounded up to 16, at most MAX_ROWS
    const int rows = std::min(MAX_ROWS, (m + 15) / 16 * 16);
    const dim3 grid((n + STRIP - 1) / STRIP, (m + rows - 1) / rows);
    if (mode == TF32) {
        launch_mma<TF32>(a, b, o, m, n, k, grid, rows * 4, vec_in, vec_out, s);
    } else if (mode == TF32X3) {
        launch_mma<TF32X3>(a, b, o, m, n, k, grid, rows * 4, vec_in, vec_out, s);
    } else if (vec_in) {
        f32dot_fma_kernel<true><<<grid, rows * 4, 0, s>>>(a, b, o, m, n, k, vec_out);
    } else {
        f32dot_fma_kernel<false><<<grid, rows * 4, 0, s>>>(a, b, o, m, n, k, vec_out);
    }
    return static_cast<int>(cudaGetLastError());
}
