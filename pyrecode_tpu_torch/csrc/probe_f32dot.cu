// The f32-dot probe: out (m, n) = lut (m, k) . oh (n, k)^T in float32,
// computed in the kernel's own body in the card's three ways of running an
// f32 product (replaces the kernel of tools/probe_f32dot.py:build, whose
// precisions DEFAULT / HIGH / HIGHEST map to these modes):
//
//   0 tf32:   operands rounded by cvt.rna.tf32.f32, one
//             mma.sync.m16n8k8 .tf32 pass on the tensor cores;
//   1 3xtf32: big = rna(x), small = rna(x - big), and three mma.sync
//             products big.big + big.small + small.big (CUTLASS's 3xTF32);
//   2 fp32:   an FMA loop, one thread an output, no tensor core.
//
// The TPU question was whether Mosaic honours a multi-pass f32 matmul, so
// that 21-bit integers survive a one-hot gather through the MXU.  On the
// card it is the precision lesson: TF32 keeps 11 significant bits, so a
// one-pass product rounds integers of 21 bits; 3xTF32 and FP32 keep them.
// mma modes: one warp a 16x8 output tile, fragments loaded straight from
// device memory.  The probe's shapes (48 x 2048 x 32) make it bound by its
// bytes and its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { TF32 = 0, TF32X3 = 1, FP32 = 2 };

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

// One warp a 16x8 tile of out.  Fragment layouts of m16n8k8 .tf32 (PTX
// ISA), g = lane / 4, q = lane % 4: a = (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4); b = (k q, n g), (k q + 4, n g); d = (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1).
template <int MODE>
__global__ void f32dot_mma_kernel(const float* __restrict__ lut, const float* __restrict__ oh,
                                  float* __restrict__ out, int m_rows, int n_cols, int depth) {
    const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    const int tiles_n = n_cols / 8;
    const int m0 = (warp / tiles_n) * 16;
    const int n0 = (warp % tiles_n) * 8;
    if (m0 >= m_rows) return;   // the whole warp
    const int g = lane >> 2;
    const int q = lane & 3;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < depth; k0 += 8) {
        const float af[4] = {lut[(m0 + g) * depth + k0 + q], lut[(m0 + g + 8) * depth + k0 + q],
                             lut[(m0 + g) * depth + k0 + q + 4],
                             lut[(m0 + g + 8) * depth + k0 + q + 4]};
        const float bf[2] = {oh[(n0 + g) * depth + k0 + q], oh[(n0 + g) * depth + k0 + q + 4]};
        uint32_t a_big[4], b_big[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) a_big[i] = rna_tf32(af[i]);
#pragma unroll
        for (int i = 0; i < 2; ++i) b_big[i] = rna_tf32(bf[i]);
        mma_tf32(acc, a_big, b_big);
        if constexpr (MODE == TF32X3) {
            uint32_t a_small[4], b_small[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) a_small[i] = rna_tf32(af[i] - __uint_as_float(a_big[i]));
#pragma unroll
            for (int i = 0; i < 2; ++i) b_small[i] = rna_tf32(bf[i] - __uint_as_float(b_big[i]));
            mma_tf32(acc, a_big, b_small);
            mma_tf32(acc, a_small, b_big);
        }
    }
    float* row0 = out + static_cast<int64_t>(m0 + g) * n_cols + n0 + 2 * q;
    float* row8 = out + static_cast<int64_t>(m0 + g + 8) * n_cols + n0 + 2 * q;
    row0[0] = acc[0];
    row0[1] = acc[1];
    row8[0] = acc[2];
    row8[1] = acc[3];
}

__global__ void f32dot_fma_kernel(const float* __restrict__ lut, const float* __restrict__ oh,
                                  float* __restrict__ out, int m_rows, int n_cols, int depth) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= static_cast<int64_t>(m_rows) * n_cols) return;
    const int m = static_cast<int>(i / n_cols);
    const int n = static_cast<int>(i % n_cols);
    float acc = 0.f;
    for (int k = 0; k < depth; ++k) acc = fmaf(lut[m * depth + k], oh[n * depth + k], acc);
    out[i] = acc;
}

}  // namespace

// lut (m_rows, depth) f32, oh (n_cols, depth) f32 -> out (m_rows, n_cols)
// f32 = lut . oh^T in mode 0 tf32, 1 3xtf32 or 2 fp32.  The mma modes need
// m_rows % 16 == 0, n_cols % 8 == 0 and depth % 8 == 0.  Returns
// cudaGetLastError().
extern "C" int pr_probe_f32dot(const void* lut, const void* oh, void* out, int mode,
                               int64_t m_rows, int64_t n_cols, int64_t depth, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* a = static_cast<const float*>(lut);
    auto* b = static_cast<const float*>(oh);
    auto* o = static_cast<float*>(out);
    const int m = static_cast<int>(m_rows), n = static_cast<int>(n_cols),
              k = static_cast<int>(depth);
    constexpr int threads = 128;
    if (mode == FP32) {
        const int64_t total = m_rows * n_cols;
        f32dot_fma_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                            s>>>(a, b, o, m, n, k);
    } else if (mode == TF32 || mode == TF32X3) {
        const int64_t warps = (m_rows / 16) * (n_cols / 8);
        const unsigned blocks = static_cast<unsigned>((warps * 32 + threads - 1) / threads);
        if (mode == TF32) {
            f32dot_mma_kernel<TF32><<<blocks, threads, 0, s>>>(a, b, o, m, n, k);
        } else {
            f32dot_mma_kernel<TF32X3><<<blocks, threads, 0, s>>>(a, b, o, m, n, k);
        }
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
