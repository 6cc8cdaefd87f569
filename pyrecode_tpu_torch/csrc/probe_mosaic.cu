// The Mosaic lowering probes of tools/probe_mosaic.py (replaces its
// kernels: pl.pallas_call in run() at probe_mosaic.py:20 and the two built
// in place at :95 and :114) as eight small card computations at the probe's
// shapes.  On the TPU each probe asked whether Mosaic could lower a
// construct the deflate kernels wanted; on the card every construct is
// ordinary CUDA, and the question is only whether the result is exact.
//
//   0 (a) NT dot (8,128) x (32,128) -> (8,32), f32, an FMA loop;
//   1 (b) transpose (32,128) -> (128,32), f32, through a shared tile;
//   2 (c) i32 % and // by 258, floored as Python's;
//   3 (d) the row-major copy (4,512) -> (1,2048), i32;
//   4 (e) rows 0, 2, ..., 14 of (16,128), i32;
//   5 (f) the rows of (32,128) rolled by a shift read from device memory
//         (np.roll(a, s, axis=0)), i32;
//   6 (g) the sum of (8,128) i32, block-reduced in int64, % 65521;
//   7 (h) (a << (s & 7)) | (a >> (8 - (s & 7))) on (8,128) i32, per element.
//
// Each moves a few KB: bound by its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void nt_dot_kernel(const float* a, const float* b, float* out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 8 * 32) return;
    const int r = i / 32, c = i % 32;
    float acc = 0.f;
    for (int k = 0; k < 128; ++k) acc = fmaf(a[r * 128 + k], b[c * 128 + k], acc);
    out[i] = acc;
}

// Block (32, 8), grid 4: block x transposes columns [32x, 32x + 32).
__global__ void transpose_kernel(const float* a, float* out) {
    __shared__ float tile[32][33];
    const int c0 = blockIdx.x * 32;
    for (int r = threadIdx.y; r < 32; r += blockDim.y) tile[r][threadIdx.x] = a[r * 128 + c0 + threadIdx.x];
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += blockDim.y) out[(c0 + r) * 32 + threadIdx.x] = tile[threadIdx.x][r];
}

__global__ void mod_div_kernel(const int32_t* a, int32_t* rem_out, int32_t* quot_out, int n,
                               int d) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int q = a[i] / d, r = a[i] % d;
    if (r != 0 && ((r < 0) != (d < 0))) {
        --q;
        r += d;
    }
    rem_out[i] = r;
    quot_out[i] = q;
}

__global__ void merge_rows_kernel(const int32_t* a, int32_t* out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 4 * 512) return;
    const int r = i / 512, c = i % 512;
    out[r * 512 + c] = a[r * 512 + c];
}

__global__ void stride_rows_kernel(const int32_t* a, int32_t* out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 8 * 128) return;
    const int r = i / 128, c = i % 128;
    out[i] = a[(2 * r) * 128 + c];
}

__global__ void roll_rows_kernel(const int32_t* a, const int32_t* shift, int32_t* out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 32 * 128) return;
    const int r = i / 128, c = i % 128;
    const int src = ((r - shift[0]) % 32 + 32) % 32;
    out[i] = a[src * 128 + c];
}

// One block of 256 threads.
__global__ void sum_mod_kernel(const int32_t* a, int32_t* out) {
    __shared__ int64_t sums[256];
    int64_t acc = 0;
    for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) acc += a[i];
    sums[threadIdx.x] = acc;
    __syncthreads();
    for (int half = 128; half > 0; half >>= 1) {
        if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = static_cast<int32_t>(((sums[0] % 65521) + 65521) % 65521);
}

__global__ void shifts_kernel(const int32_t* a, const int32_t* s, int32_t* out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 8 * 128) return;
    const int k = s[i] & 7;
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(a[i]) << k) | (a[i] >> (8 - k));
}

}  // namespace

// Probe `probe` (0..7, as listed above) on its fixed shapes: inputs in0
// and, where the probe has two, in1; outputs out0 and, for (c), out1 (the
// floor quotient).  Returns cudaGetLastError().
extern "C" int pr_probe_mosaic(int probe, const void* in0, const void* in1, void* out0, void* out1,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* fa = static_cast<const float*>(in0);
    auto* ia = static_cast<const int32_t*>(in0);
    auto* ib = static_cast<const int32_t*>(in1);
    auto* io = static_cast<int32_t*>(out0);
    switch (probe) {
        case 0: nt_dot_kernel<<<1, 256, 0, s>>>(fa, static_cast<const float*>(in1),
                                                static_cast<float*>(out0)); break;
        case 1: transpose_kernel<<<4, dim3(32, 8), 0, s>>>(fa, static_cast<float*>(out0)); break;
        case 2: mod_div_kernel<<<4, 256, 0, s>>>(ia, io, static_cast<int32_t*>(out1), 8 * 128,
                                                 258); break;
        case 3: merge_rows_kernel<<<8, 256, 0, s>>>(ia, io); break;
        case 4: stride_rows_kernel<<<4, 256, 0, s>>>(ia, io); break;
        case 5: roll_rows_kernel<<<16, 256, 0, s>>>(ia, ib, io); break;
        case 6: sum_mod_kernel<<<1, 256, 0, s>>>(ia, io); break;
        case 7: shifts_kernel<<<4, 256, 0, s>>>(ia, ib, io); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
