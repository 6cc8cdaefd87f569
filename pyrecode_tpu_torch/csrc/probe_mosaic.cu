// The Mosaic lowering probes of tools/probe_mosaic.py (replaces its
// kernels: pl.pallas_call in run() at probe_mosaic.py:20 and the two built
// in place at :95 and :114) as eight small card computations at the probe's
// shapes.  On the TPU each probe asked whether Mosaic could lower a
// construct the deflate kernels wanted; on the card every construct is
// ordinary CUDA, and the question is only whether the result is exact.
//
//   0 (a) NT dot (8,128) x (32,128) -> (8,32), f32, four FMA chains an output;
//   1 (b) transpose (32,128) -> (128,32), f32, through a padded shared tile;
//   2 (c) i32 % and // by 258, floored as Python's;
//   3 (d) the row-major copy (4,512) -> (1,2048), i32;
//   4 (e) rows 0, 2, ..., 14 of (16,128), i32;
//   5 (f) the rows of (32,128) rolled by a shift read from device memory
//         (np.roll(a, s, axis=0)), i32;
//   6 (g) the sum of (8,128) i32 in int64, % 65521;
//   7 (h) (a << (s & 7)) | (a >> (8 - (s & 7))) on (8,128) i32, per element.
//
// What bounds it: each probe moves 1-16 KB, 0.00004 ms for all eight at the
// card's memory rate, so the cost is launches and latency.  The design: one
// kernel, one block a probe, every probe of a call in one launch (the JAX
// probe's main() runs all eight, one after another; mosaic_all is that
// run).  The probes' pointers travel in a struct passed by value (under
// 400 bytes of the 4 KB a launch's parameters may hold), so no host-to-device
// copy precedes the launch.  Every array is a multiple of 128 int32 and
// 16-byte aligned (the wrapper checks), so loads and stores are 16 bytes
// but for (a)'s and (g)'s one-value outputs, and a thread issues all its
// loads before its first store, so that a block waits one round trip of
// loads; (f) reads its shift once a block, while its rows are loading, and
// reduces it once; (g) sums with warp shuffles and one shared step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_PROBES = 8;
constexpr int THREADS = 256;
constexpr int PAD = 129;   // a padded shared row of 128 values: column reads hit 32 banks

struct MosaicEntry {
    int probe;
    const void* in0;
    const void* in1;
    void* out0;
    void* out1;
};

struct MosaicArgs {
    MosaicEntry entry[MAX_PROBES];
};

__device__ __forceinline__ int4 ld4(const void* p, int i) {
    return reinterpret_cast<const int4*>(p)[i];
}

__device__ __forceinline__ void st4(void* p, int i, int4 v) { reinterpret_cast<int4*>(p)[i] = v; }

__device__ __forceinline__ float4 ldf4(const float* p, int i) {
    return reinterpret_cast<const float4*>(p)[i];
}

// float4 i of rows of 128 floats into padded shared row i / 32.
__device__ __forceinline__ void put4(float* tile, int i, float4 v) {
    float* d = tile + (i >> 5) * PAD + (i & 31) * 4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
}

// Where a thread moves several 16-byte values, it issues all its loads
// before its first store: the compiler cannot move a load past a store that
// may alias it, and one round trip of loads in place of several is most of
// what a probe costs.

// (a): both operands into padded shared rows, then one output a thread.
__device__ void nt_dot(const float* a, const float* b, float* out, float* smem) {
    float4 v[5];   // 8 + 32 rows of 32 float4: a's rows, then b's
    v[0] = ldf4(a, threadIdx.x);
#pragma unroll
    for (int j = 1; j < 5; ++j) v[j] = ldf4(b, threadIdx.x + (j - 1) * THREADS);
#pragma unroll
    for (int j = 0; j < 5; ++j) put4(smem, threadIdx.x + j * THREADS, v[j]);
    __syncthreads();
    const float* x = smem + (threadIdx.x >> 5) * PAD;
    const float* y = smem + (8 + (threadIdx.x & 31)) * PAD;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};   // four chains of FMAs, not one of 128
#pragma unroll
    for (int k = 0; k < 128; k += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(x[k + j], y[k + j], acc[j]);
    }
    out[threadIdx.x] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// (b): rows in with 16-byte loads, four rows of a column out as one 16-byte store.
__device__ void transpose(const float* a, float* out, float* tile) {
    float4 v[4];   // 32 rows of 32 float4
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ldf4(a, threadIdx.x + j * THREADS);
#pragma unroll
    for (int j = 0; j < 4; ++j) put4(tile, threadIdx.x + j * THREADS, v[j]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // 128 rows of 8 float4
        const int i = threadIdx.x + j * THREADS;
        const int c = i >> 3, r = (i & 7) * 4;
        reinterpret_cast<float4*>(out)[i] =
            make_float4(tile[r * PAD + c], tile[(r + 1) * PAD + c], tile[(r + 2) * PAD + c],
                        tile[(r + 3) * PAD + c]);
    }
}

__device__ __forceinline__ void floor_divmod(int x, int& q, int& r) {
    constexpr int D = 258;
    q = x / D;
    r = x % D;
    if (r < 0) {
        --q;
        r += D;
    }
}

__device__ void mod_div(const int32_t* a, int32_t* rem, int32_t* quot) {
    const int4 v = ld4(a, threadIdx.x);   // 256 x 4 = 8 x 128
    int4 q, r;
    floor_divmod(v.x, q.x, r.x);
    floor_divmod(v.y, q.y, r.y);
    floor_divmod(v.z, q.z, r.z);
    floor_divmod(v.w, q.w, r.w);
    st4(rem, threadIdx.x, r);
    st4(quot, threadIdx.x, q);
}

__device__ void merge_rows(const int32_t* a, int32_t* out) {
    int4 v[2];   // 512 int4
#pragma unroll
    for (int j = 0; j < 2; ++j) v[j] = ld4(a, threadIdx.x + j * THREADS);
#pragma unroll
    for (int j = 0; j < 2; ++j) st4(out, threadIdx.x + j * THREADS, v[j]);
}

__device__ void stride_rows(const int32_t* a, int32_t* out) {
    const int r = threadIdx.x >> 5, c = threadIdx.x & 31;   // 8 rows of 32 int4
    st4(out, threadIdx.x, ld4(a, (2 * r) * 32 + c));
}

// (f): each thread loads its rows in order while thread 0 reads the shift
// (the loads overlap), then stores row r at row (r + shift) mod 32.
__device__ void roll_rows(const int32_t* a, const int32_t* shift, int32_t* out, int* shared) {
    int4 v[4];   // 32 rows of 32 int4
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ld4(a, threadIdx.x + j * THREADS);
    if (threadIdx.x == 0) {
        const int s = shift[0] % 32;
        shared[0] = s < 0 ? s + 32 : s;
    }
    __syncthreads();
    const int s = shared[0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int i = threadIdx.x + j * THREADS;
        st4(out, (((i >> 5) + s) & 31) * 32 + (i & 31), v[j]);
    }
}

__device__ void sum_mod(const int32_t* a, int32_t* out, long long* partial) {
    const int4 v = ld4(a, threadIdx.x);
    long long s = static_cast<long long>(v.x) + v.y + v.z + v.w;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) partial[warp] = s;
    __syncthreads();
    if (warp == 0) {
        s = lane < THREADS / 32 ? partial[lane] : 0;
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) out[0] = static_cast<int32_t>((s % 65521 + 65521) % 65521);
    }
}

__device__ __forceinline__ int rot(int a, int s) {
    const int k = s & 7;
    return static_cast<int>(static_cast<uint32_t>(a) << k) | (a >> (8 - k));
}

__device__ void shifts(const int32_t* a, const int32_t* s, int32_t* out) {
    const int4 v = ld4(a, threadIdx.x), k = ld4(s, threadIdx.x);
    st4(out, threadIdx.x, make_int4(rot(v.x, k.x), rot(v.y, k.y), rot(v.z, k.z), rot(v.w, k.w)));
}

// Block b runs args.entry[b]; THREADS threads.
__global__ void __launch_bounds__(THREADS) mosaic_kernel(const MosaicArgs args) {
    __shared__ __align__(16) float smem[40 * PAD];
    const MosaicEntry e = args.entry[blockIdx.x];
    const auto* i0 = static_cast<const int32_t*>(e.in0);
    const auto* i1 = static_cast<const int32_t*>(e.in1);
    auto* o0 = static_cast<int32_t*>(e.out0);
    switch (e.probe) {
        case 0: nt_dot(static_cast<const float*>(e.in0), static_cast<const float*>(e.in1),
                       static_cast<float*>(e.out0), smem); break;
        case 1: transpose(static_cast<const float*>(e.in0), static_cast<float*>(e.out0), smem);
                break;
        case 2: mod_div(i0, o0, static_cast<int32_t*>(e.out1)); break;
        case 3: merge_rows(i0, o0); break;
        case 4: stride_rows(i0, o0); break;
        case 5: roll_rows(i0, i1, o0, reinterpret_cast<int*>(smem)); break;
        case 6: sum_mod(i0, o0, reinterpret_cast<long long*>(smem)); break;
        case 7: shifts(i0, i1, o0); break;
        default: break;
    }
}

}  // namespace

// n_probes (1..8) probes in one launch, one block each: probes[i] (0..7, as
// listed above) on its fixed shapes with ptrs[4 i ..] = its input 0, input
// 1 (or null), output 0 and, for (c), output 1 (the floor quotient; else
// null).  Every array 16-byte aligned.  Returns cudaGetLastError().
extern "C" int pr_probe_mosaic(int n_probes, const int32_t* probes, void* const* ptrs,
                               void* stream) {
    if (n_probes < 1 || n_probes > MAX_PROBES) return static_cast<int>(cudaErrorInvalidValue);
    MosaicArgs args{};
    for (int i = 0; i < n_probes; ++i) {
        if (probes[i] < 0 || probes[i] >= 8) return static_cast<int>(cudaErrorInvalidValue);
        args.entry[i] = {probes[i], ptrs[4 * i], ptrs[4 * i + 1], ptrs[4 * i + 2],
                         ptrs[4 * i + 3]};
    }
    mosaic_kernel<<<n_probes, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(args);
    return static_cast<int>(cudaGetLastError());
}
