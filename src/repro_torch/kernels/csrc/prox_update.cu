// gAPI-BCD closed-form update (eq. 15) and token credit (eq. 12b) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/prox_update.py:prox_update_2d.
// For every element, in f32:
//     x_new = (rho * x - g + tau * zsum) / (rho + tau * M)
//     delta = (x_new - x) / N
// x is f32 or bf16; g and zsum are f32; x_new is written in x's type and
// delta in f32.
//
// Bound: memory. Each element reads 3 values and writes 2 (20 B in f32,
// 16 B with a bf16 x) for 7 floating-point operations, far below the
// card's ~20 flop/B balance point for f32. At the trainer's shapes one
// superstep updates 4 x 494,032,768 elements: ~39.5 GB, at least 11.8 ms
// at 3.35 TB/s.
//
// Design: the Pallas kernel tiles [rows, 1024] for the TPU's vector unit
// and the caller pads every leaf; here the kernel is one flat grid-stride
// loop over numel with 16-byte vector accesses (float4, or 8 bf16 in a
// uint4) when all five pointers are 16-byte aligned, and a scalar loop
// for the tail and for unaligned pointers. No padding, no shared memory.
// The arithmetic uses the __f*_rn intrinsics: no FMA contraction and IEEE
// division, so the result is bitwise that of the plain PyTorch version.
// The kernel launches on the caller's stream and does not synchronise;
// each entry point returns cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 8 x 256 threads fill an SM

struct Coef {
    float rho, tau, denom, n;
};

__device__ __forceinline__ void prox(float x, float g, float z, const Coef& c,
                                     float& x_new, float& delta) {
    const float num =
        __fadd_rn(__fsub_rn(__fmul_rn(c.rho, x), g), __fmul_rn(c.tau, z));
    x_new = __fdiv_rn(num, c.denom);
    delta = __fdiv_rn(__fsub_rn(x_new, x), c.n);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void prox_scalar(const T* __restrict__ x,
                            const float* __restrict__ g,
                            const float* __restrict__ z, T* __restrict__ x_out,
                            float* __restrict__ d_out, int64_t begin,
                            int64_t end, Coef c) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < end; i += stride) {
        float xn, d;
        prox(to_f32(x[i]), g[i], z[i], c, xn, d);
        store(x_out + i, xn);
        d_out[i] = d;
    }
}

// f32 x: one float4 of each operand per iteration.
__global__ void prox_vec_f32(const float4* __restrict__ x,
                             const float4* __restrict__ g,
                             const float4* __restrict__ z,
                             float4* __restrict__ x_out,
                             float4* __restrict__ d_out, int64_t nvec,
                             Coef c) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
         i += stride) {
        const float4 xv = x[i], gv = g[i], zv = z[i];
        float4 xn, d;
        prox(xv.x, gv.x, zv.x, c, xn.x, d.x);
        prox(xv.y, gv.y, zv.y, c, xn.y, d.y);
        prox(xv.z, gv.z, zv.z, c, xn.z, d.z);
        prox(xv.w, gv.w, zv.w, c, xn.w, d.w);
        x_out[i] = xn;
        d_out[i] = d;
    }
}

union Bf16x8 {
    uint4 v;
    unsigned short h[8];   // raw bf16 bits
};

// bf16 x: 8 elements per iteration, one uint4 of x and x_new, two float4
// of g, zsum and delta.
__global__ void prox_vec_bf16(const uint4* __restrict__ x,
                              const float4* __restrict__ g,
                              const float4* __restrict__ z,
                              uint4* __restrict__ x_out,
                              float4* __restrict__ d_out, int64_t nvec,
                              Coef c) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
         i += stride) {
        Bf16x8 xv, xn;
        xv.v = x[i];
        const float4 g0 = g[2 * i], g1 = g[2 * i + 1];
        const float4 z0 = z[2 * i], z1 = z[2 * i + 1];
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float zs[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
        float d[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float v;
            prox(__bfloat162float(__ushort_as_bfloat16(xv.h[k])), gs[k], zs[k], c,
                 v, d[k]);
            xn.h[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
        }
        x_out[i] = xn.v;
        d_out[2 * i] = make_float4(d[0], d[1], d[2], d[3]);
        d_out[2 * i + 1] = make_float4(d[4], d[5], d[6], d[7]);
    }
}

int grid_for(int64_t work) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t want = (work + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)sms * kBlocksPerSm;
    return (int)(want < cap ? want : cap);
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool all_aligned16(const void* x, const void* g, const void* z,
                   const void* x_out, const void* d_out) {
    return aligned16(x) && aligned16(g) && aligned16(z) && aligned16(x_out) &&
           aligned16(d_out);
}

// The denominator is formed in double, as the reference forms it from
// Python floats, then every coefficient is rounded once to f32.
Coef coef(double tau, double rho, int num_walks, int num_agents) {
    return Coef{(float)rho, (float)tau, (float)(rho + tau * num_walks),
                (float)num_agents};
}

template <typename T>
void launch_scalar(const void* x, const void* g, const void* z, void* x_out,
                   void* d_out, int64_t begin, int64_t end, const Coef& c,
                   cudaStream_t s) {
    if (begin >= end) return;
    prox_scalar<T><<<grid_for(end - begin), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(g),
        static_cast<const float*>(z), static_cast<T*>(x_out),
        static_cast<float*>(d_out), begin, end, c);
}

}  // namespace

// Entry points: x, g, zsum, x_out and d_out are device pointers to n
// contiguous elements; tau, rho, M = num_walks and N = num_agents are the
// update's constants; stream is a cudaStream_t. Each returns
// cudaGetLastError() after its launches.
extern "C" {

int prox_update_f32(const void* x, const void* g, const void* z, void* x_out,
                    void* d_out, int64_t n, double tau, double rho,
                    int num_walks, int num_agents, void* stream) {
    const Coef c = coef(tau, rho, num_walks, num_agents);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int64_t begin = 0;
    if (all_aligned16(x, g, z, x_out, d_out) && n >= 4) {
        const int64_t nvec = n / 4;
        prox_vec_f32<<<grid_for(nvec), kThreads, 0, s>>>(
            static_cast<const float4*>(x), static_cast<const float4*>(g),
            static_cast<const float4*>(z), static_cast<float4*>(x_out),
            static_cast<float4*>(d_out), nvec, c);
        begin = nvec * 4;
    }
    launch_scalar<float>(x, g, z, x_out, d_out, begin, n, c, s);
    return (int)cudaGetLastError();
}

int prox_update_bf16(const void* x, const void* g, const void* z, void* x_out,
                     void* d_out, int64_t n, double tau, double rho,
                     int num_walks, int num_agents, void* stream) {
    const Coef c = coef(tau, rho, num_walks, num_agents);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int64_t begin = 0;
    if (all_aligned16(x, g, z, x_out, d_out) && n >= 8) {
        const int64_t nvec = n / 8;
        prox_vec_bf16<<<grid_for(nvec), kThreads, 0, s>>>(
            static_cast<const uint4*>(x), static_cast<const float4*>(g),
            static_cast<const float4*>(z), static_cast<uint4*>(x_out),
            static_cast<float4*>(d_out), nvec, c);
        begin = nvec * 8;
    }
    launch_scalar<__nv_bfloat16>(x, g, z, x_out, d_out, begin, n, c, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
