// RG-LRU gated linear recurrence for Hopper, with the state carried in and out.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:rglru_scan_bsw.
// For each batch row b and channel w, in f32:
//     h_t = a_t * h_{t-1} + u_t,   out_t = h_t,   t = 0 .. S-1
// with the product and the sum each rounded to nearest (__fmul_rn,
// __fadd_rn), never contracted into one FMA, so the kernel equals its plain
// PyTorch version (two rounded ops a step) bit for bit. a and u are f32;
// out is written in f32, or in bf16 rounded to nearest-even from the f32
// value (what `out.to(torch.bfloat16)` gives). Unlike the TPU kernel, which
// starts from zero and drops its final state, h_0 is read from `state` and
// the final h written back to it (in place), so decode steps and prompts
// cut in pieces continue where the last call stopped.
//
// Bound: memory. One call reads a and u (4 B each per element), writes out
// (4 B, or 2 in bf16) and reads and writes the state once; no reuse. At
// recurrentgemma-2b's width (W = 2560) a batch-1 prefill of 200 steps is
// ~6.2 MB (~1.8 us at 3.35 TB/s) and 2 flops per element. The time axis is
// sequential, so at batch 1 only B * W = 2560 threads have work, and the
// latency of the loads, not the rate, sets the pace.
//
// Design: one thread per (b, w), consecutive threads on consecutive
// channels (coalesced rows), walking time in chunks of kSteps: the loads of
// chunk c + 1 are issued into registers before the steps of chunk c run, so
// a chunk's memory latency overlaps the previous chunk's arithmetic and
// stores. Blocks of 128 threads; the grid is (ceil(W / 128), B), so W need
// not be a multiple of the block. Operands are read through their batch and
// time strides (the last dim is contiguous). A time-split two-pass scan and
// fusing the gate math that makes a and u are later work. The kernel
// launches on the caller's stream, allocates nothing, and each entry point
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 16;      // time steps loaded ahead per chunk

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

struct Seq {
    int64_t b, s;   // element strides of a [B, S, W] operand
};

template <typename O>
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const float* __restrict__ a, const float* __restrict__ u,
          O* __restrict__ out, float* __restrict__ state, int S, int W,
          Seq as, Seq us, Seq os) {
    const int w = blockIdx.x * kThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (w >= W) return;
    const float* ab = a + b * as.b + w;
    const float* ub = u + b * us.b + w;
    O* ob = out + b * os.b + w;
    float* st = state + static_cast<int64_t>(b) * W + w;

    float h = *st;
    float av[kSteps], uv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
        if (i < S) {
            av[i] = ab[i * as.s];
            uv[i] = ub[i * us.s];
        }
    }
    for (int t0 = 0; t0 < S; t0 += kSteps) {
        // the next chunk's loads go out before this chunk's steps
        float an[kSteps], un[kSteps];
        const int t1 = t0 + kSteps;
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
            if (t1 + i < S) {
                an[i] = ab[static_cast<int64_t>(t1 + i) * as.s];
                un[i] = ub[static_cast<int64_t>(t1 + i) * us.s];
            }
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
            if (t0 + i < S) {
                h = __fadd_rn(__fmul_rn(av[i], h), uv[i]);
                store(ob + static_cast<int64_t>(t0 + i) * os.s, h);
            }
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
            av[i] = an[i];
            uv[i] = un[i];
        }
    }
    *st = h;
}

template <typename O>
int launch(const void* a, const void* u, void* out, void* state, int B, int S,
           int W, const int64_t* st, void* stream) {
    const Seq as{st[0], st[1]}, us{st[2], st[3]}, os{st[4], st[5]};
    const dim3 grid((W + kThreads - 1) / kThreads, B);
    rglru_fwd<O><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(u),
        static_cast<O*>(out), static_cast<float*>(state), S, W, as, us, os);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points. a, u (f32) and out ([B, S, W], f32 or bf16 by entry) come by
// base pointer, with the element strides of their first two dims in
// `strides` (6 values: a, u, out, each as b, s); the last dim of each is
// contiguous. state: contiguous f32 [B, W], read as h_0 and overwritten with
// the final h. stream is a cudaStream_t. Each returns cudaGetLastError()
// after its launch.
extern "C" {

int rglru_scan_f32(const void* a, const void* u, void* out, void* state,
                   int B, int S, int W, const int64_t* strides, void* stream) {
    return launch<float>(a, u, out, state, B, S, W, strides, stream);
}

int rglru_scan_bf16(const void* a, const void* u, void* out, void* state,
                    int B, int S, int W, const int64_t* strides,
                    void* stream) {
    return launch<__nv_bfloat16>(a, u, out, state, B, S, W, strides, stream);
}

}  // extern "C"
