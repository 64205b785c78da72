// RWKV6 ("Finch") WKV recurrence for Hopper, with the state carried in and out.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan_bh.
// For each batch row b and head h, an f32 [hd, hd] state S goes through
// time t = 0 .. S-1, in f32:
//     out_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// that is out_t = r_t S + (r_t . (u * k_t)) v_t, then S = diag(w_t) S +
// k_t^T v_t. r, k, v and u are f32 or bf16 (converted exactly to f32), w is
// f32 and out is written in f32. Unlike the TPU kernel, which starts from
// zero and drops its final state, the state is read from `state` and the
// final state written back to it (in place), so decode steps and prompts
// cut in pieces continue where the last call stopped.
//
// Bound: at the serving shapes, memory. One call reads r, k, v (2 B each in
// bf16), w and writes out (4 B each) per element, and reads and writes the
// state once: B=1, S=200, H=32, hd=64 is ~6.8 MB (~2.0 us at 3.35 TB/s) for
// ~0.13 GFLOP (5 hd^2 per step and head; ~2 us at 67 TFLOP/s f32); a decode
// step (B=8, S=1) is dominated by the state, ~8.4 MB in and out. The time
// axis is sequential, so a short batch-1 prefill is bound by the latency of
// one step after another, not by either rate.
//
// Design: column j of S needs only v_t[j] and the full vectors r_t, k_t,
// w_t and u, so the state never leaves registers: a block owns 32 columns
// of one (b, h) and 4 threads share a column, each holding hd/4 of its rows
// (rows g, g+4, ...; 16 f32 registers for hd=64) for the whole sequence.
// The grid is (B*H, hd/32), so a batch-1 prefill of 32 heads of 64 runs 64
// blocks. Every 32 time steps the block stages r, k, w (all hd) and v (its
// columns) in shared memory, converted to f32; then each step is 4 FMAs
// per row per thread with no barrier, and the column's 4 partial outputs
// meet by two warp shuffles. Outputs are staged in shared memory and
// stored per chunk along the columns. Operands are read where they lie
// through their strides (the model passes [B, S, H, hd] projections
// viewed as [B, H, S, hd], and out is a view of the same kind), so there
// is no transpose. The kernel launches on the caller's stream, allocates
// nothing, and each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;       // state columns per block
constexpr int kRowGroups = 4;   // threads per column
constexpr int kThreads = kCols * kRowGroups;
constexpr int kSteps = 32;      // time steps staged per chunk

struct Seq {
    int64_t b, h, s;   // element strides of a [B, H, S, hd] operand
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ w,
        const T* __restrict__ u, float* __restrict__ out,
        float* __restrict__ state, int H, int S, Seq rs, Seq ks, Seq vs,
        Seq ws, Seq os) {
    constexpr int kRows = HD / kRowGroups;   // state rows per thread
    __shared__ float r_s[kSteps][HD];
    __shared__ float k_s[kSteps][HD];
    __shared__ float w_s[kSteps][HD];
    __shared__ float v_s[kSteps][kCols];
    __shared__ float o_s[kSteps][kCols];

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh % H;
    const int col0 = blockIdx.y * kCols;
    const int tid = threadIdx.x;
    const int g = tid % kRowGroups;   // rows g, g + 4, ... of column c
    const int c = tid / kRowGroups;   // the 4 threads of a column share a warp

    float* st = state + static_cast<int64_t>(bh) * HD * HD + col0 + c;
    float s[kRows];
    float uu[kRows];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
        const int i = ii * kRowGroups + g;
        s[ii] = st[i * HD];
        uu[ii] = to_f32(u[h * HD + i]);
    }

    const T* rb = r + b * rs.b + h * rs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h + col0;
    const float* wb = w + b * ws.b + h * ws.h;
    float* ob = out + b * os.b + h * os.h + col0;

    for (int t0 = 0; t0 < S; t0 += kSteps) {
        const int n = min(kSteps, S - t0);
        for (int e = tid; e < n * HD; e += kThreads) {
            const int t = e / HD;
            const int i = e % HD;
            r_s[t][i] = to_f32(rb[(t0 + t) * rs.s + i]);
            k_s[t][i] = to_f32(kb[(t0 + t) * ks.s + i]);
            w_s[t][i] = wb[(t0 + t) * ws.s + i];
        }
        for (int e = tid; e < n * kCols; e += kThreads) {
            const int t = e / kCols;
            v_s[t][e % kCols] = to_f32(vb[(t0 + t) * vs.s + e % kCols]);
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            const float vj = v_s[t][c];
            float acc = 0.f;
#pragma unroll
            for (int ii = 0; ii < kRows; ++ii) {
                const int i = ii * kRowGroups + g;
                const float kv = k_s[t][i] * vj;
                acc = fmaf(r_s[t][i], fmaf(uu[ii], kv, s[ii]), acc);
                s[ii] = fmaf(w_s[t][i], s[ii], kv);
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            if (g == 0) o_s[t][c] = acc;
        }
        __syncthreads();
        for (int e = tid; e < n * kCols; e += kThreads) {
            const int t = e / kCols;
            ob[(t0 + t) * os.s + e % kCols] = o_s[t][e % kCols];
        }
        __syncthreads();   // o_s is rewritten by the next chunk
    }

#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) st[(ii * kRowGroups + g) * HD] = s[ii];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int B, int H, int S,
           const Seq& rs, const Seq& ks, const Seq& vs, const Seq& ws,
           const Seq& os, cudaStream_t stream) {
    const dim3 grid(B * H, HD / kCols);
    wkv_fwd<T, HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const T*>(u), static_cast<float*>(out),
        static_cast<float*>(state), H, S, rs, ks, vs, ws, os);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* state, int B, int H, int S,
             int hd, const int64_t* st, void* stream) {
    const Seq rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
        vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
        os{st[12], st[13], st[14]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:
            return launch<T, 32>(r, k, v, w, u, out, state, B, H, S, rs, ks,
                                 vs, ws, os, s);
        case 64:
            return launch<T, 64>(r, k, v, w, u, out, state, B, H, S, rs, ks,
                                 vs, ws, os, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Entry points. r, k, v ([B, H, S, hd], of the entry's type), w (f32, same
// shape) and out (f32, same shape) come by base pointer, with the element
// strides of their first three dims in `strides` (15 values: r, k, v, w,
// out, each as b, h, s); the last dim of each is contiguous. u: contiguous
// [H, hd] of the entry's type. state: contiguous f32 [B, H, hd, hd], read
// and overwritten with the final state. hd is 32 or 64. stream is a
// cudaStream_t. Each returns cudaGetLastError() after its launch.
extern "C" {

int rwkv6_scan_f32(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, void* state, int B, int H, int S,
                   int hd, const int64_t* strides, void* stream) {
    return dispatch<float>(r, k, v, w, u, out, state, B, H, S, hd, strides,
                           stream);
}

int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                    const void* w, const void* u, void* out, void* state,
                    int B, int H, int S, int hd, const int64_t* strides,
                    void* stream) {
    return dispatch<__nv_bfloat16>(r, k, v, w, u, out, state, B, H, S, hd,
                                   strides, stream);
}

}  // extern "C"
