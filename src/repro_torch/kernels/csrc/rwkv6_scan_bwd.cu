// Backward of the RWKV6 WKV recurrence for Hopper.
//
// The TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan_bh has no
// backward: the reference trains RWKV6 by differentiating its jnp code
// (a lax.scan, or the chunked closed form wkv_chunked). The port's forward
// is the hand-written kernel in rwkv6_scan.cu, which autograd cannot see
// through, so this is its gradient. Forward, per batch row b and head h:
//     out_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//     S_t   = diag(w_t) S_{t-1} + k_t^T v_t
// With G_t the gradient of S_t (G_{S-1} = dstate, or zero), in f32:
//     dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
//     dk_t = G_t v_t + u * r_t (v_t . do_t)
//     dw_t = rowsum(G_t * S_{t-1})
//     dv_t = k_t G_t + (r_t . (u * k_t)) do_t
//     G_{t-1} = diag(w_t) G_t + r_t^T do_t,   dstate_in = G_{-1}
//     du   = sum_t r_t * k_t (v_t . do_t)   (one row of partial sums per b)
// `ref.rwkv6_bwd` states the same arithmetic in plain PyTorch.
//
// Bound: operations. About 14 f32 operations per state element and step
// (the forward state walked twice, the gradient state once, three row
// products and one column product); at rwkv6-1.6b's training shape (B = 2,
// H = 32, S = 256, hd = 64) ~0.94 GFLOP, ~14 us at 67 TFLOP/s, against
// ~31 MB of inputs and gradients, ~9 us at 3.35 TB/s.
//
// Design (simple first). Both recurrences are independent per row i under
// diag(w_t) scaling, and G's is independent per column j too, so each
// (b, h) gets two blocks of 4 * hd threads, each thread holding hd / 4
// elements of a row or a column (indices q, q + 4, ...; the 4 threads of a
// row or column are adjacent lanes and meet by two shuffles):
//   * the row block walks S forward, keeping a checkpoint of S every
//     kChunk steps in scratch; then, chunk by chunk from the last, runs the
//     chunk's steps again from its checkpoint, writing each S_{t-1} to
//     scratch, and walks them backwards beside G_t in registers, making
//     dr, dk, dw and du (row sums). S_{t-1} is never recovered by dividing
//     by w_t: decays reach ~1e-30. Each thread reads back only what it
//     wrote, so the scratch needs no barrier.
//   * the column block walks G backwards alone, making dv (a column sum)
//     and dstate_in; it needs no S.
// Each chunk's r, k, v, w and do are staged in shared memory as f32. No
// atomics: every sum runs in a fixed order, so a repeat is bitwise. The
// grid is (B * H, 2). The kernel launches on the caller's stream,
// allocates nothing (scratch comes from the caller, sized by
// rwkv6_scan_bwd_scratch_floats) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;   // steps staged at once; the checkpoint interval

struct Bhs {
    int64_t b, h, s;   // element strides of a [B, H, S, hd] operand
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
struct Smem {
    float r[kChunk][HD], k[kChunk][HD], w[kChunk][HD], v[kChunk][HD],
        d[kChunk][HD];
    float u[HD];
};

struct Args {
    const void *r, *k, *v;
    const float *w, *state, *dout, *dstate;
    const void* u;
    float *dr, *dk, *dv, *dw, *du, *dstate_in, *scratch;
    int H, S;
    Bhs rs, ks, vs, ws, ds, drs, dks, dvs, dws;
};

__host__ __device__ inline int num_chunks(int S) {
    return (S + kChunk - 1) / kChunk;
}

// state-sized scratch slots of one (b, h): a checkpoint per chunk, then
// the states of one chunk
__host__ __device__ inline int64_t scratch_slots(int S) {
    return num_chunks(S) + (S < kChunk ? S : kChunk);
}

// stage steps [t0, t0 + n) of the operands the block needs
template <typename T, int HD>
__device__ void stage(Smem<HD>& sm, const Args& a, int b, int h, int t0,
                      int n, bool rd, bool v) {
    const T* r = static_cast<const T*>(a.r);
    const T* k = static_cast<const T*>(a.k);
    const T* vv = static_cast<const T*>(a.v);
    for (int e = threadIdx.x; e < n * HD; e += blockDim.x) {
        const int t = e / HD, c = e % HD;
        const int64_t ts = t0 + t;
        sm.k[t][c] = to_f32(k[b * a.ks.b + h * a.ks.h + ts * a.ks.s + c]);
        sm.w[t][c] = a.w[b * a.ws.b + h * a.ws.h + ts * a.ws.s + c];
        if (rd) {
            sm.r[t][c] =
                to_f32(r[b * a.rs.b + h * a.rs.h + ts * a.rs.s + c]);
            sm.d[t][c] = a.dout[b * a.ds.b + h * a.ds.h + ts * a.ds.s + c];
        }
        if (v) {
            sm.v[t][c] =
                to_f32(vv[b * a.vs.b + h * a.vs.h + ts * a.vs.s + c]);
        }
    }
}

// S <- diag(w_t) S + k_t^T v_t on a thread's row i, columns q + 4m
template <int HD>
__device__ __forceinline__ void step_row(const Smem<HD>& sm, int t, int i,
                                         int q, float (&s)[HD / 4]) {
    const float wi = sm.w[t][i], ki = sm.k[t][i];
#pragma unroll
    for (int m = 0; m < HD / 4; ++m) {
        s[m] = fmaf(wi, s[m], ki * sm.v[t][q + 4 * m]);
    }
}

template <int HD>
__device__ __forceinline__ void save(float* slots, int slot, int tid,
                                     const float (&s)[HD / 4]) {
    float4* p = reinterpret_cast<float4*>(slots) +
                static_cast<int64_t>(slot) * (HD / 16) * (4 * HD) + tid;
#pragma unroll
    for (int m4 = 0; m4 < HD / 16; ++m4) {
        p[m4 * 4 * HD] = make_float4(s[4 * m4], s[4 * m4 + 1],
                                     s[4 * m4 + 2], s[4 * m4 + 3]);
    }
}

template <int HD>
__device__ __forceinline__ void restore(const float* slots, int slot,
                                        int tid, float (&s)[HD / 4]) {
    const float4* p = reinterpret_cast<const float4*>(slots) +
                      static_cast<int64_t>(slot) * (HD / 16) * (4 * HD) + tid;
#pragma unroll
    for (int m4 = 0; m4 < HD / 16; ++m4) {
        const float4 x = p[m4 * 4 * HD];
        s[4 * m4] = x.x;
        s[4 * m4 + 1] = x.y;
        s[4 * m4 + 2] = x.z;
        s[4 * m4 + 3] = x.w;
    }
}

// The row block: dr, dk, dw and du of one (b, h).
template <typename T, int HD>
__device__ void row_pass(Smem<HD>& sm, const Args& a, int b, int h) {
    constexpr int kPer = HD / 4;
    const int tid = threadIdx.x, i = tid >> 2, q = tid & 3;
    const int64_t bh = static_cast<int64_t>(b) * a.H + h;
    const int S = a.S, nc = num_chunks(S);
    float* slots = a.scratch + bh * scratch_slots(S) * HD * HD;

    float s[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
        s[m] = a.state[(bh * HD + i) * HD + q + 4 * m];
    }
    // forward: a checkpoint of S_{t0 - 1} at every chunk start t0
    for (int c = 0; c < nc; ++c) {
        save<HD>(slots, c, tid, s);
        if (c + 1 == nc) break;
        __syncthreads();
        stage<T, HD>(sm, a, b, h, c * kChunk, kChunk, false, true);
        __syncthreads();
        for (int t = 0; t < kChunk; ++t) step_row<HD>(sm, t, i, q, s);
    }

    float g[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
        g[m] = a.dstate ? a.dstate[(bh * HD + i) * HD + q + 4 * m] : 0.f;
    }
    float du = 0.f;
    for (int c = nc - 1; c >= 0; --c) {
        const int t0 = c * kChunk, n = min(kChunk, S - t0);
        __syncthreads();
        stage<T, HD>(sm, a, b, h, t0, n, true, true);
        __syncthreads();
        // the chunk's S_{t - 1}, from its checkpoint
        restore<HD>(slots, c, tid, s);
        for (int t = 0; t < n; ++t) {
            save<HD>(slots, nc + t, tid, s);
            if (t + 1 < n) step_row<HD>(sm, t, i, q, s);
        }
        for (int t = n - 1; t >= 0; --t) {
            float sp[kPer];
            restore<HD>(slots, nc + t, tid, sp);
            float pr = 0.f, pk = 0.f, pw = 0.f, pvd = 0.f;
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                const float dj = sm.d[t][q + 4 * m], vj = sm.v[t][q + 4 * m];
                pr = fmaf(sp[m], dj, pr);
                pk = fmaf(g[m], vj, pk);
                pw = fmaf(g[m], sp[m], pw);
                pvd = fmaf(vj, dj, pvd);
            }
            pr = quad_sum(pr);
            pk = quad_sum(pk);
            pw = quad_sum(pw);
            pvd = quad_sum(pvd);
            const float ri = sm.r[t][i], ki = sm.k[t][i], wi = sm.w[t][i];
            const float ui = sm.u[i];
            const int64_t ts = t0 + t;
            if (q == 0) {
                a.dr[b * a.drs.b + h * a.drs.h + ts * a.drs.s + i] =
                    fmaf(ui * ki, pvd, pr);
            } else if (q == 1) {
                a.dk[b * a.dks.b + h * a.dks.h + ts * a.dks.s + i] =
                    fmaf(ui * ri, pvd, pk);
            } else if (q == 2) {
                a.dw[b * a.dws.b + h * a.dws.h + ts * a.dws.s + i] = pw;
            }
            du = fmaf(ri * ki, pvd, du);
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                g[m] = fmaf(wi, g[m], ri * sm.d[t][q + 4 * m]);
            }
        }
    }
    if (q == 0) a.du[bh * HD + i] = du;
}

// The column block: dv and dstate_in of one (b, h).
template <typename T, int HD>
__device__ void column_pass(Smem<HD>& sm, const Args& a, int b, int h) {
    constexpr int kPer = HD / 4;
    const int tid = threadIdx.x, j = tid >> 2, q = tid & 3;
    const int64_t bh = static_cast<int64_t>(b) * a.H + h;
    const int S = a.S, nc = num_chunks(S);
    float g[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
        g[m] = a.dstate ? a.dstate[(bh * HD + q + 4 * m) * HD + j] : 0.f;
    }
    for (int c = nc - 1; c >= 0; --c) {
        const int t0 = c * kChunk, n = min(kChunk, S - t0);
        __syncthreads();
        stage<T, HD>(sm, a, b, h, t0, n, true, false);
        __syncthreads();
        for (int t = n - 1; t >= 0; --t) {
            float pk = 0.f, pb = 0.f;
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                const int i = q + 4 * m;
                const float ki = sm.k[t][i];
                pk = fmaf(ki, g[m], pk);
                pb = fmaf(sm.r[t][i] * sm.u[i], ki, pb);
            }
            pk = quad_sum(pk);
            pb = quad_sum(pb);
            const float dj = sm.d[t][j];
            if (q == 0) {
                a.dv[b * a.dvs.b + h * a.dvs.h + (t0 + t) * a.dvs.s + j] =
                    fmaf(pb, dj, pk);
            }
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                g[m] = fmaf(sm.w[t][q + 4 * m], g[m], sm.r[t][q + 4 * m] * dj);
            }
        }
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
        a.dstate_in[(bh * HD + q + 4 * m) * HD + j] = g[m];
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(4 * HD) wkv_bwd(const Args a) {
    __shared__ Smem<HD> sm;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const T* u = static_cast<const T*>(a.u);
    for (int c = threadIdx.x; c < HD; c += blockDim.x) {
        sm.u[c] = to_f32(u[h * HD + c]);
    }
    __syncthreads();
    if (blockIdx.y == 0) {
        row_pass<T, HD>(sm, a, b, h);
    } else {
        column_pass<T, HD>(sm, a, b, h);
    }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* state, const void* dout,
           const void* dstate, void* dr, void* dk, void* dv, void* dw,
           void* du, void* dstate_in, int B, int H, int S, int hd,
           const int64_t* st, void* scratch, void* stream) {
    Args a{r, k, v,
           static_cast<const float*>(w), static_cast<const float*>(state),
           static_cast<const float*>(dout), static_cast<const float*>(dstate),
           u,
           static_cast<float*>(dr), static_cast<float*>(dk),
           static_cast<float*>(dv), static_cast<float*>(dw),
           static_cast<float*>(du), static_cast<float*>(dstate_in),
           static_cast<float*>(scratch), H, S,
           {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
           {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
           {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
           {st[18], st[19], st[20]}, {st[21], st[22], st[23]},
           {st[24], st[25], st[26]}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(B * H, 2);
    if (hd == 64) {
        wkv_bwd<T, 64><<<grid, 4 * 64, 0, s>>>(a);
    } else if (hd == 32) {
        wkv_bwd<T, 32><<<grid, 4 * 32, 0, s>>>(a);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points. r, k, v ([B, H, S, hd], the entry's type), w and dout
// ([B, H, S, hd] f32) come by base pointer with the element strides of
// their first three dims in `strides` (27 values: r, k, v, w, dout, dr, dk,
// dv, dw, each as b, h, s); the last dim of each is contiguous. u:
// contiguous [H, hd] of the entry's type. state: the forward's incoming
// f32 [B, H, hd, hd]; dstate: the gradient of its final state (same shape,
// or null for zero); both contiguous. dr, dk, dv, dw: f32 [B, H, S, hd]
// through their strides; du: contiguous f32 [B, H, hd] (per batch row);
// dstate_in: contiguous f32 [B, H, hd, hd]. scratch: f32, at least
// rwkv6_scan_bwd_scratch_floats(B, H, S, hd). stream is a cudaStream_t.
// hd is 32 or 64. Each returns cudaGetLastError() after its launch.
extern "C" {

int rwkv6_scan_bwd_f32(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* state,
                       const void* dout, const void* dstate, void* dr,
                       void* dk, void* dv, void* dw, void* du,
                       void* dstate_in, int B, int H, int S, int hd,
                       const int64_t* strides, void* scratch, void* stream) {
    return launch<float>(r, k, v, w, u, state, dout, dstate, dr, dk, dv, dw,
                         du, dstate_in, B, H, S, hd, strides, scratch,
                         stream);
}

int rwkv6_scan_bwd_bf16(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* state,
                        const void* dout, const void* dstate, void* dr,
                        void* dk, void* dv, void* dw, void* du,
                        void* dstate_in, int B, int H, int S, int hd,
                        const int64_t* strides, void* scratch, void* stream) {
    return launch<__nv_bfloat16>(r, k, v, w, u, state, dout, dstate, dr, dk,
                                 dv, dw, du, dstate_in, B, H, S, hd, strides,
                                 scratch, stream);
}

// f32 scratch floats a launch needs.
int64_t rwkv6_scan_bwd_scratch_floats(int B, int H, int S, int hd) {
    return static_cast<int64_t>(B) * H * scratch_slots(S) * hd * hd;
}

}  // extern "C"
