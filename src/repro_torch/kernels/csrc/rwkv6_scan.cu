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
// step (B=8, S=1) is dominated by the state, ~8.4 MB in and out.
//
// Two bodies; the caller picks one from S alone (`chunked`, see the entry
// points), never from B, so a row's result does not depend on its batch.
//
// The step body (short S, decode): time one step after another. Column j
// of S needs only v_t[j] and the full vectors r_t, k_t, w_t and u, so the
// state never leaves registers: a block owns 32 columns of one (b, h) and
// 4 threads share a column, each holding hd/4 of its rows (16 f32 registers
// for hd=64). The grid is (B*H, hd/32). Every 32 time steps the block
// stages r, k, w (all hd) and v (its columns) in shared memory, converted
// to f32; then each step is 4 FMAs per row per thread with no barrier, and
// the column's 4 partial outputs meet by two warp shuffles. Its pace is
// the latency of one dependent step after another (~255 ns a step).
//
// The chunked body (long S): the closed form of the reference's
// wkv_chunked (src/repro/models/rwkv6.py), which turns a chunk of C steps
// (64, or 32) into matrix products, so the sequential part is one fold per
// chunk instead of one step per time step. Each chunk is cut into
// sub-chunks of 16, and every exponent is a sum of lw = log2(max(w, 1e-38))
// over at most 16 steps of one sub-chunk, taken from its start (Lp_t, the
// steps before t) or towards its end (Ls_s, the steps after s); decay
// across whole sub-chunks is a product of their totals E_j = 2^(sum lw), so
// every factor is <= 1 and nothing overflows (sums over 64 steps drift
// past the reference's own 1e-3 at strong decays):
//     q_t = r_t 2^Lp_t,  k~_s = k_s 2^Ls_s  (per channel)
//     A[t][s] = q_t . (k~_s prod_{I<m<J} E_m)       sub-chunks I < J
//     A[t][s] = sum_d r_td k_sd prod_{s<q<t} w_qd     s < t, one sub-chunk
//     A[t][t] = r_t . (u k_t)                          (the bonus)
//     out_t   = (A v)_t + (q_t prod_{m<J} E_m) S_in
//     S_out   = diag(prod_m E_m) S_in + sum_s (k~_s prod_{m>I} E_m)^T v_s
// The diagonal 16x16 blocks take the exact ratio on the FMA units, as a
// running product of the decays (the f32 multiplications the step body
// makes; no exp, so nothing above the diagonal to mask). The four products
// (off-diagonal q k~^T, A v, the state contribution k_dec^T v, and r_dec
// S_in) run on the tensor cores (mma.sync m16n8k8 TF32) with each f32
// operand split in two TF32 terms, hi + lo, and three products (lo hi +
// hi lo + hi hi): ~f32 accuracy.
// Two launches a call:
//   1. wkv_fwd_chunk, grid (B*H, chunks), 8 warps (two blocks an SM):
//      stages the chunk's r, k, v, w with cp.async (through their
//      strides), writes the chunk's intra-chunk output A v into out, its
//      r_dec, its contribution dS and its total decay into scratch; the
//      last block of a (b, h) to finish (a ticket counter, as
//      attn::finish_split) folds the chunks in chunk order, S <- diag(tot)
//      S + dS, the next chunk's loads in flight, writing each chunk's S_in
//      over its dS and the final state into `state`, and resets the
//      ticket;
//   2. wkv_fwd_cross, same grid: out += r_dec S_in, the out values it adds
//      to loaded while its copies are in flight.
// A block's time is latency, not rate: every phase is a short chain of
// dependent steps, so the design spreads each over 8 warps and keeps the
// diagonal blocks branch-free.
// Operands are read where they lie through their strides (the model passes
// [B, S, H, hd] projections viewed as [B, H, S, hd], and out is a view of
// the same kind), so there is no transpose. The kernels launch on the
// caller's stream, allocate nothing, and each entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"   // cp.async helpers

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

// ---------------------------------------------------------------------------
// The chunked body.
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;          // steps of a chunk (C)
constexpr int kSub = 16;            // steps of a sub-chunk
constexpr int kChunkThreads = 256;  // 8 warps

// f32 as two TF32 terms, hi = tf32(x) and lo = tf32(x - hi), each rounded
// to nearest (away from zero on a tie).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a b for a 16x8 TF32 A fragment (row-major) and an 8x8 B fragment
// (column-major), f32 accumulator. Thread lane = 4 g + q holds a[0] at (g,
// q), a[1] at (g + 8, q), a[2] at (g, q + 4), a[3] at (g + 8, q + 4); b[0]
// at (k = q, n = g), b[1] at (q + 4, g); d[0], d[1] at row g, cols 2q, 2q +
// 1 and d[2], d[3] at row g + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of f32 values split once for several products.
struct FragA {
    uint32_t hi[4], lo[4];
    __device__ __forceinline__ explicit FragA(const float (&x)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
    }
};

// d += a b in three TF32 products (the two small cross terms first).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma_tf32(d, a.lo, h0, h1);
    mma_tf32(d, a.hi, l0, l1);
    mma_tf32(d, a.hi, h0, h1);
}

// The A fragment of rows [row0, row0 + 16), cols [k0, k0 + 8) of an f32
// shared array of pitch P.
template <int P>
__device__ __forceinline__ FragA frag_a(const float* m, int row0, int k0,
                                        int lane) {
    const int g = lane / 4, q = lane % 4;
    const float* p = m + (row0 + g) * P + k0 + q;
    const float x[4] = {p[0], p[8 * P], p[4], p[8 * P + 4]};
    return FragA(x);
}

// Shared-memory layout of wkv_fwd_chunk, all f32 unless said: r (then q),
// k (then k~) and w at pitch HD + 4 (rows read as A fragments start in
// different banks), v at pitch HD + 8 (rows read as B fragments), the
// chunk matrix A [C][C + 4], the sub-chunk totals E [C / 16][HD] and u
// [HD]; for bf16 the raw staged r, k, v [C][HD] lie over A, E and u (dead
// before those are written), so that two blocks fit on an SM.
template <typename T, int HD, int C>
struct ChunkSmem {
    static constexpr int kP = HD + 4;
    static constexpr int kPV = HD + 8;
    static constexpr int kPA = C + 4;
    static constexpr int kNS = C / kSub;
    static constexpr bool kRaw = sizeof(T) != sizeof(float);
    float* r;
    float* k;
    float* w;
    float* v;
    float* a;
    float* e;
    float* u;
    T* raw;
    __device__ explicit ChunkSmem(unsigned char* p) {
        r = reinterpret_cast<float*>(p);
        k = r + C * kP;
        w = k + C * kP;
        v = w + C * kP;
        a = v + C * kPV;
        e = a + C * kPA;
        u = e + kNS * HD;
        raw = reinterpret_cast<T*>(a);
    }
    // A, E and u, or for bf16 the raw tiles if larger
    __host__ __device__ static constexpr size_t tail_bytes() {
        return sizeof(float) * (C * kPA + kNS * HD + HD) >
                       (kRaw ? sizeof(T) * 3 * C * HD : 0)
                   ? sizeof(float) * (C * kPA + kNS * HD + HD)
                   : sizeof(T) * 3 * C * HD;
    }
    __host__ __device__ static constexpr size_t bytes() {
        return sizeof(float) * (3 * C * kP + C * kPV) + tail_bytes();
    }
};

template <typename U>
__device__ __forceinline__ U zero_of() {
    return U(0.f);
}

// Stage rows [0, C) of one chunk of an operand whose row t lies at base +
// t * ss (HD contiguous elements) into dst at pitch P; rows at or past n
// are zero-filled and never read. `async`: 16-byte cp.async copies (every
// row address 16-byte aligned); else plain loads.
template <typename U, int HD, int C, int P>
__device__ __forceinline__ void stage_rows(U* dst, const U* base, int64_t ss,
                                           int n, bool async, int tid) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(U));
    constexpr int kChunks = HD / kPer;
    for (int i = tid; i < C * kChunks; i += kChunkThreads) {
        const int t = i / kChunks;
        const int c = (i % kChunks) * kPer;
        const bool ok = t < n;
        const U* src = base + (ok ? t : 0) * ss + c;
        U* d = dst + t * P + c;
        if (async) {
            attn::cp_async16(d, src, ok);
        } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j) d[j] = ok ? src[j] : zero_of<U>();
        }
    }
}

// Launch 1: one chunk of one (b, h). Scratch: rdec [B*H][chunks * C][HD],
// ds [B*H][chunks][HD][HD] (dS, then S_in), tot [B*H][chunks][HD].
template <typename T, int HD, int C>
__global__ void __launch_bounds__(kChunkThreads, 2)
wkv_fwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const T* __restrict__ u, float* __restrict__ out,
              float* __restrict__ state, float* __restrict__ rdec,
              float* __restrict__ ds, float* __restrict__ tot,
              int* __restrict__ ticket, int H, int S, Seq rs, Seq ks, Seq vs,
              Seq ws, Seq os, bool async) {
    using Sm = ChunkSmem<T, HD, C>;
    constexpr int kP = Sm::kP, kPV = Sm::kPV, kPA = Sm::kPA, kNS = Sm::kNS;
    extern __shared__ __align__(16) unsigned char smem[];
    const Sm sm(smem);
    __shared__ int last;

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh % H;
    const int c = blockIdx.y;
    const int nc = gridDim.y;
    const int t0 = c * C;
    const int n = min(C, S - t0);
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int q = lane % 4;

    // stage r, k, v (raw for bf16) and w; u converted directly
    {
        const T* rb = r + b * rs.b + h * rs.h + t0 * rs.s;
        const T* kb = k + b * ks.b + h * ks.h + t0 * ks.s;
        const T* vb = v + b * vs.b + h * vs.h + t0 * vs.s;
        const float* wb = w + b * ws.b + h * ws.h + t0 * ws.s;
        if constexpr (Sm::kRaw) {
            stage_rows<T, HD, C, HD>(sm.raw, rb, rs.s, n, async, tid);
            stage_rows<T, HD, C, HD>(sm.raw + C * HD, kb, ks.s, n, async, tid);
            stage_rows<T, HD, C, HD>(sm.raw + 2 * C * HD, vb, vs.s, n, async,
                                     tid);
        } else {
            stage_rows<T, HD, C, kP>(reinterpret_cast<T*>(sm.r), rb, rs.s, n,
                                     async, tid);
            stage_rows<T, HD, C, kP>(reinterpret_cast<T*>(sm.k), kb, ks.s, n,
                                     async, tid);
            stage_rows<T, HD, C, kPV>(reinterpret_cast<T*>(sm.v), vb, vs.s, n,
                                      async, tid);
        }
        stage_rows<float, HD, C, kP>(sm.w, wb, ws.s, n, async, tid);
        attn::cp_async_commit();
        const float uu = tid < HD ? to_f32(u[h * HD + tid]) : 0.f;
        attn::cp_async_wait<0>();
        __syncthreads();
        if constexpr (Sm::kRaw) {
            for (int i = tid; i < C * HD; i += kChunkThreads) {
                const int t = i / HD, d = i % HD;
                sm.r[t * kP + d] = to_f32(sm.raw[i]);
                sm.k[t * kP + d] = to_f32(sm.raw[C * HD + i]);
                sm.v[t * kPV + d] = to_f32(sm.raw[2 * C * HD + i]);
            }
            __syncthreads();   // raw is dead: u, A and E may overwrite it
        }
        if (tid < HD) sm.u[tid] = uu;
        __syncthreads();
    }

    // (a) the diagonal blocks, exact: thread (J, s, slice) runs the decay
    // product of k_s forward over t, for its slice of the channels (groups
    // of 4 interleaved, so that the slices' loads fall in different banks);
    // the steps before s are selected away, not branched around
    {
        constexpr int kSlices = kChunkThreads / C;   // 4 (C = 64) or 8
        constexpr int kDS = HD / kSlices;            // channels a slice
        const int slice = tid % kSlices;
        const int s = (tid / kSlices) % kSub;
        const int J = tid / (kSlices * kSub);
        const int row_s = J * kSub + s;
        float acc[kSub];
#pragma unroll
        for (int t = 0; t < kSub; ++t) acc[t] = 0.f;
#pragma unroll
        for (int i = 0; i < kDS / 4; ++i) {
            const int d0 = 4 * (slice + kSlices * i);
            const float4 kk = *reinterpret_cast<const float4*>(
                sm.k + row_s * kP + d0);
            const float4 uu = *reinterpret_cast<const float4*>(sm.u + d0);
            float kp[4] = {kk.x, kk.y, kk.z, kk.w};
            const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
                const int row = J * kSub + t;
                const float4 rr = *reinterpret_cast<const float4*>(
                    sm.r + row * kP + d0);
                const float4 ww = *reinterpret_cast<const float4*>(
                    sm.w + row * kP + d0);
                const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
                const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
                const bool after = t > s, here = t == s;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float coef =
                        after ? kp[j] : (here ? kp[j] * uv[j] : 0.f);
                    acc[t] = fmaf(rv[j], coef, acc[t]);
                    kp[j] = after ? kp[j] * wv[j] : kp[j];
                }
            }
        }
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
#pragma unroll
            for (int off = 1; off < kSlices; off <<= 1) {
                acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
            }
        }
        if (slice == 0) {
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
                sm.a[(J * kSub + t) * kPA + row_s] = acc[t];
            }
        }
    }
    __syncthreads();

    // (b) per (sub-chunk, channel): log-decays, q = r 2^Lp over r, k~ =
    // k 2^Ls over k, and the sub-chunk's total E
    for (int p = tid; p < kNS * HD; p += kChunkThreads) {
        const int J = p / HD, d = p % HD;
        float lw[kSub];
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
            const int row = J * kSub + t;
            lw[t] = row < n ? log2f(fmaxf(sm.w[row * kP + d], 1e-38f)) : 0.f;
        }
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
            sm.r[(J * kSub + t) * kP + d] *= exp2f(acc);
            acc += lw[t];
        }
        sm.e[J * HD + d] = exp2f(acc);
        acc = 0.f;
#pragma unroll
        for (int t = kSub - 1; t >= 0; --t) {
            sm.k[(J * kSub + t) * kP + d] *= exp2f(acc);
            acc += lw[t];
        }
    }
    __syncthreads();

    // (c) the off-diagonal blocks (J, I), I < J, on the tensor cores: q_J
    // (k~_I prod_{I<m<J} E_m)^T, a pair of sub-chunks per warp in turn
    constexpr int kPairs = kNS * (kNS - 1) / 2;
    for (int p = warp; p < kPairs; p += kChunkThreads / 32) {
        int J = 1, I = p;
        while (I >= J) {
            I -= J;
            ++J;
        }
        float acc[2][4] = {};
        for (int k0 = 0; k0 < HD; k0 += 8) {
            const FragA fa = frag_a<kP>(sm.r, J * kSub, k0, lane);
            float m0 = 1.f, m1 = 1.f;
            for (int m = I + 1; m < J; ++m) {
                m0 *= sm.e[m * HD + k0 + q];
                m1 *= sm.e[m * HD + k0 + q + 4];
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const float* kr =
                    sm.k + (I * kSub + nt * 8 + g) * kP + k0 + q;
                mma3(acc[nt], fa, kr[0] * m0, kr[4] * m1);
            }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float* ar =
                sm.a + (J * kSub + g) * kPA + I * kSub + nt * 8 + 2 * q;
            ar[0] = acc[nt][0];
            ar[1] = acc[nt][1];
            ar[8 * kPA] = acc[nt][2];
            ar[8 * kPA + 1] = acc[nt][3];
        }
    }
    // r_dec = q prod_{m<J} E_m, every row of the chunk, for launch 2
    {
        float* rd = rdec + (static_cast<int64_t>(bh) * nc + c) * C * HD;
        for (int i = tid; i < C * HD / 4; i += kChunkThreads) {
            const int t = i / (HD / 4), d = (i % (HD / 4)) * 4;
            float4 x = *reinterpret_cast<const float4*>(sm.r + t * kP + d);
            float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
            for (int m = 0; m < t / kSub; ++m) {
                const float4 e = *reinterpret_cast<const float4*>(
                    sm.e + m * HD + d);
                f.x *= e.x;
                f.y *= e.y;
                f.z *= e.z;
                f.w *= e.w;
            }
            x.x *= f.x;
            x.y *= f.y;
            x.z *= f.z;
            x.w *= f.w;
            *reinterpret_cast<float4*>(rd + t * HD + d) = x;
        }
    }
    __syncthreads();

    // (d) the intra-chunk output A v into out: row block J, all or half of
    // the hd columns a warp
    {
        constexpr int kWarpsPerRow = (kChunkThreads / 32) / kNS;
        constexpr int kNT = HD / 8 / kWarpsPerRow;
        const int J = warp % kNS;
        const int part = warp / kNS;
        float acc[kNT][4] = {};
        for (int k0 = 0; k0 < (J + 1) * kSub; k0 += 8) {
            const FragA fa = frag_a<kPA>(sm.a, J * kSub, k0, lane);
#pragma unroll
            for (int i = 0; i < kNT; ++i) {
                const float* vr =
                    sm.v + (k0 + q) * kPV + (part * kNT + i) * 8 + g;
                mma3(acc[i], fa, vr[0], vr[4 * kPV]);
            }
        }
        float* ob = out + b * os.b + h * os.h;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int t = J * kSub + g + 8 * half;
            if (t < n) {
                float* orow = ob + (t0 + t) * os.s;
#pragma unroll
                for (int i = 0; i < kNT; ++i) {
                    *reinterpret_cast<float2*>(
                        orow + (part * kNT + i) * 8 + 2 * q) =
                        make_float2(acc[i][2 * half], acc[i][2 * half + 1]);
                }
            }
        }
    }

    // (e) the chunk's contribution dS = k_dec^T v, k_dec = k~ prod_{m>I} E_m:
    // a 16-channel row block of dS a warp (two warps share one at hd 32)
    {
        constexpr int kMT = HD / 16;
        constexpr int kWPM = (kChunkThreads / 32) / kMT;
        constexpr int kNT = HD / 8 / kWPM;
        const int m0 = (warp % kMT) * 16;
        const int part = warp / kMT;
        float acc[kNT][4] = {};
        for (int k0 = 0; k0 < C; k0 += 8) {
            const int I = k0 / kSub;
            float f0 = 1.f, f1 = 1.f;
            for (int m = I + 1; m < kNS; ++m) {
                f0 *= sm.e[m * HD + m0 + g];
                f1 *= sm.e[m * HD + m0 + g + 8];
            }
            const float* kr = sm.k + (k0 + q) * kP + m0 + g;
            const float x[4] = {kr[0] * f0, kr[8] * f1, kr[4 * kP] * f0,
                                kr[4 * kP + 8] * f1};
            const FragA fa(x);
#pragma unroll
            for (int i = 0; i < kNT; ++i) {
                const float* vr =
                    sm.v + (k0 + q) * kPV + (part * kNT + i) * 8 + g;
                mma3(acc[i], fa, vr[0], vr[4 * kPV]);
            }
        }
        float* dsb = ds + (static_cast<int64_t>(bh) * nc + c) * HD * HD;
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
            const int col = (part * kNT + i) * 8 + 2 * q;
            *reinterpret_cast<float2*>(dsb + (m0 + g) * HD + col) =
                make_float2(acc[i][0], acc[i][1]);
            *reinterpret_cast<float2*>(dsb + (m0 + g + 8) * HD + col) =
                make_float2(acc[i][2], acc[i][3]);
        }
    }
    // (f) the chunk's total decay prod_m E_m
    for (int d = tid; d < HD; d += kChunkThreads) {
        float p = 1.f;
        for (int m = 0; m < kNS; ++m) p *= sm.e[m * HD + d];
        tot[(static_cast<int64_t>(bh) * nc + c) * HD + d] = p;
    }

    // (g) the last block of this (b, h) folds the chunks in chunk order
    __threadfence();   // dS and tot are visible before the ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(ticket + bh, 1) == nc - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid == 0) ticket[bh] = 0;   // ready for the next launch
    // each thread folds elements e = tid + i * kChunkThreads (coalesced);
    // the chunks' decays are staged in this block's shared memory, now
    // idle, up to kBatch chunks at a time, and dS is loaded two chunks
    // ahead of the fold
    constexpr int kE = HD * HD / kChunkThreads;
    constexpr int kBatch =
        static_cast<int>(Sm::bytes() / (sizeof(float) * HD));
    float* tot_s = reinterpret_cast<float*>(smem);   // [kBatch][HD]
    float* sp = state + static_cast<int64_t>(bh) * HD * HD;
    float* dsb = ds + static_cast<int64_t>(bh) * nc * HD * HD;
    const float* tb = tot + static_cast<int64_t>(bh) * nc * HD;
    float sv[kE], x0[kE], x1[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) {
        const int e = tid + i * kChunkThreads;
        sv[i] = sp[e];
        x0[i] = __ldcg(dsb + e);
        x1[i] = nc > 1 ? __ldcg(dsb + HD * HD + e) : 0.f;
    }
    for (int c0 = 0; c0 < nc; c0 += kBatch) {
        const int c1 = min(nc, c0 + kBatch);
        __syncthreads();   // the previous batch's decays are read
        for (int i = tid; i < (c1 - c0) * HD; i += kChunkThreads) {
            tot_s[i] = __ldcg(tb + c0 * HD + i);
        }
        __syncthreads();
        for (int ci = c0; ci < c1; ++ci) {
            const bool more = ci + 2 < nc;
            const float* tc = tot_s + (ci - c0) * HD;
#pragma unroll
            for (int i = 0; i < kE; ++i) {
                const int e = tid + i * kChunkThreads;
                const float x2 =
                    more ? __ldcg(dsb + (ci + 2) * HD * HD + e) : 0.f;
                dsb[ci * HD * HD + e] = sv[i];   // S_in of chunk ci, over dS
                sv[i] = fmaf(tc[e / HD], sv[i], x0[i]);
                x0[i] = x1[i];
                x1[i] = x2;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kE; ++i) sp[tid + i * kChunkThreads] = sv[i];
}

// Launch 2's shared memory: r_dec [C][HD + 4] and S_in [HD][HD + 8].
template <int HD, int C>
constexpr size_t cross_smem_bytes() {
    return sizeof(float) * (C * (HD + 4) + HD * (HD + 8));
}

// Launch 2: out += r_dec S_in for one chunk of one (b, h).
template <int HD, int C>
__global__ void __launch_bounds__(kChunkThreads)
wkv_fwd_cross(const float* __restrict__ rdec,
              const float* __restrict__ s_in,
              float* __restrict__ out, int H, int S, Seq os) {
    constexpr int kP = HD + 4, kPS = HD + 8, kNS = C / kSub;
    extern __shared__ __align__(16) unsigned char smem[];
    float* rd = reinterpret_cast<float*>(smem);
    float* sn = rd + C * kP;
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh % H;
    const int c = blockIdx.y;
    const int nc = gridDim.y;
    const int t0 = c * C;
    const int n = min(C, S - t0);
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int q = lane % 4;

    stage_rows<float, HD, C, kP>(
        rd, rdec + (static_cast<int64_t>(bh) * nc + c) * C * HD, HD, C, true,
        tid);
    stage_rows<float, HD, HD, kPS>(
        sn, s_in + (static_cast<int64_t>(bh) * nc + c) * HD * HD, HD, HD, true,
        tid);
    attn::cp_async_commit();

    constexpr int kWarpsPerRow = (kChunkThreads / 32) / kNS;
    constexpr int kNT = HD / 8 / kWarpsPerRow;
    const int J = warp % kNS;
    const int part = warp / kNS;
    // the intra-chunk output this thread adds to, loaded while the copies
    // are in flight
    float* ob = out + b * os.b + h * os.h;
    float2 prev[2][kNT];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int t = J * kSub + g + 8 * half;
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
            prev[half][i] = t < n ? *reinterpret_cast<const float2*>(
                                        ob + (t0 + t) * os.s +
                                        (part * kNT + i) * 8 + 2 * q)
                                  : make_float2(0.f, 0.f);
        }
    }
    attn::cp_async_wait<0>();
    __syncthreads();
    if (J * kSub >= n) return;   // rows past S
    float acc[kNT][4] = {};
    for (int k0 = 0; k0 < HD; k0 += 8) {
        const FragA fa = frag_a<kP>(rd, J * kSub, k0, lane);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
            const float* sr = sn + (k0 + q) * kPS + (part * kNT + i) * 8 + g;
            mma3(acc[i], fa, sr[0], sr[4 * kPS]);
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int t = J * kSub + g + 8 * half;
        if (t < n) {
            float* orow = ob + (t0 + t) * os.s;
#pragma unroll
            for (int i = 0; i < kNT; ++i) {
                *reinterpret_cast<float2*>(orow + (part * kNT + i) * 8 +
                                           2 * q) =
                    make_float2(prev[half][i].x + acc[i][2 * half],
                                prev[half][i].y + acc[i][2 * half + 1]);
            }
        }
    }
}

// true if every (b, h) row base and every row of a strided [B, H, S, HD]
// operand is 16-byte aligned
bool aligned16(const void* p, const Seq& st, size_t esize) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (st.b * esize) % 16 == 0 && (st.h * esize) % 16 == 0 &&
           (st.s * esize) % 16 == 0;
}

template <typename T, int HD, int C>
int launch_chunked(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, void* state, int B, int H, int S,
                   const Seq& rs, const Seq& ks, const Seq& vs, const Seq& ws,
                   const Seq& os, float* scratch, int* tickets,
                   cudaStream_t stream) {
    const int nc = (S + C - 1) / C;
    const int64_t bhc = static_cast<int64_t>(B) * H * nc;
    float* rdec = scratch;
    float* ds = rdec + bhc * C * HD;
    float* tot = ds + bhc * HD * HD;
    const bool async = aligned16(r, rs, sizeof(T)) &&
                       aligned16(k, ks, sizeof(T)) &&
                       aligned16(v, vs, sizeof(T)) &&
                       aligned16(w, ws, sizeof(float));
    const dim3 grid(B * H, nc);
    const size_t bytes = ChunkSmem<T, HD, C>::bytes();
    cudaFuncSetAttribute(wkv_fwd_chunk<T, HD, C>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    cudaFuncSetAttribute(wkv_fwd_chunk<T, HD, C>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    wkv_fwd_chunk<T, HD, C><<<grid, kChunkThreads, bytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const T*>(u), static_cast<float*>(out),
        static_cast<float*>(state), rdec, ds, tot, tickets, H, S, rs, ks, vs,
        ws, os, async);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t cross = cross_smem_bytes<HD, C>();
    cudaFuncSetAttribute(wkv_fwd_cross<HD, C>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(cross));
    wkv_fwd_cross<HD, C><<<grid, kChunkThreads, cross, stream>>>(
        rdec, ds, static_cast<float*>(out), H, S, os);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int B, int H, int S,
           const Seq& rs, const Seq& ks, const Seq& vs, const Seq& ws,
           const Seq& os, int chunked, float* scratch, int* tickets,
           cudaStream_t stream) {
    if (chunked) {
        return launch_chunked<T, HD, kChunk>(r, k, v, w, u, out, state, B, H,
                                             S, rs, ks, vs, ws, os, scratch,
                                             tickets, stream);
    }
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
             int hd, const int64_t* st, int chunked, void* scratch,
             void* tickets, void* stream) {
    const Seq rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
        vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
        os{st[12], st[13], st[14]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* scr = static_cast<float*>(scratch);
    int* tk = static_cast<int*>(tickets);
    switch (hd) {
        case 32:
            return launch<T, 32>(r, k, v, w, u, out, state, B, H, S, rs, ks,
                                 vs, ws, os, chunked, scr, tk, s);
        case 64:
            return launch<T, 64>(r, k, v, w, u, out, state, B, H, S, rs, ks,
                                 vs, ws, os, chunked, scr, tk, s);
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
// and overwritten with the final state. hd is 32 or 64. chunked: 0 for the
// step body, 1 for the chunked body, which then takes `scratch` (f32, B * H
// * ceil(S / C) * (C * hd + hd * hd + hd) values, C = kChunk = 64) and
// `tickets` (B * H zeroed int32 counters, left zeroed). stream is a
// cudaStream_t. Each returns cudaGetLastError() after its launches.
extern "C" {

int rwkv6_scan_f32(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, void* state, int B, int H, int S,
                   int hd, const int64_t* strides, int chunked,
                   void* scratch, void* tickets, void* stream) {
    return dispatch<float>(r, k, v, w, u, out, state, B, H, S, hd, strides,
                           chunked, scratch, tickets, stream);
}

int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                    const void* w, const void* u, void* out, void* state,
                    int B, int H, int S, int hd, const int64_t* strides,
                    int chunked, void* scratch, void* tickets, void* stream) {
    return dispatch<__nv_bfloat16>(r, k, v, w, u, out, state, B, H, S, hd,
                                   strides, chunked, scratch, tickets, stream);
}

// Dynamic shared bytes of the chunked body's launch 1 (cross = 0) or
// launch 2 (cross = 1) for bf16 (or f32) inputs and hd 32 or 64; -1 for
// another head dim.
int rwkv6_scan_smem_bytes(int bf16, int hd, int cross) {
#define WKV_SMEM(HD)                                                       \
    if (hd == HD) {                                                        \
        if (cross) return static_cast<int>(cross_smem_bytes<HD, kChunk>()); \
        return static_cast<int>(                                           \
            bf16 ? ChunkSmem<__nv_bfloat16, HD, kChunk>::bytes()           \
                 : ChunkSmem<float, HD, kChunk>::bytes());                 \
    }
    WKV_SMEM(32)
    WKV_SMEM(64)
#undef WKV_SMEM
    return -1;
}

}  // extern "C"
