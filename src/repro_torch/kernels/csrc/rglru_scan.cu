// RG-LRU gated linear recurrence for Hopper, with its gate math fused in and
// the state carried in and out.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:rglru_scan_bsw,
// h_t = a_t * h_{t-1} + u_t, together with the ops of the RG-LRU block
// that make a and u from the two gate products (models/rglru.py). For each
// batch row b and channel w, from ga = xa @ W_a, gi = xa @ W_i and xa (all
// [B, S, W] in the compute type T, f32 or bf16) and b_a, b_i, lamb ([W], T):
//     r   = T(sigmoid(T(ga + b_a)))        i = T(sigmoid(T(gi + b_i)))
//     a   = exp((-8 * softplus(f32(lamb))) * f32(r))                 (f32)
//     u   = sqrt(max(1 - a * a, 1e-12)) * f32(T(i * xa))              (f32)
//     h_t = a_t * h_{t-1} + u_t,   out_t = T(h_t)
// where T(x) rounds an f32 value to T (nearest-even; nothing for f32) and
// sigmoid(x) = 1 / (1 + exp(-x)), softplus(x) = x > 20 ? x : log1p(exp(x)).
// These are PyTorch's own ops on the card, in its order and roundings
// (each op computes in f32 and rounds to its output type once): every
// product, sum and quotient is rounded alone (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn; never contracted into an FMA) and exp and log1p
// are CUDA's expf and log1pf, so the kernel equals its plain PyTorch
// version (`ref.rglru_gated`) bit for bit. Unlike the TPU kernel, which
// starts from zero and drops its final state, h_0 is read from `state`
// (f32 [B, W]) and the final h written back to it (in place), so decode
// steps and prompts cut in pieces continue where the last call stopped.
//
// Bound: memory. One call reads ga, gi and xa (2 B each per element in
// bf16), the three [W] parameters and the state, and writes out and the
// state; at recurrentgemma-2b's width (W = 2560) a bf16 prefill of 200
// steps at batch 1 is ~4.1 MB (~1.2 us at 3.35 TB/s), for ~21 operations
// an element. The walk over time is sequential per channel, so at batch 1
// only W = 2560 chains exist.
//
// Design. Up to kDirectMaxSteps steps (decode) take the direct body: one
// thread per (b, channel), 128 a block, every step's inputs loaded
// straight into registers. Longer prompts take the tiled body: a block
// owns CH = 16 channels of one batch row (grid (ceil(W / CH), B): 160
// blocks at batch 1) and 8 warps. It walks time in tiles of 64
// steps: the inputs of the next kStages - 1 = 3 tiles are in flight into a
// ring in shared memory through cp.async (16 bytes a copy; element loads
// where a piece reaches past W) while the block's other warps compute a
// and u
// for every step of the next tile in parallel (nothing there depends on
// h), and the first warp (one thread per channel) walks the current tile
// out of shared memory, h_t = a_t h_{t-1} + u_t, writing each step's
// output. The parameters' per-channel terms (the biases, -8 softplus(lamb))
// are loaded once a block. Operands are read through their batch and time
// strides (the last dim contiguous). The kernel launches on the caller's
// stream, allocates nothing, and each entry point returns
// cudaGetLastError().
//
// The backward (`rglru_bwd`, entry points rglru_scan_bwd_*): the gradient
// of the gate math and the recurrence, for training; see its note below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"   // cp.async helpers

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTile = 64;       // time steps a tile
constexpr int kStages = 4;      // raw tiles in flight or in use
constexpr int kChannels = 16;   // channels a block (32 and 64 measured)
constexpr int kDirectMaxSteps = 4;   // the most steps the direct body takes
constexpr int kDirectThreads = 128;

struct Seq {
    int64_t b, s;   // element strides of a [B, S, W] operand
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
// x rounded to T and back: PyTorch's rounding of an op's f32 result
template <typename T>
__device__ __forceinline__ float round_to(float x) {
    if constexpr (std::is_same<T, float>::value) {
        return x;
    } else {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// torch.sigmoid on the card: 1 / (1 + exp(-x)) in f32
__device__ __forceinline__ float sigmoid(float x) {
    return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// One step's gate values: r, i and a, 1 - a^2 before its clamp, and i * xa
// rounded to the compute type (f32 values).
struct Gate {
    float r, i, a, one_m, gated;
};

// sqrt(max(1 - a^2, 1e-12))
__device__ __forceinline__ float scale_of(float one_m) {
    const float floor = static_cast<float>(1e-12);
    return __fsqrt_rn(one_m < floor ? floor : one_m);
}

// A channel's per-channel terms: its two biases and -8 softplus(lamb).
struct Channel {
    float bias_a = 0.f, bias_i = 0.f, neg_sp = 0.f;
    template <typename T>
    __device__ __forceinline__ void load(const T* ba, const T* bi,
                                         const T* lamb, int w) {
        bias_a = to_f32(ba[w]);
        bias_i = to_f32(bi[w]);
        const float l = to_f32(lamb[w]);
        // F.softplus (beta 1, threshold 20), then the scalar -8 (exact)
        const float sp = l > 20.f ? l : log1pf(expf(l));
        neg_sp = __fmul_rn(sp, -8.f);
    }
    // the gates, the decay, 1 - a^2 (unclamped) and i * xa of one step
    // from its gate products and xa, in the block's order and roundings
    template <typename T>
    __device__ __forceinline__ Gate parts(float xg, float xi,
                                          float x) const {
        Gate g;
        g.r = round_to<T>(sigmoid(round_to<T>(__fadd_rn(xg, bias_a))));
        g.i = round_to<T>(sigmoid(round_to<T>(__fadd_rn(xi, bias_i))));
        g.a = expf(__fmul_rn(neg_sp, g.r));
        g.gated = round_to<T>(__fmul_rn(g.i, x));
        g.one_m = __fsub_rn(1.f, __fmul_rn(g.a, g.a));
        return g;
    }
    // a and u of one step
    template <typename T>
    __device__ __forceinline__ void gates(float xg, float xi, float x,
                                          float& a, float& u) const {
        const Gate g = parts<T>(xg, xi, x);
        a = g.a;
        u = __fmul_rn(scale_of(g.one_m), g.gated);
    }
};

// The shared memory of one block: a ring of kStages tiles of the raw inputs
// (ga, gi, xa: [3][kTile][CH] of T) and two tiles of a and u ([2][kTile][CH]
// f32).
template <typename T, int CH>
struct ScanSmem {
    static constexpr int kRaw = 3 * kTile * CH;   // elements of a raw tile
    static constexpr int kAu = 2 * kTile * CH;    // floats of an a, u tile
    static constexpr size_t bytes() {
        return kStages * sizeof(T) * kRaw + 2 * sizeof(float) * kAu;
    }
};

// Issue the copies of tile rows [t0, t0 + n) of ga, gi and xa for this
// block's channels [w0, w0 + CH) into raw (the wrapper guarantees 16-byte
// aligned bases and strides); a 16-byte piece that reaches past W is
// loaded element by element (nothing past W is read).
template <typename T, int CH>
__device__ __forceinline__ void stage_tile(T* raw, const T* const (&src)[3],
                                           const Seq (&st)[3], int t0, int n,
                                           int w0, int W, int tid) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kPieces = CH / kPer;   // per row of one input
    for (int i = tid; i < 3 * n * kPieces; i += kThreads) {
        const int x = i / (n * kPieces);
        const int t = (i / kPieces) % n;
        const int c = (i % kPieces) * kPer;
        const T* from = src[x] + (t0 + t) * st[x].s + w0 + c;
        T* to = raw + (x * kTile + t) * CH + c;
        if (w0 + c + kPer <= W) {
            attn::cp_async16(to, from, true);
        } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                if (w0 + c + j < W) to[j] = from[j];
            }
        }
    }
}

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const T* __restrict__ ga, const T* __restrict__ gi,
          const T* __restrict__ ba, const T* __restrict__ bi,
          const T* __restrict__ lamb, const T* __restrict__ xa,
          T* __restrict__ out, float* __restrict__ state, int S, int W,
          Seq gas, Seq gis, Seq xas, Seq os) {
    using Sm = ScanSmem<T, CH>;
    constexpr int kWalkers = (CH + 31) / 32 * 32;   // whole warps walk
    constexpr int kWorkers = kThreads - kWalkers;   // the rest compute a, u
    static_assert(kWorkers % CH == 0, "workers cover whole rows");
    constexpr int kRowsAtOnce = kWorkers / CH;
    constexpr int kStepsPerWorker = (kTile + kRowsAtOnce - 1) / kRowsAtOnce;
    extern __shared__ __align__(16) unsigned char smem[];
    T* raw = reinterpret_cast<T*>(smem);       // [kStages][kRaw]
    float* au =                                // [2][kAu]
        reinterpret_cast<float*>(raw + kStages * Sm::kRaw);

    const int w0 = blockIdx.x * CH;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const T* const src[3] = {ga + b * gas.b, gi + b * gis.b, xa + b * xas.b};
    const Seq st[3] = {gas, gis, xas};
    const int tiles = (S + kTile - 1) / kTile;

    // a worker's channel and its per-channel terms
    const bool worker = tid >= kWalkers;
    const int wc = (tid - kWalkers) % CH;
    const int wrow = (tid - kWalkers) / CH;
    Channel ch;
    if (worker && w0 + wc < W) ch.load(ba, bi, lamb, w0 + wc);
    // a walker's channel and state
    const bool walker = tid < CH && w0 + tid < W;
    float h = walker ? state[static_cast<int64_t>(b) * W + w0 + tid] : 0.f;
    T* ob = out + b * os.b + w0 + tid;

    // the first kStages - 1 tiles, one commit group each (empty past S)
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
        if (j < tiles) {
            stage_tile<T, CH>(raw + j * Sm::kRaw, src, st, j * kTile,
                              min(kTile, S - j * kTile), w0, W, tid);
        }
        attn::cp_async_commit();
    }
    for (int it = 0; it <= tiles; ++it) {
        attn::cp_async_wait<kStages - 2>();
        __syncthreads();   // tile it landed; tile it - 1's a, u are done
        const int next = it + kStages - 1;   // into the slot tile it - 1 left
        if (next < tiles) {
            stage_tile<T, CH>(raw + (next % kStages) * Sm::kRaw, src, st,
                              next * kTile, min(kTile, S - next * kTile), w0,
                              W, tid);
        }
        attn::cp_async_commit();
        if (worker && it < tiles && w0 + wc < W) {
            // a and u of tile it, every step at once
            const T* rt = raw + (it % kStages) * Sm::kRaw;
            float* at = au + (it % 2) * Sm::kAu;
            const int n = min(kTile, S - it * kTile);
            // a worker's steps are independent: unrolled, they overlap
#pragma unroll
            for (int j = 0; j < kStepsPerWorker; ++j) {
                const int t = wrow + j * kRowsAtOnce;
                if (t < n) {
                    float a, u;
                    ch.gates<T>(to_f32(rt[t * CH + wc]),
                                to_f32(rt[(kTile + t) * CH + wc]),
                                to_f32(rt[(2 * kTile + t) * CH + wc]), a, u);
                    at[t * CH + wc] = a;
                    at[(kTile + t) * CH + wc] = u;
                }
            }
        }
        if (walker && it >= 1) {
            // walk tile it - 1
            const float* at = au + ((it - 1) % 2) * Sm::kAu;
            const int tb = (it - 1) * kTile;
            const int n = min(kTile, S - tb);
            int t = 0;
            for (; t + 4 <= n; t += 4) {
                float av[4], uv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    av[j] = at[(t + j) * CH + tid];
                    uv[j] = at[(kTile + t + j) * CH + tid];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    h = __fadd_rn(__fmul_rn(av[j], h), uv[j]);
                    store(ob + static_cast<int64_t>(tb + t + j) * os.s, h);
                }
            }
            for (; t < n; ++t) {
                h = __fadd_rn(__fmul_rn(at[t * CH + tid], h),
                              at[(kTile + t) * CH + tid]);
                store(ob + static_cast<int64_t>(tb + t) * os.s, h);
            }
        }
    }
    if (walker) state[static_cast<int64_t>(b) * W + w0 + tid] = h;
}

// The direct body for a few steps (decode): one thread per (b, channel),
// each step's inputs read straight into registers, the same arithmetic.
template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
rglru_fwd_direct(const T* __restrict__ ga, const T* __restrict__ gi,
                 const T* __restrict__ ba, const T* __restrict__ bi,
                 const T* __restrict__ lamb, const T* __restrict__ xa,
                 T* __restrict__ out, float* __restrict__ state, int S,
                 int W, Seq gas, Seq gis, Seq xas, Seq os) {
    const int w = blockIdx.x * kDirectThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (w >= W) return;
    Channel ch;
    ch.load(ba, bi, lamb, w);
    float* st = state + static_cast<int64_t>(b) * W + w;
    float h = *st;
    for (int t = 0; t < S; ++t) {
        float a, u;
        ch.gates<T>(to_f32(ga[b * gas.b + t * gas.s + w]),
                    to_f32(gi[b * gis.b + t * gis.s + w]),
                    to_f32(xa[b * xas.b + t * xas.s + w]), a, u);
        h = __fadd_rn(__fmul_rn(a, h), u);
        store(out + b * os.b + t * os.s + w, h);
    }
    *st = h;
}

// The backward (the port's own: the TPU kernel has none, and the
// reference differentiates its jnp scan). One thread per (b, channel), 128
// a block: it walks time forward, recomputing every step's a and u from
// the gate products as the forward does (the same code, so the same bits)
// and writing the f32 h to `hs` (the forward's output is rounded to T, so
// it is no f32 h); then it walks back, with the carry c_t = a_{t+1}
// dh_{t+1} (dh_final past the end):
//     dh_t = dout_t + c_t,   da_t = dh_t h_{t-1},   du_t = dh_t
// and back through the gate math, each op rounded alone as
// `ref.rglru_gated_bwd` states it:
//     dgated = dh scale,  dscale = dh gated,
//     dclamp = dscale / (2 scale) where 1 - a^2 >= 1e-12, else 0,
//     da -= 2 a dclamp,  dlog_a = da a,  dr = dlog_a (-8 softplus(lamb)),
//     dgate_a = dr (1 - r) r,  di = dgated xa,  dgate_i = di (1 - i) i,
//     dxa = dgated i.
// db_a, db_i and dlamb (sum_t dlog_a r, times -8 softplus'(lamb)) are
// summed over t in reverse for the thread's (b, channel), and dh0 = c_{-1}
// written last. Bound: memory (ga, gi, xa, dout read twice or once, dgate_a,
// dgate_i, dxa and hs written, hs read back). No atomics: a repeat is
// bitwise.
template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
rglru_bwd(const T* __restrict__ ga, const T* __restrict__ gi,
          const T* __restrict__ ba, const T* __restrict__ bi,
          const T* __restrict__ lamb, const T* __restrict__ xa,
          const float* __restrict__ state, const T* __restrict__ dout,
          const float* __restrict__ dh_final, float* __restrict__ dga,
          float* __restrict__ dgi, float* __restrict__ dxa,
          float* __restrict__ dba, float* __restrict__ dbi,
          float* __restrict__ dlamb, float* __restrict__ dh0,
          float* __restrict__ hs, int S, int W, Seq gas, Seq gis, Seq xas,
          Seq dos) {
    const int w = blockIdx.x * kDirectThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (w >= W) return;
    Channel ch;
    ch.load(ba, bi, lamb, w);
    const int64_t bw = static_cast<int64_t>(b) * W + w;
    const int64_t base = static_cast<int64_t>(b) * S * W + w;   // [B, S, W]
    const float h0 = state[bw];
    float h = h0;
#pragma unroll 4
    for (int t = 0; t < S; ++t) {
        float a, u;
        ch.gates<T>(to_f32(ga[b * gas.b + t * gas.s + w]),
                    to_f32(gi[b * gis.b + t * gis.s + w]),
                    to_f32(xa[b * xas.b + t * xas.s + w]), a, u);
        h = __fadd_rn(__fmul_rn(a, h), u);
        hs[base + static_cast<int64_t>(t) * W] = h;
    }
    float carry = dh_final ? dh_final[bw] : 0.f;
    float acc_a = 0.f, acc_i = 0.f, acc_l = 0.f;
#pragma unroll 4
    for (int t = S - 1; t >= 0; --t) {
        const float x = to_f32(xa[b * xas.b + t * xas.s + w]);
        const Gate g = ch.parts<T>(to_f32(ga[b * gas.b + t * gas.s + w]),
                                   to_f32(gi[b * gis.b + t * gis.s + w]), x);
        const float scale = scale_of(g.one_m);
        const float hp =
            t > 0 ? hs[base + static_cast<int64_t>(t - 1) * W] : h0;
        const float dh =
            __fadd_rn(to_f32(dout[b * dos.b + t * dos.s + w]), carry);
        const float dgated = __fmul_rn(dh, scale);
        const float dclamp = __fdiv_rn(__fmul_rn(dh, g.gated),
                                       __fmul_rn(2.f, scale));
        const float done =
            g.one_m >= static_cast<float>(1e-12) ? dclamp : 0.f;
        const float da = __fsub_rn(__fmul_rn(dh, hp),
                                   __fmul_rn(2.f, __fmul_rn(done, g.a)));
        const float dlog = __fmul_rn(da, g.a);
        const float dgav = __fmul_rn(
            __fmul_rn(__fmul_rn(dlog, ch.neg_sp), __fsub_rn(1.f, g.r)), g.r);
        const float dgiv = __fmul_rn(
            __fmul_rn(__fmul_rn(dgated, x), __fsub_rn(1.f, g.i)), g.i);
        const int64_t o = base + static_cast<int64_t>(t) * W;
        dga[o] = dgav;
        dgi[o] = dgiv;
        dxa[o] = __fmul_rn(dgated, g.i);
        acc_a = __fadd_rn(acc_a, dgav);
        acc_i = __fadd_rn(acc_i, dgiv);
        acc_l = __fadd_rn(acc_l, __fmul_rn(dlog, g.r));
        carry = __fmul_rn(g.a, dh);
    }
    // softplus'(lamb): 1 past PyTorch's threshold of 20, else sigmoid
    const float l = to_f32(lamb[w]);
    const float dsoft = l > 20.f ? 1.f : sigmoid(l);
    dh0[bw] = carry;
    dba[bw] = acc_a;
    dbi[bw] = acc_i;
    dlamb[bw] = __fmul_rn(__fmul_rn(acc_l, -8.f), dsoft);
}

template <typename T>
int launch_bwd(void* const* p, int B, int S, int W, const int64_t* st,
               void* stream) {
    const Seq gas{st[0], st[1]}, gis{st[2], st[3]}, xas{st[4], st[5]},
        dos{st[6], st[7]};
    const dim3 grid((W + kDirectThreads - 1) / kDirectThreads, B);
    rglru_bwd<T><<<grid, kDirectThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
        static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
        static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
        static_cast<const float*>(p[6]), static_cast<const T*>(p[7]),
        static_cast<const float*>(p[8]), static_cast<float*>(p[9]),
        static_cast<float*>(p[10]), static_cast<float*>(p[11]),
        static_cast<float*>(p[12]), static_cast<float*>(p[13]),
        static_cast<float*>(p[14]), static_cast<float*>(p[15]),
        static_cast<float*>(p[16]), S, W, gas, gis, xas, dos);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ga, const void* gi, const void* ba, const void* bi,
           const void* lamb, const void* xa, void* out, void* state, int B,
           int S, int W, const int64_t* st, void* stream) {
    constexpr int CH = kChannels;
    const Seq gas{st[0], st[1]}, gis{st[2], st[3]}, xas{st[4], st[5]},
        os{st[6], st[7]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (S <= kDirectMaxSteps) {
        const dim3 grid((W + kDirectThreads - 1) / kDirectThreads, B);
        rglru_fwd_direct<T><<<grid, kDirectThreads, 0, s>>>(
            static_cast<const T*>(ga), static_cast<const T*>(gi),
            static_cast<const T*>(ba), static_cast<const T*>(bi),
            static_cast<const T*>(lamb), static_cast<const T*>(xa),
            static_cast<T*>(out), static_cast<float*>(state), S, W, gas, gis,
            xas, os);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t bytes = ScanSmem<T, CH>::bytes();
    cudaFuncSetAttribute(rglru_fwd<T, CH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const dim3 grid((W + CH - 1) / CH, B);
    rglru_fwd<T, CH><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(ga), static_cast<const T*>(gi),
        static_cast<const T*>(ba), static_cast<const T*>(bi),
        static_cast<const T*>(lamb), static_cast<const T*>(xa),
        static_cast<T*>(out), static_cast<float*>(state), S, W, gas, gis, xas,
        os);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points. ga, gi and xa ([B, S, W], of the entry's type) come by base
// pointer, with the element strides of their first two dims in `strides`
// (8 values: ga, gi, xa, out, each as b, s); the last dim of each is
// contiguous. ba, bi, lamb: contiguous [W] of the entry's type. out: [B, S,
// W] of the entry's type. state: contiguous f32 [B, W], read as h_0 and
// overwritten with the final h. stream is a cudaStream_t. Each returns
// cudaGetLastError() after its launch.
extern "C" {

int rglru_scan_f32(const void* ga, const void* gi, const void* ba,
                   const void* bi, const void* lamb, const void* xa,
                   void* out, void* state, int B, int S, int W,
                   const int64_t* strides, void* stream) {
    return launch<float>(ga, gi, ba, bi, lamb, xa, out, state, B, S, W,
                         strides, stream);
}

int rglru_scan_bf16(const void* ga, const void* gi, const void* ba,
                    const void* bi, const void* lamb, const void* xa,
                    void* out, void* state, int B, int S, int W,
                    const int64_t* strides, void* stream) {
    return launch<__nv_bfloat16>(ga, gi, ba, bi, lamb, xa, out, state, B, S,
                                 W, strides, stream);
}

// The backward. p: 17 pointers, in order ga, gi, b_a, b_i, lamb, xa (the
// entry's type, as the forward takes them), state (the forward's incoming
// f32 h, [B, W]), dout ([B, S, W], the entry's type), dh_final (f32 [B, W],
// or null for zero), then the f32 outputs dgate_a, dgate_i, dxa
// (contiguous [B, S, W]), db_a, db_i, dlamb (per batch row, contiguous
// [B, W]) and dh0 ([B, W]), and the f32 scratch hs (contiguous [B, S, W]).
// strides: 8 values, ga, gi, xa, dout, each as b, s (elements; the last
// dim contiguous).
int rglru_scan_bwd_f32(void* const* p, int B, int S, int W,
                       const int64_t* strides, void* stream) {
    return launch_bwd<float>(p, B, S, W, strides, stream);
}

int rglru_scan_bwd_bf16(void* const* p, int B, int S, int W,
                        const int64_t* strides, void* stream) {
    return launch_bwd<__nv_bfloat16>(p, B, S, W, strides, stream);
}

// Dynamic shared bytes of a launch for bf16 (or f32) inputs.
int rglru_scan_smem_bytes(int bf16) {
    return static_cast<int>(bf16 ? ScanSmem<__nv_bfloat16, kChannels>::bytes()
                                 : ScanSmem<float, kChannels>::bytes());
}

}  // extern "C"
