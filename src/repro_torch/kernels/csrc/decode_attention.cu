// One-token grouped-query decode attention over a linear KV cache, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_grouped. For batch row b, kv head c and its G query
// heads g (query head c * G + g), in f32:
//     s_gj = (q_g . k_j) * scale for cache rows j < lengths[b], else -1e30,
//     out_g = sum_j exp(s_gj - m_g) v_j / max(sum_j exp(s_gj - m_g), 1e-30)
// with V rows at or past lengths[b] zeroed and the running max, sum and
// accumulator kept in f32 across kv tiles, as the TPU kernel keeps them in
// scratch across its sequential kv grid axis. Inputs are f32 or bf16; the
// output is written in the input type.
//
// Bound: memory. Each valid cache row is read once for all G heads
// (2 * hd values of K and V) and takes 4 * G * hd FLOPs: for qwen2-0.5b
// (G = 7, hd = 64, bf16) that is 7 FLOP per byte, far below the card's
// ~295 FLOP/B balance point. At the serving path's shape (8 rows, 2 kv
// heads, at most 512 cached tokens) one call moves at most 2 MB, under a
// microsecond at 3.35 TB/s, so launch and latency dominate in practice.
//
// Design: one block of 256 threads per (kv head, batch row), which keeps
// the G query heads of a kv head together, as the TPU kernel's [G, hd]
// tile does, so every K and V row is read from device memory once. The
// block loops over the row's valid length only, in tiles of 64 cache rows
// staged in shared memory with 16-byte loads (rows past the length are
// zero-filled, never read); it scores the G x 64 logits into shared
// memory, one warp per head updates the running max and sum, and each
// thread owns NO of the G * hd outputs in registers across tiles. The
// cache is read where it lies: k and v come as [B, T, KV, hd] slices of
// the arena with their strides, and lengths are read on the device, so
// the step needs neither a transpose nor a host sync. Splitting long
// caches across blocks (flash-decoding) is left for a later version. The
// kernel launches on the caller's stream, allocates nothing, and each
// entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using attn::kNegInf;
using attn::kTileRows;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Strides {
    int64_t b, t, h;   // elements between batch rows, positions, heads
};

template <typename T, int HD, int NO>
__global__ void __launch_bounds__(kThreads)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ lengths,
           T* __restrict__ out, int Tk, int H, int group, int64_t qsb,
           int64_t qsh, Strides ks, Strides vs, float scale) {
    constexpr int kPitch = attn::pitch<T, HD>();
    extern __shared__ __align__(16) unsigned char smem[];
    T* k_tile = reinterpret_cast<T*>(smem);
    T* v_tile = k_tile + kTileRows * kPitch;
    float* q_s = reinterpret_cast<float*>(v_tile + kTileRows * kPitch);
    float* p_s = q_s + group * HD;            // [G, 64] logits, then probs
    float* m_s = p_s + group * kTileRows;     // [G] running max
    float* l_s = m_s + group;                 // [G] running sum
    float* c_s = l_s + group;                 // [G] this tile's correction

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int len = min(max(lengths[b], 0), Tk);
    const int nout = group * HD;

    for (int i = tid; i < nout; i += kThreads) {
        q_s[i] = attn::to_f32(q[b * qsb + (kvh * group + i / HD) * qsh + i % HD]);
    }
    for (int g = tid; g < group; g += kThreads) {
        m_s[g] = kNegInf;
        l_s[g] = 0.f;
    }
    const T* k_head = k + b * ks.b + kvh * ks.h;
    const T* v_head = v + b * vs.b + kvh * vs.h;

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < len; k0 += kTileRows) {
        __syncthreads();   // q_s ready / the previous tile is consumed
        attn::load_tile<T, HD>(k_tile, k_head, ks.t, k0, len, tid, kThreads);
        attn::load_tile<T, HD>(v_tile, v_head, vs.t, k0, len, tid, kThreads);
        __syncthreads();

        // logits: one (head, cache row) pair per thread and step
        for (int i = tid; i < group * kTileRows; i += kThreads) {
            const int g = i / kTileRows;
            const int t = i % kTileRows;
            const float* qg = q_s + g * HD;
            const T* kt = k_tile + t * kPitch;
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < HD; d += 8) {
                float kv[8];
                attn::load8(kt + d, kv);
#pragma unroll
                for (int e = 0; e < 8; ++e) s = fmaf(qg[d + e], kv[e], s);
            }
            p_s[i] = k0 + t < len ? s * scale : kNegInf;
        }
        __syncthreads();

        // running max and sum: one warp per head, two logits per lane
        for (int g = warp; g < group; g += kWarps) {
            float* pg = p_s + g * kTileRows;
            const float a = pg[lane];
            const float c = pg[lane + 32];
            float tmax = fmaxf(a, c);
#pragma unroll
            for (int o = 16; o > 0; o /= 2) {
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
            }
            const float m_old = m_s[g];
            const float m_new = fmaxf(m_old, tmax);
            const float pa = expf(a - m_new);
            const float pc = expf(c - m_new);
            pg[lane] = pa;
            pg[lane + 32] = pc;
            float sum = pa + pc;
#pragma unroll
            for (int o = 16; o > 0; o /= 2) {
                sum += __shfl_xor_sync(0xffffffffu, sum, o);
            }
            if (lane == 0) {
                const float corr = expf(m_old - m_new);
                l_s[g] = l_s[g] * corr + sum;
                m_s[g] = m_new;
                c_s[g] = corr;
            }
        }
        __syncthreads();

        // acc = acc * corr + p @ v for the outputs this thread owns
#pragma unroll
        for (int i = 0; i < NO; ++i) {
            const int o = tid + i * kThreads;
            if (o < nout) {
                const int g = o / HD;
                const int d = o % HD;
                const float* pg = p_s + g * kTileRows;
                float a = acc[i] * c_s[g];
#pragma unroll 8
                for (int t = 0; t < kTileRows; ++t) {
                    a = fmaf(pg[t], attn::to_f32(v_tile[t * kPitch + d]), a);
                }
                acc[i] = a;
            }
        }
    }
    __syncthreads();   // l_s is final (also when the row holds no token)

#pragma unroll
    for (int i = 0; i < NO; ++i) {
        const int o = tid + i * kThreads;
        if (o < nout) {
            const int g = o / HD;
            T* dst = out + (static_cast<int64_t>(b) * H + kvh * group + g) * HD +
                     o % HD;
            attn::store(dst, acc[i] / fmaxf(l_s[g], 1e-30f));
        }
    }
}

template <typename T, int HD, int NO>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int Tk, int H, int KV, int64_t qsb, int64_t qsh,
           const Strides& ks, const Strides& vs, float scale,
           cudaStream_t stream) {
    constexpr int kPitch = attn::pitch<T, HD>();
    const int group = H / KV;
    const size_t smem = sizeof(T) * kPitch * 2 * kTileRows +
                        sizeof(float) * (group * HD + group * kTileRows + 3 * group);
    cudaError_t err = attn::allow_smem(decode_fwd<T, HD, NO>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(KV, B);
    decode_fwd<T, HD, NO><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lengths, static_cast<T*>(out), Tk, H, group,
        qsb, qsh, ks, vs, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_outputs(const void* q, const void* k, const void* v,
               const int* lengths, void* out, int B, int Tk, int H, int KV,
               int64_t qsb, int64_t qsh, const Strides& ks, const Strides& vs,
               float scale, cudaStream_t stream) {
    const int per_thread = ((H / KV) * HD + kThreads - 1) / kThreads;
    if (per_thread <= 1)
        return launch<T, HD, 1>(q, k, v, lengths, out, B, Tk, H, KV, qsb, qsh,
                                ks, vs, scale, stream);
    if (per_thread <= 2)
        return launch<T, HD, 2>(q, k, v, lengths, out, B, Tk, H, KV, qsb, qsh,
                                ks, vs, scale, stream);
    if (per_thread <= 4)
        return launch<T, HD, 4>(q, k, v, lengths, out, B, Tk, H, KV, qsb, qsh,
                                ks, vs, scale, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int B, int Tk, int H, int KV, int hd, int64_t qsb,
             int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
             int64_t vst, int64_t vsh, float scale, void* stream) {
    const Strides ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
    const int* lens = static_cast<const int*>(lengths);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:
            return by_outputs<T, 32>(q, k, v, lens, out, B, Tk, H, KV, qsb, qsh,
                                     ks, vs, scale, s);
        case 64:
            return by_outputs<T, 64>(q, k, v, lens, out, B, Tk, H, KV, qsb, qsh,
                                     ks, vs, scale, s);
        case 128:
            return by_outputs<T, 128>(q, k, v, lens, out, B, Tk, H, KV, qsb,
                                      qsh, ks, vs, scale, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Entry points. q: [B, H, hd] by its base pointer and the element strides
// of its first two dims; k, v: [B, T, KV, hd] by base pointer and element
// strides of their first three dims (the last dim of every operand is
// contiguous); lengths: int32 [B] on the device; out: a contiguous
// [B, H, hd] buffer of q's type. K/V pointers and strides in bytes are
// multiples of 16; hd is 32, 64 or 128; H is a multiple of KV with
// (H / KV) * hd <= 1024. stream is a cudaStream_t. Each returns
// cudaGetLastError() after its launch.
extern "C" {

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int B, int T, int H,
                         int KV, int hd, int64_t qsb, int64_t qsh, int64_t ksb,
                         int64_t kst, int64_t ksh, int64_t vsb, int64_t vst,
                         int64_t vsh, float scale, void* stream) {
    return dispatch<float>(q, k, v, lengths, out, B, T, H, KV, hd, qsb, qsh,
                           ksb, kst, ksh, vsb, vst, vsh, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, int B, int T, int H,
                          int KV, int hd, int64_t qsb, int64_t qsh,
                          int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                          int64_t vst, int64_t vsh, float scale,
                          void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, T, H, KV, hd, qsb,
                                   qsh, ksb, kst, ksh, vsb, vst, vsh, scale,
                                   stream);
}

}  // extern "C"
