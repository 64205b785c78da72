// Causal / sliding-window GQA prefill attention (online softmax) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bhsd. For query head h (kv head h / G), row i and kv
// position j, in f32:
//     s_ij = (q_i . k_j) * scale, masked to -1e30 unless j < T and
//            (not causal or j <= i) and (window <= 0 or j > i - window);
//     out_i = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
// with the running max m, sum l and accumulator kept in f32 across kv
// tiles, as the TPU kernel keeps them in VMEM scratch. Inputs are f32 or
// bf16; the output is written in the input type.
//
// Bound: at the serving paths' shapes the work is small: one prompt of
// Sp = 256, 14 heads of 64, 2 kv heads, bf16 (qwen2-0.5b) is ~30 MFLOP over
// ~1.1 MB, and one of 200 tokens, 10 heads of 256 over 1 kv head
// (recurrentgemma-2b) ~0.2 GFLOP over ~1.2 MB: the launch and the latency
// of the few dependent tile steps bound them. At long prompts the FLOPs
// grow as Sp * min(Sp, window) and the operations bound it (tensor-core
// peak).
//
// Design: the TPU grid walks kv blocks in sequence into scratch; here one
// block of 256 threads owns one (batch, head, tile of 64 query rows) and
// loops over kv tiles of 64 rows itself. Q, K and V tiles are staged in
// shared memory in the input type (33 KB per bf16 64x256 tile, rows padded
// by 16 bytes against bank conflicts). Four threads share a query row: each
// scores 16 of the tile's 64 columns with plain f32 FMAs, the row's max is
// combined with two shuffles, and each keeps its own partial sum over its
// columns. The row's probabilities are then staged in shared memory (the
// four threads lie in one warp, so a warp barrier suffices), and for
// p @ V each thread owns a quarter of the head dim, in 8-wide chunks
// interleaved with its row's other threads (neighbouring lanes read
// neighbouring 16 bytes of a V row): HD / 4 f32 accumulators a thread, 64
// at HD = 256, where a whole [HD] row would not fit in 255 registers.
// Tiles wholly above the causal diagonal or wholly before the window are
// not visited: they would add exactly 0 (the diagonal tile holds a valid
// entry for every row). Tensor cores (mma/wgmma) and TMA are left for a
// later version. The caller passes the model's [B, S, heads, HD] layouts
// by strides, so nothing is transposed or copied before the launch. The
// kernel launches on the caller's stream, allocates nothing, and each
// entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using attn::kNegInf;
using attn::kTileRows;

constexpr int kThreads = 256;
constexpr int kRowThreads = 4;                    // threads per query row
constexpr int kQRows = kThreads / kRowThreads;    // 64 query rows per block
constexpr int kCols = kTileRows / kRowThreads;    // kv columns per thread
constexpr int kPPitch = kTileRows + 4;   // row pitch of the staged P tile

// Dynamic shared memory: the Q, K and V tiles and the f32 P tile.
template <typename T, int HD>
constexpr size_t smem_bytes() {
    return sizeof(T) * attn::pitch<T, HD>() * (kQRows + 2 * kTileRows) +
           sizeof(float) * kQRows * kPPitch;
}

struct Strides {
    int64_t b, s, h;   // elements between batch rows, positions, heads
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int Tk, int H,
          int group, Strides qs, Strides ks, Strides vs, int causal,
          int window, float scale) {
    constexpr int kPitch = attn::pitch<T, HD>();
    constexpr int kChunks = HD / (8 * kRowThreads);   // 8-wide dim chunks
    extern __shared__ __align__(16) unsigned char smem[];
    T* q_tile = reinterpret_cast<T*>(smem);
    T* k_tile = q_tile + kQRows * kPitch;
    T* v_tile = k_tile + kTileRows * kPitch;
    float* p_tile = reinterpret_cast<float*>(v_tile + kTileRows * kPitch);

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * kQRows;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / group;
    const int row = tid / kRowThreads;     // query row within the tile
    const int part = tid % kRowThreads;    // its columns and dim chunks
    const int qi = q0 + row;
    float* p_row = p_tile + row * kPPitch;

    attn::load_tile<T, HD>(q_tile, q + b * qs.b + h * qs.h, qs.s, q0, S, tid,
                           kThreads);
    const T* k_head = k + b * ks.b + kvh * ks.h;
    const T* v_head = v + b * vs.b + kvh * vs.h;

    int kv_lo = 0;
    int kv_hi = Tk;
    if (causal) kv_hi = min(Tk, q0 + kQRows);
    if (window > 0) kv_lo = max(0, q0 - window + 1);
    kv_lo -= kv_lo % kTileRows;

    float m = kNegInf;     // the row's running max (same in its 4 threads)
    float l = 0.f;         // this thread's partial sum over its columns
    float acc[kChunks * 8];   // the row's output at this thread's dims
#pragma unroll
    for (int d = 0; d < kChunks * 8; ++d) acc[d] = 0.f;

    for (int k0 = kv_lo; k0 < kv_hi; k0 += kTileRows) {
        __syncthreads();   // the previous tile and P are consumed
        attn::load_tile<T, HD>(k_tile, k_head, ks.s, k0, Tk, tid, kThreads);
        attn::load_tile<T, HD>(v_tile, v_head, vs.s, k0, Tk, tid, kThreads);
        __syncthreads();

        float s[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 8) {
            float qv[8];
            attn::load8(q_tile + row * kPitch + d, qv);
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                float kv[8];
                attn::load8(k_tile + (part + kRowThreads * j) * kPitch + d, kv);
#pragma unroll
                for (int e = 0; e < 8; ++e) s[j] = fmaf(qv[e], kv[e], s[j]);
            }
        }
        float tmax = kNegInf;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            const int kj = k0 + part + kRowThreads * j;
            const bool ok = kj < Tk && (!causal || kj <= qi) &&
                            (window <= 0 || kj > qi - window);
            s[j] = ok ? s[j] * scale : kNegInf;
            tmax = fmaxf(tmax, s[j]);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m, tmax);
        const float corr = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            s[j] = expf(s[j] - m_new);
            psum += s[j];
            p_row[part + kRowThreads * j] = s[j];
        }
        l = l * corr + psum;
        __syncwarp();      // the row's 64 probabilities are staged

#pragma unroll
        for (int d = 0; d < kChunks * 8; ++d) acc[d] *= corr;
#pragma unroll 4
        for (int t = 0; t < kTileRows; ++t) {
            const float p = p_row[t];
            const T* v_row = v_tile + t * kPitch;
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
                float vv[8];
                attn::load8(v_row + (c * kRowThreads + part) * 8, vv);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    acc[c * 8 + e] = fmaf(p, vv[e], acc[c * 8 + e]);
                }
            }
        }
        m = m_new;
    }

    // the row's sum: its four partials (lanes 4r..4r+3 of the warp)
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qi >= S) return;
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * S + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            attn::store(o + (c * kRowThreads + part) * 8 + e,
                        acc[c * 8 + e] / denom);
        }
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, const Strides& qs, const Strides& ks,
           const Strides& vs, int causal, int window, float scale,
           cudaStream_t stream) {
    const size_t smem = smem_bytes<T, HD>();
    cudaError_t err = attn::allow_smem(flash_fwd<T, HD>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + kQRows - 1) / kQRows, H, B);
    flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, H / KV, qs,
        ks, vs, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int Tk, int H, int KV, int hd, int64_t qsb, int64_t qss,
             int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
             int64_t vst, int64_t vsh, int causal, int window, float scale,
             void* stream) {
    const Strides qs{qsb, qss, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:
            return launch<T, 32>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
                                 causal, window, scale, s);
        case 64:
            return launch<T, 64>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
                                 causal, window, scale, s);
        case 128:
            return launch<T, 128>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
                                  causal, window, scale, s);
        case 256:
            return launch<T, 256>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
                                  causal, window, scale, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Entry points. q: [B, S, H, hd] and k, v: [B, T, KV, hd], each given by
// its base pointer and element strides of its first three dims (the last
// dim is contiguous); out: a contiguous [B, S, H, hd] buffer of the same
// type. Pointers and strides in bytes are multiples of 16; hd is 32, 64,
// 128 or 256; H is a multiple of KV. stream is a cudaStream_t. Each returns
// cudaGetLastError() after its launch.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T, int H, int KV, int hd,
                        int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                        int64_t kst, int64_t ksh, int64_t vsb, int64_t vst,
                        int64_t vsh, int causal, int window, float scale,
                        void* stream) {
    return dispatch<float>(q, k, v, out, B, S, T, H, KV, hd, qsb, qss, qsh,
                           ksb, kst, ksh, vsb, vst, vsh, causal, window,
                           scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int T, int H, int KV,
                         int hd, int64_t qsb, int64_t qss, int64_t qsh,
                         int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                         int64_t vst, int64_t vsh, int causal, int window,
                         float scale, void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, hd, qsb, qss,
                                   qsh, ksb, kst, ksh, vsb, vst, vsh, causal,
                                   window, scale, stream);
}

}  // extern "C"
