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
// (G = 7, hd = 64, bf16) that is 7 FLOP per byte, and for recurrentgemma-2b
// (G = 10, hd = 256) 10, far below the card's ~295 FLOP/B balance point.
// At the serving paths' shapes (8 rows; 2 kv heads and at most 512 cached
// tokens, or 1 kv head of 256 and a ring of at most 2048) one call moves at
// most 2 MB (17 MB), under a microsecond (5 us) at 3.35 TB/s, so launch and
// latency dominate in practice.
//
// Design: one block of 256 threads per (kv head, batch row), which keeps
// the G query heads of a kv head together, as the TPU kernel's [G, hd]
// tile does, so every K and V row is read from device memory once. The
// block loops over the row's valid length only, in tiles of 64 cache rows
// staged in shared memory with 16-byte loads (rows past the length are
// zero-filled, never read); it scores the G x 64 logits into shared
// memory, one warp per head updates the running max and sum, and each
// thread owns NO of the G * hd outputs in registers across tiles (NO = 10
// at G * hd = 2560; any G, a power of two or not). The
// cache is read where it lies: k and v come as [B, T, KV, hd] slices of
// the arena with their strides, and lengths are read on the device, so
// the step needs neither a transpose nor a host sync. The block's body is
// attn::grouped_decode (attention_common.cuh), which the paged and ring
// kernels (decode_attention_paged.cu) share. Splitting long
// caches across blocks (flash-decoding) is left for a later version. The
// kernel launches on the caller's stream, allocates nothing, and each
// entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

constexpr int kThreads = attn::kDecodeThreads;

struct Strides {
    int64_t b, t, h;   // elements between batch rows, positions, heads
};

template <typename T, int HD, int NO>
__global__ void __launch_bounds__(kThreads)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ lengths,
           T* __restrict__ out, int Tk, int H, int group, int64_t qsb,
           int64_t qsh, Strides ks, Strides vs, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int len = min(max(lengths[b], 0), Tk);
    const attn::LinearRows<T> rows{k + b * ks.b + kvh * ks.h,
                                   v + b * vs.b + kvh * vs.h, ks.t, vs.t};
    attn::grouped_decode<T, HD, NO>(
        q + b * qsb + kvh * group * qsh, qsh, group, len, rows, scale,
        out + (static_cast<int64_t>(b) * H + kvh * group) * HD, smem);
}

template <typename T, int HD, int NO>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int Tk, int H, int KV, int64_t qsb, int64_t qsh,
           const Strides& ks, const Strides& vs, float scale,
           cudaStream_t stream) {
    const int group = H / KV;
    const size_t smem = attn::decode_smem_bytes<T, HD>(group);
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
    if (per_thread <= attn::kMaxDecodeOutputs)
        return launch<T, HD, attn::kMaxDecodeOutputs>(
            q, k, v, lengths, out, B, Tk, H, KV, qsb, qsh, ks, vs, scale,
            stream);
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
        case 256:
            return by_outputs<T, 256>(q, k, v, lens, out, B, Tk, H, KV, qsb,
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
// multiples of 16; hd is 32, 64, 128 or 256; H is a multiple of KV with
// (H / KV) * hd <= 2560. stream is a cudaStream_t. Each returns
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
