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
// most 2 MB (17 MB), under a microsecond (5 us) at 3.35 TB/s, so the
// number of blocks in flight and the latency of each tile step set the
// time: one block per (kv head, batch row) gave 8 blocks on 132 SMs for
// recurrentgemma, each walking up to 32 tiles one after another.
//
// Design (flash-decoding): the cache is split across blocks. The grid is
// (KV, B, splits); block (c, b, s) takes cache rows [s * R, (s + 1) * R)
// of row b, where R = split_rows comes from the wrapper
// (kernels/decode_attention.py: split_rows(T, KV, hd), a multiple of 64
// that depends on T, KV and hd only, never on B or the lengths, so a row's
// result is bitwise the same alone or in any batch, and the grid needs no
// host sync). Each block keeps the G query heads of its kv head together,
// as the TPU kernel's [G, hd] tile does, so every K and V row is read from
// device memory once; its body is attn::split_decode (attention_common.cuh):
// K/V tiles double-buffered with cp.async; the G heads' logits on the
// tensor cores in bf16 (G padded to 16 rows: as per-pair FMA dot products,
// 256 scalar q loads and 256 FMAs a pair at hd 256, they were about half
// the body's instructions), f32 FMAs for f32 inputs; a running max and sum
// per head; P V on the tensor cores as well, P in three bf16 terms (on
// f32 FMAs for f32 inputs); NO of the G * hd outputs per thread (NO = 10
// at G * hd = 2560). A block whose chunk starts at or past
// lengths[b] returns at once. attn::finish_split ends the others: when the
// row's valid rows fit one chunk (and for a row of length 0, which gives
// 0) that block writes the output itself; otherwise every working block
// writes its partial (m, l, acc) in f32 to scratch and takes a ticket
// from an int32 counter per (batch row, kv head), and the last to arrive
// combines the partials in split order in the same launch (deterministic)
// and resets the counter to 0 for the next call.
// The wrapper allocates the scratch (torch.empty) and the counters (once
// per device, zeroed); the kernel launches on the caller's stream,
// allocates nothing, and each entry point returns cudaGetLastError(). The
// cache is read where it lies: k and v come as [B, T, KV, hd] slices of
// the arena with their strides, and lengths are read on the device.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = attn::kDecodeThreads;
constexpr int kMaxSplits = 32;   // most splits of one row (the combine's)

struct Strides {
    int64_t b, t, h;   // elements between batch rows, positions, heads
};

// Dynamic shared memory: the split body's, which the combine reuses for
// its [splits, G] maxima, sums and weights and [G] denominators.
template <typename T, int HD>
size_t smem_bytes(int group) {
    const size_t body = attn::SplitSmem<T, HD>::bytes(group);
    const size_t combine = attn::combine_smem_bytes(kMaxSplits, group);
    return body > combine ? body : combine;
}

template <typename T, int HD, int NO>
__global__ void __launch_bounds__(kThreads, 1)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ lengths,
           T* __restrict__ out, int Tk, int H, int group, int64_t qsb,
           int64_t qsh, Strides ks, Strides vs, float scale, int split_rows,
           float* __restrict__ partial, int* __restrict__ tickets) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int split = blockIdx.z;
    const int len = min(max(lengths[b], 0), Tk);
    const int active = len == 0 ? 1 : (len + split_rows - 1) / split_rows;
    if (split >= active) return;
    const int row0 = split * split_rows;
    const int row1 = min(row0 + split_rows, len);
    const attn::LinearRows<T> rows{k + b * ks.b + kvh * ks.h,
                                   v + b * vs.b + kvh * vs.h, ks.t, vs.t};
    float acc[NO];
    attn::split_decode<T, HD, NO>(q + b * qsb + kvh * group * qsh, qsh,
                                  group, row0, row1, rows, scale, smem, acc);
    const int64_t slot = static_cast<int64_t>(b) * gridDim.x + kvh;
    attn::finish_split<T, HD, NO>(
        acc, group, split, active,
        partial + slot * gridDim.z * (group * (HD + 2)), tickets + slot,
        out + (static_cast<int64_t>(b) * H + kvh * group) * HD, smem);
}

struct Args {
    const void *q, *k, *v;
    const int* lengths;
    void* out;
    int B, Tk, H, KV;
    int64_t qsb, qsh;
    Strides ks, vs;
    float scale;
    int split_rows;
    float* partial;
    int* tickets;
    cudaStream_t stream;
};

template <typename T, int HD, int NO>
int launch(const Args& a) {
    const int group = a.H / a.KV;
    const size_t smem = smem_bytes<T, HD>(group);
    cudaError_t err = attn::allow_smem(decode_fwd<T, HD, NO>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int splits = a.Tk > 0 ? (a.Tk + a.split_rows - 1) / a.split_rows : 1;
    const dim3 grid(a.KV, a.B, splits);
    decode_fwd<T, HD, NO><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out), a.Tk,
        a.H, group, a.qsb, a.qsh, a.ks, a.vs, a.scale, a.split_rows,
        a.partial, a.tickets);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_outputs(const Args& a) {
    const int per_thread = ((a.H / a.KV) * HD + kThreads - 1) / kThreads;
    if (per_thread <= 1) return launch<T, HD, 1>(a);
    if (per_thread <= 2) return launch<T, HD, 2>(a);
    if (per_thread <= 4) return launch<T, HD, 4>(a);
    if (per_thread <= attn::kMaxDecodeOutputs)
        return launch<T, HD, attn::kMaxDecodeOutputs>(a);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int B, int Tk, int H, int KV, int hd, int64_t qsb,
             int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
             int64_t vst, int64_t vsh, float scale, int split_rows,
             void* partial, void* tickets, void* stream) {
    if (split_rows <= 0 || split_rows % attn::kTileRows ||
        (Tk + split_rows - 1) / split_rows > kMaxSplits ||
        (Tk > split_rows && (partial == nullptr || tickets == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{q, k, v, static_cast<const int*>(lengths), out, B, Tk, H,
                 KV, qsb, qsh, Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh},
                 scale, split_rows, static_cast<float*>(partial),
                 static_cast<int*>(tickets),
                 static_cast<cudaStream_t>(stream)};
    switch (hd) {
        case 32: return by_outputs<T, 32>(a);
        case 64: return by_outputs<T, 64>(a);
        case 96: return by_outputs<T, 96>(a);
        case 128: return by_outputs<T, 128>(a);
        case 256: return by_outputs<T, 256>(a);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
size_t smem_for(int hd, int group) {
    switch (hd) {
        case 32: return smem_bytes<T, 32>(group);
        case 64: return smem_bytes<T, 64>(group);
        case 96: return smem_bytes<T, 96>(group);
        case 128: return smem_bytes<T, 128>(group);
        case 256: return smem_bytes<T, 256>(group);
        default: return 0;
    }
}

}  // namespace

// Entry points. q: [B, H, hd] by its base pointer and the element strides
// of its first two dims; k, v: [B, T, KV, hd] by base pointer and element
// strides of their first three dims (the last dim of every operand is
// contiguous); lengths: int32 [B] on the device; out: a contiguous
// [B, H, hd] buffer of q's type. K/V pointers and strides in bytes are
// multiples of 16; hd is 32, 64, 96, 128 or 256; H is a multiple of KV with
// (H / KV) * hd <= 2560. split_rows is a multiple of 64 with at most 32
// splits of T; where T > split_rows, partial is f32 scratch of
// B * KV * splits * ((H / KV) * (hd + 2)) values and tickets int32 [B * KV]
// counters that are 0 (each launch leaves them 0). stream is a
// cudaStream_t. Each returns cudaGetLastError() after its launch.
extern "C" {

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int B, int T, int H,
                         int KV, int hd, int64_t qsb, int64_t qsh, int64_t ksb,
                         int64_t kst, int64_t ksh, int64_t vsb, int64_t vst,
                         int64_t vsh, float scale, int split_rows,
                         void* partial, void* tickets, void* stream) {
    return dispatch<float>(q, k, v, lengths, out, B, T, H, KV, hd, qsb, qsh,
                           ksb, kst, ksh, vsb, vst, vsh, scale, split_rows,
                           partial, tickets, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, int B, int T, int H,
                          int KV, int hd, int64_t qsb, int64_t qsh,
                          int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                          int64_t vst, int64_t vsh, float scale,
                          int split_rows, void* partial, void* tickets,
                          void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, T, H, KV, hd, qsb,
                                   qsh, ksb, kst, ksh, vsb, vst, vsh, scale,
                                   split_rows, partial, tickets, stream);
}

// Bytes of dynamic shared memory a launch at (bf16 or f32, hd, G) asks for.
int decode_attention_smem_bytes(int is_bf16, int hd, int group) {
    return static_cast<int>(is_bf16 ? smem_for<__nv_bfloat16>(hd, group)
                                    : smem_for<float>(hd, group));
}

}  // extern "C"
