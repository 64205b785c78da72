// One-token grouped-query decode attention against a paged KV pool, and
// over a sliding-window ring of pool blocks, for Hopper.
//
// Replaces two TPU kernels of src/repro/kernels/decode_attention.py:
//   * decode_attention_paged_grouped: batch row b's logical position p is
//     row p % bs of pool block tables[b, p / bs]; positions p < lengths[b]
//     are valid, and block 0 is the null block that unallocated entries
//     point at;
//   * decode_attention_ring_grouped: the row's last min(lengths[b], window)
//     tokens sit in a ring of blocks, ring slot j in ring block j / bs,
//     which is table entry (starts[b] + j / bs) % W; ring slots
//     j < min(lengths[b], window) are valid.
// Both compute, for kv head c and its G query heads, the masked softmax of
// decode_attention.cu in f32 (masked logits at -1e30, V rows past the
// length zeroed, out = acc / max(l, 1e-30)) over the valid rows in
// ascending logical (ring-slot) order. Iterating by ring slot, not by table
// entry, keeps the output bitwise invariant under a joint rotation of the
// table and ring_starts, as on the TPU.
//
// Bound: memory, as the linear kernel: each valid row of K and V is read
// once for all G heads, 7 FLOP per byte at qwen2-0.5b's widths in bf16. The
// tables and lengths add 4 bytes per row and entry.
//
// Design: the linear kernel's block (one per (kv head, batch row), 256
// threads, 64-row K/V tiles in padded shared memory, f32 running max, sum
// and accumulator: attn::grouped_decode) with attn::PagedRows as the row
// map: before each tile, 64 threads look up the tile's block ids in the
// row's table (read on the device, so the step needs no host sync) into
// shared memory, and every 16-byte load computes its row's address from
// the block id and p % bs, so any block size works. The loop stops at
// min(lengths[b], W * bs) for the paged pool (a dead row's length drifts
// up without bound while its table stays on the null block) and at
// min(lengths[b], window, W * bs) for the ring: the serving engine slices
// a ring's table to the pow2 width of its live rows, which is narrower
// than the ring until a row holds more than W * bs tokens. The pool
// is the model's layer slice [NB, bs, KV, hd], read through its strides;
// q is read in the model's [B, H, hd] layout. The kernel launches on the
// caller's stream, allocates nothing, and each entry point returns
// cudaGetLastError().

#include "attention_common.cuh"

namespace {

constexpr int kThreads = attn::kDecodeThreads;

struct PoolStrides {
    int64_t blk, row, h;   // elements between blocks, rows of a block, heads
};

// window = 0: a paged row; window > 0: a ring of that window, starts[b]
// its rotation.
template <typename T, int HD, int NO>
__global__ void __launch_bounds__(kThreads)
paged_fwd(const T* __restrict__ q, const T* __restrict__ k_pool,
          const T* __restrict__ v_pool, const int* __restrict__ tables,
          const int* __restrict__ starts, const int* __restrict__ lengths,
          T* __restrict__ out, int H, int group, int num_blocks,
          int block_size, int W, int window, int64_t qsb, int64_t qsh,
          PoolStrides ks, PoolStrides vs, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int cap = window > 0 ? min(window, W * block_size) : W * block_size;
    const int len = min(max(lengths[b], 0), cap);
    int* blk_s = reinterpret_cast<int*>(
        smem + attn::decode_smem_bytes<T, HD>(group));
    const attn::PagedRows<T> rows{
        k_pool + kvh * ks.h, v_pool + kvh * vs.h, ks.blk, ks.row, vs.blk,
        vs.row, tables + static_cast<int64_t>(b) * W, num_blocks, block_size,
        W, window > 0 ? starts[b] : 0, blk_s};
    attn::grouped_decode<T, HD, NO>(
        q + b * qsb + kvh * group * qsh, qsh, group, len, rows, scale,
        out + (static_cast<int64_t>(b) * H + kvh * group) * HD, smem);
}

struct Args {
    const void* q;
    const void* k_pool;
    const void* v_pool;
    const int* tables;
    const int* starts;
    const int* lengths;
    void* out;
    int B, H, KV, num_blocks, block_size, W, window;
    int64_t qsb, qsh;
    PoolStrides ks, vs;
    float scale;
    cudaStream_t stream;
};

template <typename T, int HD, int NO>
int launch(const Args& a) {
    const int group = a.H / a.KV;
    const size_t smem =
        attn::decode_smem_bytes<T, HD>(group) + sizeof(int) * attn::kTileRows;
    cudaError_t err = attn::allow_smem(paged_fwd<T, HD, NO>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.KV, a.B);
    paged_fwd<T, HD, NO><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), a.tables, a.starts, a.lengths,
        static_cast<T*>(a.out), a.H, group, a.num_blocks, a.block_size, a.W,
        a.window, a.qsb, a.qsh, a.ks, a.vs, a.scale);
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
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* starts, const void* lengths,
             void* out, int B, int H, int KV, int hd, int num_blocks,
             int block_size, int W, int window, int64_t qsb, int64_t qsh,
             int64_t ks_blk, int64_t ks_row, int64_t ks_h, int64_t vs_blk,
             int64_t vs_row, int64_t vs_h, float scale, void* stream) {
    const Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
                 static_cast<const int*>(starts),
                 static_cast<const int*>(lengths), out, B, H, KV, num_blocks,
                 block_size, W, window, qsb, qsh,
                 PoolStrides{ks_blk, ks_row, ks_h},
                 PoolStrides{vs_blk, vs_row, vs_h}, scale,
                 static_cast<cudaStream_t>(stream)};
    if (window > 0 && starts == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
        case 32: return by_outputs<T, 32>(a);
        case 64: return by_outputs<T, 64>(a);
        case 128: return by_outputs<T, 128>(a);
        case 256: return by_outputs<T, 256>(a);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Entry points. q: [B, H, hd] by its base pointer and the element strides
// of its first two dims; k_pool, v_pool: [NB, bs, KV, hd] by base pointer
// and element strides of their first three dims (the last dim of every
// operand is contiguous; pointers and strides in bytes are multiples of
// 16); tables: contiguous int32 [B, W]; starts: int32 [B] (read only when
// window > 0, the ring); lengths: int32 [B]; out:
// a contiguous [B, H, hd] buffer of q's type. hd is 32, 64, 128 or 256; H
// is a multiple of KV with (H / KV) * hd <= 2560. stream is a cudaStream_t.
// Each returns cudaGetLastError() after its launch.
extern "C" {

int decode_attention_paged_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* lengths, void* out, int B, int H, int KV,
    int hd, int num_blocks, int block_size, int W, int window, int64_t qsb,
    int64_t qsh, int64_t ks_blk, int64_t ks_row, int64_t ks_h, int64_t vs_blk,
    int64_t vs_row, int64_t vs_h, float scale, void* stream) {
    return dispatch<float>(q, k_pool, v_pool, tables, starts, lengths, out, B,
                           H, KV, hd, num_blocks, block_size, W, window, qsb,
                           qsh, ks_blk, ks_row, ks_h, vs_blk, vs_row, vs_h,
                           scale, stream);
}

int decode_attention_paged_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* lengths, void* out, int B, int H, int KV,
    int hd, int num_blocks, int block_size, int W, int window, int64_t qsb,
    int64_t qsh, int64_t ks_blk, int64_t ks_row, int64_t ks_h, int64_t vs_blk,
    int64_t vs_row, int64_t vs_h, float scale, void* stream) {
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, tables, starts, lengths,
                                   out, B, H, KV, hd, num_blocks, block_size,
                                   W, window, qsb, qsh, ks_blk, ks_row, ks_h,
                                   vs_blk, vs_row, vs_h, scale, stream);
}

}  // extern "C"
