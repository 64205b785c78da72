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
// tables and lengths add 4 bytes per row and entry. At the paged serving
// shape (8 rows of at most 512 tokens, 2 kv heads of 64) one call moves
// under 2 MB, well under a microsecond at 3.35 TB/s, so the blocks in
// flight and the latency of each tile step set the time.
//
// Design: the linear decode kernel's split-KV body (decode_attention.cu)
// with attn::PagedRows as the row map. The grid is (KV, B, splits); block
// (c, b, s) takes logical rows (ring slots) [s * R, (s + 1) * R) of row b,
// with R = split_rows from the wrapper (kernels/decode_attention_paged.py:
// paged_split_rows(hd), a multiple of 64 that depends on hd only: never on
// the table's width W, which the serving engine sets to the pow2 that
// covers its live rows and so changes as rows join, leave and grow, nor on
// B or the lengths; a row's chunks, and so its bits, are the same under
// any table width, alone or in any batch). The grid holds
// ceil(cap / R) splits for the largest cap a row can have; a block whose
// chunk starts at or past its row's cap returns at once. Before its first
// cp.async copy, a block looks up the block ids of its whole chunk in the
// row's table (read on the device, so the step needs no host sync) into
// shared memory, behind one barrier; every 16-byte copy then computes its
// row's address from the staged id and p % bs, so any block size works and
// each tile's prefetch finds its ids. The body is attn::split_decode (K/V
// tiles in 2 cp.async stages, bf16 logits and P V on mma.sync, f32 FMAs
// for f32 inputs), and attn::finish_split writes one-chunk rows directly
// and combines the others in split order in the same launch, through a
// ticket counter per (batch row, kv head) that the last block resets. The
// cap is min(lengths[b], W * bs) for the paged pool (a dead row's length
// drifts up without bound while its table stays on the null block) and
// min(lengths[b], window, W * bs) for the ring: the serving engine slices
// a ring's table to the pow2 width of its live rows, which is narrower
// than the ring until a row holds more than W * bs tokens. The pool is
// the model's layer slice [NB, bs, KV, hd], read through its strides; q
// is read in the model's [B, H, hd] layout. The wrapper allocates the
// partials (torch.empty) and shares the linear kernel's per-device
// counters; the kernel launches on the caller's stream, allocates
// nothing, and each entry point returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

constexpr int kThreads = attn::kDecodeThreads;
constexpr int kMaxGrid = 65535;   // most blocks along the grid's z axis

struct PoolStrides {
    int64_t blk, row, h;   // elements between blocks, rows of a block, heads
};

// The most rows (ring slots) a row of the batch can attend to.
int max_cap(int W, int block_size, int window) {
    const int64_t table = static_cast<int64_t>(W) * block_size;
    const int64_t cap = window > 0 && window < table ? window : table;
    return static_cast<int>(cap < INT32_MAX ? cap : INT32_MAX);
}

// Dynamic shared memory: the split body's (which the combine of `splits`
// partials reuses), then the split's staged block ids.
template <typename T, int HD>
size_t smem_bytes(int group, int splits, int split_rows, int block_size) {
    const size_t body = attn::SplitSmem<T, HD>::bytes(group);
    const size_t combine = attn::combine_smem_bytes(splits, group);
    return (body > combine ? body : combine) +
           sizeof(int) * attn::paged_ids(split_rows, block_size);
}

// window = 0: a paged row; window > 0: a ring of that window, starts[b]
// its rotation. `ids_at`: the byte offset of the staged ids in smem.
template <typename T, int HD, int NO>
__global__ void __launch_bounds__(kThreads, 1)
paged_fwd(const T* __restrict__ q, const T* __restrict__ k_pool,
          const T* __restrict__ v_pool, const int* __restrict__ tables,
          const int* __restrict__ starts, const int* __restrict__ lengths,
          T* __restrict__ out, int H, int group, int num_blocks,
          int block_size, int W, int cap, int window, int64_t qsb,
          int64_t qsh, PoolStrides ks, PoolStrides vs, float scale,
          int split_rows, size_t ids_at, float* __restrict__ partial,
          int* __restrict__ tickets) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int split = blockIdx.z;
    const int len = min(max(lengths[b], 0), cap);
    const int active = len == 0 ? 1 : (len + split_rows - 1) / split_rows;
    if (split >= active) return;
    const int row0 = split * split_rows;
    const int row1 = min(row0 + split_rows, len);
    const attn::PagedRows<T> rows{
        k_pool + kvh * ks.h, v_pool + kvh * vs.h, ks.blk, ks.row, vs.blk,
        vs.row, tables + static_cast<int64_t>(b) * W, num_blocks, block_size,
        W, window > 0 ? starts[b] : 0, row0 / block_size,
        reinterpret_cast<int*>(smem + ids_at)};
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
    int split_rows, splits;
    float* partial;
    int* tickets;
    cudaStream_t stream;
};

template <typename T, int HD, int NO>
int launch(const Args& a) {
    const int group = a.H / a.KV;
    const size_t smem =
        smem_bytes<T, HD>(group, a.splits, a.split_rows, a.block_size);
    const size_t ids_at =
        smem - sizeof(int) * attn::paged_ids(a.split_rows, a.block_size);
    cudaError_t err = attn::allow_smem(paged_fwd<T, HD, NO>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.KV, a.B, a.splits);
    paged_fwd<T, HD, NO><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), a.tables, a.starts, a.lengths,
        static_cast<T*>(a.out), a.H, group, a.num_blocks, a.block_size, a.W,
        max_cap(a.W, a.block_size, a.window), a.window, a.qsb, a.qsh, a.ks,
        a.vs, a.scale, a.split_rows, ids_at, a.partial, a.tickets);
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
             int64_t vs_row, int64_t vs_h, float scale, int split_rows,
             void* partial, void* tickets, void* stream) {
    if (block_size <= 0 || W <= 0 || split_rows <= 0 ||
        split_rows % attn::kTileRows || (window > 0 && starts == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t splits =
        (static_cast<int64_t>(max_cap(W, block_size, window)) + split_rows -
         1) / split_rows;
    if (splits > kMaxGrid ||
        (splits > 1 && (partial == nullptr || tickets == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
                 static_cast<const int*>(starts),
                 static_cast<const int*>(lengths), out, B, H, KV, num_blocks,
                 block_size, W, window, qsb, qsh,
                 PoolStrides{ks_blk, ks_row, ks_h},
                 PoolStrides{vs_blk, vs_row, vs_h}, scale, split_rows,
                 static_cast<int>(splits),
                 static_cast<float*>(partial), static_cast<int*>(tickets),
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
size_t smem_for(int hd, int group, int splits, int split_rows,
                int block_size) {
    switch (hd) {
        case 32: return smem_bytes<T, 32>(group, splits, split_rows,
                                          block_size);
        case 64: return smem_bytes<T, 64>(group, splits, split_rows,
                                          block_size);
        case 96: return smem_bytes<T, 96>(group, splits, split_rows,
                                          block_size);
        case 128: return smem_bytes<T, 128>(group, splits, split_rows,
                                            block_size);
        case 256: return smem_bytes<T, 256>(group, splits, split_rows,
                                            block_size);
        default: return 0;
    }
}

}  // namespace

// Entry points. q: [B, H, hd] by its base pointer and the element strides
// of its first two dims; k_pool, v_pool: [NB, bs, KV, hd] by base pointer
// and element strides of their first three dims (the last dim of every
// operand is contiguous; pointers and strides in bytes are multiples of
// 16); tables: contiguous int32 [B, W]; starts: int32 [B] (read only when
// window > 0, the ring); lengths: int32 [B]; out: a contiguous [B, H, hd]
// buffer of q's type. hd is 32, 64, 96, 128 or 256; H is a multiple of KV
// with (H / KV) * hd <= 2560. split_rows is a multiple of 64; with
// splits = ceil(cap / split_rows) for cap = W * bs (paged) or
// min(window, W * bs) (ring), at most 65535: where splits > 1, partial is
// f32 scratch of B * KV * splits * ((H / KV) * (hd + 2)) values and
// tickets int32 [B * KV] counters that are 0 (each launch leaves them 0).
// stream is a cudaStream_t. Each returns cudaGetLastError() after its
// launch.
extern "C" {

int decode_attention_paged_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* lengths, void* out, int B, int H, int KV,
    int hd, int num_blocks, int block_size, int W, int window, int64_t qsb,
    int64_t qsh, int64_t ks_blk, int64_t ks_row, int64_t ks_h, int64_t vs_blk,
    int64_t vs_row, int64_t vs_h, float scale, int split_rows, void* partial,
    void* tickets, void* stream) {
    return dispatch<float>(q, k_pool, v_pool, tables, starts, lengths, out, B,
                           H, KV, hd, num_blocks, block_size, W, window, qsb,
                           qsh, ks_blk, ks_row, ks_h, vs_blk, vs_row, vs_h,
                           scale, split_rows, partial, tickets, stream);
}

int decode_attention_paged_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* lengths, void* out, int B, int H, int KV,
    int hd, int num_blocks, int block_size, int W, int window, int64_t qsb,
    int64_t qsh, int64_t ks_blk, int64_t ks_row, int64_t ks_h, int64_t vs_blk,
    int64_t vs_row, int64_t vs_h, float scale, int split_rows, void* partial,
    void* tickets, void* stream) {
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, tables, starts, lengths,
                                   out, B, H, KV, hd, num_blocks, block_size,
                                   W, window, qsb, qsh, ks_blk, ks_row, ks_h,
                                   vs_blk, vs_row, vs_h, scale, split_rows,
                                   partial, tickets, stream);
}

// Bytes of dynamic shared memory a launch at (bf16 or f32, hd, G, splits,
// split_rows, bs) asks for.
int decode_attention_paged_smem_bytes(int is_bf16, int hd, int group,
                                      int splits, int split_rows,
                                      int block_size) {
    return static_cast<int>(
        is_bf16 ? smem_for<__nv_bfloat16>(hd, group, splits, split_rows,
                                          block_size)
                : smem_for<float>(hd, group, splits, split_rows, block_size));
}

}  // extern "C"
