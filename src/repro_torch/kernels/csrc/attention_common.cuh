// Helpers shared by the port's attention kernels (flash_attention.cu,
// decode_attention.cu, decode_attention_paged.cu): element conversion,
// 8-wide loads from shared memory, the cooperative copy of a [64, HD] tile
// into shared memory (synchronous, and with cp.async), inline PTX for
// ldmatrix and the bf16 mma.sync, the `Rows` interface (where logical
// cache row p of a linear cache or a paged pool lies in device memory),
// and the split one-token grouped decode that the linear, paged and ring
// decode kernels share: split_decode, one block over one chunk of a row's
// cache, and finish_split, which writes a chunk's output or partial and
// combines a row's partials in the last block to finish.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace attn {

constexpr float kNegInf = -1e30f;   // the TPU kernels' masked logit
constexpr int kTileRows = 64;       // K/V rows staged per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Row pitch of a shared tile: HD plus 16 bytes, so that rows read
// together start in different banks and every row stays 16-byte aligned.
template <typename T, int HD>
__host__ __device__ constexpr int pitch() {
    return HD + 16 / static_cast<int>(sizeof(T));
}

// 8 consecutive elements at a 16-byte-aligned shared address, as floats.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        o[2 * i] = f.x;
        o[2 * i + 1] = f.y;
    }
}

// Copy logical rows [row0, row0 + 64) into a shared tile of pitch<T,
// HD>(), 16 bytes per thread per step; `row(p)` is the device address of
// logical row p. Rows at or past `valid` are written as zeros (never read
// from device memory). The caller guarantees that every row address is
// 16-byte aligned.
template <typename T, int HD, typename RowFn>
__device__ __forceinline__ void load_rows(T* dst, const RowFn& row, int row0,
                                          int valid, int tid, int nthreads) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // elements / 16 B
    constexpr int kChunks = HD / kPer;                         // per row
    constexpr int kPitch = pitch<T, HD>();
    for (int i = tid; i < kTileRows * kChunks; i += nthreads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * kPer;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < valid) {
            val = *reinterpret_cast<const uint4*>(row(row0 + r) + c);
        }
        *reinterpret_cast<uint4*>(dst + r * kPitch + c) = val;
    }
}

// load_rows over a row-strided [rows, HD] matrix; `src` and `stride` in
// bytes are multiples of 16.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride,
                                          int row0, int valid, int tid,
                                          int nthreads) {
    load_rows<T, HD>(dst, [=](int p) { return src + p * stride; }, row0,
                     valid, tid, nthreads);
}

// Allow a kernel more than 48 KB of dynamic shared memory where it asks
// for it; returns the CUDA error of the attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Inline PTX: asynchronous copies (cp.async), shared-memory fragment loads
// (ldmatrix) and the bf16 tensor-core product (mma.sync m16n8k16, f32
// accumulator), as the redesigned flash and decode kernels use them.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to shared memory without passing
// through registers; with `valid` false nothing is read and the 16 bytes
// are zeroed (`src` must still be a device address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async version of load_rows: issue the copies of logical rows [row0,
// row0 + ROWS) into a shared tile of pitch<T, HD>(), zero-filling rows at
// or past `valid` (row0 < valid: row(row0) stands in as their address).
// The caller commits and waits.
template <typename T, int HD, int ROWS, int NTHREADS, typename RowFn>
__device__ __forceinline__ void async_rows(T* dst, const RowFn& row, int row0,
                                           int valid, int tid) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = HD / kPer;
    constexpr int kPitch = pitch<T, HD>();
    const T* first = row(row0);
#pragma unroll 4
    for (int i = tid; i < ROWS * kChunks; i += NTHREADS) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * kPer;
        const bool ok = row0 + r < valid;
        cp_async16(dst + r * kPitch + c, (ok ? row(row0 + r) : first) + c, ok);
    }
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (16 contiguous bytes) and receives, of each
// matrix, row lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1
// (`trans`: of the transposed matrix).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
}
// Two 8x8 b16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p))
                 : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_addr(p))
        : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
}

// d += a @ b for a 16x16 bf16 A fragment (row-major), a 16x8 bf16 B
// fragment (column-major) and a 16x8 f32 accumulator. Thread lane = 4 g +
// t holds d[0], d[1] at row g, cols 2t, 2t + 1 and d[2], d[3] at row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (x in the low half), each rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Split two f32 values into three bf16 pairs, hi = bf16(x), mid = bf16(x
// - hi) and lo = bf16(x - hi - mid) (each difference exact in f32): hi +
// mid + lo is x to ~2^-26 of |x|, so three bf16 products stand in for an
// f32 one. (Two terms leave ~2^-17: measured in a CPU emulation, enough to
// miss a 2-ulp + 1e-6 bound on a few outputs near zero.)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat16 hx = __float2bfloat16_rn(x);
    const __nv_bfloat16 hy = __float2bfloat16_rn(y);
    x -= __bfloat162float(hx);
    y -= __bfloat162float(hy);
    const __nv_bfloat16 mx = __float2bfloat16_rn(x);
    const __nv_bfloat16 my = __float2bfloat16_rn(y);
    const __nv_bfloat162 h = __halves2bfloat162(hx, hy);
    const __nv_bfloat162 m = __halves2bfloat162(mx, my);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = *reinterpret_cast<const uint32_t*>(&m);
    lo = pack_bf16(x - __bfloat162float(mx), y - __bfloat162float(my));
}

// ---------------------------------------------------------------------------
// Where the cache rows of one (kv head, batch row) lie: the `Rows`
// interface of split_decode. k_row(p) and v_row(p) are the device
// addresses of logical cache row p; a staged map (kStaged) first looks up
// what its rows need, once per split, with stage(row0, row1, tid), called
// by every thread of the block and followed by a barrier.
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;
// most outputs a thread owns: G * HD <= 2560 (10 query heads of 256)
constexpr int kMaxDecodeOutputs = 10;

// Rows of a linear cache: row p of a kv head lies at base + p * stride.
template <typename T>
struct LinearRows {
    const T* k;
    const T* v;
    int64_t k_stride, v_stride;
    static constexpr bool kStaged = false;
    __device__ void stage(int, int, int) const {}
    __device__ const T* k_row(int p) const { return k + p * k_stride; }
    __device__ const T* v_row(int p) const { return v + p * v_stride; }
};

// Shared ints PagedRows stages for a split of `rows` rows: the table
// entries rows [row0, row0 + rows) touch, at most rows / bs + 2.
__host__ __device__ constexpr int paged_ids(int rows, int block_size) {
    return rows / block_size + 2;
}

// Rows of a paged pool: logical row p of a batch row lies at row p % bs of
// pool block table[(start + p / bs) % W] (start = 0 for a paged row, the
// row's ring start for a ring, where p counts ring slots). `stage` looks
// up the block ids of the split's rows [row0, row1) once, into shared
// memory (entry p / bs at blk_s[p / bs - first], first = row0 / bs), so
// that every tile's cp.async copies find their ids before they are issued;
// a block id outside the pool is clamped into it, so a bad table cannot
// fault.
template <typename T>
struct PagedRows {
    const T* k;          // the kv head's slice of the K pool
    const T* v;
    int64_t k_block, k_row_stride, v_block, v_row_stride;
    const int* table;    // this batch row's [W] block ids
    int num_blocks, block_size, width, start;
    int first;           // the split's first table entry: row0 / bs
    int* blk_s;          // shared [paged_ids(rows, bs)]: the split's ids
    static constexpr bool kStaged = true;
    __device__ void stage(int row0, int row1, int tid) const {
        if (row1 <= row0) return;
        const int last = (row1 - 1) / block_size;
        for (int e = row0 / block_size + tid; e <= last; e += kDecodeThreads) {
            int x = (start + e) % width;
            x += x < 0 ? width : 0;
            blk_s[e - first] = min(max(table[x], 0), num_blocks - 1);
        }
    }
    __device__ const T* k_row(int p) const {
        return k + blk_s[p / block_size - first] * k_block +
               (p % block_size) * k_row_stride;
    }
    __device__ const T* v_row(int p) const {
        return v + blk_s[p / block_size - first] * v_block +
               (p % block_size) * v_row_stride;
    }
};


// ---------------------------------------------------------------------------
// One chunk of a split one-token grouped decode (flash-decoding): the body
// of one block, which serves one (kv head, batch row), its G query heads
// and the cache rows [row0, row1) (all valid) of one split. Over those
// rows only, in f32,
//     s_gj = (q_g . k_j) * scale,
//     m_g = max_j s_gj,  l_g = sum_j exp(s_gj - m_g),
//     acc_g = sum_j exp(s_gj - m_g) v_j,
// with the running max, sum and accumulator carried across tiles of rows
// as the TPU kernels carry them in scratch across their sequential kv grid
// axis (logits of rows past the chunk in a tile are -1e30, and their V
// rows are zero-filled). m and l are left in shared memory and acc in each
// thread's NO outputs (outputs tid + i * 256 of the flat [G, HD]);
// finish_split normalises them or combines them with the other chunks'.
// A staged `rows` (PagedRows) stages the split's block ids first, behind
// one barrier. K/V tiles go through a ring of 2 cp.async stages: the next
// tile's copy is in flight while this tile is scored and accumulated, and
// a stage is refilled behind the tile's first barrier. In bf16 both
// products run on the tensor cores (mma.sync, f32 accumulators, the G
// heads padded to 16-row tiles): the logits from Q and K fragments, each
// warp scoring 8 of a tile's 64 rows, and P V with P in three bf16 terms
// (as in flash_attention.cu), each warp owning every 8th 8-dim n-tile of
// the output; the fragments reach acc through shared memory after the
// last tile. f32 inputs (the tests and the card-against-CPU checks) take
// f32 FMAs: one (head, row) pair per thread and step for the logits, NO
// outputs per thread for p @ v.
// ---------------------------------------------------------------------------

// Cache rows per staged tile: 64, or 32 where two stages of 64-row K and
// V tiles would not fit in shared memory (f32 at HD 256).
template <typename T, int HD>
__host__ __device__ constexpr int split_tile_rows() {
    return sizeof(T) * HD > 512 ? 32 : 64;
}

// K/V tile stages of split_decode: one tile in flight while one is
// computed (3 stages, two in flight, measured no faster)
constexpr int kSplitStages = 2;

// The dynamic shared memory of split_decode, carved from `smem`: two
// stages of K and V tiles (afterwards, in bf16, the [G, HD] accumulator),
// q (bf16 MMA tiles or f32), the [G, rows + 1] probabilities (a pitch that
// puts heads in different banks) and the running max, sum and correction
// per head.
template <typename T, int HD>
struct SplitSmem {
    // bf16 runs both products on the tensor cores, f32 on FMAs
    static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
    static constexpr int kRows = split_tile_rows<T, HD>();
    static constexpr int kPitch = pitch<T, HD>();
    static constexpr int kPPitch = kRows + 1;
    T* k;        // [kSplitStages][kRows][kPitch]
    T* v;        // [kSplitStages][kRows][kPitch]
    float* red;  // bf16: [G * HD], over the tiles once they are done
    float* q;    // f32: [G * HD]
    T* qt;       // bf16: [16 * ceil(G / 16)][kPitch], rows past G zero
    float* p;    // [G][kPPitch]
    float* m;    // [G]
    float* l;    // [G]
    float* c;    // [G]
    static __host__ __device__ constexpr size_t stage_bytes(int group) {
        const size_t tiles = sizeof(T) * kPitch * 2 * kSplitStages * kRows;
        const size_t sums = kMma ? sizeof(float) * group * HD : 0;
        return tiles > sums ? tiles : sums;
    }
    static __host__ __device__ constexpr size_t q_bytes(int group) {
        return kMma ? sizeof(T) * 16 * ((group + 15) / 16) * kPitch
                    : sizeof(float) * group * HD;
    }
    static __host__ __device__ constexpr size_t bytes(int group) {
        return stage_bytes(group) + q_bytes(group) +
               sizeof(float) * (group * kPPitch + 3 * group);
    }
    __device__ SplitSmem(unsigned char* smem, int group) {
        k = reinterpret_cast<T*>(smem);
        v = k + kSplitStages * kRows * kPitch;
        red = reinterpret_cast<float*>(smem);
        q = reinterpret_cast<float*>(smem + stage_bytes(group));
        qt = reinterpret_cast<T*>(q);
        p = reinterpret_cast<float*>(smem + stage_bytes(group) +
                                     q_bytes(group));
        m = p + group * kPPitch;
        l = m + group;
        c = l + group;
    }
};

template <typename T, int HD, int NO, typename Rows>
__device__ __forceinline__ void split_decode(const T* __restrict__ q,
                                             int64_t qsh, int group, int row0,
                                             int row1, const Rows& rows,
                                             float scale, unsigned char* smem,
                                             float (&acc)[NO]) {
    constexpr int kThreads = kDecodeThreads;
    constexpr int kWarps = kThreads / 32;
    using Smem = SplitSmem<T, HD>;
    constexpr int kRows = Smem::kRows;
    constexpr int kPitch = Smem::kPitch;
    constexpr int kPPitch = Smem::kPPitch;
    constexpr int kPerLane = kRows / 32;   // logits per lane in the softmax
    // bf16: 16-head MMA tiles (G <= NO * 256 / HD) and the 8-dim n-tiles a
    // warp owns (every 8th)
    constexpr int kMT = (NO * 16 + HD - 1) / HD;
    constexpr int kNW = (HD / 8 + kWarps - 1) / kWarps;
    const Smem sm(smem, group);
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nout = group * HD;
    const int ntiles = (row1 - row0 + kRows - 1) / kRows;
    const auto k_row = [&](int p) { return rows.k_row(p); };
    const auto v_row = [&](int p) { return rows.v_row(p); };

    rows.stage(row0, row1, tid);   // the split's block ids, once
    if constexpr (Rows::kStaged) __syncthreads();

    // the first kSplitStages - 1 tiles, one commit group each (empty past
    // the chunk), so that the wait below always leaves one group pending
    for (int st = 0; st < kSplitStages - 1; ++st) {
        if (st < ntiles) {
            const int r0 = row0 + st * kRows;
            async_rows<T, HD, kRows, kThreads>(sm.k + st * kRows * kPitch,
                                               k_row, r0, row1, tid);
            async_rows<T, HD, kRows, kThreads>(sm.v + st * kRows * kPitch,
                                               v_row, r0, row1, tid);
        }
        cp_async_commit();
    }
    const int mtiles = (group + 15) / 16;   // 16-row MMA tiles of heads
    if constexpr (Smem::kMma) {
        for (int i = tid; i < mtiles * 16 * HD; i += kThreads) {
            const int g = i / HD;
            sm.qt[g * kPitch + i % HD] =
                g < group ? q[g * qsh + i % HD] : __float2bfloat16_rn(0.f);
        }
    } else {
        for (int i = tid; i < nout; i += kThreads) {
            sm.q[i] = to_f32(q[(i / HD) * qsh + i % HD]);
        }
    }
    for (int g = tid; g < group; g += kThreads) {
        sm.m[g] = kNegInf;
        sm.l[g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;   // f32: the outputs' sums
    float o[kMT][kNW][4];    // bf16: the accumulator fragments
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int nw = 0; nw < kNW; ++nw) {
            o[mt][nw][0] = o[mt][nw][1] = o[mt][nw][2] = o[mt][nw][3] = 0.f;
        }
    }

    for (int it = 0; it < ntiles; ++it) {
        const int r0 = row0 + it * kRows;
        cp_async_wait<kSplitStages - 2>();
        // this tile has landed for every thread (q, m and l are set), and
        // the previous tile's stage and probabilities are consumed
        __syncthreads();
        const int nxt = it + kSplitStages - 1;   // into the previous stage
        if (nxt < ntiles) {
            const int at = (nxt % kSplitStages) * kRows * kPitch;
            async_rows<T, HD, kRows, kThreads>(sm.k + at, k_row,
                                               row0 + nxt * kRows, row1, tid);
            async_rows<T, HD, kRows, kThreads>(sm.v + at, v_row,
                                               row0 + nxt * kRows, row1, tid);
        }
        cp_async_commit();
        const int st = (it % kSplitStages) * kRows * kPitch;
        const T* k_tile = sm.k + st;
        const T* v_tile = sm.v + st;

        if constexpr (Smem::kMma) {
            // logits on the tensor cores: Q [16 heads, HD] x K^T, each warp
            // 8 of the tile's 64 rows (bf16 products are exact in f32)
            static_assert(kRows == 8 * kWarps, "one 8-row slice a warp");
            const int n0 = warp * 8;
            const int lm_row = lane % 8 + ((lane / 8) % 2) * 8;
            const int lm_col = (lane / 16) * 8;
            for (int mt = 0; mt < mtiles; ++mt) {
                float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk) {
                    uint32_t a[4], bk[2];
                    ldmatrix_x4(a, sm.qt + (mt * 16 + lm_row) * kPitch +
                                       kk * 16 + lm_col);
                    ldmatrix_x2(bk, k_tile + (n0 + lane % 8) * kPitch +
                                        kk * 16 + ((lane / 8) % 2) * 8);
                    mma_bf16(sc, a, bk[0], bk[1]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int g = mt * 16 + lane / 4 + (e / 2) * 8;
                    const int t = n0 + 2 * (lane % 4) + (e % 2);
                    if (g < group) {
                        sm.p[g * kPPitch + t] =
                            r0 + t < row1 ? sc[e] * scale : kNegInf;
                    }
                }
            }
        } else {
            // logits: one (head, cache row) pair per thread and step
            for (int i = tid; i < group * kRows; i += kThreads) {
                const int g = i / kRows;
                const int t = i % kRows;
                const float* qg = sm.q + g * HD;
                const T* kt = k_tile + t * kPitch;
                float s = 0.f;
#pragma unroll
                for (int d = 0; d < HD; d += 8) {
                    float kv[8];
                    load8(kt + d, kv);
#pragma unroll
                    for (int e = 0; e < 8; ++e) s = fmaf(qg[d + e], kv[e], s);
                }
                sm.p[g * kPPitch + t] = r0 + t < row1 ? s * scale : kNegInf;
            }
        }
        __syncthreads();

        // running max and sum: one warp per head
        for (int g = warp; g < group; g += kWarps) {
            float* pg = sm.p + g * kPPitch;
            float x[kPerLane];
            float tmax = kNegInf;
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                x[j] = pg[lane + 32 * j];
                tmax = fmaxf(tmax, x[j]);
            }
#pragma unroll
            for (int o = 16; o > 0; o /= 2) {
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
            }
            const float m_old = sm.m[g];
            const float m_new = fmaxf(m_old, tmax);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                x[j] = expf(x[j] - m_new);
                pg[lane + 32 * j] = x[j];
                sum += x[j];
            }
#pragma unroll
            for (int o = 16; o > 0; o /= 2) {
                sum += __shfl_xor_sync(0xffffffffu, sum, o);
            }
            if (lane == 0) {
                const float corr = expf(m_old - m_new);
                sm.l[g] = sm.l[g] * corr + sum;
                sm.m[g] = m_new;
                sm.c[g] = corr;
            }
        }
        __syncthreads();

        if constexpr (Smem::kMma) {
            // o = o * corr + P V on the tensor cores: P [16 heads, 64 rows]
            // in three bf16 terms (as in flash_attention.cu), V through
            // ldmatrix.trans
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
                if (mt >= mtiles) break;
                const int g0 = mt * 16 + lane / 4;
                const int g1 = g0 + 8;
                const float c0 = g0 < group ? sm.c[g0] : 1.f;
                const float c1 = g1 < group ? sm.c[g1] : 1.f;
#pragma unroll
                for (int nw = 0; nw < kNW; ++nw) {
                    o[mt][nw][0] *= c0;
                    o[mt][nw][1] *= c0;
                    o[mt][nw][2] *= c1;
                    o[mt][nw][3] *= c1;
                }
#pragma unroll
                for (int kk = 0; kk < kRows / 16; ++kk) {
                    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int g = r % 2 ? g1 : g0;
                        const float* pr = sm.p + g * kPPitch + kk * 16 +
                                          2 * (lane % 4) + (r / 2) * 8;
                        split_bf16(g < group ? pr[0] : 0.f,
                                   g < group ? pr[1] : 0.f, hi[r], mid[r],
                                   lo[r]);
                    }
#pragma unroll
                    for (int nw = 0; nw < kNW; ++nw) {
                        const int n = warp + nw * kWarps;
                        if (n < HD / 8) {
                            uint32_t bv[2];
                            ldmatrix_x2_trans(
                                bv, v_tile + (kk * 16 + lane % 16) * kPitch +
                                        n * 8);
                            mma_bf16(o[mt][nw], hi, bv[0], bv[1]);
                            mma_bf16(o[mt][nw], mid, bv[0], bv[1]);
                            mma_bf16(o[mt][nw], lo, bv[0], bv[1]);
                        }
                    }
                }
            }
        } else {
            // acc = acc * corr + p @ v for the outputs this thread owns
#pragma unroll
            for (int i = 0; i < NO; ++i) {
                const int x = tid + i * kThreads;
                if (x < nout) {
                    const float* pg = sm.p + (x / HD) * kPPitch;
                    float a = acc[i] * sm.c[x / HD];
#pragma unroll 8
                    for (int t = 0; t < kRows; ++t) {
                        a = fmaf(pg[t], to_f32(v_tile[t * kPitch + x % HD]),
                                 a);
                    }
                    acc[i] = a;
                }
            }
        }
    }
    cp_async_wait<0>();   // only empty groups can still be pending
    __syncthreads();      // the tiles are consumed; m and l are final

    if constexpr (Smem::kMma) {
        // acc: the fragments' values, through shared memory
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int nw = 0; nw < kNW; ++nw) {
                const int n = warp + nw * kWarps;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int g = mt * 16 + lane / 4 + (e / 2) * 8;
                    if (n < HD / 8 && g < group) {
                        sm.red[g * HD + n * 8 + 2 * (lane % 4) + e % 2] =
                            o[mt][nw][e];
                    }
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NO; ++i) {
            const int x = tid + i * kThreads;
            acc[i] = x < nout ? sm.red[x] : 0.f;
        }
        __syncthreads();   // read before the caller reuses shared memory
    }
}


// ---------------------------------------------------------------------------
// The end of one split: after split_decode over chunk `split` of the
// `active` chunks that start below the row's length. A row that fits one
// chunk (and a row of length 0, which gives 0) is written by its block:
// out = acc / max(l, 1e-30). Otherwise every working block writes its
// partial (acc [G * HD], m [G], l [G]) in f32 to `partial` (this (row, kv
// head)'s [active][G * (HD + 2)] scratch), fences, and takes a ticket
// from `ticket`; the last to arrive combines, in the same launch:
//     M = max_s m_s;
//     out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
// reading the partials in split order (never arrival order), so the
// result is deterministic, and resets the ticket to 0 for the next launch;
// each of its threads has the loads of 4 splits in flight at once. `out`
// is the contiguous [G, HD] destination; `smem` is split_decode's, which
// the combine reuses: it holds at least combine_smem_bytes(active, G).
// ---------------------------------------------------------------------------

constexpr int kCombineSplits = 4;   // splits the combine loads at once

// The combine's shared memory: [splits][G] maxima, sums and weights, [G]
// denominators.
__host__ __device__ constexpr size_t combine_smem_bytes(int splits,
                                                        int group) {
    return sizeof(float) * (3 * splits + 1) * group;
}

template <typename T, int HD, int NO>
__device__ __forceinline__ void finish_split(const float (&acc)[NO],
                                             int group, int split, int active,
                                             float* __restrict__ partial,
                                             int* __restrict__ ticket,
                                             T* __restrict__ out,
                                             unsigned char* smem) {
    constexpr int kThreads = kDecodeThreads;
    __shared__ int last;
    const SplitSmem<T, HD> sm(smem, group);
    const int tid = threadIdx.x;
    const int nout = group * HD;
    if (active == 1) {
#pragma unroll
        for (int i = 0; i < NO; ++i) {
            const int x = tid + i * kThreads;
            if (x < nout) store(out + x, acc[i] / fmaxf(sm.l[x / HD], 1e-30f));
        }
        return;
    }

    const int stride = nout + 2 * group;
    float* mine = partial + split * stride;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
        const int x = tid + i * kThreads;
        if (x < nout) mine[x] = acc[i];
    }
    for (int g = tid; g < group; g += kThreads) {
        mine[nout + g] = sm.m[g];
        mine[nout + group + g] = sm.l[g];
    }
    __threadfence();   // the partial is visible before the ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(ticket, 1) == active - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid == 0) *ticket = 0;   // ready for the next launch

    // the combine, in split order; the body's shared memory is free again
    float* ms = reinterpret_cast<float*>(smem);   // [active][G] maxima
    float* ls = ms + active * group;              // [active][G] sums
    float* w = ls + active * group;               // [active][G] weights
    float* den = w + active * group;              // [G] denominators
    for (int i = tid; i < active * group; i += kThreads) {
        const float* ml = partial + (i / group) * stride + nout + i % group;
        ms[i] = __ldcg(ml);
        ls[i] = __ldcg(ml + group);
    }
    __syncthreads();
    for (int g = tid; g < group; g += kThreads) {
        float mx = kNegInf;
        for (int s = 0; s < active; ++s) mx = fmaxf(mx, ms[s * group + g]);
        float l = 0.f;
        for (int s = 0; s < active; ++s) {
            const float e = expf(ms[s * group + g] - mx);
            w[s * group + g] = e;
            l = fmaf(e, ls[s * group + g], l);
        }
        den[g] = fmaxf(l, 1e-30f);
    }
    __syncthreads();
    float a[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) a[i] = 0.f;
    for (int s0 = 0; s0 < active; s0 += kCombineSplits) {
        // the loads of kCombineSplits splits in flight together, then the
        // sums in split order
        float part[kCombineSplits][NO];
#pragma unroll
        for (int j = 0; j < kCombineSplits; ++j) {
#pragma unroll
            for (int i = 0; i < NO; ++i) {
                const int x = tid + i * kThreads;
                part[j][i] = s0 + j < active && x < nout
                                 ? __ldcg(partial + (s0 + j) * stride + x)
                                 : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < kCombineSplits; ++j) {
#pragma unroll
            for (int i = 0; i < NO; ++i) {
                const int x = tid + i * kThreads;
                if (s0 + j < active && x < nout) {
                    a[i] = fmaf(w[(s0 + j) * group + x / HD], part[j][i],
                                a[i]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
        const int x = tid + i * kThreads;
        if (x < nout) store(out + x, a[i] / den[x / HD]);
    }
}

}  // namespace attn
