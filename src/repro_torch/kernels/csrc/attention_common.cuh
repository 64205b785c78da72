// Helpers shared by the port's attention kernels (flash_attention.cu,
// decode_attention.cu, decode_attention_paged.cu): element conversion,
// 8-wide loads from shared memory, the cooperative copy of a [64, HD] tile
// into shared memory, and the body of one-token grouped decode attention,
// which the linear, paged and ring decode kernels share: they differ only
// in where logical cache row p lies in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// One-token grouped decode attention: the body of one block, which serves
// one (kv head, batch row) and the G query heads of that kv head. In f32:
//     s_gj = (q_g . k_j) * scale for logical cache rows j < len, else -1e30,
//     out_g = sum_j exp(s_gj - m_g) v_j / max(sum_j exp(s_gj - m_g), 1e-30)
// with V rows at or past len zeroed, and the running max, sum and
// accumulator in f32 across tiles of 64 rows, as the TPU kernels keep them
// in scratch across their sequential kv grid axis. The block loops over
// [0, len) only; `rows` says where row p lies (see LinearRows, PagedRows).
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;
// most outputs a thread owns: G * HD <= 2560 (10 query heads of 256)
constexpr int kMaxDecodeOutputs = 10;

// Dynamic shared memory of grouped_decode: the K and V tiles, q, the
// [G, 64] logits and the running max, sum and correction per head.
template <typename T, int HD>
__host__ __device__ constexpr size_t decode_smem_bytes(int group) {
    return sizeof(T) * pitch<T, HD>() * 2 * kTileRows +
           sizeof(float) * (group * HD + group * kTileRows + 3 * group);
}

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

// Rows of a paged pool: logical row p of a batch row lies at row p % bs of
// pool block table[(start + p / bs) % W] (start = 0 for a paged row, the
// row's ring start for a ring, where p counts ring slots). `stage` looks
// up the 64 block ids of a tile once, into shared memory; a block id
// outside the pool is clamped into it, so a bad table cannot fault.
template <typename T>
struct PagedRows {
    const T* k;          // the kv head's slice of the K pool
    const T* v;
    int64_t k_block, k_row_stride, v_block, v_row_stride;
    const int* table;    // this batch row's [W] block ids
    int num_blocks, block_size, width, start;
    int* blk_s;          // shared [64]: the tile's block ids
    static constexpr bool kStaged = true;
    __device__ void stage(int row0, int len, int tid) const {
        if (tid < kTileRows) {
            const int p = row0 + tid;
            int blk = 0;
            if (p < len) {
                int e = (start + p / block_size) % width;
                e += e < 0 ? width : 0;
                blk = min(max(table[e], 0), num_blocks - 1);
            }
            blk_s[tid] = blk;
        }
    }
    __device__ const T* k_row(int p) const {
        return k + blk_s[p % kTileRows] * k_block +
               (p % block_size) * k_row_stride;
    }
    __device__ const T* v_row(int p) const {
        return v + blk_s[p % kTileRows] * v_block +
               (p % block_size) * v_row_stride;
    }
};

// q: the block's first query head (G heads, qsh elements apart, each HD
// contiguous); out: a contiguous [G, HD] destination; NO outputs per
// thread (G * HD <= NO * kDecodeThreads). Every thread of the block calls
// it; `smem` holds decode_smem_bytes<T, HD>(group) bytes.
template <typename T, int HD, int NO, typename Rows>
__device__ __forceinline__ void grouped_decode(const T* __restrict__ q,
                                               int64_t qsh, int group, int len,
                                               const Rows& rows, float scale,
                                               T* __restrict__ out,
                                               unsigned char* smem) {
    constexpr int kThreads = kDecodeThreads;
    constexpr int kWarps = kThreads / 32;
    constexpr int kPitch = pitch<T, HD>();
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
    const int nout = group * HD;

    for (int i = tid; i < nout; i += kThreads) {
        q_s[i] = to_f32(q[(i / HD) * qsh + i % HD]);
    }
    for (int g = tid; g < group; g += kThreads) {
        m_s[g] = kNegInf;
        l_s[g] = 0.f;
    }

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < len; k0 += kTileRows) {
        __syncthreads();   // q_s ready / the previous tile is consumed
        if constexpr (Rows::kStaged) {
            rows.stage(k0, len, tid);
            __syncthreads();
        }
        load_rows<T, HD>(k_tile, [&](int p) { return rows.k_row(p); }, k0, len,
                         tid, kThreads);
        load_rows<T, HD>(v_tile, [&](int p) { return rows.v_row(p); }, k0, len,
                         tid, kThreads);
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
                load8(kt + d, kv);
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
                    a = fmaf(pg[t], to_f32(v_tile[t * kPitch + d]), a);
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
            store(out + o, acc[i] / fmaxf(l_s[o / HD], 1e-30f));
        }
    }
}

}  // namespace attn
