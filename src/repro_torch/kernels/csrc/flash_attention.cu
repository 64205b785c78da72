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
// peak). The first version scored and accumulated with scalar f32 FMAs out
// of shared memory, behind synchronous tile loads: 20-41x slower than
// SDPA, and slower than its plain version at HD 256.
//
// Design, bf16 (the serving path): FlashAttention-2 on the tensor cores,
// in inline PTX. A block of 4 warps owns one (batch, head, tile of 64
// query rows); each warp owns 16 rows and walks the kv tiles of 64 rows
// (32 at HD 256, where the 64-column S tile beside the O fragments
// spilled) itself; causal blocks start with the last query tiles, which
// visit the most kv tiles. Q (kept in shared memory: a 16 x 256 O
// fragment already takes 128 f32 registers a thread at HD 256) and K/V
// tiles are staged with cp.async, 16 bytes a thread, through a ring of 2
// stages: the next tile's copy is in flight while this one is computed,
// behind one barrier a tile. Rows are padded by
// 16 bytes, so the 8 rows of each ldmatrix lie in different banks. S =
// Q K^T is mma.sync m16n8k16 (bf16 in, f32 accumulator) on fragments from
// ldmatrix; bf16 x bf16 products are exact in f32, so S is the f32 dot
// product up to the order of its sums. The online softmax runs on the
// accumulator fragments (each thread holds 2 rows; row max and sum by quad
// shuffles; the correction is applied to the O fragments). The TPU kernel
// multiplies P by V in f32; here P is split into three bf16 terms, P_hi =
// bf16(p), P_mid = bf16(p - P_hi), P_lo = bf16(p - P_hi - P_mid), and O +=
// P_hi V + P_mid V + P_lo V (three MMAs, V through ldmatrix.trans), which
// is p V to ~2^-26 of each term, while l stays the sum of the f32 p. (Two
// terms, ~2^-17, miss the card tests' 2-ulp + 1e-6 bound on a few outputs
// near zero.) A warp skips a tile wholly above its rows' diagonal or
// wholly before their window (it would add exactly 0), and computes the
// mask only on a tile that the diagonal, the window's edge or the end of
// the keys cuts for its rows; the block skips tiles wholly masked for all
// its rows. The kv tile size and order do not
// depend on B, so a row's result is the same in any batch.
//
// f32 inputs (only the card-against-CPU checks and the tests use them)
// keep the first version's FMA body: tensor cores would need 3xTF32
// products to keep f32 exact. Four threads share a query row; each scores
// 16 of the tile's 64 columns, the row's probabilities are staged in shared
// memory, and each thread accumulates a quarter of the head dim.
//
// The caller passes the model's [B, S, heads, HD] layouts by strides, so
// nothing is transposed or copied before the launch. The kernels launch on
// the caller's stream, allocate nothing, and each entry point returns
// cudaGetLastError().

#include <type_traits>

#include "attention_common.cuh"

namespace {

using attn::kNegInf;
using attn::kTileRows;
using bf16 = __nv_bfloat16;

struct Strides {
    int64_t b, s, h;   // elements between batch rows, positions, heads
};

// ---- bf16: tensor cores ----

constexpr int kMmaThreads = 128;   // 4 warps of 16 query rows
constexpr int kMmaRows = 64;       // query rows per block

// kv rows per tile: 64, or 32 at HD 256, where a warp's 16 x 256 O
// fragments already hold 128 f32 registers a thread and the 64-column S
// tile would spill.
template <int HD>
__host__ __device__ constexpr int kv_rows() {
    return HD > 128 ? 32 : 64;
}

// K/V tile stages: one tile in flight while one is computed (3 stages
// measured no faster at HD 64 and slower at HD 256, where the third stage
// leaves room for one block an SM, not two)
constexpr int kStages = 2;

// Dynamic shared memory: the Q tile and the stages of K and V tiles.
template <int HD>
constexpr size_t mma_smem_bytes() {
    return sizeof(bf16) * attn::pitch<bf16, HD>() *
           (kMmaRows + 2 * kStages * kv_rows<HD>());
}

// One block per SM in the launch bound lets ptxas keep every fragment in
// registers (capping it at 128 for 4 blocks an SM spilled at HD 64 and ran
// slower).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ out, int S, int Tk,
          int H, int group, Strides qs, Strides ks, Strides vs, int causal,
          int window, float scale) {
    constexpr int kPitch = attn::pitch<bf16, HD>();
    constexpr int kKvRows = kv_rows<HD>();
    constexpr int kSt = kKvRows / 8;   // 8-column tiles of S per warp
    constexpr int kOt = HD / 8;        // 8-column tiles of O per warp
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* q_s = reinterpret_cast<bf16*>(smem);
    bf16* k_s = q_s + kMmaRows * kPitch;            // [kStages][kKvRows]
    bf16* v_s = k_s + kStages * kKvRows * kPitch;   // [kStages][kKvRows]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    // causal: the last query tiles, which visit the most kv tiles, first
    const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) *
                   kMmaRows;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int w0 = q0 + warp * 16;     // the warp's first query row
    const int rows[2] = {w0 + lane / 4, w0 + lane / 4 + 8};   // this thread's
    const int quad = lane % 4;
    // ldmatrix: the row (within 16) and 8-column half this lane addresses
    const int lm_row = lane % 8 + ((lane / 8) % 2) * 8;
    const int lm_col = (lane / 16) * 8;
    const int lm_krow = lane % 8 + (lane / 16) * 8;     // K: rows by n-tile
    const int lm_kcol = ((lane / 8) % 2) * 8;

    const bf16* q_head = q + b * qs.b + h * qs.h;
    const bf16* k_head = k + b * ks.b + (h / group) * ks.h;
    const bf16* v_head = v + b * vs.b + (h / group) * vs.h;
    const auto q_row = [=](int p) { return q_head + p * qs.s; };
    const auto k_row = [=](int p) { return k_head + p * ks.s; };
    const auto v_row = [=](int p) { return v_head + p * vs.s; };

    int kv_lo = 0;
    int kv_hi = Tk;
    if (causal) kv_hi = min(Tk, q0 + kMmaRows);
    if (window > 0) kv_lo = max(0, q0 - window + 1);
    kv_lo -= kv_lo % kKvRows;
    const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kKvRows - 1) / kKvRows
                                     : 0;

    // Q and the first kStages - 1 tiles, one commit group each (empty past
    // the last tile), so that the wait below always leaves one pending
    attn::async_rows<bf16, HD, kMmaRows, kMmaThreads>(q_s, q_row, q0, S, tid);
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < ntiles) {
            const int k0 = kv_lo + st * kKvRows;
            attn::async_rows<bf16, HD, kKvRows, kMmaThreads>(
                k_s + st * kKvRows * kPitch, k_row, k0, Tk, tid);
            attn::async_rows<bf16, HD, kKvRows, kMmaThreads>(
                v_s + st * kKvRows * kPitch, v_row, k0, Tk, tid);
        }
        attn::cp_async_commit();
    }

    float o[kOt][4];
#pragma unroll
    for (int d = 0; d < kOt; ++d) {
        o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};   // running max of the thread's rows
    float l[2] = {0.f, 0.f};           // this thread's partial sums

    for (int it = 0; it < ntiles; ++it) {
        const int k0 = kv_lo + it * kKvRows;
        attn::cp_async_wait<kStages - 2>();
        // this tile (and Q) has landed for every thread, and every warp is
        // done with the previous tile, whose stage the next copy refills
        __syncthreads();
        const int nxt = it + kStages - 1;
        if (nxt < ntiles) {
            const int at = (nxt % kStages) * kKvRows * kPitch;
            attn::async_rows<bf16, HD, kKvRows, kMmaThreads>(
                k_s + at, k_row, kv_lo + nxt * kKvRows, Tk, tid);
            attn::async_rows<bf16, HD, kKvRows, kMmaThreads>(
                v_s + at, v_row, kv_lo + nxt * kKvRows, Tk, tid);
        }
        attn::cp_async_commit();
        const int st = (it % kStages) * kKvRows * kPitch;
        const bf16* k_t = k_s + st;
        const bf16* v_t = v_s + st;
        const int k1 = k0 + kKvRows - 1;   // the tile's last column
        const bool skip = w0 >= S || (causal && k0 > w0 + 15) ||
                          (window > 0 && k1 <= w0 - window);
        // a tile that no mask cuts for any of the warp's rows
        const bool whole = k1 < Tk && (!causal || k1 <= w0) &&
                           (window <= 0 || k0 > w0 + 15 - window);
        if (!skip) {
            // S = Q K^T over this tile, f32 accumulators
            float s[kSt][4];
#pragma unroll
            for (int n = 0; n < kSt; ++n) {
                s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            }
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t a[4];
                attn::ldmatrix_x4(a, q_s + (warp * 16 + lm_row) * kPitch +
                                         kk * 16 + lm_col);
#pragma unroll
                for (int n = 0; n < kSt / 2; ++n) {
                    uint32_t bk[4];
                    attn::ldmatrix_x4(bk, k_t + (n * 16 + lm_krow) * kPitch +
                                              kk * 16 + lm_kcol);
                    attn::mma_bf16(s[2 * n], a, bk[0], bk[1]);
                    attn::mma_bf16(s[2 * n + 1], a, bk[2], bk[3]);
                }
            }
            // scale and mask; the rows' max over the tile
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int n = 0; n < kSt; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kj = k0 + n * 8 + 2 * quad + (e & 1);
                    const int qi = rows[e / 2];
                    const bool ok = whole ||
                                    (kj < Tk && (!causal || kj <= qi) &&
                                     (window <= 0 || kj > qi - window));
                    s[n][e] = ok ? s[n][e] * scale : kNegInf;
                    mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
                }
            }
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m[r], mx[r]);
                corr[r] = expf(m[r] - m_new);
                m[r] = m_new;
            }
            float psum[2] = {0.f, 0.f};
#pragma unroll
            for (int n = 0; n < kSt; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[n][e] = expf(s[n][e] - m[e / 2]);
                    psum[e / 2] += s[n][e];
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
            for (int d = 0; d < kOt; ++d) {
                o[d][0] *= corr[0];
                o[d][1] *= corr[0];
                o[d][2] *= corr[1];
                o[d][3] *= corr[1];
            }
            // O += P V with P = P_hi + P_mid + P_lo: the accumulator
            // fragments of two 8-column tiles of S are the A fragment of
            // one 16-key step
#pragma unroll
            for (int kk = 0; kk < kKvRows / 16; ++kk) {
                uint32_t hi[4], mid[4], lo[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    attn::split_bf16(s[2 * kk + r / 2][2 * (r % 2)],
                                     s[2 * kk + r / 2][2 * (r % 2) + 1],
                                     hi[r], mid[r], lo[r]);
                }
#pragma unroll
                for (int n = 0; n < kOt / 2; ++n) {
                    uint32_t bv[4];
                    attn::ldmatrix_x4_trans(bv, v_t + (kk * 16 + lm_row) *
                                                          kPitch +
                                                    n * 16 + lm_col);
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        attn::mma_bf16(o[2 * n + j], hi, bv[2 * j],
                                       bv[2 * j + 1]);
                        attn::mma_bf16(o[2 * n + j], mid, bv[2 * j],
                                       bv[2 * j + 1]);
                        attn::mma_bf16(o[2 * n + j], lo, bv[2 * j],
                                       bv[2 * j + 1]);
                    }
                }
            }
        }
    }
    attn::cp_async_wait<0>();   // no copy outlives the block (no kv tile)

    // each row's sum: the four partials of its quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (rows[r] >= S) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        bf16* orow = out + ((static_cast<int64_t>(b) * S + rows[r]) * H + h) *
                               HD + 2 * quad;
#pragma unroll
        for (int d = 0; d < kOt; ++d) {
            *reinterpret_cast<uint32_t*>(orow + d * 8) =
                attn::pack_bf16(o[d][2 * r] / denom, o[d][2 * r + 1] / denom);
        }
    }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Tk, int H, int KV, const Strides& qs,
               const Strides& ks, const Strides& vs, int causal, int window,
               float scale, cudaStream_t stream) {
    const size_t smem = mma_smem_bytes<HD>();
    cudaError_t err = attn::allow_smem(flash_fwd<HD>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + kMmaRows - 1) / kMmaRows, H, B);
    flash_fwd<HD><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Tk, H,
        H / KV, qs, ks, vs, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

// ---- f32: the FMA body ----

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_fma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Tk, int H, int KV, const Strides& qs,
               const Strides& ks, const Strides& vs, int causal, int window,
               float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes<T, HD>();
    cudaError_t err = attn::allow_smem(flash_fwd_fma<T, HD>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + kQRows - 1) / kQRows, H, B);
    flash_fwd_fma<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, H / KV, qs,
        ks, vs, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores, f32 on the FMA body
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, const Strides& qs, const Strides& ks,
           const Strides& vs, int causal, int window, float scale,
           cudaStream_t stream) {
    if constexpr (std::is_same_v<T, bf16>) {
        return launch_mma<HD>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
                              causal, window, scale, stream);
    } else {
        return launch_fma<T, HD>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
                                 causal, window, scale, stream);
    }
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
        case 96:
            return launch<T, 96>(q, k, v, out, B, S, Tk, H, KV, qs, ks, vs,
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

// Dynamic shared memory of the kernel that takes (dtype, hd), or 0.
size_t smem_for(bool is_bf16, int hd) {
    switch (hd) {
        case 32: return is_bf16 ? mma_smem_bytes<32>() : smem_bytes<float, 32>();
        case 64: return is_bf16 ? mma_smem_bytes<64>() : smem_bytes<float, 64>();
        case 96: return is_bf16 ? mma_smem_bytes<96>() : smem_bytes<float, 96>();
        case 128:
            return is_bf16 ? mma_smem_bytes<128>() : smem_bytes<float, 128>();
        case 256:
            return is_bf16 ? mma_smem_bytes<256>() : smem_bytes<float, 256>();
        default: return 0;
    }
}

}  // namespace

// Entry points. q: [B, S, H, hd] and k, v: [B, T, KV, hd], each given by
// its base pointer and element strides of its first three dims (the last
// dim is contiguous); out: a contiguous [B, S, H, hd] buffer of the same
// type. Pointers and strides in bytes are multiples of 16; hd is 32, 64,
// 96, 128 or 256; H is a multiple of KV. stream is a cudaStream_t. Each returns
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

// Bytes of dynamic shared memory a launch at (bf16 or f32, hd) asks for.
int flash_attention_smem_bytes(int is_bf16, int hd) {
    return static_cast<int>(smem_for(is_bf16 != 0, hd));
}

}  // extern "C"
