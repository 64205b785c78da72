// Helpers shared by the port's attention kernels (flash_attention.cu,
// decode_attention.cu): element conversion, 8-wide loads from shared
// memory, and the cooperative copy of a [64, HD] tile into shared memory.
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

// Copy rows [row0, row0 + 64) of a row-strided [rows, HD] matrix into a
// shared tile of pitch<T, HD>(), 16 bytes per thread per step; rows at or
// past `valid` are written as zeros (never read from device memory). The
// caller guarantees 16-byte alignment of `src` and of `stride` in bytes.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride,
                                          int row0, int valid, int tid,
                                          int nthreads) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // elements / 16 B
    constexpr int kChunks = HD / kPer;                         // per row
    constexpr int kPitch = pitch<T, HD>();
    for (int i = tid; i < kTileRows * kChunks; i += nthreads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * kPer;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < valid) {
            val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
        }
        *reinterpret_cast<uint4*>(dst + r * kPitch + c) = val;
    }
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

}  // namespace attn
