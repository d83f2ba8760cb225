// Shared helpers for the hand-written Hopper kernels of bitsandbytes_tpu_torch.
// Every entry point has a plain C interface (loaded with ctypes), launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BNB_EXPORT extern "C" __attribute__((visibility("default")))

// The 16 entries of a 4-bit codebook, rounded to bf16 and held as f32: the
// "unit" values the JAX package's paired kernels decode (_pair_words).
struct Units16 {
    float v[16];
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x at the lower address
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
    return __bfloat1622float2(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}
