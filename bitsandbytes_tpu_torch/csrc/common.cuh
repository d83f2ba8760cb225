// Shared helpers for the hand-written Hopper kernels of bitsandbytes_tpu_torch.
// Every entry point has a plain C interface (loaded with ctypes), launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The same in f16 (one cvt.rn.f16x2.f32).
__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);  // .x at the lower address
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

// Operand types a C entry point takes, by the wrappers' codes (_KIND).
enum Kind { kF32 = 0, kBf16 = 1, kF16 = 2 };

// --- the double-quantized absmax (the _dq kernels of gemm4bit_paired.cu and gemm4bit.cu) ---

constexpr int kMaxSegments = 40;

// The half map's segments (functional/dynamic_segments.kernel_table): code
// i decodes as +-fma(float(a - sub[k]), step[k], add[k]), a = |i - zero_idx|
// in segment k (the last k with start[k] <= a).
struct DynDecode {
    int zero_idx;
    int nseg;
    int start[kMaxSegments];
    int sub[kMaxSegments];
    float step[kMaxSegments];
    float add[kMaxSegments];
};

// Entry i of the canonical dynamic map, rounded as the JAX package's jitted
// decode rounds it (one fused multiply-add).  Each kernel fills a 256-entry
// shared-memory table with it once per block.
__device__ __forceinline__ float dyn_decode(const DynDecode& dec, int i) {
    const int d = i - dec.zero_idx;
    const int a = d < 0 ? -d : d;
    int k = 0;
    while (k + 1 < dec.nseg && a >= dec.start[k + 1]) ++k;
    const float v = __fmaf_rn((float)(a - dec.sub[k]), dec.step[k], dec.add[k]);
    return d < 0 ? -v : v;
}

template <class T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32(float x) { return x; }
template <> __device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <> __device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half from_f32(float x) { return __float2half_rn(x); }

// x rounded to T's precision, as f32.
template <class T> __device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Eight values of T at a 16-byte aligned address, as f32.
template <class T> __device__ __forceinline__ void load8(const T* src, float* a) {
    if constexpr (sizeof(T) == 4) {
        const float4 u = *reinterpret_cast<const float4*>(src);
        const float4 v = *reinterpret_cast<const float4*>(src + 4);
        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
        a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
    } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float2 f;
            if constexpr (std::is_same<T, __half>::value) {
                __half2 h = *reinterpret_cast<const __half2*>(&w[i]);
                f = __half22float2(h);
            } else {
                f = unpack_bf16x2(w[i]);
            }
            a[2 * i] = f.x;
            a[2 * i + 1] = f.y;
        }
    }
}

// Two f32 values rounded to a 16-bit T, packed low address first.
template <class T> __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const T a = from_f32<T>(lo), b = from_f32<T>(hi);
    return (uint32_t)(*reinterpret_cast<const uint16_t*>(&a)) |
           ((uint32_t)(*reinterpret_cast<const uint16_t*>(&b)) << 16);
}

// Eight f32 values rounded to T, stored at a 16-byte aligned address.
template <class T> __device__ __forceinline__ void store8(T* dst, const float* a) {
    if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(a[4], a[5], a[6], a[7]);
    } else {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack2<T>(a[0], a[1]), pack2<T>(a[2], a[3]), pack2<T>(a[4], a[5]), pack2<T>(a[6], a[7]));
    }
}

// 16 bytes of T (eight 16-bit values or four f32) rounded from f32, at a
// 16-byte aligned address: one store instruction.
template <class T> __device__ __forceinline__ void store16(T* dst, const float* a) {
    if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
    else
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack2<T>(a[0], a[1]), pack2<T>(a[2], a[3]), pack2<T>(a[4], a[5]), pack2<T>(a[6], a[7]));
}

// --- PTX helpers of the tensor-core kernels (flash_cached.cu, gemm4bit.cu) ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes (nothing read) when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x16] b[16x8], f16 in, f32 accumulate.
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

