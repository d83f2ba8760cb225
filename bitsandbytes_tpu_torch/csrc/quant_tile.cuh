// The tile of the blockwise quantize kernels (quant4bit.cu, kernel 1, and
// blockwise8.cu, kernel 13).
//
// A CUDA block of kQtThreads threads owns R runs of kQtRun contiguous
// elements.  In run r, thread tid holds elements r * kQtRun + tid * 16 ..
// + 16 in registers: a warp covers 512 contiguous elements a run, and a
// lane's 16 codes leave as one 16-byte store, so each warp store writes 512
// contiguous bytes.  Every load of a tile is issued before any is used, so
// the input is read from device memory once.  A quantization block (a power
// of two, 32..4096 elements) is blocksize / 16 neighbouring lanes of one warp
// up to 512, else blocksize / 512 neighbouring warps; its absmax is a
// __shfl_xor_sync max over its lanes, combined across warps in shared memory
// from 1024 on.  The lane that holds a block's first element stores its
// absmax.  A run past the end of the input (n is a whole number of blocks,
// so of 16-element pieces) is neither read nor written.
#pragma once

#include <cfloat>

#include "common.cuh"

constexpr int kQtThreads = 256;
constexpr int kQtWarps = kQtThreads / 32;
constexpr int kQtLane = 16;                   // contiguous elements a lane holds of one run
constexpr int kQtRun = kQtThreads * kQtLane;  // 4096: a run holds whole blocks of every blocksize

// 16 elements of T as they lie in memory: 4 (f32) or 2 (16-bit) 16-byte words.
template <class T>
struct Raw16 {
    uint4 w[sizeof(T)];
};

template <class T>
__device__ __forceinline__ void load_raw16(const T* p, Raw16<T>& r) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < (int)sizeof(T); ++k) r.w[k] = __ldg(q + k);
}

// The 16 elements upcast to f32 (exact), in memory order.
template <class T>
__device__ __forceinline__ void unpack16(const Raw16<T>& r, float* v) {
#pragma unroll
    for (int k = 0; k < (int)sizeof(T); ++k) {
        const uint32_t w[4] = {r.w[k].x, r.w[k].y, r.w[k].z, r.w[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if constexpr (sizeof(T) == 4) {
                v[4 * k + i] = __uint_as_float(w[i]);
            } else if constexpr (std::is_same<T, __half>::value) {
                const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
                v[8 * k + 2 * i] = f.x;
                v[8 * k + 2 * i + 1] = f.y;
            } else {  // bf16: the upper 16 bits of an f32
                v[8 * k + 2 * i] = __uint_as_float(w[i] << 16);
                v[8 * k + 2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
            }
        }
    }
}

// m[r]: this lane's max |x| of run r in; out: the max over its quantization
// block.  blocksize = 1 << log2bs, 32..4096; the whole block calls it (it may
// wait at a barrier).  fmaxf ignores a NaN, in any order.
template <int R>
__device__ __forceinline__ void qt_block_max(float (&m)[R], int log2bs, float* s_wmax) {
    const int lanes = 1 << (log2bs - 4);  // lanes of one quantization block
    if (lanes <= 32) {
        for (int o = 1; o < lanes; o <<= 1)
#pragma unroll
            for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
        return;
    }
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = warp_max(m[r]);
    if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int r = 0; r < R; ++r) s_wmax[r * kQtWarps + warp] = m[r];
    __syncthreads();
    const int g = lanes >> 5, first = warp & ~(g - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        float v = s_wmax[r * kQtWarps + first];
        for (int k = 1; k < g; ++k) v = fmaxf(v, s_wmax[r * kQtWarps + first + k]);
        m[r] = v;
    }
}

// 16 codes (each < 256), one a byte in element order, as one 16-byte store.
__device__ __forceinline__ void store_codes16(uint8_t* dst, const uint32_t* q) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = q[4 * k] | (q[4 * k + 1] << 8) | (q[4 * k + 2] << 16) | (q[4 * k + 3] << 24);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The scale of a block, as the JAX package computes 1 / max(absmax, 1e-38)
// with subnormals flushed (XLA on the CPU, and the TPU): its clamp to the
// subnormal 1e-38 is a no-op, so an all-zero block gets scale inf, NaN
// scaled values and rank 0.  IEEE division (built with -prec-div=true).
__device__ __forceinline__ float qt_scale(float m) { return m < FLT_MIN ? INFINITY : 1.0f / m; }
