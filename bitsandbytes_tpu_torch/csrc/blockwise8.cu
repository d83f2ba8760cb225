// Blockwise 8-bit quantize and dequantize against a codebook of up to 256
// entries (the dynamic map by default).
//
// quantize_blockwise8_kernel replaces the TPU kernel quantize_blockwise_pallas
// (_q_kernel) of the JAX package's ops/pallas/blockwise8.py:
//   absmax = max |x| over the block
//   scaled = clip(x * (1 / absmax), -1, 1)       (inf below FLT_MIN, see below)
//   q      = #{midpoints m_i : m_i < scaled}     (NaN ranks 0)
// with the optional stochastic move to the neighbouring code entry, the
// uniforms given per element (the TPU kernel's "u" mode).
// Bound on the H100: bytes (4 B read, 1 B written per element, plus 4 B of
// absmax per block).  One warp owns one quantization block: a strided max
// with a shuffle reduction, then each lane ranks 4 elements a step (16-byte
// loads, one 4-byte store) by a binary search over the midpoints in shared
// memory (8 steps for 255 sorted midpoints, where the TPU kernel runs 255
// compare-adds; equal counts for sorted midpoints).  A codebook whose
// midpoints are not sorted takes the linear count instead.  The block's
// second pass finds its data in L1/L2.  The codebook and its midpoints come
// from device memory, read coalesced into shared memory by every block.
//
// dequantize_blockwise8_kernel replaces dequantize_blockwise_pallas
// (_dq_kernel) of the same file:
//   out = code[q] * absmax[block]   (f32 product, then rounded to the output type)
// Bound: bytes (1 B read, 2 or 4 B written per element).  One thread reads 8
// codes with one 8-byte load, looks them up in a shared-memory table and
// writes 8 values; blocksize >= 32 keeps the 8 inside one block.
//
// Built without --use_fast_math and with IEEE division: the codes must equal
// the JAX package's bit for bit.
#include <cfloat>

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kQThreads = 256;

__device__ __forceinline__ int rank_of(float s, const float* mid, int nmid, bool sorted) {
    if (sorted) {
        int lo = 0, hi = nmid;  // first midpoint >= s (NaN: none is < s, so 0)
        while (lo < hi) {
            const int m = (lo + hi) >> 1;
            if (mid[m] < s) lo = m + 1; else hi = m;
        }
        return lo;
    }
    int r = 0;
    for (int j = 0; j < nmid; ++j) r += (mid[j] < s) ? 1 : 0;
    return r;
}

// One element: scale, clip, rank, and the optional stochastic move.
__device__ __forceinline__ uint32_t quantize_one(float x, float scale, float u, bool stochastic,
                                                 const float* code, const float* mid, int ncode,
                                                 bool sorted) {
    float sc = x * scale;
    // clip keeps a NaN, as it does in the JAX package (fminf/fmaxf would not)
    if (!isnan(sc)) sc = fminf(fmaxf(sc, -1.0f), 1.0f);
    int r = rank_of(sc, mid, ncode - 1, sorted);
    if (stochastic) {
        const float lower = code[r];
        const int nb = min(max(r + (sc > lower ? 1 : -1), 0), ncode - 1);
        const float gap = fabsf(code[nb] - lower);
        const float p = gap > 0.0f ? fabsf(sc - lower) / fmaxf(gap, 1e-20f) : 0.0f;
        if (u < p) r = nb;
    }
    return (uint32_t)r;
}

// tables: the codebook (256 floats, ncode used) then its midpoints (255
// floats, ncode - 1 used), in device memory.
__global__ void __launch_bounds__(kQThreads)
quantize_blockwise8_kernel(const float* __restrict__ x, const float* __restrict__ u,
                           uint8_t* __restrict__ q, float* __restrict__ absmax,
                           long long nblocks, int blocksize, const float* __restrict__ tables,
                           int ncode, int sorted) {
    __shared__ float s_code[256];
    __shared__ float s_mid[256];
    for (int i = threadIdx.x; i < 511; i += kQThreads) {
        if (i < 256) s_code[i] = tables[i];
        else s_mid[i - 256] = tables[i];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long blk = (long long)blockIdx.x * (kQThreads / 32) + (threadIdx.x >> 5);
    if (blk >= nblocks) return;  // uniform across the warp
    const float* xb = x + blk * blocksize;
    uint8_t* qb = q + blk * blocksize;
    const float* ub = u ? u + blk * blocksize : nullptr;

    float m = 0.0f;
    for (int i = lane * 4; i < blocksize; i += 128) {  // blocksize % 4 == 0: whole float4s
        const float4 v = *reinterpret_cast<const float4*>(xb + i);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    m = warp_max(m);
    // The JAX package computes 1 / max(absmax, 1e-38) with subnormals
    // flushed, so an all-zero block gets scale inf, NaN scaled values and
    // rank 0.  Mirror that exactly.
    const float scale = m < FLT_MIN ? INFINITY : 1.0f / m;
    const bool srt = sorted != 0;
    const bool stoch = ub != nullptr;

    // 4 elements a lane per step: a 16-byte load (the block's second read,
    // mostly from L1/L2) and one 4-byte store of 4 codes
    for (int i = lane * 4; i < blocksize; i += 128) {
        const float4 v = *reinterpret_cast<const float4*>(xb + i);
        const float4 w = stoch ? *reinterpret_cast<const float4*>(ub + i) : make_float4(0, 0, 0, 0);
        const uint32_t r0 = quantize_one(v.x, scale, w.x, stoch, s_code, s_mid, ncode, srt);
        const uint32_t r1 = quantize_one(v.y, scale, w.y, stoch, s_code, s_mid, ncode, srt);
        const uint32_t r2 = quantize_one(v.z, scale, w.z, stoch, s_code, s_mid, ncode, srt);
        const uint32_t r3 = quantize_one(v.w, scale, w.w, stoch, s_code, s_mid, ncode, srt);
        *reinterpret_cast<uint32_t*>(qb + i) = r0 | (r1 << 8) | (r2 << 16) | (r3 << 24);
    }
    if (lane == 0) absmax[blk] = m;
}

constexpr int kDqThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDqThreads)
dequantize_blockwise8_kernel(const uint8_t* __restrict__ q, const float* __restrict__ absmax,
                             T* __restrict__ out, long long n, int blocksize,
                             const float* __restrict__ tables) {
    __shared__ float s_code[256];
    for (int i = threadIdx.x; i < 256; i += kDqThreads) s_code[i] = tables[i];
    __syncthreads();

    const long long i8 = ((long long)blockIdx.x * kDqThreads + threadIdx.x) * 8;
    if (i8 >= n) return;
    const uint2 w = *reinterpret_cast<const uint2*>(q + i8);
    const float am = absmax[i8 / blocksize];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? w.x : w.y;
        v[j] = s_code[(word >> (8 * (j & 3))) & 0xFFu] * am;
    }
    store8(out + i8, v);
}

}  // namespace

// x, u (nullable), q, absmax: n elements in whole blocks.  tables: 511 floats
// on the device, the codebook padded to 256 then its 255 midpoints (padded);
// ncode entries used; sorted: the used midpoints are non-decreasing.
BNB_EXPORT int bnb_quantize_blockwise8(const float* x, const float* u, uint8_t* q, float* absmax,
                                       long long n, int blocksize, const float* tables, int ncode,
                                       int sorted, cudaStream_t stream) {
    if (blocksize < 4 || blocksize % 4 || n % blocksize || ncode < 2 || ncode > 256)
        return (int)cudaErrorInvalidValue;
    const long long nblocks = n / blocksize;
    if (nblocks > 0) {
        const long long grid = (nblocks + kQThreads / 32 - 1) / (kQThreads / 32);
        quantize_blockwise8_kernel<<<(unsigned)grid, kQThreads, 0, stream>>>(
            x, u, q, absmax, nblocks, blocksize, tables, ncode, sorted);
    }
    return (int)cudaGetLastError();
}

// out_kind: 0 float32, 1 bfloat16, 2 float16.  tables as above (only the
// codebook part is read).
BNB_EXPORT int bnb_dequantize_blockwise8(const uint8_t* q, const float* absmax, void* out,
                                         long long n, int blocksize, const float* tables,
                                         int out_kind, cudaStream_t stream) {
    if (blocksize < 8 || blocksize % 8 || n % blocksize || out_kind < 0 || out_kind > 2)
        return (int)cudaErrorInvalidValue;
    const long long threads = n / 8;
    if (threads > 0) {
        const unsigned grid = (unsigned)((threads + kDqThreads - 1) / kDqThreads);
        if (out_kind == 0)
            dequantize_blockwise8_kernel<float><<<grid, kDqThreads, 0, stream>>>(
                q, absmax, static_cast<float*>(out), n, blocksize, tables);
        else if (out_kind == 1)
            dequantize_blockwise8_kernel<__nv_bfloat16><<<grid, kDqThreads, 0, stream>>>(
                q, absmax, static_cast<__nv_bfloat16*>(out), n, blocksize, tables);
        else
            dequantize_blockwise8_kernel<__half><<<grid, kDqThreads, 0, stream>>>(
                q, absmax, static_cast<__half*>(out), n, blocksize, tables);
    }
    return (int)cudaGetLastError();
}
