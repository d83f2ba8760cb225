// 4-bit blockwise quantize: W -> (codes, absmax).
//
// Replaces the TPU kernel quantize_4bit_codes_pallas (_q4_kernel) of the JAX
// package's ops/pallas/quant4bit.py.
//
// Bound on the H100: bytes.  Each element is read once as f32 (4 B) and
// written once as a code (1 B), plus 4 B of absmax per block; the compare-
// rank is 15 compares per element, far below the card's integer rate.  The
// design keeps one 64-element block in one warp: a coalesced read, a
// __shfl_xor_sync max, then each lane ranks its elements from registers, so
// the input is read from device memory exactly once.
//
// The codes must equal the JAX package's bit for bit, so this file is built
// without --use_fast_math, with IEEE division and without flush-to-zero:
//   scale  = 1 / absmax   (inf below the smallest normal float, see below)
//   scaled = clip(x * scale, -1, 1)
//   rank   = #{sorted midpoints m_i : scaled > m_i}
// and rank is mapped to the bit pattern through the argsort order for
// codebooks stored in bit-pattern order (FP4, int4, af4; NF4 is sorted).
//
// Stochastic mode (the TPU kernel's mode "u", _stochastic_move16): given one
// f32 uniform u per element, the rank moves to its value-adjacent neighbour
// (toward the scaled value, clipped to 0..15) when
//   u < |scaled - code[rank]| / max(|code[nbr] - code[rank]|, 1e-20)
// over the value-sorted code, before the bit-pattern map.  The uniforms
// come from the caller (a torch.Generator), as the TPU's interpret tier
// takes them; they add 4 B read per element.
// Codes come out unpacked, one per byte; the caller packs them in the
// layout it needs (flat, 2d or N-paired), as the TPU kernel's caller does.
#include <cfloat>

#include "common.cuh"

namespace {

struct Q4Tables {
    float mid[15];
    int order[16];
    float sorted[16];  // the code in value order (stochastic mode)
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_4bit_codes_kernel(const float* __restrict__ x, const float* __restrict__ u,
                           uint8_t* __restrict__ codes, float* __restrict__ absmax, long long nblocks,
                           int blocksize, Q4Tables tab, int identity) {
    const int lane = threadIdx.x & 31;
    const long long blk = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (blk >= nblocks) return;  // uniform across the warp
    const float* xb = x + blk * blocksize;
    uint8_t* qb = codes + blk * blocksize;

    float m = 0.0f;
    for (int i = lane; i < blocksize; i += 32) m = fmaxf(m, fabsf(xb[i]));
    m = warp_max(m);
    // The JAX package computes 1 / max(absmax, 1e-38) with subnormals
    // flushed (XLA on the CPU, and the TPU), so its clamp to the subnormal
    // 1e-38 is a no-op: an all-zero block gets scale = inf, scaled = NaN and
    // rank 0.  Mirror that exactly.
    const float scale = m < FLT_MIN ? INFINITY : 1.0f / m;

    for (int i = lane; i < blocksize; i += 32) {
        float s = xb[i] * scale;
        s = fminf(fmaxf(s, -1.0f), 1.0f);
        int r = 0;
#pragma unroll
        for (int j = 0; j < 15; ++j) r += (s > tab.mid[j]) ? 1 : 0;
        if (u != nullptr) {
            const float lower = tab.sorted[r];
            const int nbr = min(max(r + (s > lower ? 1 : -1), 0), 15);
            const float gap = fabsf(tab.sorted[nbr] - lower);
            const float p_move = gap > 0.0f ? fabsf(s - lower) / fmaxf(gap, 1e-20f) : 0.0f;
            if (u[blk * blocksize + i] < p_move) r = nbr;
        }
        if (!identity) r = tab.order[r];
        qb[i] = (uint8_t)r;
    }
    if (lane == 0) absmax[blk] = m;
}

}  // namespace

// u: NULL, or one f32 uniform per element (stochastic mode); sorted_code [16]
// on the host.
BNB_EXPORT int bnb_quantize_4bit_codes(const float* x, const float* u, uint8_t* codes, float* absmax,
                                       long long n, int blocksize, const float* midpoints,
                                       const int* order, const float* sorted_code, int identity,
                                       cudaStream_t stream) {
    if (blocksize <= 0 || n % blocksize) return (int)cudaErrorInvalidValue;
    Q4Tables tab;
    for (int j = 0; j < 15; ++j) tab.mid[j] = midpoints[j];
    for (int j = 0; j < 16; ++j) tab.order[j] = order[j];
    for (int j = 0; j < 16; ++j) tab.sorted[j] = sorted_code[j];
    const long long nblocks = n / blocksize;
    if (nblocks > 0) {
        const long long grid = (nblocks + kThreads / 32 - 1) / (kThreads / 32);
        quantize_4bit_codes_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
            x, u, codes, absmax, nblocks, blocksize, tab, identity);
    }
    return (int)cudaGetLastError();
}
