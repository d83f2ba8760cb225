// Fused 8-bit blockwise optimizer update.
//
// optimizer_update_8bit_kernel replaces the TPU kernel
// optimizer_update_8bit_pallas -> _run (body _kernel) of the JAX package's
// ops/pallas/optim8bit.py.  Per 256-element quantization block, in one pass:
//   s    = decode(code) * absmax             (segment arithmetic, below)
//   p, s = rule(g * gnorm_scale, p, s)      (adam, momentum, lion, rmsprop, adagrad)
//   non-finite g: p kept, states zeroed
//   absmax' = max |s| over the block
//   code' = requant(clip(s * (1 / absmax'), -1, 1)), sign fixup on state1
// written in place: the parameter, both uint8 states and both absmax arrays.
//
// optimizer_update_8bit_ademamix_kernel replaces the TPU kernel
// optimizer_update_8bit_pallas -> _run_ademamix (body _kernel_ademamix) of
// the same file: AdEMAMix's three states in the same pass,
//   m1' = fma(1 - beta1, g, m1 * beta1)            (signed map, sign fixup)
//   m2' = fma(1 - beta3_t, g, m2 * beta3_t)        (signed map, sign fixup)
//   nu' = fma((1 - beta2) g, g, nu * beta2)        (unsigned map, no fixup)
//   u   = fma(alpha_t, m2', m1' / c1) / (sqrt(nu') / c2 + eps)
//   p'  = fma(p, 1 - lr wd, -(lr u))  or, without decay, fma(-lr, u, p)
// with the scheduled alpha_t and beta3_t and the bias corrections c1, c2
// from the host.  The fused multiply-adds stand where XLA contracts the JAX
// kernel's products on the CPU, so the plain version (which rounds them the
// same way) gives the JAX kernel's bits.  Bound by bytes too: 18 per
// element.  The same warp per quantization block; the two momenta arrive as
// two pointers, the halves of the JAX package's [2, n] leaf, so the second
// one need not be 8-byte aligned and its codes load bytewise when it is not.
//
// g and p are f32, bf16 or f16 (one type for both): loaded in that type,
// the update computed in f32, p stored in its own type rounded to nearest
// even, as the JAX package's new_p.astype(p.dtype).  States and absmax are
// unchanged by the parameter type.
//
// Bound on the H100: bytes, 16 per element in f32 (g 4 read, p 4 read + 4
// written, each uint8 state 1 read + 1 written), 10 in bf16 or f16.  One warp owns one quantization
// block, 8 elements a lane (two 16-byte loads of g and of p, one 8-byte load
// of each state), so the block absmax is a shuffle reduction in registers and
// no block order is assumed.  A grid-stride loop lets each CUDA block build
// its two 256-entry decode tables once in shared memory and reuse them over
// many quantization blocks.  The TPU kernel's grid walks [TB, 256] tiles in
// order; here any block may run first, since blocks share nothing.
//
// Segment arithmetic (functional/dynamic_segments.py): code i of a map
// decodes as fma(float(a - sub[k]), step[k], add[k]) for a = i (or |i - z|
// on the half map of a symmetric map, with the sign of i - z), k the segment
// of a by start[]; a value x requantizes to start[k] + clamp(floor(fma(x -
// rsub[k], inv[k], radd[k])), 0, cnt1[k]) for k the segment of x by the
// boundary midpoints bound[] (x > bound: a value on a boundary goes down).
// A NaN scaled value (an all-zero block, 0 * inf) counts as negative.
//
// Every operation of the update is an explicitly rounded intrinsic in the
// plain version's order (ops/optim8bit.py), so nvcc's contraction cannot
// move a code between the two.  Built without --use_fast_math.
#include <cfloat>

#include "common.cuh"

constexpr int kMaxSeg = 16;

// One state codebook's segments (ops/optim8bit._StateMap).
struct StateMap {
    int sym;         // decode and requantize on the half map, mirrored at zero_idx
    int signed_map;  // the sign fixup applies
    int zero_idx;
    int nseg;
    int start[kMaxSeg];
    int sub[kMaxSeg];
    int cnt1[kMaxSeg];
    float step[kMaxSeg];
    float add[kMaxSeg];
    float bound[kMaxSeg];  // nseg - 1 used
    float rsub[kMaxSeg];
    float inv[kMaxSeg];
    float radd[kMaxSeg];
};

// One step's float32 scalars, computed on the host (ops/optim8bit.UpdateScalars).
struct OptScalars {
    float beta1, beta2, omb1, omb2, eps, eps_c2, step_size, lr, weight_decay, decay, gnorm_scale;
    int use_decay;
    int first_step;
    float c1, c2, alpha_t, beta3_t, omb3;  // ademamix
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 256;
constexpr int kPerLane = kBlock / 32;  // 8

enum Rule { kAdam = 0, kMomentum = 1, kLion = 2, kRmsprop = 3, kAdagrad = 4 };

__device__ __forceinline__ float decode_entry(const StateMap& m, int i) {
    const int d = m.sym ? i - m.zero_idx : i;
    const int a = d < 0 ? -d : d;
    int k = 0;
    while (k + 1 < m.nseg && a >= m.start[k + 1]) ++k;
    const float v = __fmaf_rn((float)(a - m.sub[k]), m.step[k], m.add[k]);
    return d < 0 ? -v : v;
}

__device__ __forceinline__ bool negative(float x) { return signbit(x) || isnan(x); }

// A scaled value in [-1, 1] (or NaN) -> its code.
__device__ __forceinline__ uint32_t requant(const StateMap& m, float x, bool fixup) {
    const bool neg = negative(x);
    const float a = m.sym ? fabsf(x) : x;
    int k = 0;
    for (int b = 0; b + 1 < m.nseg; ++b) k += (a > m.bound[b]) ? 1 : 0;
    const float t = __fmaf_rn(__fsub_rn(a, m.rsub[k]), m.inv[k], m.radd[k]);
    int j = 0;
    if (!isnan(t)) {
        const float f = floorf(t);
        j = f <= 0.0f ? 0 : min((int)f, m.cnt1[k]);
    }
    int q = m.start[k] + j;
    if (m.sym) {
        const int jn = min(q, m.zero_idx);
        q = neg ? m.zero_idx - jn : m.zero_idx + q;
    }
    if (fixup && m.signed_map && ((q < m.zero_idx) != neg)) q = neg ? q - 1 : q + 1;
    return (uint32_t)q;
}

__device__ __forceinline__ float sign_of(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <int kRule>
__device__ __forceinline__ void rule_update(const OptScalars& sc, float g, float& p, float s1, float s2,
                                            float& ns1, float& ns2) {
    if (kRule == kAdam) {
        ns1 = __fadd_rn(__fmul_rn(s1, sc.beta1), __fmul_rn(sc.omb1, g));
        ns2 = __fadd_rn(__fmul_rn(s2, sc.beta2), __fmul_rn(__fmul_rn(sc.omb2, g), g));
        const float pd = sc.use_decay ? __fmul_rn(p, sc.decay) : p;
        p = __fadd_rn(pd, __fmul_rn(sc.step_size,
                                    __fdiv_rn(ns1, __fadd_rn(__fsqrt_rn(ns2), sc.eps_c2))));
    } else if (kRule == kMomentum) {
        const float gw = __fadd_rn(g, __fmul_rn(p, sc.weight_decay));
        ns1 = sc.first_step ? gw : __fadd_rn(__fmul_rn(s1, sc.beta1), gw);
        p = __fsub_rn(p, __fmul_rn(sc.lr, ns1));
    } else if (kRule == kLion) {
        const float pd = sc.use_decay ? __fmul_rn(p, sc.decay) : p;
        const float dir = sign_of(__fadd_rn(__fmul_rn(s1, sc.beta1), __fmul_rn(sc.omb1, g)));
        p = __fsub_rn(pd, __fmul_rn(sc.lr, dir));
        ns1 = __fadd_rn(__fmul_rn(s1, sc.beta2), __fmul_rn(sc.omb2, g));
    } else if (kRule == kRmsprop) {
        const float gw = __fadd_rn(g, __fmul_rn(p, sc.weight_decay));
        ns1 = __fadd_rn(__fmul_rn(s1, sc.beta1), __fmul_rn(__fmul_rn(sc.omb1, gw), gw));
        p = __fsub_rn(p, __fdiv_rn(__fmul_rn(sc.lr, gw), __fadd_rn(__fsqrt_rn(ns1), sc.eps)));
    } else {
        const float gw = __fadd_rn(g, __fmul_rn(p, sc.weight_decay));
        ns1 = __fadd_rn(s1, __fmul_rn(gw, gw));
        p = __fsub_rn(p, __fdiv_rn(__fmul_rn(sc.lr, gw), __fadd_rn(__fsqrt_rn(ns1), sc.eps)));
    }
}

__device__ __forceinline__ float inv_absmax(float m) {
    // The JAX package computes 1 / max(absmax, 1e-38) with subnormals
    // flushed: an all-zero block gets scale inf and NaN scaled values.
    return m < FLT_MIN ? INFINITY : 1.0f / m;
}

__device__ __forceinline__ float clip_unit(float x) {
    return isnan(x) ? x : fminf(fmaxf(x, -1.0f), 1.0f);  // a NaN stays NaN, as in jnp.clip
}

template <int kRule, bool kTwo, class T>
__global__ void __launch_bounds__(kThreads)
optimizer_update_8bit_kernel(const T* __restrict__ g, T* __restrict__ p,
                             uint8_t* __restrict__ s1, uint8_t* __restrict__ s2,
                             float* __restrict__ am1, float* __restrict__ am2, long long n,
                             long long nblocks, OptScalars sc, StateMap map1, StateMap map2,
                             int fixup) {
    __shared__ float t1[256];
    __shared__ float t2[256];
    __shared__ StateMap m1, m2;
    const int tid = threadIdx.x;
    if (tid == 0) m1 = map1;
    if (tid == 32 && kTwo) m2 = map2;
    t1[tid] = decode_entry(map1, tid);
    if (kTwo) t2[tid] = decode_entry(map2, tid);
    __syncthreads();

    const int lane = tid & 31;
    const bool fix = fixup != 0;
    for (long long blk = (long long)blockIdx.x * kWarps + (tid >> 5); blk < nblocks;
         blk += (long long)gridDim.x * kWarps) {
        const long long base = blk * kBlock + lane * kPerLane;
        const bool whole = base + kPerLane <= n;
        float gv[kPerLane], pv[kPerLane], p0[kPerLane], x1[kPerLane], x2[kPerLane];
        uint8_t c1[kPerLane], c2[kPerLane];
        if (whole) {
            load8(g + base, gv);
            load8(p + base, pv);
            const uint2 w1 = *reinterpret_cast<const uint2*>(s1 + base);
            uint2 w2 = make_uint2(0, 0);
            if (kTwo) w2 = *reinterpret_cast<const uint2*>(s2 + base);
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                c1[j] = (uint8_t)(((j < 4 ? w1.x : w1.y) >> (8 * (j & 3))) & 0xFFu);
                c2[j] = (uint8_t)(((j < 4 ? w2.x : w2.y) >> (8 * (j & 3))) & 0xFFu);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                const bool in = base + j < n;
                gv[j] = in ? to_f32(g[base + j]) : 0.0f;
                pv[j] = in ? to_f32(p[base + j]) : 0.0f;
                c1[j] = in ? s1[base + j] : (uint8_t)m1.zero_idx;
                c2[j] = (kTwo && in) ? s2[base + j] : (uint8_t)(kTwo ? m2.zero_idx : 0);
            }
        }
        const float a1 = am1[blk];
        const float a2 = kTwo ? am2[blk] : 0.0f;

        float mx1 = 0.0f, mx2 = 0.0f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            const float gj = __fmul_rn(gv[j], sc.gnorm_scale);
            const float s1v = __fmul_rn(t1[c1[j]], a1);
            const float s2v = kTwo ? __fmul_rn(t2[c2[j]], a2) : 0.0f;
            float pj = pv[j], ns1, ns2 = 0.0f;
            rule_update<kRule>(sc, gj, pj, s1v, s2v, ns1, ns2);
            if (!isfinite(gj)) {
                pj = pv[j];
                ns1 = 0.0f;
                ns2 = 0.0f;
            }
            p0[j] = pj;
            x1[j] = ns1;
            x2[j] = ns2;
            mx1 = fmaxf(mx1, fabsf(ns1));
            mx2 = fmaxf(mx2, fabsf(ns2));
        }
        mx1 = warp_max(mx1);
        if (kTwo) mx2 = warp_max(mx2);
        const float sc1 = inv_absmax(mx1);
        const float sc2 = inv_absmax(mx2);

        uint32_t q1[2] = {0u, 0u}, q2[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            q1[j >> 2] |= requant(m1, clip_unit(__fmul_rn(x1[j], sc1)), fix) << (8 * (j & 3));
            if (kTwo) q2[j >> 2] |= requant(m2, clip_unit(__fmul_rn(x2[j], sc2)), false) << (8 * (j & 3));
        }
        if (whole) {
            store8(p + base, p0);
            *reinterpret_cast<uint2*>(s1 + base) = make_uint2(q1[0], q1[1]);
            if (kTwo) *reinterpret_cast<uint2*>(s2 + base) = make_uint2(q2[0], q2[1]);
        } else {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                if (base + j < n) {
                    p[base + j] = from_f32<T>(p0[j]);
                    s1[base + j] = (uint8_t)(q1[j >> 2] >> (8 * (j & 3)));
                    if (kTwo) s2[base + j] = (uint8_t)(q2[j >> 2] >> (8 * (j & 3)));
                }
            }
        }
        if (lane == 0) {  // every lane read the old absmax before the shuffles above
            am1[blk] = mx1;
            if (kTwo) am2[blk] = mx2;
        }
    }
}

// Eight codes of a state at s + base: one 8-byte load where aligned and
// whole, else byte by byte with the code of 0.0 past n.
__device__ __forceinline__ void load_codes8(const uint8_t* s, long long base, long long n, bool whole,
                                            uint8_t zero, uint8_t* c) {
    if (whole && ((reinterpret_cast<uintptr_t>(s + base) & 7u) == 0)) {
        const uint2 w = *reinterpret_cast<const uint2*>(s + base);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) c[j] = (uint8_t)(((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xFFu);
    } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) c[j] = base + j < n ? s[base + j] : zero;
    }
}

__device__ __forceinline__ void store_codes8(uint8_t* s, long long base, long long n, bool whole,
                                             const uint32_t* q) {
    if (whole && ((reinterpret_cast<uintptr_t>(s + base) & 7u) == 0)) {
        *reinterpret_cast<uint2*>(s + base) = make_uint2(q[0], q[1]);
    } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
            if (base + j < n) s[base + j] = (uint8_t)(q[j >> 2] >> (8 * (j & 3)));
    }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
optimizer_update_8bit_ademamix_kernel(const T* __restrict__ g, T* __restrict__ p,
                                      uint8_t* __restrict__ m1, uint8_t* __restrict__ m2,
                                      uint8_t* __restrict__ nu, float* __restrict__ am_m1,
                                      float* __restrict__ am_m2, float* __restrict__ am_nu, long long n,
                                      long long nblocks, OptScalars sc, StateMap map1, StateMap map2,
                                      int fixup) {
    __shared__ float t1[256];
    __shared__ float t2[256];
    __shared__ StateMap sm1, sm2;
    const int tid = threadIdx.x;
    if (tid == 0) sm1 = map1;
    if (tid == 32) sm2 = map2;
    t1[tid] = decode_entry(map1, tid);
    t2[tid] = decode_entry(map2, tid);
    __syncthreads();

    const int lane = tid & 31;
    const bool fix = fixup != 0;
    const uint8_t z1 = (uint8_t)sm1.zero_idx, z2 = (uint8_t)sm2.zero_idx;
    for (long long blk = (long long)blockIdx.x * kWarps + (tid >> 5); blk < nblocks;
         blk += (long long)gridDim.x * kWarps) {
        const long long base = blk * kBlock + lane * kPerLane;
        const bool whole = base + kPerLane <= n;
        float gv[kPerLane], pv[kPerLane];
        if (whole) {
            load8(g + base, gv);
            load8(p + base, pv);
        } else {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                const bool in = base + j < n;
                gv[j] = in ? to_f32(g[base + j]) : 0.0f;
                pv[j] = in ? to_f32(p[base + j]) : 0.0f;
            }
        }
        uint8_t c1[kPerLane], c2[kPerLane], c3[kPerLane];
        load_codes8(m1, base, n, whole, z1, c1);
        load_codes8(m2, base, n, whole, z1, c2);
        load_codes8(nu, base, n, whole, z2, c3);
        const float a1 = am_m1[blk], a2 = am_m2[blk], a3 = am_nu[blk];

        float x1[kPerLane], x2[kPerLane], x3[kPerLane];
        float mx1 = 0.0f, mx2 = 0.0f, mx3 = 0.0f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            const float gj = __fmul_rn(gv[j], sc.gnorm_scale);
            const float v1 = __fmul_rn(t1[c1[j]], a1);
            const float v2 = __fmul_rn(t1[c2[j]], a2);
            const float v3 = __fmul_rn(t2[c3[j]], a3);
            float n1 = __fmaf_rn(sc.omb1, gj, __fmul_rn(v1, sc.beta1));
            float n2 = __fmaf_rn(sc.omb3, gj, __fmul_rn(v2, sc.beta3_t));
            float n3 = __fmaf_rn(__fmul_rn(sc.omb2, gj), gj, __fmul_rn(v3, sc.beta2));
            const float mixed = __fmaf_rn(sc.alpha_t, n2, __fdiv_rn(n1, sc.c1));
            const float adaptive = __fadd_rn(__fdiv_rn(__fsqrt_rn(n3), sc.c2), sc.eps);
            const float stp = __fdiv_rn(mixed, adaptive);
            float pj = sc.use_decay ? __fmaf_rn(pv[j], sc.decay, -__fmul_rn(sc.lr, stp))
                                    : __fmaf_rn(-sc.lr, stp, pv[j]);
            if (!isfinite(gj)) {
                pj = pv[j];
                n1 = n2 = n3 = 0.0f;
            }
            pv[j] = pj;
            x1[j] = n1;
            x2[j] = n2;
            x3[j] = n3;
            mx1 = fmaxf(mx1, fabsf(n1));
            mx2 = fmaxf(mx2, fabsf(n2));
            mx3 = fmaxf(mx3, fabsf(n3));
        }
        mx1 = warp_max(mx1);
        mx2 = warp_max(mx2);
        mx3 = warp_max(mx3);
        const float sc1 = inv_absmax(mx1), sc2 = inv_absmax(mx2), sc3 = inv_absmax(mx3);

        uint32_t q1[2] = {0u, 0u}, q2[2] = {0u, 0u}, q3[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            q1[j >> 2] |= requant(sm1, clip_unit(__fmul_rn(x1[j], sc1)), fix) << (8 * (j & 3));
            q2[j >> 2] |= requant(sm1, clip_unit(__fmul_rn(x2[j], sc2)), fix) << (8 * (j & 3));
            q3[j >> 2] |= requant(sm2, clip_unit(__fmul_rn(x3[j], sc3)), false) << (8 * (j & 3));
        }
        if (whole) {
            store8(p + base, pv);
        } else {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j)
                if (base + j < n) p[base + j] = from_f32<T>(pv[j]);
        }
        store_codes8(m1, base, n, whole, q1);
        store_codes8(m2, base, n, whole, q2);
        store_codes8(nu, base, n, whole, q3);
        if (lane == 0) {  // every lane read the old absmax before the shuffles above
            am_m1[blk] = mx1;
            am_m2[blk] = mx2;
            am_nu[blk] = mx3;
        }
    }
}

unsigned grid_of(long long nblocks) {
    const long long grid = (nblocks + kWarps - 1) / kWarps;
    return (unsigned)(grid > 4096 ? 4096 : grid);  // the grid-stride loop covers the rest
}

template <int kRule, bool kTwo, class T>
void launch_t(const void* g, void* p, uint8_t* s1, uint8_t* s2, float* am1, float* am2, long long n,
              const OptScalars& sc, const StateMap& m1, const StateMap& m2, int fixup, cudaStream_t stream) {
    const long long nblocks = (n + kBlock - 1) / kBlock;
    optimizer_update_8bit_kernel<kRule, kTwo, T><<<grid_of(nblocks), kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(p), s1, s2, am1, am2, n, nblocks, sc, m1, m2, fixup);
}

template <int kRule, bool kTwo>
int launch(const void* g, void* p, uint8_t* s1, uint8_t* s2, float* am1, float* am2, long long n,
           const OptScalars& sc, const StateMap& m1, const StateMap& m2, int fixup, int kind,
           cudaStream_t stream) {
    switch (kind) {
        case kF32: launch_t<kRule, kTwo, float>(g, p, s1, s2, am1, am2, n, sc, m1, m2, fixup, stream); break;
        case kBf16:
            launch_t<kRule, kTwo, __nv_bfloat16>(g, p, s1, s2, am1, am2, n, sc, m1, m2, fixup, stream);
            break;
        case kF16: launch_t<kRule, kTwo, __half>(g, p, s1, s2, am1, am2, n, sc, m1, m2, fixup, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <class T>
void launch_ademamix(const void* g, void* p, uint8_t* m1, uint8_t* m2, uint8_t* nu, float* am_m1,
                     float* am_m2, float* am_nu, long long n, const OptScalars& sc, const StateMap& map1,
                     const StateMap& map2, int fixup, cudaStream_t stream) {
    const long long nblocks = (n + kBlock - 1) / kBlock;
    optimizer_update_8bit_ademamix_kernel<T><<<grid_of(nblocks), kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(p), m1, m2, nu, am_m1, am_m2, am_nu, n, nblocks, sc, map1,
        map2, fixup);
}

bool map_ok(const StateMap* m) { return m->nseg >= 1 && m->nseg <= kMaxSeg; }

}  // namespace

// g [n] and p [n] (kind: 0 f32, 1 bf16, 2 f16, both of it); s1/s2 [n] uint8
// and am1/am2 [ceil(n/256)] f32; p, the states and absmax updated in place
// (s2 and am2 NULL for the one-state rules).  rule: 0 adam (two states), 1
// momentum, 2 lion, 3 rmsprop, 4 adagrad.  sc, m1 and m2 on the host.
BNB_EXPORT int bnb_optimizer_update_8bit(const void* g, void* p, uint8_t* s1, uint8_t* s2,
                                         float* am1, float* am2, long long n, int rule,
                                         const OptScalars* sc, const StateMap* m1,
                                         const StateMap* m2, int fixup, int kind, cudaStream_t stream) {
    if (n <= 0 || !map_ok(m1) || !map_ok(m2)) return (int)cudaErrorInvalidValue;
    if (rule == kAdam && (s2 == nullptr || am2 == nullptr)) return (int)cudaErrorInvalidValue;
    switch (rule) {
        case kAdam: return launch<kAdam, true>(g, p, s1, s2, am1, am2, n, *sc, *m1, *m2, fixup, kind, stream);
        case kMomentum:
            return launch<kMomentum, false>(g, p, s1, s2, am1, am2, n, *sc, *m1, *m2, fixup, kind, stream);
        case kLion: return launch<kLion, false>(g, p, s1, s2, am1, am2, n, *sc, *m1, *m2, fixup, kind, stream);
        case kRmsprop:
            return launch<kRmsprop, false>(g, p, s1, s2, am1, am2, n, *sc, *m1, *m2, fixup, kind, stream);
        case kAdagrad:
            return launch<kAdagrad, false>(g, p, s1, s2, am1, am2, n, *sc, *m1, *m2, fixup, kind, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// AdEMAMix: g [n] and p [n] (kind as above); the momenta m1/m2 and nu [n]
// uint8 and their absmax am_m1/am_m2/am_nu [ceil(n/256)] f32; p, the states
// and absmax updated in place; map1 decodes the momenta, map2 nu.  sc, map1
// and map2 on the host.
BNB_EXPORT int bnb_optimizer_update_8bit_ademamix(const void* g, void* p, uint8_t* m1, uint8_t* m2,
                                                  uint8_t* nu, float* am_m1, float* am_m2, float* am_nu,
                                                  long long n, const OptScalars* sc, const StateMap* map1,
                                                  const StateMap* map2, int fixup, int kind,
                                                  cudaStream_t stream) {
    if (n <= 0 || !map_ok(map1) || !map_ok(map2) || m1 == nullptr || m2 == nullptr || nu == nullptr)
        return (int)cudaErrorInvalidValue;
    switch (kind) {
        case kF32:
            launch_ademamix<float>(g, p, m1, m2, nu, am_m1, am_m2, am_nu, n, *sc, *map1, *map2, fixup, stream);
            break;
        case kBf16:
            launch_ademamix<__nv_bfloat16>(g, p, m1, m2, nu, am_m1, am_m2, am_nu, n, *sc, *map1, *map2, fixup,
                                           stream);
            break;
        case kF16:
            launch_ademamix<__half>(g, p, m1, m2, nu, am_m1, am_m2, am_nu, n, *sc, *map1, *map2, fixup, stream);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
