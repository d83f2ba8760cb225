// Fused 8-bit blockwise optimizer update over a table of tensors.
//
// optimizer_update_8bit_kernel replaces the TPU kernel
// optimizer_update_8bit_pallas -> _run (body _kernel) of the JAX package's
// ops/pallas/optim8bit.py.  Per 256-element quantization block, in one pass:
//   s    = decode(code) * absmax             (segment arithmetic, below)
//   p, s = rule(g * gnorm_scale, p, s)      (adam, momentum, lion, rmsprop, adagrad)
//   non-finite g: p kept, states zeroed
//   absmax' = max |s| over the block
//   code' = requant(clip(s * (1 / absmax'), -1, 1)), sign fixup on state1
// written in place: the parameter, the uint8 states and their absmax arrays.
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
// same way) gives the JAX kernel's bits.  The two momenta are the halves of
// the JAX package's [2, n] leaf, so the second starts n codes in and its
// codes load bytewise where that is not 8-byte aligned.
//
// g and p are f32, bf16 or f16 (one type for both): loaded in that type,
// the update computed in f32, p stored in its own type rounded to nearest
// even, as the JAX package's new_p.astype(p.dtype).
//
// The bound on the H100 is bytes, 16 per element in f32 (g 4 read, p 4 read
// + 4 written, each uint8 state 1 read + 1 written), 18 for AdEMAMix, plus 8
// per block and state for the absmax; the kernel is issue-bound short of it,
// mostly on requantizing.  One launch updates every tensor of an optimizer
// step's group: the wrapper hands a table of Leaf descriptors whose `first`
// fields are the prefix sums of their block counts, so the blocks of all
// tensors form one concatenation.  The grid is what the card holds resident,
// each CUDA block stages the codebooks in shared memory once, and each warp
// walks a contiguous range of the concatenation,
// one quantization block at a time, 8 elements a lane (so the block absmax
// is a shuffle reduction in registers); it finds its first leaf by a binary
// search over `first` and steps to the next leaf where its range crosses one.
// The TPU kernel's grid walks [TB, 256] tiles in order; here blocks share
// nothing and any may run first.
//
// Segment arithmetic (functional/dynamic_segments.py): code i of a map
// decodes as fma(float(a - sub[k]), step[k], add[k]) for a = i (or |i - z|
// on the half map of a symmetric map, with the sign of i - z), k the segment
// of a; the wrapper computes the 256 values with the plain version once per
// codebook.  A value x requantizes to start[k] + clamp(floor(fma(x - rsub[k],
// inv[k], radd[k])), 0, cnt1[k]) for k the number of sorted segment bounds
// below x (a value on a bound goes down): a table by x's sign and exponent
// and one compare give k, and a segment's five numbers are one 16-byte
// shared-memory load.  Requantizing is most of the kernel's instructions
// (three times an element in AdEMAMix), so it has no search and no branch
// on the data.
// A NaN scaled value (an all-zero block, 0 * inf) counts as negative.
//
// The codebooks live in device memory (StateMapWords), staged into shared
// memory: no kernel parameter is indexed by a register, which can make nvcc
// copy the parameter to local memory in every thread.
//
// Every operation of the update is an explicitly rounded intrinsic in the
// plain version's order (ops/optim8bit.py), so nvcc's contraction cannot
// move a code between the two.  Built without --use_fast_math.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kMaxSeg = 16;

// One state codebook as ops/optim8bit._map_words lays it out in device
// memory, 468 32-bit words.
struct StateMapWords {
    int sym;         // decode and requantize on the half map, mirrored at zero_idx
    int signed_map;  // the sign fixup applies
    int zero_idx;
    int nseg;
    float bound[kMaxSeg];  // sorted; +inf past the nseg - 1 used
    float4 seg[kMaxSeg];   // rsub, inv, radd, and start | cnt1 << 16 as bits
    float dec[256];        // the decoded codes
    uint8_t first[512];    // per sign and exponent of a value, the bounds below all of that binade
};
static_assert(sizeof(StateMapWords) == 468 * 4, "ops/optim8bit._MAP_WORDS");

// One tensor of the table (ops/optim8bit._LEAF_FIELDS), ten 8-byte words.
struct Leaf {
    const void* g;
    void* p;
    uint8_t* s[3];    // state1, state2; AdEMAMix: m1, m2, nu
    float* am[3];     // their absmax arrays
    long long n;      // elements
    long long first;  // its first block in the concatenation
};
static_assert(sizeof(Leaf) == 80, "ops/optim8bit._LEAF_FIELDS");

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 256;
constexpr int kPerLane = kBlock / 32;  // 8

enum Rule { kAdam = 0, kMomentum = 1, kLion = 2, kRmsprop = 3, kAdagrad = 4, kAdemamix = 5 };

}  // namespace

// One step's float32 scalars, computed on the host (ops/optim8bit.UpdateScalars).
struct OptScalars {
    float beta1, beta2, omb1, omb2, eps, eps_c2, step_size, lr, weight_decay, decay, gnorm_scale;
    int use_decay;
    int first_step;
    float c1, c2, alpha_t, beta3_t, omb3;  // ademamix
};

namespace {

// States of a rule, and which of the two codebooks state i takes: the last
// of two or three states takes the second (adam's and AdEMAMix's nu).
template <int kRule> constexpr int kStates = kRule == kAdam ? 2 : (kRule == kAdemamix ? 3 : 1);
template <int NS> __host__ __device__ constexpr int map_of(int i) { return NS >= 2 && i == NS - 1 ? 1 : 0; }

__device__ __forceinline__ bool negative(float x) { return signbit(x) || isnan(x); }

// A scaled value in [-1, 1] (or NaN) -> its code.  The segment is the
// number of bounds below a: those below a's whole binade (a table by sign
// and exponent, 0 for NaN), plus the one bound a binade may hold
// (ops/optim8bit._map_words refuses a codebook with two), one compare
// against the +inf padding past the last.
__device__ __forceinline__ uint32_t requant(const StateMapWords& m, float x, bool fixup) {
    const bool neg = negative(x);
    const float a = m.sym ? fabsf(x) : x;
    int k = m.first[__float_as_uint(a) >> 23];
    k += a > m.bound[k] ? 1 : 0;
    const float4 r = m.seg[k];
    const int sc = __float_as_int(r.w);
    // floor, clamped to [0, cnt1]; a NaN t (a NaN value) converts to 0
    const int j = min(max(__float2int_rd(__fmaf_rn(__fsub_rn(a, r.x), r.y, r.z)), 0), sc >> 16);
    const int z = m.zero_idx;
    int q = (sc & 0xFFFF) + j;
    q = m.sym ? (neg ? z - min(q, z) : z + q) : q;
    const bool flip = fixup && m.signed_map && ((q < z) != neg);
    return (uint32_t)(q + (flip ? (neg ? -1 : 1) : 0));
}

__device__ __forceinline__ float sign_of(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// The f32 rule on one element: p in place, the decoded states s -> ns.
template <int kRule>
__device__ __forceinline__ void rule_update(const OptScalars& sc, float g, float& p, const float* s, float* ns) {
    if constexpr (kRule == kAdam) {
        ns[0] = __fadd_rn(__fmul_rn(s[0], sc.beta1), __fmul_rn(sc.omb1, g));
        ns[1] = __fadd_rn(__fmul_rn(s[1], sc.beta2), __fmul_rn(__fmul_rn(sc.omb2, g), g));
        const float pd = sc.use_decay ? __fmul_rn(p, sc.decay) : p;
        p = __fadd_rn(pd, __fmul_rn(sc.step_size,
                                    __fdiv_rn(ns[0], __fadd_rn(__fsqrt_rn(ns[1]), sc.eps_c2))));
    } else if constexpr (kRule == kMomentum) {
        const float gw = __fadd_rn(g, __fmul_rn(p, sc.weight_decay));
        ns[0] = sc.first_step ? gw : __fadd_rn(__fmul_rn(s[0], sc.beta1), gw);
        p = __fsub_rn(p, __fmul_rn(sc.lr, ns[0]));
    } else if constexpr (kRule == kLion) {
        const float pd = sc.use_decay ? __fmul_rn(p, sc.decay) : p;
        const float dir = sign_of(__fadd_rn(__fmul_rn(s[0], sc.beta1), __fmul_rn(sc.omb1, g)));
        p = __fsub_rn(pd, __fmul_rn(sc.lr, dir));
        ns[0] = __fadd_rn(__fmul_rn(s[0], sc.beta2), __fmul_rn(sc.omb2, g));
    } else if constexpr (kRule == kRmsprop) {
        const float gw = __fadd_rn(g, __fmul_rn(p, sc.weight_decay));
        ns[0] = __fadd_rn(__fmul_rn(s[0], sc.beta1), __fmul_rn(__fmul_rn(sc.omb1, gw), gw));
        p = __fsub_rn(p, __fdiv_rn(__fmul_rn(sc.lr, gw), __fadd_rn(__fsqrt_rn(ns[0]), sc.eps)));
    } else if constexpr (kRule == kAdagrad) {
        const float gw = __fadd_rn(g, __fmul_rn(p, sc.weight_decay));
        ns[0] = __fadd_rn(s[0], __fmul_rn(gw, gw));
        p = __fsub_rn(p, __fdiv_rn(__fmul_rn(sc.lr, gw), __fadd_rn(__fsqrt_rn(ns[0]), sc.eps)));
    } else {  // AdEMAMix
        ns[0] = __fmaf_rn(sc.omb1, g, __fmul_rn(s[0], sc.beta1));
        ns[1] = __fmaf_rn(sc.omb3, g, __fmul_rn(s[1], sc.beta3_t));
        ns[2] = __fmaf_rn(__fmul_rn(sc.omb2, g), g, __fmul_rn(s[2], sc.beta2));
        const float mixed = __fmaf_rn(sc.alpha_t, ns[1], __fdiv_rn(ns[0], sc.c1));
        const float adaptive = __fadd_rn(__fdiv_rn(__fsqrt_rn(ns[2]), sc.c2), sc.eps);
        const float stp = __fdiv_rn(mixed, adaptive);
        p = sc.use_decay ? __fmaf_rn(p, sc.decay, -__fmul_rn(sc.lr, stp)) : __fmaf_rn(-sc.lr, stp, p);
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

// Quantization block b of leaf L, by one warp.
template <int kRule, class T>
__device__ __forceinline__ void update_block(const Leaf& L, long long b, const OptScalars& sc,
                                             const StateMapWords* sm, bool fix, int lane) {
    constexpr int NS = kStates<kRule>;
    const long long n = L.n;
    const long long base = b * kBlock + lane * kPerLane;
    const bool whole = base + kPerLane <= n;
    const T* g = static_cast<const T*>(L.g);
    T* p = static_cast<T*>(L.p);
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
    uint8_t c[NS][kPerLane];
    float a[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        load_codes8(L.s[i], base, n, whole, (uint8_t)sm[map_of<NS>(i)].zero_idx, c[i]);
        a[i] = L.am[i][b];
    }

    float x[NS][kPerLane], mx[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
        const float gj = __fmul_rn(gv[j], sc.gnorm_scale);
        float s[NS], ns[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = __fmul_rn(sm[map_of<NS>(i)].dec[c[i][j]], a[i]);
        float pj = pv[j];
        rule_update<kRule>(sc, gj, pj, s, ns);
        const bool finite = isfinite(gj);
        pv[j] = finite ? pj : pv[j];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            x[i][j] = finite ? ns[i] : 0.0f;
            mx[i] = fmaxf(mx[i], fabsf(x[i][j]));
        }
    }

    uint32_t q[NS][2];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        mx[i] = warp_max(mx[i]);
        const float inv = inv_absmax(mx[i]);
        q[i][0] = q[i][1] = 0u;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
            q[i][j >> 2] |= requant(sm[map_of<NS>(i)], clip_unit(__fmul_rn(x[i][j], inv)), fix && map_of<NS>(i) == 0)
                            << (8 * (j & 3));
    }
    if (whole) {
        store8(p + base, pv);
    } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
            if (base + j < n) p[base + j] = from_f32<T>(pv[j]);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) store_codes8(L.s[i], base, n, whole, q[i]);
    if (lane == 0) {  // every lane read the old absmax before the shuffles above
#pragma unroll
        for (int i = 0; i < NS; ++i) L.am[i][b] = mx[i];
    }
}

// The body both kernels share: stage the codebooks, then walk this warp's
// contiguous range [total w / W, total (w + 1) / W) of the concatenation.
template <int kRule, class T>
__device__ __forceinline__ void walk(const Leaf* __restrict__ leaves, int nleaves, long long total,
                                     const StateMapWords* __restrict__ maps, const OptScalars& sc, int fixup) {
    constexpr int kMaps = kStates<kRule> == 1 ? 1 : 2;
    __shared__ StateMapWords sm[kMaps];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(maps);
    uint32_t* dst = reinterpret_cast<uint32_t*>(sm);
    for (int i = threadIdx.x; i < kMaps * (int)(sizeof(StateMapWords) / 4); i += kThreads) dst[i] = src[i];
    __syncthreads();

    const long long warps = (long long)gridDim.x * kWarps;
    const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    long long blk = total * w / warps;
    const long long end = total * (w + 1) / warps;
    if (blk >= end) return;
    int lo = 0, hi = nleaves - 1;  // the last leaf whose first block is at or before blk
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (leaves[mid].first <= blk) lo = mid;
        else hi = mid - 1;
    }
    int li = lo;
    Leaf L = leaves[li];
    long long next = li + 1 < nleaves ? leaves[li + 1].first : total;
    const int lane = threadIdx.x & 31;
    for (; blk < end; ++blk) {
        if (blk >= next) {  // every leaf holds a block, so the next one starts here
            L = leaves[++li];
            next = li + 1 < nleaves ? leaves[li + 1].first : total;
        }
        update_block<kRule, T>(L, blk - L.first, sc, sm, fixup != 0, lane);
    }
}

// Three resident blocks an SM (80 registers, a few spilled) ran faster than
// two without spills (93 and 108 registers) in probes on the card.
template <int kRule, class T>
__global__ void __launch_bounds__(kThreads, 3)
optimizer_update_8bit_kernel(const Leaf* __restrict__ leaves, int nleaves, long long total,
                             const StateMapWords* __restrict__ maps, const OptScalars sc, int fixup) {
    walk<kRule, T>(leaves, nleaves, total, maps, sc, fixup);
}

template <class T>
__global__ void __launch_bounds__(kThreads, 3)
optimizer_update_8bit_ademamix_kernel(const Leaf* __restrict__ leaves, int nleaves, long long total,
                                      const StateMapWords* __restrict__ maps, const OptScalars sc, int fixup) {
    walk<kAdemamix, T>(leaves, nleaves, total, maps, sc, fixup);
}

template <int kRule, class T>
int launch(const Leaf* leaves, int nleaves, long long total, const StateMapWords* maps, const OptScalars& sc,
           int fixup, int sms, cudaStream_t stream) {
    void (*kern)(const Leaf*, int, long long, const StateMapWords*, const OptScalars, int);
    if constexpr (kRule == kAdemamix) kern = optimizer_update_8bit_ademamix_kernel<T>;
    else kern = optimizer_update_8bit_kernel<kRule, T>;
    static int per_sm = 0;  // resident blocks an SM, asked once per instance
    if (per_sm == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
        if (err != cudaSuccess) return (int)err;
    }
    const long long want = (total + kWarps - 1) / kWarps;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    kern<<<(unsigned)(want < resident ? want : resident), kThreads, 0, stream>>>(leaves, nleaves, total, maps,
                                                                                  sc, fixup);
    return (int)cudaGetLastError();
}

template <int kRule>
int launch_kind(const Leaf* leaves, int nleaves, long long total, const StateMapWords* maps, const OptScalars& sc,
                int fixup, int kind, int sms, cudaStream_t stream) {
    switch (kind) {
        case kF32: return launch<kRule, float>(leaves, nleaves, total, maps, sc, fixup, sms, stream);
        case kBf16: return launch<kRule, __nv_bfloat16>(leaves, nleaves, total, maps, sc, fixup, sms, stream);
        case kF16: return launch<kRule, __half>(leaves, nleaves, total, maps, sc, fixup, sms, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// One launch over a table of nleaves Leaf descriptors (device memory) whose
// blocks number total, each leaf at least one; maps: the codebooks of state1
// (and state2) in device memory, StateMapWords each.  g and p of every leaf
// of one type (kind: 0 f32, 1 bf16, 2 f16), 16-byte aligned; p, the states
// and absmax updated in place.  rule: 0 adam (two states), 1 momentum, 2
// lion, 3 rmsprop, 4 adagrad, 5 ademamix (three states).  sc on the host;
// sms: the card's multiprocessors.
BNB_EXPORT int bnb_optimizer_update_8bit(const void* leaves, int nleaves, long long total, const void* maps,
                                         const OptScalars* sc, int rule, int fixup, int kind, int sms,
                                         cudaStream_t stream) {
    if (nleaves <= 0 || total <= 0 || total < nleaves || sms <= 0) return (int)cudaErrorInvalidValue;
    const Leaf* t = static_cast<const Leaf*>(leaves);
    const StateMapWords* m = static_cast<const StateMapWords*>(maps);
    switch (rule) {
        case kAdam: return launch_kind<kAdam>(t, nleaves, total, m, *sc, fixup, kind, sms, stream);
        case kMomentum: return launch_kind<kMomentum>(t, nleaves, total, m, *sc, fixup, kind, sms, stream);
        case kLion: return launch_kind<kLion>(t, nleaves, total, m, *sc, fixup, kind, sms, stream);
        case kRmsprop: return launch_kind<kRmsprop>(t, nleaves, total, m, *sc, fixup, kind, sms, stream);
        case kAdagrad: return launch_kind<kAdagrad>(t, nleaves, total, m, *sc, fixup, kind, sms, stream);
        case kAdemamix: return launch_kind<kAdemamix>(t, nleaves, total, m, *sc, fixup, kind, sms, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
