// 4-bit blockwise quantize: W -> (codes, absmax).
//
// Replaces the TPU kernel quantize_4bit_codes_pallas (_q4_kernel) of the JAX
// package's ops/pallas/quant4bit.py.  As there, W comes in its own type (f32,
// bf16 or f16) and is upcast in registers; the upcast is exact, so a 16-bit W
// gives the codes of its f32 copy.
//
// Bound on the H100: bytes.  Each element is read once in its type (4 or 2 B)
// and written once as a code (1 B), plus 4 B of absmax per block; the
// stochastic mode reads 4 B of uniform more.  The design is the streaming
// tile of quant_tile.cuh: a CUDA block owns R runs of 4096 contiguous elements
// (16384 a tile; 8192 in stochastic mode, whose uniforms double the
// registers), each lane 16 contiguous elements of a run held in registers
// from the absmax through the rank, every load of the tile issued before any
// is used; the absmax is a shuffle max over the lanes of a quantization block
// (blocksize <= 512) or combined across warps in shared memory; a lane's 16
// codes leave as one 16-byte store.  The rank is a four-level binary search
// over the sorted midpoints, staged in shared memory once a block (rank16):
// about a dozen instructions and three conflict-free shared loads an
// element.  Probes on the H100 (PERF.md §6): counting the 15 compares, each
// an FSETP and a SEL, took about 37 instructions an element, and a tree of
// selects over the parameters was compiled to branches; either held the
// kernel at the card's issue rate, f32 and bf16 W alike, well short of the
// copy rate.
// No parameter is indexed by a register: nvcc copies such a parameter to local
// memory in every thread (SASS STL), as kernel 10's once did.  The rank -> bit
// pattern map is a 64-bit word of nibbles, and the stochastic mode's
// value-sorted code is staged in shared memory by a select over constant
// indices.
//
// The codes must equal the JAX package's bit for bit, so this file is built
// without --use_fast_math, with IEEE division and without flush-to-zero:
//   scale  = 1 / absmax   (inf below the smallest normal float, qt_scale)
//   scaled = clip(x * scale, -1, 1)
//   rank   = #{sorted midpoints m_i : scaled > m_i}
// and rank is mapped to the bit pattern through the argsort order for
// codebooks stored in bit-pattern order (FP4, int4, af4; NF4 is sorted).  The
// round-to-nearest rank skips the clip: every midpoint lies in [-1, 1) (the
// wrapper checks), so scaled > m_i and clip(scaled) > m_i agree, a NaN ranks 0
// either way.
//
// Stochastic mode (the TPU kernel's mode "u", _stochastic_move16): given one
// f32 uniform u per element, the rank moves to its value-adjacent neighbour
// (toward the scaled value, clipped to 0..15) when
//   u < |scaled - code[rank]| / max(|code[nbr] - code[rank]|, 1e-20)
// over the value-sorted code, before the bit-pattern map.  The uniforms come
// from the caller (a torch.Generator), as the TPU's interpret tier takes them.
// Codes come out unpacked, one per byte; the caller packs them in the layout
// it needs (flat, 2d or N-paired), as the TPU kernel's caller does.
#include "quant_tile.cuh"

namespace {

// Read only at constant indices (selects), so the fields stay in the
// parameter bank.
struct Q4Params {
    float mid[15];             // sorted midpoints
    float sorted[16];          // the code in value order (stochastic mode)
    unsigned long long order;  // rank r -> bit pattern: the nibble (order >> 4r) & 15
};

// Entry i of a parameter array, by selects over constant indices.
template <int N>
__device__ __forceinline__ float entry(const float (&v)[N], int i) {
    float c = v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) c = i == k ? v[k] : c;
    return c;
}

// #{j : s > mid[j]} over the 15 sorted midpoints (s_mid in shared memory), as
// a four-level binary search: a compare with mid[7] (a register), then three
// shared loads, each at an index the compares so far give.  Distinct entries
// lie in distinct banks, so a warp's loads never conflict.  A NaN compares
// false at every level and ranks 0, as in the count.
__device__ __forceinline__ int rank16(float s, float mid7, const float* s_mid) {
    int r = s > mid7 ? 8 : 0;
    r |= s > s_mid[r + 3] ? 4 : 0;
    r |= s > s_mid[r + 1] ? 2 : 0;
    r |= s > s_mid[r] ? 1 : 0;
    return r;
}

template <class T, bool kStoch, bool kIdentity>
__global__ void __launch_bounds__(kQtThreads, 2)
quantize_4bit_codes_kernel(const T* __restrict__ x, const float* __restrict__ u, uint8_t* __restrict__ codes,
                           float* __restrict__ absmax, long long n, int log2bs, Q4Params p) {
    constexpr int R = kStoch ? 2 : 4;  // runs a tile
    __shared__ float s_wmax[R * kQtWarps];
    __shared__ float s_mid[16];
    __shared__ float s_sorted[16];

    const long long base = (long long)blockIdx.x * (R * kQtRun) + threadIdx.x * kQtLane;
    bool live[R];
    Raw16<T> raw[R]{};
    float uu[kStoch ? R : 1][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        live[r] = base + r * kQtRun < n;
        if (live[r]) load_raw16(x + base + r * kQtRun, raw[r]);
    }
    if constexpr (kStoch) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            Raw16<float> w{};
            if (live[r]) load_raw16(u + base + r * kQtRun, w);
            unpack16(w, uu[r]);  // no instructions: the words are the floats
        }
        if (threadIdx.x < 16) s_sorted[threadIdx.x] = entry(p.sorted, threadIdx.x);
    }
    if (threadIdx.x < 15) s_mid[threadIdx.x] = entry(p.mid, threadIdx.x);

    float v[R][16], m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        unpack16(raw[r], v[r]);
        m[r] = 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i) m[r] = fmaxf(m[r], fabsf(v[r][i]));
    }
    qt_block_max<R>(m, log2bs, s_wmax);
    __syncthreads();  // s_mid and s_sorted
    const float mid7 = p.mid[7];

#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        const long long e = base + r * kQtRun;
        const float scale = qt_scale(m[r]);
        uint32_t q[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            float s = v[r][i] * scale;
            int k;
            if constexpr (kStoch) {
                s = fminf(fmaxf(s, -1.0f), 1.0f);
                k = rank16(s, mid7, s_mid);
                const float lower = s_sorted[k];
                const int nbr = min(max(k + (s > lower ? 1 : -1), 0), 15);
                const float gap = fabsf(s_sorted[nbr] - lower);
                const float p_move = gap > 0.0f ? fabsf(s - lower) / fmaxf(gap, 1e-20f) : 0.0f;
                if (uu[r][i] < p_move) k = nbr;
            } else {
                k = rank16(s, mid7, s_mid);
            }
            q[i] = kIdentity ? (uint32_t)k : (uint32_t)(p.order >> (4 * k)) & 15u;
        }
        store_codes16(codes + e, q);
        if ((e & ((1LL << log2bs) - 1)) == 0) absmax[e >> log2bs] = m[r];
    }
}

template <class T, bool kStoch, bool kIdentity>
void launch(const void* x, const float* u, uint8_t* codes, float* absmax, long long n, int log2bs,
            const Q4Params& p, cudaStream_t stream) {
    constexpr long long tile = (kStoch ? 2 : 4) * kQtRun;
    const unsigned grid = (unsigned)((n + tile - 1) / tile);
    quantize_4bit_codes_kernel<T, kStoch, kIdentity><<<grid, kQtThreads, 0, stream>>>(
        static_cast<const T*>(x), u, codes, absmax, n, log2bs, p);
}

template <class T>
void launch_kind(const void* x, const float* u, uint8_t* codes, float* absmax, long long n, int log2bs,
                 const Q4Params& p, bool identity, cudaStream_t stream) {
    if (u != nullptr) {
        if (identity) launch<T, true, true>(x, u, codes, absmax, n, log2bs, p, stream);
        else launch<T, true, false>(x, u, codes, absmax, n, log2bs, p, stream);
    } else {
        if (identity) launch<T, false, true>(x, u, codes, absmax, n, log2bs, p, stream);
        else launch<T, false, false>(x, u, codes, absmax, n, log2bs, p, stream);
    }
}

}  // namespace

// x: n elements of x_kind (0 float32, 1 bfloat16, 2 float16), u: NULL or n
// f32 uniforms (stochastic mode), both 16-byte aligned, as codes; blocksize a
// power of two, 32..4096, dividing n.  midpoints [15] (sorted, in [-1, 1)) and
// sorted_code [16] on the host; order: the rank -> bit-pattern nibbles.
BNB_EXPORT int bnb_quantize_4bit_codes(const void* x, const float* u, uint8_t* codes, float* absmax, long long n,
                                       int blocksize, const float* midpoints, const float* sorted_code,
                                       unsigned long long order, int identity, int x_kind, cudaStream_t stream) {
    int log2bs = 5;
    while (log2bs < 12 && (1 << log2bs) != blocksize) ++log2bs;
    if ((1 << log2bs) != blocksize || n % blocksize || x_kind < kF32 || x_kind > kF16)
        return (int)cudaErrorInvalidValue;
    Q4Params p;
    for (int j = 0; j < 15; ++j) {
        if (!(midpoints[j] >= -1.0f && midpoints[j] < 1.0f) || (j > 0 && !(midpoints[j] >= midpoints[j - 1])))
            return (int)cudaErrorInvalidValue;
        p.mid[j] = midpoints[j];
    }
    for (int j = 0; j < 16; ++j) p.sorted[j] = sorted_code[j];
    p.order = order;
    if (n > 0) {
        if (x_kind == kF32) launch_kind<float>(x, u, codes, absmax, n, log2bs, p, identity != 0, stream);
        else if (x_kind == kBf16) launch_kind<__nv_bfloat16>(x, u, codes, absmax, n, log2bs, p, identity != 0, stream);
        else launch_kind<__half>(x, u, codes, absmax, n, log2bs, p, identity != 0, stream);
    }
    return (int)cudaGetLastError();
}
