// Causal flash attention of the training path (no cache): the forward, the
// dK/dV and the dQ kernel, bf16, head_dim 128 or 256, T a multiple of 64.
//
// Replaces the three TPU kernels the JAX package reaches through
// models/llama.py:_flash_call, in jax/experimental/pallas/ops/tpu/
// flash_attention.py: the forward (_flash_attention_kernel_single_batch,
// pallas_call at :758), the dK/dV kernel (_flash_attention_dkv_kernel, :1121)
// and the dQ kernel (_flash_attention_dq_kernel, :1456), causal, sm_scale =
// hd^-0.5.
//
// q   [B, T, H, hd]    bf16, rows read through (batch, token) strides
// k,v [B, T, KVH, hd]  bf16, the same; query head h reads KV head h / (H/KVH)
// o, dq [B, T, H, hd], dk, dv [B, T, KVH, hd]  bf16, packed
// m, l, di [B, H, T]   f32: the row max and row sum of the forward, and
//                      di = sum(o * do) (computed by the caller)
//
// Numerics follow the TPU kernels: s = f32(q.k) * scale; a key after its
// query is masked (the TPU kernel adds -0.7 * FLT_MAX; here its p is 0, which
// is what exp gives there); forward: online softmax, p rounded to bf16 before
// the PV product, f32 accumulation, o = acc / l stored in bf16 (the TPU
// kernel renormalizes acc at every block: the same function up to f32
// rounding), m and l in f32.  Backward: p = exp(s - m) * (1 / l) in f32, ds =
// (do.v - di) * p * scale; p and ds rounded to bf16 before the dV, dK and dQ
// products; f32 accumulators stored once in bf16.  The GQA group's dK/dV add
// up in f32 inside the dK/dV kernel (the TPU path rounds per query head, then
// sums the repeat's transpose).
//
// Bound on the H100: operations (2 T^2 hd H flops a product over the causal
// half, against 2 T hd H bytes a tensor), so the design keeps every product
// on the tensor cores and every intermediate in registers:
//
// * mma.sync.m16n8k16 bf16 -> f32.  A block is four warps (eight for the
//   dK/dV kernel at hd 256), 16 rows a warp; operands by ldmatrix from
//   shared memory (rows padded by 16 B against bank conflicts), and p / ds
//   straight from the accumulators of the product before as the A fragment of
//   the next one.
// * Forward and dQ: a block owns 64 query rows of one head and walks the
//   64-key tiles of its KV head up to the diagonal through a two-stage
//   cp.async ring.  The dQ sum runs in key order in registers: no atomics.
// * dK/dV: a block owns 64 keys of one KV head and walks its group's query
//   heads, then the 64-row query tiles from the diagonal down, Q and dO (and
//   the rows' m, l, di) through the ring; dK and dV stay in registers over
//   the whole group and are stored once.  At hd 256 two warps share each 16
//   keys, each accumulating half of hd (both recompute the scores: the
//   registers hold 16 x 128 of dK and of dV a warp, not 16 x 256).
// * Causal work only: tiles above the diagonal are never loaded, and in the
//   diagonal tile a warp skips the 16-wide chunks it cannot reach.  Blocks
//   with the most tiles launch first.
// * Fixed order everywhere, so a result is the same from run to run.
#include <cfloat>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRows = 64;  // query rows (forward, dQ) or keys (dK/dV) of a block
constexpr int kTile = 64;  // keys (forward, dQ) or query rows (dK/dV) of a ring stage
constexpr float kMask = -0.7f * FLT_MAX;

struct Params {
    const __nv_bfloat16* q;
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    const __nv_bfloat16* dout;
    const float* m;
    const float* l;
    const float* di;
    __nv_bfloat16* o;
    __nv_bfloat16* dq;
    __nv_bfloat16* dk;
    __nv_bfloat16* dv;
    float* m_out;
    float* l_out;
    long long sqb, sqt, skb, skt, svb, svt, sdb, sdt;  // (batch, token) strides in elements
    int T, H, KVH;
    float scale;
};

template <int HD>
struct Geo {
    static constexpr int kStride = HD + 8;                              // bf16 elements a padded row
    static constexpr size_t kTileBytes = (size_t)kTile * kStride * 2;  // one 64-row bf16 tile
};

// rows [t0, t0 + 64) of head `head` of a strided [B, T, heads, HD] tensor ->
// a padded shared tile, 16 bytes a copy
template <int HD, int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long long sb, long long st,
                                          int b, int t0, int head) {
    constexpr int kChunks = HD / 8;
    const __nv_bfloat16* base = src + b * sb + (long long)t0 * st + (long long)head * HD;
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
        const int j = i / kChunks;
        const int c = (i - j * kChunks) * 8;
        cp_async16(dst + j * Geo<HD>::kStride + c, base + j * st + c, true);
    }
}

// A fragment (16 rows x k16) of a row-major padded tile: rows r0.., columns c0..
template <int S>
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* tile, int r0, int c0, int lane) {
    ldsm_x4(a, tile + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n rows n0..n0+15 of a [n][k] tile, k16 at c0)
template <int S>
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* tile, int n0, int c0, int lane) {
    ldsm_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * S + c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles of a [k][n] tile (k rows k0..k0+15, n at c0..c0+15)
template <int S>
__device__ __forceinline__ void frag_b_trans(uint32_t* b, const __nv_bfloat16* tile, int k0, int c0, int lane) {
    ldsm_x4_trans(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + c0 + (lane >> 4) * 8);
}

// the A fragment of a k16 step from two n8 accumulator tiles (rows x 16 columns)
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
    a[0] = pack_bf16x2(c0[0], c0[1]);
    a[1] = pack_bf16x2(c0[2], c0[3]);
    a[2] = pack_bf16x2(c1[0], c1[1]);
    a[3] = pack_bf16x2(c1[2], c1[3]);
}

// ---------------------------------------------------------------------------
// forward: o, m, l
// ---------------------------------------------------------------------------

template <int HD>
struct FwdLayout {
    static constexpr size_t kQ = 0;
    static constexpr size_t kStage = Geo<HD>::kTileBytes;                // [2][K | V]
    static constexpr size_t kBytes = kStage + 2 * 2 * Geo<HD>::kTileBytes;
};

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_kernel(const Params p) {
    constexpr int S = Geo<HD>::kStride;
    constexpr int kDT = HD / 8;  // n8 tiles of the output
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
    auto sK = [&](int st) {
        return reinterpret_cast<__nv_bfloat16*>(smem + FwdLayout<HD>::kStage + st * 2 * Geo<HD>::kTileBytes);
    };
    auto sV = [&](int st) { return sK(st) + kTile * S; };

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gq = lane >> 2, t4 = lane & 3;
    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x, b = blockIdx.y;
    const int kvh = h / (p.H / p.KVH);
    const int r0 = qi * kRows;
    const int ntiles = qi + 1;  // kTile == kRows: the last tile is the diagonal

    load_rows<HD, 128>(sQ, p.q, p.sqb, p.sqt, b, r0, h);
    load_rows<HD, 128>(sK(0), p.k, p.skb, p.skt, b, 0, kvh);
    load_rows<HD, 128>(sV(0), p.v, p.svb, p.svt, b, 0, kvh);
    cp_async_commit();

    const int wrow = warp * 16;
    const int row[2] = {r0 + wrow + gq, r0 + wrow + gq + 8};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float acc[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

    for (int it = 0; it < ntiles; ++it) {
        const int st = it & 1;
        if (it + 1 < ntiles) {
            load_rows<HD, 128>(sK(st ^ 1), p.k, p.skb, p.skt, b, (it + 1) * kTile, kvh);
            load_rows<HD, 128>(sV(st ^ 1), p.v, p.svb, p.svt, b, (it + 1) * kTile, kvh);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const __nv_bfloat16* K = sK(st);
        const __nv_bfloat16* V = sV(st);
        const bool diag = it == ntiles - 1;
        // the diagonal tile's keys past this warp's last row contribute nothing
        const int nchunks = diag ? warp + 1 : kTile / 16;

        float s[kTile / 8][4];
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4];
            frag_a<S>(a, sQ, wrow, kk * 16, lane);
#pragma unroll
            for (int j = 0; j < kTile / 16; ++j) {
                if (j < nchunks) {
                    uint32_t bk[4];
                    frag_b<S>(bk, K, 16 * j, kk * 16, lane);
                    mma_bf16(s[2 * j], a, bk[0], bk[1]);
                    mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
                }
            }
        }

        // scale, mask, online softmax (rows gq and gq + 8 of the warp); the
        // scale is its own rounding, as in the TPU kernel (no contraction)
        uint32_t ok = 0u;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = it * kTile + n * 8 + 2 * t4 + (e & 1);
                const bool valid = n / 2 < nchunks && key <= row[e >> 1];
                const float x = valid ? __fmul_rn(s[n][e], p.scale) : kMask;
                s[n][e] = x;
                ok |= (valid ? 1u : 0u) << (n * 4 + e);
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            corr[i] = expf(m[i] - mx[i]);
            m[i] = mx[i];
        }
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pr = (ok >> (n * 4 + e)) & 1u ? expf(s[n][e] - mx[e >> 1]) : 0.0f;
                rs[e >> 1] += pr;
                s[n][e] = pr;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
            rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
            l[i] = l[i] * corr[i] + rs[i];
        }
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
            acc[n][0] *= corr[0];
            acc[n][1] *= corr[0];
            acc[n][2] *= corr[1];
            acc[n][3] *= corr[1];
        }

        // O += P V, p rounded to bf16 in the A fragment
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) {
            if (j < nchunks) {
                uint32_t a[4];
                acc_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
                for (int dd = 0; dd < HD / 16; ++dd) {
                    uint32_t bv[4];
                    frag_b_trans<S>(bv, V, 16 * j, dd * 16, lane);
                    mma_bf16(acc[2 * dd], a, bv[0], bv[1]);
                    mma_bf16(acc[2 * dd + 1], a, bv[2], bv[3]);
                }
            }
        }
        __syncthreads();  // this stage is refilled by the next iteration's load
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row[i];
        const float inv = 1.0f / l[i];
        __nv_bfloat16* dst = p.o + (((size_t)b * p.T + r) * p.H + h) * HD;
#pragma unroll
        for (int n = 0; n < kDT; ++n)
            *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t4) = pack_bf16x2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
        if (t4 == 0) {
            const size_t ml = ((size_t)b * p.H + h) * p.T + r;
            p.m_out[ml] = m[i];
            p.l_out[ml] = l[i];
        }
    }
}

// ---------------------------------------------------------------------------
// dQ: dq = sum over keys of ds k
// ---------------------------------------------------------------------------

constexpr int kDqChunk = 32;  // keys a warp's scores hold at once

template <int HD>
struct DqLayout {
    static constexpr size_t kQ = 0;
    static constexpr size_t kDo = Geo<HD>::kTileBytes;
    static constexpr size_t kStage = 2 * Geo<HD>::kTileBytes;  // [2][K | V]
    static constexpr size_t kBytes = kStage + 2 * 2 * Geo<HD>::kTileBytes;
};

template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(const Params p) {
    constexpr int S = Geo<HD>::kStride;
    constexpr int kDT = HD / 8;
    constexpr int kCT = kDqChunk / 8;  // n8 tiles of a chunk's scores
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + DqLayout<HD>::kQ);
    __nv_bfloat16* sDo = reinterpret_cast<__nv_bfloat16*>(smem + DqLayout<HD>::kDo);
    auto sK = [&](int st) {
        return reinterpret_cast<__nv_bfloat16*>(smem + DqLayout<HD>::kStage + st * 2 * Geo<HD>::kTileBytes);
    };
    auto sV = [&](int st) { return sK(st) + kTile * S; };

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gq = lane >> 2, t4 = lane & 3;
    const int qi = gridDim.z - 1 - blockIdx.z;
    const int h = blockIdx.x, b = blockIdx.y;
    const int kvh = h / (p.H / p.KVH);
    const int r0 = qi * kRows;
    const int ntiles = qi + 1;

    load_rows<HD, 128>(sQ, p.q, p.sqb, p.sqt, b, r0, h);
    load_rows<HD, 128>(sDo, p.dout, p.sdb, p.sdt, b, r0, h);
    load_rows<HD, 128>(sK(0), p.k, p.skb, p.skt, b, 0, kvh);
    load_rows<HD, 128>(sV(0), p.v, p.svb, p.svt, b, 0, kvh);
    cp_async_commit();

    const int wrow = warp * 16;
    int row[2];
    float mrow[2], linv[2], drow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        row[i] = r0 + wrow + gq + 8 * i;
        const size_t ml = ((size_t)b * p.H + h) * p.T + row[i];
        mrow[i] = p.m[ml];
        linv[i] = 1.0f / p.l[ml];
        drow[i] = p.di[ml];
    }
    float acc[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

    for (int it = 0; it < ntiles; ++it) {
        const int st = it & 1;
        if (it + 1 < ntiles) {
            load_rows<HD, 128>(sK(st ^ 1), p.k, p.skb, p.skt, b, (it + 1) * kTile, kvh);
            load_rows<HD, 128>(sV(st ^ 1), p.v, p.svb, p.svt, b, (it + 1) * kTile, kvh);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const __nv_bfloat16* K = sK(st);
        const __nv_bfloat16* V = sV(st);
        const bool diag = it == ntiles - 1;

#pragma unroll
        for (int c = 0; c < kTile / kDqChunk; ++c) {
            const int k0 = c * kDqChunk;  // the chunk's first key within the tile
            // a diagonal chunk whose first key follows every row of this warp
            if (diag && k0 > wrow + 15) continue;
            float s[kCT][4], dp[kCT][4];
#pragma unroll
            for (int n = 0; n < kCT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t aq[4], ad[4];
                frag_a<S>(aq, sQ, wrow, kk * 16, lane);
                frag_a<S>(ad, sDo, wrow, kk * 16, lane);
#pragma unroll
                for (int j = 0; j < kCT / 2; ++j) {
                    uint32_t bk[4], bv[4];
                    frag_b<S>(bk, K, k0 + 16 * j, kk * 16, lane);
                    frag_b<S>(bv, V, k0 + 16 * j, kk * 16, lane);
                    mma_bf16(s[2 * j], aq, bk[0], bk[1]);
                    mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
                    mma_bf16(dp[2 * j], ad, bv[0], bv[1]);
                    mma_bf16(dp[2 * j + 1], ad, bv[2], bv[3]);
                }
            }
            // ds = (dp - di) * p * scale, p = exp(s - m) / l, 0 past the diagonal
#pragma unroll
            for (int n = 0; n < kCT; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    const int key = it * kTile + k0 + n * 8 + 2 * t4 + (e & 1);
                    const float pr = key <= row[i] ? expf(__fmul_rn(s[n][e], p.scale) - mrow[i]) * linv[i] : 0.0f;
                    s[n][e] = (dp[n][e] - drow[i]) * pr * p.scale;
                }
            }
            // dQ += ds K, ds rounded to bf16
#pragma unroll
            for (int j = 0; j < kCT / 2; ++j) {
                uint32_t a[4];
                acc_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
                for (int dd = 0; dd < HD / 16; ++dd) {
                    uint32_t bk[4];
                    frag_b_trans<S>(bk, K, k0 + 16 * j, dd * 16, lane);
                    mma_bf16(acc[2 * dd], a, bk[0], bk[1]);
                    mma_bf16(acc[2 * dd + 1], a, bk[2], bk[3]);
                }
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        __nv_bfloat16* dst = p.dq + (((size_t)b * p.T + row[i]) * p.H + h) * HD;
#pragma unroll
        for (int n = 0; n < kDT; ++n)
            *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t4) = pack_bf16x2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
}

// ---------------------------------------------------------------------------
// dK/dV: dv = sum p^T do, dk = sum ds^T q over the group's heads and rows
// ---------------------------------------------------------------------------

constexpr int kDkvChunk = 16;  // query rows a warp's transposed scores hold at once

template <int HD>
struct DkvLayout {
    static constexpr size_t kK = 0;
    static constexpr size_t kV = Geo<HD>::kTileBytes;
    static constexpr size_t kStage = 2 * Geo<HD>::kTileBytes;  // [2][Q | dO | m, l, di]
    static constexpr size_t kRowVals = 2 * Geo<HD>::kTileBytes;  // offset of m, l, di within a stage
    static constexpr size_t kStageBytes = 2 * Geo<HD>::kTileBytes + 3 * kTile * sizeof(float);
    static constexpr size_t kBytes = kStage + 2 * kStageBytes;
};

template <int HD>
__global__ void __launch_bounds__(128 * (HD / 128)) flash_bwd_dkv_kernel(const Params p) {
    constexpr int kThreads = 128 * (HD / 128);
    constexpr int S = Geo<HD>::kStride;
    constexpr int kDT = 128 / 8;        // n8 tiles of a warp's 128 columns of dK / dV
    constexpr int kCT = kDkvChunk / 8;  // n8 tiles of a chunk's transposed scores
    using Lay = DkvLayout<HD>;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kK);
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kV);
    auto stage = [&](int st) { return smem + Lay::kStage + st * Lay::kStageBytes; };

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gq = lane >> 2, t4 = lane & 3;
    const int kg = warp & 3;     // the warp's 16 keys of the block
    const int dc = (warp >> 2) * 128;  // the warp's first column of dK / dV
    const int kj = blockIdx.z;  // key tile: the first ones have the most query tiles
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int G = p.H / p.KVH;
    const int k0 = kj * kRows;
    const int nq = p.T / kTile - kj;  // query tiles from the diagonal down
    const int niter = G * nq;

    auto load_stage = [&](int iter, int st) {
        const int h = kvh * G + iter / nq;
        const int t0 = (kj + iter % nq) * kTile;
        unsigned char* s = stage(st);
        load_rows<HD, kThreads>(reinterpret_cast<__nv_bfloat16*>(s), p.q, p.sqb, p.sqt, b, t0, h);
        load_rows<HD, kThreads>(reinterpret_cast<__nv_bfloat16*>(s + Geo<HD>::kTileBytes), p.dout, p.sdb, p.sdt, b,
                                t0, h);
        float* vals = reinterpret_cast<float*>(s + Lay::kRowVals);
        const size_t ml = ((size_t)b * p.H + h) * p.T + t0;
        for (int i = threadIdx.x; i < 3 * kTile / 4; i += kThreads) {
            const int which = i / (kTile / 4);
            const int c = (i - which * (kTile / 4)) * 4;
            const float* src = which == 0 ? p.m : (which == 1 ? p.l : p.di);
            cp_async16(vals + which * kTile + c, src + ml + c, true);
        }
    };

    load_rows<HD, kThreads>(sK, p.k, p.skb, p.skt, b, k0, kvh);
    load_rows<HD, kThreads>(sV, p.v, p.svb, p.svt, b, k0, kvh);
    load_stage(0, 0);
    cp_async_commit();

    const int krow = kg * 16;  // the warp's first key row in sK
    const int key[2] = {k0 + krow + gq, k0 + krow + gq + 8};
    float dk[kDT][4], dv[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

    for (int iter = 0; iter < niter; ++iter) {
        const int st = iter & 1;
        if (iter + 1 < niter) load_stage(iter + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const unsigned char* s_ = stage(st);
        const __nv_bfloat16* Q = reinterpret_cast<const __nv_bfloat16*>(s_);
        const __nv_bfloat16* Do = reinterpret_cast<const __nv_bfloat16*>(s_ + Geo<HD>::kTileBytes);
        const float* sm = reinterpret_cast<const float*>(s_ + Lay::kRowVals);
        const float* sl = sm + kTile;
        const float* sd = sm + 2 * kTile;
        const int t0 = (kj + iter % nq) * kTile;
        const bool diag = t0 == k0;

#pragma unroll
        for (int c = 0; c < kTile / kDkvChunk; ++c) {
            const int q0 = c * kDkvChunk;  // the chunk's first row within the tile
            // a diagonal chunk whose last row precedes every key of this warp
            if (diag && q0 + kDkvChunk - 1 < krow) continue;
            // transposed scores and dP: [16 keys x 16 rows]
            float s[kCT][4], dp[kCT][4];
#pragma unroll
            for (int n = 0; n < kCT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t ak[4], av[4], bq[4], bd[4];
                frag_a<S>(ak, sK, krow, kk * 16, lane);
                frag_a<S>(av, sV, krow, kk * 16, lane);
                frag_b<S>(bq, Q, q0, kk * 16, lane);
                frag_b<S>(bd, Do, q0, kk * 16, lane);
                mma_bf16(s[0], ak, bq[0], bq[1]);
                mma_bf16(s[1], ak, bq[2], bq[3]);
                mma_bf16(dp[0], av, bd[0], bd[1]);
                mma_bf16(dp[1], av, bd[2], bd[3]);
            }
            // p = exp(s - m) * (1 / l), ds = (dp - di) * p * scale; 0 where the key follows the row
#pragma unroll
            for (int n = 0; n < kCT; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = q0 + n * 8 + 2 * t4 + (e & 1);  // row within the tile
                    const bool valid = key[e >> 1] <= t0 + r;
                    const float pr = valid ? expf(__fmul_rn(s[n][e], p.scale) - sm[r]) * (1.0f / sl[r]) : 0.0f;
                    s[n][e] = pr;
                    dp[n][e] = (dp[n][e] - sd[r]) * pr * p.scale;
                }
            }
            // dV += P^T dO and dK += dS^T Q over this warp's columns, rounded to bf16
            uint32_t ap[4], as[4];
            acc_to_a(ap, s[0], s[1]);
            acc_to_a(as, dp[0], dp[1]);
#pragma unroll
            for (int dd = 0; dd < 128 / 16; ++dd) {
                uint32_t bd[4], bq[4];
                frag_b_trans<S>(bd, Do, q0, dc + dd * 16, lane);
                frag_b_trans<S>(bq, Q, q0, dc + dd * 16, lane);
                mma_bf16(dv[2 * dd], ap, bd[0], bd[1]);
                mma_bf16(dv[2 * dd + 1], ap, bd[2], bd[3]);
                mma_bf16(dk[2 * dd], as, bq[0], bq[1]);
                mma_bf16(dk[2 * dd + 1], as, bq[2], bq[3]);
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const size_t off = (((size_t)b * p.T + key[i]) * p.KVH + kvh) * HD + dc;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
            *reinterpret_cast<uint32_t*>(p.dk + off + n * 8 + 2 * t4) = pack_bf16x2(dk[n][2 * i], dk[n][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(p.dv + off + n * 8 + 2 * t4) = pack_bf16x2(dv[n][2 * i], dv[n][2 * i + 1]);
        }
    }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Params& p, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

bool shapes_ok(int B, int T, int H, int KVH, int hd) {
    return B > 0 && B <= 65535 && T > 0 && T % kTile == 0 && T / kTile <= 65535 && H > 0 && KVH > 0 && H % KVH == 0 &&
           (hd == 128 || hd == 256);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* m, const float* l,
                   const float* di, int T, int H, int KVH, long long sqb, long long sqt, long long skb, long long skt,
                   long long svb, long long svt, long long sdb, long long sdt, float scale) {
    Params p = {};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.dout = static_cast<const __nv_bfloat16*>(dout);
    p.m = m;
    p.l = l;
    p.di = di;
    p.sqb = sqb;
    p.sqt = sqt;
    p.skb = skb;
    p.skt = skt;
    p.svb = svb;
    p.svt = svt;
    p.sdb = sdb;
    p.sdt = sdt;
    p.T = T;
    p.H = H;
    p.KVH = KVH;
    p.scale = scale;
    return p;
}

}  // namespace

// o [B, T, H, hd] bf16 (packed), m, l [B, H, T] f32.
BNB_EXPORT int bnb_flash_attention_causal_fwd(const void* q, const void* k, const void* v, void* o, float* m,
                                              float* l, int B, int T, int H, int KVH, int hd, long long sqb,
                                              long long sqt, long long skb, long long skt, long long svb,
                                              long long svt, float scale, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd)) return (int)cudaErrorInvalidValue;
    Params p = make_params(q, k, v, nullptr, nullptr, nullptr, nullptr, T, H, KVH, sqb, sqt, skb, skt, svb, svt, 0,
                           0, scale);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.m_out = m;
    p.l_out = l;
    const dim3 grid(H, B, T / kRows);
    if (hd == 128) return launch(flash_fwd_kernel<128>, grid, 128, FwdLayout<128>::kBytes, p, stream);
    return launch(flash_fwd_kernel<256>, grid, 128, FwdLayout<256>::kBytes, p, stream);
}

// dk, dv [B, T, KVH, hd] bf16 (packed).
BNB_EXPORT int bnb_flash_attention_causal_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                                  const float* m, const float* l, const float* di, void* dk,
                                                  void* dv, int B, int T, int H, int KVH, int hd, long long sqb,
                                                  long long sqt, long long skb, long long skt, long long svb,
                                                  long long svt, long long sdb, long long sdt, float scale,
                                                  cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd)) return (int)cudaErrorInvalidValue;
    Params p = make_params(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt, scale);
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    const dim3 grid(KVH, B, T / kRows);
    if (hd == 128) return launch(flash_bwd_dkv_kernel<128>, grid, 128, DkvLayout<128>::kBytes, p, stream);
    return launch(flash_bwd_dkv_kernel<256>, grid, 256, DkvLayout<256>::kBytes, p, stream);
}

// dq [B, T, H, hd] bf16 (packed).
BNB_EXPORT int bnb_flash_attention_causal_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                                 const float* m, const float* l, const float* di, void* dq, int B,
                                                 int T, int H, int KVH, int hd, long long sqb, long long sqt,
                                                 long long skb, long long skt, long long svb, long long svt,
                                                 long long sdb, long long sdt, float scale, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd)) return (int)cudaErrorInvalidValue;
    Params p = make_params(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt, scale);
    p.dq = static_cast<__nv_bfloat16*>(dq);
    const dim3 grid(H, B, T / kRows);
    if (hd == 128) return launch(flash_bwd_dq_kernel<128>, grid, 128, DqLayout<128>::kBytes, p, stream);
    return launch(flash_bwd_dq_kernel<256>, grid, 128, DqLayout<256>::kBytes, p, stream);
}
