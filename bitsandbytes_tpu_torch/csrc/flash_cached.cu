// Flash attention of new-token queries over a KV cache: dense or paged, bf16
// or int8 KV, head_dim 64, 128 or 256.
//
// Replaces two TPU kernels of the JAX package's ops/pallas/flash_cached.py:
// flash_attention_cached (_kernel / _flash_step) in its bf16- and int8-KV
// modes, and flash_attention_paged (_paged_kernel / _flash_paged_jit), the
// same recurrence over a shared block pool walked through per-slot tables.
//
// q   [B, KVH, GT, hd]  bf16, GQA heads folded with positions: row r = g*T + t
// dense: k,v [B, KVH, S, hd], int8 scales ks,vs [B, KVH, S] f32
// paged: k,v [NB, KVH, BS, hd], int8 scales ks,vs [NB, KVH, BS] f32, tables
//        [B, MAXB] int32; logical position p of slot b lies in pool block
//        tables[b, p / BS] at row p % BS, and the logical length is MAXB * BS
// lengths [B]           int32, position of each slot's newest query token
// out [B, KVH, GT, hd]  bf16
// A row's query position is lengths[b] - (T-1) + (r mod T); it attends kv
// positions p <= q_pos (and p > q_pos - window when a window is given).
//
// Numerics follow the TPU kernel: the score is q.k in f32 from bf16 inputs
// (int8 codes are exact in bf16), times the position's K scale (int8), then
// times hd^-0.5; masked scores are -1e30; the online softmax keeps m and l in
// f32 from the unscaled p; p (times the position's V scale, int8) is rounded
// to bf16 before the PV product; the result is divided by max(l, 1e-38).
//
// Bound on the H100: bytes at decode (every live K and V row is read once per
// split: 2 * hd * 2 B a position in bf16, 2 * hd B + 8 B of scales in int8,
// against 4 * hd flops a position and query row), operations only for long
// prefill chunks.  The design, one template over <KV type, paged, hd, decode>:
//
// * Tensor cores.  A block is four warps.  S = Q K^T and O += P V run as
//   mma.sync.m16n8k16 bf16 -> f32: Q and K fragments by ldmatrix, V by
//   ldmatrix.trans, P straight from the S accumulators.  The K scale
//   multiplies the accumulator's columns after the QK product; the V scale
//   multiplies p before p is rounded into the bf16 A fragment of PV.
// * Prefill (GT > 16 folded rows): a block owns 64 query rows, 16 a warp, so
//   each K/V byte is read once per 64 rows (the old kernel: once per 8).
// * Decode (GT <= 16): a block owns all GT rows of a kv head (padded to the
//   mma's 16) and its four warps split every 64-position tile, 16 positions
//   a warp; their partial (m, l, acc) combine in shared memory in warp order.
// * Split-KV.  When B * KVH * row tiles is under one wave of SMs, the logical
//   positions are cut into splits (multiples of 64, from the host, the same
//   for the dense and the paged kernel) so that the grid covers about two
//   waves; each split writes f32 (m, l, acc[hd]) and flash_combine_kernel
//   adds the splits in split order, so the result is the same every run.
// * Asynchronous, double-buffered K/V tiles: cp.async into a two-stage ring
//   in dynamic shared memory (rows padded by 16 B against bank conflicts),
//   the next tile in flight while the current one is computed.  int8 tiles
//   arrive as bytes (cp.async cannot convert) and are widened to bf16 in
//   shared memory once per tile, so both types share the ldmatrix path;
//   the widening is one shared-memory pass, against a global read.
// * No work on dead positions: a block walks only the tiles between its
//   rows' first and last attendable position within its split; positions of
//   a tile outside that range are zero-filled, never addressed.  The paged
//   kernel stages the table entries of its live range once and reads none
//   past the block of its last live position.  A chunk of 64 positions may
//   span several pool blocks (BS < 64), with the dense kernel's boundaries,
//   so a pool scattered from a dense cache gives the dense kernel's bits.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKT = 64;        // kv positions per tile
constexpr int kDecodeRows = 16;  // folded rows the decode variant takes (one mma tile)
constexpr float kFill = -1e30f;

struct Params {
    const __nv_bfloat16* q;
    const void* k;
    const void* v;
    const float* ks;
    const float* vs;
    const int* tables;
    const int* lengths;
    __nv_bfloat16* out;  // written when nsplit == 1
    float* part_acc;     // [nsplit, B*KVH*GT, hd] when nsplit > 1
    float* part_ml;      // [nsplit, B*KVH*GT, 2]
    int KVH, GT, S, T, window;
    float scale;
    int maxb, bs_shift, split_len, nsplit;
};

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

// Shared-memory layout of one instantiation, in bytes from the start of the
// dynamic region: Q, the two K/V stages (and their int8 scales), the widened
// bf16 tile of an int8 cache, then the paged table.  After the loop the
// decode variant reuses the stages for the four warps' partial results.
template <typename KV, int HD, bool kDecode>
struct Layout {
    static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
    static constexpr int kQRows = kDecode ? kDecodeRows : kWarps * 16;
    static constexpr int kQStride = HD + 8;                                  // bf16 elements
    static constexpr int kKVStride = HD + 16 / (int)sizeof(KV);              // KV elements (16 B pad)
    static constexpr int kWideStride = HD + 8;                               // bf16 elements
    static constexpr size_t kQ = 0;
    static constexpr size_t kQBytes = (size_t)kQRows * kQStride * 2;
    static constexpr size_t kTileBytes = (size_t)kKT * kKVStride * sizeof(KV);  // one of K or V
    static constexpr size_t kStage = kQ + kQBytes;
    static constexpr size_t kStageBytes = 2 * kTileBytes;
    static constexpr size_t kScales = kStage + 2 * kStageBytes;
    static constexpr size_t kScaleBytes = kInt8 ? 2 * 2 * kKT * sizeof(float) : 0;  // [stage][k|v][KT]
    static constexpr size_t kWide = kScales + kScaleBytes;
    static constexpr size_t kWideBytes = kInt8 ? 2 * (size_t)kKT * kWideStride * 2 : 0;
    static constexpr size_t kCombineBytes =
        kDecode ? (size_t)kWarps * kDecodeRows * (HD + 2) * sizeof(float) : 0;
    static constexpr size_t kLoopEnd = kWide + kWideBytes;
    static constexpr size_t kTable =
        (kLoopEnd > kStage + kCombineBytes ? kLoopEnd : kStage + kCombineBytes);
};

template <typename KV, bool kPaged, int HD, bool kDecode>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
    using Lay = Layout<KV, HD, kDecode>;
    constexpr bool kInt8 = Lay::kInt8;
    constexpr int kQS = Lay::kQStride;
    constexpr int kKS = Lay::kKVStride;
    constexpr int kNP = kDecode ? 16 : kKT;  // positions a warp takes of each tile
    constexpr int kNT = kNP / 8;             // n-tiles of S
    constexpr int kDT = HD / 8;              // n-tiles of O
    constexpr int kPer = 16 / (int)sizeof(KV);  // KV elements per 16-byte copy
    constexpr int kChunks = HD / kPer;          // 16-byte copies per row
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kQ);
    int* s_tbl = reinterpret_cast<int*>(smem + Lay::kTable);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gq = lane >> 2;  // the mma's group (row within 8)
    const int t4 = lane & 3;   // thread within the group
    const int bh = blockIdx.x;
    const int b = bh / p.KVH;
    const int h = bh - b * p.KVH;
    const int r0 = blockIdx.y * Lay::kQRows;
    const int sp = blockIdx.z;
    const int GT = p.GT, T = p.T;
    const int length = p.lengths[b];

    // the kv range any row of this block can attend, within this split
    const int nrows = min(Lay::kQRows, GT - r0);
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int i = 0; i < nrows; ++i) {
        const int qp = length - (T - 1) + ((r0 + i) % T);
        qmin = min(qmin, qp);
        qmax = max(qmax, qp);
    }
    const int split_lo = sp * p.split_len;
    const int lo = max(split_lo, p.window > 0 ? max(0, qmin - p.window + 1) : 0);
    const int hi = min(min(p.S, split_lo + p.split_len), qmax + 1);
    const int t_lo = (lo / kKT) * kKT;  // tiles start on logical multiples of 64
    const int ntiles = hi > lo ? (hi - t_lo + kKT - 1) / kKT : 0;

    const int tlo = lo >> p.bs_shift;
    if constexpr (kPaged) {
        if (ntiles > 0) {
            const int n_tbl = ((hi - 1) >> p.bs_shift) - tlo + 1;
            for (int i = tid; i < n_tbl; i += kThreads) s_tbl[i] = p.tables[(size_t)b * p.maxb + tlo + i];
        }
        __syncthreads();
    }
    // row of a kv position in the [rows, hd] view of k/v (and index of its scale)
    auto row_of = [&](int pos) -> size_t {
        if constexpr (kPaged) {
            const size_t blk = (size_t)s_tbl[(pos >> p.bs_shift) - tlo];
            return ((blk * p.KVH + h) << p.bs_shift) + (pos & ((1 << p.bs_shift) - 1));
        } else {
            return (size_t)bh * p.S + pos;
        }
    };

    const KV* kg = static_cast<const KV*>(p.k);
    const KV* vg = static_cast<const KV*>(p.v);
    auto load_tile = [&](int it, int st) {
        const int t0 = t_lo + it * kKT;
        KV* sk = reinterpret_cast<KV*>(smem + Lay::kStage + st * Lay::kStageBytes);
        KV* sv = reinterpret_cast<KV*>(smem + Lay::kStage + st * Lay::kStageBytes + Lay::kTileBytes);
        for (int i = tid; i < kKT * kChunks; i += kThreads) {
            const int j = i / kChunks;
            const int c = (i - j * kChunks) * kPer;
            const int pos = t0 + j;
            const bool live = pos >= lo && pos < hi;
            const size_t g = live ? row_of(pos) * HD + c : 0;
            cp_async16(sk + j * kKS + c, kg + g, live);
            cp_async16(sv + j * kKS + c, vg + g, live);
        }
        if constexpr (kInt8) {
            float* ssc = reinterpret_cast<float*>(smem + Lay::kScales) + st * 2 * kKT;
            const int j = tid & (kKT - 1);
            const int pos = t0 + j;
            const bool live = pos >= lo && pos < hi;
            const size_t rr = live ? row_of(pos) : 0;
            if (tid < kKT)
                cp_async4(ssc + j, p.ks + rr, live);
            else
                cp_async4(ssc + kKT + j, p.vs + rr, live);
        }
    };

    // Q rows of the block (zero past GT), in the first group with tile 0
    for (int i = tid; i < Lay::kQRows * (HD / 8); i += kThreads) {
        const int rr = i / (HD / 8);
        const int c = (i - rr * (HD / 8)) * 8;
        const bool live = r0 + rr < GT;
        cp_async16(sQ + rr * kQS + c, p.q + (live ? ((size_t)bh * GT + r0 + rr) * HD + c : 0), live);
    }
    if (ntiles > 0) load_tile(0, 0);
    cp_async_commit();

    const int wrow = kDecode ? 0 : warp * 16;  // the warp's first row in sQ
    const int wpos = kDecode ? warp * 16 : 0;  // the warp's first position in a tile
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + wrow + gq + 8 * i;
        qpos[i] = r < GT ? length - (T - 1) + (r % T) : -1;  // -1: a padding row attends nothing
    }

    float m[2] = {kFill, kFill}, l[2] = {0.0f, 0.0f};
    float acc[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

    for (int it = 0; it < ntiles; ++it) {
        const int st = it & 1;
        if (it + 1 < ntiles) load_tile(it + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();

        const __nv_bfloat16* sK;
        const __nv_bfloat16* sV;
        constexpr int kStride = kInt8 ? Lay::kWideStride : kKS;
        const float* ssc = reinterpret_cast<const float*>(smem + Lay::kScales) + st * 2 * kKT;
        if constexpr (kInt8) {
            // widen the int8 tile to bf16 (exact) for the ldmatrix path
            const int8_t* rk = reinterpret_cast<const int8_t*>(smem + Lay::kStage + st * Lay::kStageBytes);
            const int8_t* rv = rk + Lay::kTileBytes;
            __nv_bfloat16* wk = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kWide);
            __nv_bfloat16* wv = wk + kKT * Lay::kWideStride;
            for (int i = tid; i < 2 * kKT * (HD / 16); i += kThreads) {
                const int which = i / (kKT * (HD / 16));
                const int ii = i - which * kKT * (HD / 16);
                const int j = ii / (HD / 16);
                const int c = (ii - j * (HD / 16)) * 16;
                const int8_t* src = (which ? rv : rk) + j * kKS + c;
                const uint4 raw = *reinterpret_cast<const uint4*>(src);
                const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
                uint32_t w[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) w[e] = pack_bf16x2((float)bytes[2 * e], (float)bytes[2 * e + 1]);
                uint4* dst = reinterpret_cast<uint4*>((which ? wv : wk) + j * Lay::kWideStride + c);
                dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
                dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
            }
            __syncthreads();
            sK = wk;
            sV = wv;
        } else {
            sK = reinterpret_cast<const __nv_bfloat16*>(smem + Lay::kStage + st * Lay::kStageBytes);
            sV = reinterpret_cast<const __nv_bfloat16*>(smem + Lay::kStage + st * Lay::kStageBytes +
                                                        Lay::kTileBytes);
        }

        // S = Q K^T over this warp's positions
        float s[kNT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, sQ + (wrow + ((lane >> 3) & 1) * 8 + (lane & 7)) * kQS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < kNT / 2; ++j) {
                uint32_t bk[4];
                ldsm_x4(bk, sK + (wpos + 16 * j + (lane >> 4) * 8 + (lane & 7)) * kStride + kk * 16 +
                                ((lane >> 3) & 1) * 8);
                mma_bf16(s[2 * j], a, bk[0], bk[1]);
                mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
            }
        }

        // scale, mask, online softmax (rows gq and gq + 8 of the warp)
        const int t0 = t_lo + it * kKT;
        uint32_t ok = 0u;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = wpos + n * 8 + 2 * t4 + (e & 1);
                const int pos = t0 + j;
                const int qp = qpos[e >> 1];
                const bool valid = pos < hi && pos <= qp && (p.window <= 0 || pos > qp - p.window);
                float x = s[n][e];
                if constexpr (kInt8) x = x * ssc[j];
                x = valid ? x * p.scale : kFill;
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
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool valid = (ok >> (n * 4 + e)) & 1u;
                const float pr = valid ? expf(s[n][e] - mx[e >> 1]) : 0.0f;
                rs[e >> 1] += pr;
                float w = pr;
                if constexpr (kInt8) w = valid ? pr * ssc[kKT + wpos + n * 8 + 2 * t4 + (e & 1)] : 0.0f;
                s[n][e] = w;
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
        for (int j = 0; j < kNT / 2; ++j) {
            uint32_t a[4];
            a[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
            a[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
            a[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
            a[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
            for (int dd = 0; dd < HD / 16; ++dd) {
                uint32_t bv[4];
                ldsm_x4_trans(bv, sV + (wpos + 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * kStride + dd * 16 +
                                      (lane >> 4) * 8);
                mma_bf16(acc[2 * dd], a, bv[0], bv[1]);
                mma_bf16(acc[2 * dd + 1], a, bv[2], bv[3]);
            }
        }
        __syncthreads();  // this stage is refilled by the next iteration's load
    }
    cp_async_wait<0>();

    const size_t rows_all = (size_t)gridDim.x * GT;  // B*KVH*GT
    if constexpr (kDecode) {
        // the four warps' partials, combined in warp order
        __syncthreads();
        float* sc = reinterpret_cast<float*>(smem + Lay::kStage);  // [warp][row][hd]
        float* sml = sc + kWarps * kDecodeRows * HD;                 // [warp][row][m, l]
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
            const int col = n * 8 + 2 * t4;
            *reinterpret_cast<float2*>(sc + (warp * kDecodeRows + gq) * HD + col) = make_float2(acc[n][0], acc[n][1]);
            *reinterpret_cast<float2*>(sc + (warp * kDecodeRows + gq + 8) * HD + col) =
                make_float2(acc[n][2], acc[n][3]);
        }
        if (t4 == 0) {
            sml[(warp * kDecodeRows + gq) * 2] = m[0];
            sml[(warp * kDecodeRows + gq) * 2 + 1] = l[0];
            sml[(warp * kDecodeRows + gq + 8) * 2] = m[1];
            sml[(warp * kDecodeRows + gq + 8) * 2 + 1] = l[1];
        }
        __syncthreads();
        for (int i = tid; i < GT * HD; i += kThreads) {
            const int r = i / HD;
            const int d = i - r * HD;
            float M = kFill;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sml[(w * kDecodeRows + r) * 2]);
            float L = 0.0f, A = 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                const float f = expf(sml[(w * kDecodeRows + r) * 2] - M);
                L += sml[(w * kDecodeRows + r) * 2 + 1] * f;
                A += sc[(w * kDecodeRows + r) * HD + d] * f;
            }
            const size_t row = (size_t)bh * GT + r;
            if (p.nsplit == 1) {
                p.out[row * HD + d] = __float2bfloat16_rn(A / fmaxf(L, 1e-38f));
            } else {
                p.part_acc[((size_t)sp * rows_all + row) * HD + d] = A;
                if (d == 0) {
                    p.part_ml[((size_t)sp * rows_all + row) * 2] = M;
                    p.part_ml[((size_t)sp * rows_all + row) * 2 + 1] = L;
                }
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = r0 + wrow + gq + 8 * i;
            if (r >= GT) continue;
            const size_t row = (size_t)bh * GT + r;
            if (p.nsplit == 1) {
                const float den = fmaxf(l[i], 1e-38f);
#pragma unroll
                for (int n = 0; n < kDT; ++n)
                    *reinterpret_cast<uint32_t*>(p.out + row * HD + n * 8 + 2 * t4) =
                        pack_bf16x2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
            } else {
#pragma unroll
                for (int n = 0; n < kDT; ++n)
                    *reinterpret_cast<float2*>(p.part_acc + ((size_t)sp * rows_all + row) * HD + n * 8 + 2 * t4) =
                        make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
                if (t4 == 0) {
                    p.part_ml[((size_t)sp * rows_all + row) * 2] = m[i];
                    p.part_ml[((size_t)sp * rows_all + row) * 2 + 1] = l[i];
                }
            }
        }
    }
}

// out[row, d] = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-38),
// M = max_s m_s, the sums in split order.  One block per row.
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ out, int rows, int hd, int nsplit) {
    const size_t row = blockIdx.x;
    float M = kFill;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_ml[((size_t)s * rows + row) * 2]);
    for (int d = threadIdx.x; d < hd; d += kThreads) {
        float L = 0.0f, A = 0.0f;
        for (int s = 0; s < nsplit; ++s) {
            const size_t o = (size_t)s * rows + row;
            const float f = expf(part_ml[o * 2] - M);
            L += part_ml[o * 2 + 1] * f;
            A += part_acc[o * hd + d] * f;
        }
        out[row * hd + d] = __float2bfloat16_rn(A / fmaxf(L, 1e-38f));
    }
}

template <typename KV, bool kPaged, int HD, bool kDecode>
int launch_t(const Params& p, int B, int table_entries, cudaStream_t stream) {
    using Lay = Layout<KV, HD, kDecode>;
    const size_t smem = Lay::kTable + (kPaged ? (size_t)table_entries * sizeof(int) : 0);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(flash_kernel<KV, kPaged, HD, kDecode>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int row_tiles = kDecode ? 1 : (p.GT + Lay::kQRows - 1) / Lay::kQRows;
    const dim3 grid(B * p.KVH, row_tiles, p.nsplit);
    flash_kernel<KV, kPaged, HD, kDecode><<<grid, kThreads, smem, stream>>>(p);
    if (p.nsplit > 1) {  // queued at once behind it: no host round trip between the two
        const int rows = B * p.KVH * p.GT;
        flash_combine_kernel<<<rows, kThreads, 0, stream>>>(p.part_acc, p.part_ml, p.out, rows, HD, p.nsplit);
    }
    return (int)cudaGetLastError();
}

template <typename KV, bool kPaged, int HD>
int launch_hd(const Params& p, int B, int table_entries, cudaStream_t stream) {
    if (p.GT <= kDecodeRows) return launch_t<KV, kPaged, HD, true>(p, B, table_entries, stream);
    return launch_t<KV, kPaged, HD, false>(p, B, table_entries, stream);
}

template <typename KV, bool kPaged>
int launch(const Params& p, int B, int hd, int table_entries, cudaStream_t stream) {
    switch (hd) {
        case 64: return launch_hd<KV, kPaged, 64>(p, B, table_entries, stream);
        case 128: return launch_hd<KV, kPaged, 128>(p, B, table_entries, stream);
        case 256: return launch_hd<KV, kPaged, 256>(p, B, table_entries, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

bool splits_ok(int S, int split_len, int nsplit) {
    return split_len > 0 && split_len % kKT == 0 && nsplit >= 1 && (long long)split_len * nsplit >= S &&
           (long long)split_len * (nsplit - 1) < S;
}

Params make_params(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   const int* tables, const int* lengths, void* out, float* part_acc, float* part_ml, int KVH,
                   int GT, int S, int T, int window, float scale, int maxb, int bs_shift, int split_len,
                   int nsplit) {
    Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = k;
    p.v = v;
    p.ks = ks;
    p.vs = vs;
    p.tables = tables;
    p.lengths = lengths;
    p.out = static_cast<__nv_bfloat16*>(out);
    p.part_acc = part_acc;
    p.part_ml = part_ml;
    p.KVH = KVH;
    p.GT = GT;
    p.S = S;
    p.T = T;
    p.window = window;
    p.scale = scale;
    p.maxb = maxb;
    p.bs_shift = bs_shift;
    p.split_len = split_len;
    p.nsplit = nsplit;
    return p;
}

}  // namespace

// ks/vs are NULL for a bf16 cache.  Positions [s*split_len, (s+1)*split_len)
// go to split s; with nsplit > 1 the kernel writes part_acc [nsplit,
// B*KVH*GT, hd] and part_ml [nsplit, B*KVH*GT, 2] (f32 scratch) and the
// combine kernel, launched next on the same stream, writes out.
BNB_EXPORT int bnb_flash_attention_cached(const void* q, const void* k, const void* v,
                                          const float* ks, const float* vs, const int* lengths,
                                          void* out, float* part_acc, float* part_ml, int B, int KVH,
                                          int GT, int S, int hd, int T, int window, float scale,
                                          int int8_kv, int split_len, int nsplit, cudaStream_t stream) {
    if (T <= 0 || GT <= 0 || S <= 0 || !splits_ok(S, split_len, nsplit)) return (int)cudaErrorInvalidValue;
    const Params p = make_params(q, k, v, ks, vs, nullptr, lengths, out, part_acc, part_ml, KVH, GT, S, T,
                                 window, scale, 0, 0, split_len, nsplit);
    if (int8_kv) return launch<int8_t, false>(p, B, hd, 0, stream);
    return launch<__nv_bfloat16, false>(p, B, hd, 0, stream);
}

// ks/vs are NULL for a bf16 pool; bs must be a power of two.  Splits as above,
// over the logical length maxb * bs.
BNB_EXPORT int bnb_flash_attention_paged(const void* q, const void* pool_k, const void* pool_v,
                                         const float* ks, const float* vs, const int* tables,
                                         const int* lengths, void* out, float* part_acc, float* part_ml,
                                         int B, int KVH, int GT, int maxb, int bs, int hd, int T, int window,
                                         float scale, int int8_kv, int split_len, int nsplit,
                                         cudaStream_t stream) {
    if (T <= 0 || GT <= 0 || maxb <= 0 || bs <= 0 || (bs & (bs - 1))) return (int)cudaErrorInvalidValue;
    const int bs_shift = __builtin_ctz((unsigned)bs);
    const int S = maxb * bs;
    if (!splits_ok(S, split_len, nsplit)) return (int)cudaErrorInvalidValue;
    // table entries a block stages: those of one split's positions, one more
    // where the split does not start on a block boundary
    const int table_entries = min(maxb, split_len / bs + 2);
    const Params p = make_params(q, pool_k, pool_v, ks, vs, tables, lengths, out, part_acc, part_ml, KVH, GT,
                                 S, T, window, scale, maxb, bs_shift, split_len, nsplit);
    if (int8_kv) return launch<int8_t, true>(p, B, hd, table_entries, stream);
    return launch<__nv_bfloat16, true>(p, B, hd, table_entries, stream);
}

// part_acc [nsplit, rows, hd], part_ml [nsplit, rows, 2] f32 -> out [rows, hd] bf16.
BNB_EXPORT int bnb_flash_attention_combine(const float* part_acc, const float* part_ml, void* out, int rows,
                                           int hd, int nsplit, cudaStream_t stream) {
    if (rows <= 0 || hd <= 0 || nsplit < 1) return (int)cudaErrorInvalidValue;
    flash_combine_kernel<<<rows, kThreads, 0, stream>>>(part_acc, part_ml, static_cast<__nv_bfloat16*>(out),
                                                        rows, hd, nsplit);
    return (int)cudaGetLastError();
}
