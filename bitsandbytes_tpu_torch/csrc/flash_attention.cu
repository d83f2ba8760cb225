// Causal flash attention of the training path (no cache): the forward, the
// dK/dV and the dQ kernel, bf16, head_dim 128 or 256, T a multiple of 128.
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
// rounding), m (the max of the scaled scores) and l = sum exp(scale s - m) in
// f32; the kernel takes p = 2^(scale log2(e) s - scale log2(e) max s), one
// FMA and ex2.  Backward: p = exp(s - m) * (1 / l) in f32, ds = (do.v - di) *
// p * scale; p and ds rounded to bf16 before the dV, dK and dQ products; f32
// accumulators stored once in bf16.  The GQA group's dK/dV add up in f32
// inside the dK/dV kernel (the TPU path rounds per query head, then sums the
// repeat's transpose).
//
// Bound on the H100: operations (2 T^2 hd H flops a product over the causal
// half, against 2 T hd H bytes a tensor), so the design keeps every product
// on the tensor cores and every intermediate in registers:
//
// * Forward (sm90.cuh): a block is a producer warpgroup and one consumer
//   warpgroup for each 64 query rows of one head: two (128 rows) at hd 128,
//   one at hd 256 (FwdCfg says why).  One producer thread loads Q once and
//   the K and V tiles of the KV head, from key 0 up to the diagonal, with TMA
//   into a two-stage ring of 128-byte-swizzled tiles (full mbarriers, and
//   empty ones for K and V apart; 128 keys a stage at hd 128, 64 at hd 256:
//   160 KB either way).  A consumer runs S = Q K^T on wgmma with both
//   operands in shared memory, the softmax in registers (the mask only on
//   the tiles that reach the diagonal), and O += P V on wgmma with P from
//   registers (the S accumulators rounded to bf16 are the A fragments) and V
//   as a transposed B.  At hd 128 the diagonal tile's last 64 keys follow
//   every row of the first warpgroup: it computes them masked.
// * Backward: mma.sync.m16n8k16 bf16 -> f32.  A block is four warps (eight
//   for the dK/dV kernel at hd 256), 16 rows a warp; operands by ldmatrix
//   from shared memory (rows padded by 16 B against bank conflicts), and p /
//   ds straight from the accumulators of the product before as the A
//   fragment of the next one.
// * dQ: a block owns 64 query rows of one head and walks the 64-key tiles of
//   its KV head up to the diagonal through a two-stage cp.async ring.  The dQ
//   sum runs in key order in registers: no atomics.
// * dK/dV: a block owns 64 keys of one KV head and walks its group's query
//   heads, then the 64-row query tiles from the diagonal down, Q and dO (and
//   the rows' m, l, di) through the ring; dK and dV stay in registers over
//   the whole group and are stored once.  At hd 256 two warps share each 16
//   keys, each accumulating half of hd (both recompute the scores: the
//   registers hold 16 x 128 of dK and of dV a warp, not 16 x 256).
// * Causal work only: tiles above the diagonal are never loaded, and in the
//   diagonal tile a backward warp skips the 16-wide chunks it cannot reach.
//   Blocks with the most tiles launch first.
// * Fixed order everywhere, so a result is the same from run to run.
#include <cmath>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRows = 64;  // query rows (dQ) or keys (dK/dV) of a block
constexpr int kTile = 64;  // keys (dQ) or query rows (dK/dV) of a ring stage

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
// forward: o, m, l (wgmma, TMA, a producer warpgroup)
// ---------------------------------------------------------------------------

// Registers set the shape.  ptxas (CUDA 12.9, sm_90a) kept every wgmma
// accumulator and A fragment under the launch register count, 168 a thread
// at 384 threads, though setmaxnreg gives the consumers 232: at hd 256 it
// spilled O to make room for S.  So at hd 128 a block is two consumer
// warpgroups, each holding O (64 registers), S (64) and P (32) for 64 rows,
// one tile at a time (issuing the next S before the softmax needs 160 and
// spilled).  At hd 256, where O alone takes 128, a block is one consumer
// warpgroup of 64 rows at 256 threads (up to 255 registers), which issues
// the next tile's S product before this tile's softmax and PV product, so its
// tensor cores do not wait on the softmax.
template <int HD>
struct FwdCfg {
    static constexpr int kConsumers = HD == 128 ? 2 : 1;
    static constexpr bool kOverlap = kConsumers == 1;
    static constexpr int kRows = 64 * kConsumers;  // query rows of a block
    static constexpr int kThreads = 128 * (1 + kConsumers);
    static constexpr int kKeys = HD == 128 ? 128 : 64;  // keys of a ring stage
    static constexpr int kStages = 2;
    static constexpr int kChunks = HD / 64;  // 64-column chunks of a row (128-byte swizzled tiles)
    static constexpr uint32_t kQBytes = kRows * HD * 2;
    static constexpr uint32_t kKvBytes = kKeys * HD * 2;  // a K or a V tile
    // shared memory from a 1024-byte aligned base: Q, the stages' [K | V], the
    // barriers (Q's, then K full, V full, K empty and V empty for each stage)
    static constexpr uint32_t kStage0 = kQBytes;
    static constexpr uint32_t kBars = kStage0 + kStages * 2 * kKvBytes;
    static constexpr uint32_t kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;  // + the base's alignment
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
    using C = FwdCfg<HD>;
    constexpr int N = C::kKeys;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full_k = full_q + 1;
    uint64_t* full_v = full_k + C::kStages;
    uint64_t* empty_k = full_v + C::kStages;
    uint64_t* empty_v = empty_k + C::kStages;
    auto sK = [&](int st) { return smem + C::kStage0 + st * 2 * C::kKvBytes; };
    auto sV = [&](int st) { return sK(st) + C::kKvBytes; };

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = qi * C::kRows;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full_k + st, 1);
            mbar_init(full_v + st, 1);
            mbar_init(empty_k + st, 4 * C::kConsumers);  // each consumer warp once
            mbar_init(empty_v + st, 4 * C::kConsumers);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // the producer: one thread issues every load; K and V tiles of KV
        // head h / (H / KVH) from key 0 up to the block's last row
        if constexpr (C::kConsumers == 2) setmaxnreg_dec<32>();
        if (threadIdx.x == 0) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            const int kvh = h / (p.H / p.KVH);
            const int ntiles = (r0 + C::kRows) / N;
            mbar_expect_tx(full_q, C::kQBytes);
            for (int c = 0; c < C::kChunks; ++c) tma_load_4d(smem + c * C::kRows * 128, &tq, full_q, c * 64, h, r0, b);
            for (int t = 0; t < ntiles; ++t) {
                const int st = t % C::kStages;
                const uint32_t par = ((t / C::kStages) - 1) & 1;
                if (t >= C::kStages) mbar_wait(empty_k + st, par);
                mbar_expect_tx(full_k + st, C::kKvBytes);
                for (int c = 0; c < C::kChunks; ++c)
                    tma_load_4d(sK(st) + c * N * 128, &tk, full_k + st, c * 64, kvh, t * N, b);
                if (t >= C::kStages) mbar_wait(empty_v + st, par);
                mbar_expect_tx(full_v + st, C::kKvBytes);
                for (int c = 0; c < C::kChunks; ++c)
                    tma_load_4d(sV(st) + c * N * 128, &tv, full_v + st, c * 64, kvh, t * N, b);
            }
        }
        return;
    }

    // a consumer warpgroup: 64 query rows, S = Q K^T and O += P V on wgmma
    if constexpr (C::kConsumers == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int rw = r0 + 64 * (wg - 1);  // the warpgroup's first row
    const int row[2] = {rw + 16 * warp + gq, rw + 16 * warp + gq + 8};
    const int ntiles = (rw + 64 + N - 1) / N;  // the tiles holding a key <= its last row
    const unsigned char* sQ = smem + (wg - 1) * 64 * 128;  // its rows of each Q chunk
    const float sl2 = p.scale * 1.44269504088896341f;  // scale * log2(e): exp(scale x) = 2^(sl2 x)
    float m[2] = {-INFINITY, -INFINITY};  // the row max of the unscaled scores
    float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float s[N / 2];
    uint32_t pa[N / 16][4];
    float corr[2];

    // S = Q K_t^T into s, committed as one group
    auto issue_s = [&](int t) {
        const int st = t % C::kStages;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) s[i] = 0.0f;
        mbar_wait(full_k + st, (t / C::kStages) & 1);
        const uint32_t qa = opaque(smem_addr(sQ)), ka = opaque(smem_addr(sK(st)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * C::kRows * 128 + (kk % 4) * 32;
            const uint32_t koff = (kk / 4) * N * 128 + (kk % 4) * 32;
            wgmma_ss<N>(s, gmma_desc_sw128(qa + off, 16, 1024), gmma_desc_sw128(ka + koff, 16, 1024), 1);
        }
        wgmma_commit();
    };
    // O += P V_t, committed as one group.  The fence follows the wait: no
    // branch may sit between a fence and its wgmma (ptxas would add a fence
    // of its own there and serialize every wgmma of the kernel).
    auto issue_pv = [&](int t) {
        const int st = t % C::kStages;
        mbar_wait(full_v + st, (t / C::kStages) & 1);
        const uint32_t va = opaque(smem_addr(sV(st)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_rs_tb<HD>(o, pa[kk], gmma_desc_sw128(va + kk * 16 * 128, N * 128, 1024), 1);
        wgmma_commit();
    };
    auto pack = [&](int kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };
    // the online softmax of tile t; corr is the factor o takes before the
    // tile's PV product.  p = 2^(sl2 s - sl2 m), one FMA and ex2, rounded to
    // bf16 pairs: the A fragments of the PV product (key step kk: n8 tiles
    // 2 kk, 2 kk + 1), packed as they come, or, while a PV product still
    // reads pa (kOverlap), kept in s for to_pa.
    auto softmax = [&](int t) {
        if (t * N + N - 1 > rw) {  // a key can follow a row: key t N + 8 j + 2 t4 + (e & 1) after row[e / 2]
            const int lim[2] = {row[0] - t * N - 2 * t4, row[1] - t * N - 2 * t4};
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (8 * j + (e & 1) > lim[e >> 1]) s[4 * j + e] = -INFINITY;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float ms[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            ms[i] = mx[i] * sl2;
            corr[i] = ex2(fmaf(m[i], sl2, -ms[i]));  // 0 on the first tile (m = -inf)
            m[i] = mx[i];
        }
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int i = 8 * kk + e;
                s[i] = ex2(fmaf(s[i], sl2, -ms[(e >> 1) & 1]));
                rs[(e >> 1) & 1] += s[i];
            }
            if constexpr (!C::kOverlap) pack(kk);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
    };
    auto to_pa = [&]() {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) pack(kk);
    };
    auto rescale_o = [&]() {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    };
    auto pv_landed = [&]() {
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) fence_regs(pa[kk]);
    };
    auto release = [&](uint64_t* bars, int t) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + t % C::kStages);  // this warp is done with the tile
    };

    mbar_wait(full_q, 0);
    if constexpr (!C::kOverlap) {
        for (int t = 0; t < ntiles; ++t) {
            issue_s(t);
            wgmma_wait<0>();
            fence_regs(s);
            release(empty_k, t);
            softmax(t);
            rescale_o();
            issue_pv(t);
            wgmma_wait<0>();
            pv_landed();
            release(empty_v, t);
        }
    } else {
        issue_s(0);
        wgmma_wait<0>();
        fence_regs(s);
        release(empty_k, 0);
        softmax(0);
        to_pa();
        for (int t = 1; t < ntiles; ++t) {
            issue_s(t);
            issue_pv(t - 1);
            wgmma_wait<1>();  // S_t has landed, P V_{t-1} may still run
            fence_regs(s);
            release(empty_k, t);
            softmax(t);
            wgmma_wait<0>();
            pv_landed();
            release(empty_v, t - 1);
            rescale_o();
            to_pa();
        }
        issue_pv(ntiles - 1);
        wgmma_wait<0>();
        pv_landed();
        release(empty_v, ntiles - 1);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.0f / l[i];
        __nv_bfloat16* dst = p.o + (((size_t)b * p.T + row[i]) * p.H + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
                pack_bf16x2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        if (t4 == 0) {
            const size_t ml = ((size_t)b * p.H + h) * p.T + row[i];
            p.m_out[ml] = __fmul_rn(m[i], p.scale);  // max of the scaled scores: the scale is monotone
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

// The three tensor maps of the forward ([B, T, heads, hd] read in place through
// its batch and token strides; boxes of 64 columns by the block's query rows
// or a stage's keys) and its launch.
template <int HD>
int launch_fwd(const Params& p, int B, cudaStream_t stream) {
    using C = FwdCfg<HD>;
    auto encode = [&](CUtensorMap* map, const __nv_bfloat16* base, int heads, long long sb, long long st, int rows) {
        // with one batch its stride is never used: any valid one will do
        const uint64_t sbb = B == 1 ? (uint64_t)p.T * st * 2 : (uint64_t)sb * 2;
        const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)heads, (uint64_t)p.T, (uint64_t)B};
        const uint64_t strides[3] = {(uint64_t)HD * 2, (uint64_t)st * 2, sbb};
        const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
        return encode_bf16_sw128(map, base, 4, dims, strides, box);
    };
    CUtensorMap tq, tk, tv;
    int e = encode(&tq, p.q, p.H, p.sqb, p.sqt, C::kRows);
    if (e == 0) e = encode(&tk, p.k, p.KVH, p.skb, p.skt, C::kKeys);
    if (e == 0) e = encode(&tv, p.v, p.KVH, p.svb, p.svt, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a =
        cudaFuncSetAttribute(flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_fwd_kernel<HD><<<dim3(p.H, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}

}  // namespace

// o [B, T, H, hd] bf16 (packed), m, l [B, H, T] f32; T a multiple of 128.
// Returns a CUDA error, or kTmaError + the CUresult of cuTensorMapEncodeTiled
// when a tensor map cannot be encoded (nothing is launched then).
BNB_EXPORT int bnb_flash_attention_causal_fwd(const void* q, const void* k, const void* v, void* o, float* m,
                                              float* l, int B, int T, int H, int KVH, int hd, long long sqb,
                                              long long sqt, long long skb, long long skt, long long svb,
                                              long long svt, float scale, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || T % 128) return (int)cudaErrorInvalidValue;
    Params p = make_params(q, k, v, nullptr, nullptr, nullptr, nullptr, T, H, KVH, sqb, sqt, skb, skt, svb, svt, 0,
                           0, scale);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.m_out = m;
    p.l_out = l;
    if (hd == 128) return launch_fwd<128>(p, B, stream);
    return launch_fwd<256>(p, B, stream);
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
