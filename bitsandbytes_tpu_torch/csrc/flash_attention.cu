// Causal flash attention of the training path (no cache): the forward, the
// dK/dV and the dQ kernel, T a multiple of 128, in two families: the wgmma
// kernels take bf16 and f16 at head_dim 128 and 256; the wide family (at the
// end of the file) takes f32 at any head_dim that is a multiple of 128 and
// bf16 and f16 at head_dim 384 and up.
//
// Replaces the three TPU kernels the JAX package reaches through
// models/llama.py:_flash_call, in jax/experimental/pallas/ops/tpu/
// flash_attention.py: the forward (_flash_attention_kernel_single_batch,
// pallas_call at :758), the dK/dV kernel (_flash_attention_dkv_kernel, :1121)
// and the dQ kernel (_flash_attention_dq_kernel, :1456), causal, sm_scale =
// hd^-0.5.
//
// q   [B, T, H, hd]    E, rows read through (batch, token) strides
// k,v [B, T, KVH, hd]  E, the same; query head h reads KV head h / (H/KVH)
// o, dq [B, T, H, hd], dk, dv [B, T, KVH, hd]  E, packed
// m, l, di [B, H, T]   f32: the row max and row sum of the forward, and
//                      di = sum(o * do) (computed by the caller)
//
// Numerics follow the TPU kernels: s = f32(q.k) * scale; a key after its
// query is masked (the TPU kernel adds -0.7 * FLT_MAX; here its p is 0, which
// is what exp gives there); forward: online softmax, p rounded to E before
// the PV product, f32 accumulation, o = acc / l stored in E (the TPU
// kernel renormalizes acc at every block: the same function up to f32
// rounding), m (the max of the scaled scores) and l = sum exp(scale s - m) in
// f32; the kernel takes p = 2^(scale log2(e) s - scale log2(e) max s), one
// FMA and ex2.  Backward: p = exp(s - m) * (1 / l) in f32 (both kernels take
// it as 2^(scale log2(e) s - m log2(e)) * (1 / l), one FMA and ex2), ds =
// (do.v - di) * p * scale; p and ds rounded to E before the dV, dK and dQ
// products (no-ops in f32); f32 accumulators stored once in E.  The GQA
// group's dK/dV add up in f32
// inside the dK/dV kernel (the TPU path rounds per query head, then sums the
// repeat's transpose).
//
// Bound on the H100: operations (2 T^2 hd H flops a product over the causal
// half, against 2 T hd H bytes a tensor), so the wgmma design keeps every
// product on the tensor cores and every intermediate in registers (bf16 and
// f16 are the same kernels, templated on E: the same tiles, swizzle, stages
// and wgmma shapes, the instruction's type word and the TMA type apart):
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
//   registers (the S accumulators rounded to E are the A fragments) and V
//   as a transposed B.  At hd 128 the diagonal tile's last 64 keys follow
//   every row of the first warpgroup: it computes them masked.
// * dK/dV (sm90.cuh): a block is one item of a work plan built on the host
//   (ops/flash_attention.dkv_plan): 64 keys of one KV head, 128 columns of
//   dK and dV (half of hd at 256), and a range of the key tile's iterations
//   over its group's query heads and the 64-row query tiles from the
//   diagonal down.  A producer thread loads K and V once and each
//   iteration's Q and dO tiles with TMA, and the rows' m, l, di by bulk
//   copies, into a ring (four stages at hd 128, two at 256).  One consumer
//   warpgroup runs S^T = K Q^T and dP^T = V dO^T on wgmma from shared memory,
//   p and ds in registers (the mask only on the diagonal tile; m log2(e) and
//   1 / l once a row), and dV += P^T dO, dK += dS^T Q on wgmma with P^T and
//   dS^T from registers and dO and Q as transposed B.  dK and dV stay in
//   registers over the item.  A key tile with more work than a slot's mean
//   is split into pieces that write f32 partials; the combine kernel adds
//   them in piece order and rounds once.  Items go longest first.
// * dQ (sm90.cuh; the bound is 3 products of 2 hd flops a (row, key) pair
//   of the causal half, 0.052 ms at 4r's T 2048 on an H100): a block is one
//   consumer warpgroup for each 64 query rows of one head, two (128 rows) at
//   hd 128, one at hd 256, and a producer warp (DqCfg says why).  One
//   producer thread loads Q and dO once, and the K and V tiles of the KV
//   head, from key 0 up to the block's last row, with TMA into a two-stage
//   ring of 64-key 128-byte-swizzled tiles.  A consumer runs S = Q K^T and
//   dP = dO V^T on wgmma from shared memory, p and ds in registers (the mask
//   only on its diagonal tile; m log2(e), 1 / l and di read once a row), and
//   dQ += dS K on wgmma with dS from registers and K read as a transposed B
//   from the same stage.  dQ stays in f32 registers over the walk, summed in
//   key order (no atomics, no split of a row's keys), and is stored once.
// * Causal work only: tiles above the diagonal are never loaded (a dQ
//   consumer stops at its own diagonal tile).  Blocks with the most tiles
//   launch first.
// * Fixed order everywhere, so a result is the same from run to run.
#include <cmath>

#include "common.cuh"
#include "sm90.cuh"

namespace {

// E: the element type of q, k, v, do and the outputs (bf16 or f16 on the
// wgmma kernels; f32, bf16 or f16 on the wide family)
template <class E>
struct Params {
    const E* q;
    const E* k;
    const E* v;
    const E* dout;
    const float* m;
    const float* l;
    const float* di;
    E* o;
    E* dq;
    E* dk;
    E* dv;
    float* m_out;
    float* l_out;
    long long sqb, sqt, skb, skt, svb, svt, sdb, sdt;  // (batch, token) strides in elements
    int T, H, KVH;
    float scale;
};

// Two f32 values rounded to the 16-bit E, packed low address first: the A
// fragments of a wgmma from registers, and the outputs' pairs.
template <class E> __device__ __forceinline__ uint32_t pack_x2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack_x2<__nv_bfloat16>(float lo, float hi) { return pack_bf16x2(lo, hi); }
template <> __device__ __forceinline__ uint32_t pack_x2<__half>(float lo, float hi) { return pack_f16x2(lo, hi); }

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

// 1 / x in one instruction, with no slow path to branch to
__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

template <int HD, class E>
__global__ void __launch_bounds__(FwdCfg<HD>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params<E> p) {
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
            wgmma_ss<N, E>(s, gmma_desc_sw128(qa + off, 16, 1024), gmma_desc_sw128(ka + koff, 16, 1024), 1);
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
            wgmma_rs_tb<HD, E>(o, pa[kk], gmma_desc_sw128(va + kk * 16 * 128, N * 128, 1024), 1);
        wgmma_commit();
    };
    auto pack = [&](int kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_x2<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };
    // the online softmax of tile t; corr is the factor o takes before the
    // tile's PV product.  p = 2^(sl2 s - sl2 m), one FMA and ex2, rounded to
    // E pairs: the A fragments of the PV product (key step kk: n8 tiles
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
        E* dst = p.o + (((size_t)b * p.T + row[i]) * p.H + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
                pack_x2<E>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        if (t4 == 0) {
            const size_t ml = ((size_t)b * p.H + h) * p.T + row[i];
            p.m_out[ml] = __fmul_rn(m[i], p.scale);  // max of the scaled scores: the scale is monotone
            p.l_out[ml] = l[i];
        }
    }
}

// ---------------------------------------------------------------------------
// dQ: dq = sum over keys of ds k (wgmma, TMA, a producer warp)
// ---------------------------------------------------------------------------

// Registers set the shape.  ptxas keeps every wgmma accumulator and A
// fragment under the launch register count (the forward's finding), and a
// consumer warpgroup of 64 query rows holds dQ (HD / 2 registers), S and dP
// of a 64-key stage (32 + 32) and dS as E A fragments (16): 144 at hd
// 128, 208 at hd 256.  The producer is one warp after the consumer
// warpgroups, not a warpgroup of its own, so the launch count stays high
// without setmaxnreg: 224 a thread at hd 128, where a block is two consumers
// (128 rows of one head, 288 threads) that read each K/V stage together,
// and 255 at hd 256, one consumer of 64 rows (160 threads).  m, l and di
// belong to a thread's two rows for the whole block: each consumer thread
// reads them into registers once.
template <int HD>
struct DqCfg {
    static constexpr int kConsumers = HD == 128 ? 2 : 1;
    static constexpr int kRows = 64 * kConsumers;  // query rows of a block
    static constexpr int kThreads = 128 * kConsumers + 32;
    static constexpr int kKeys = 64;  // keys of a ring stage
    static constexpr int kStages = 2;
    static constexpr int kChunks = HD / 64;  // 64-column chunks of a row (128-byte swizzled tiles)
    static constexpr uint32_t kQBytes = kRows * HD * 2;   // Q, and dO
    static constexpr uint32_t kKvBytes = kKeys * HD * 2;  // a K or a V tile
    // shared memory from a 1024-byte aligned base: Q, dO, the stages' [K | V],
    // the barriers (Q and dO's, then each stage's full and empty)
    static constexpr uint32_t kStage0 = 2 * kQBytes;
    static constexpr uint32_t kBars = kStage0 + kStages * 2 * kKvBytes;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;  // + the base's alignment
};

template <int HD, class E>
__global__ void __launch_bounds__(DqCfg<HD>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                        const Params<E> p) {
    using C = DqCfg<HD>;
    constexpr int N = C::kKeys;
    constexpr float kLog2e = 1.44269504088896341f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full = full_q + 1;
    uint64_t* empty = full + C::kStages;
    auto sK = [&](int st) { return smem + C::kStage0 + st * 2 * C::kKvBytes; };
    auto sV = [&](int st) { return sK(st) + C::kKvBytes; };

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = qi * C::kRows;
    const int wg = threadIdx.x / 128;  // a consumer warpgroup, or kConsumers: the producer warp

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 4 * C::kConsumers);  // each consumer warp once
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == C::kConsumers) {
        // the producer: one thread loads Q and dO once, then the K and V
        // tiles of KV head h / (H / KVH) from key 0 up to the block's last row
        if (threadIdx.x == 128 * C::kConsumers) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            tma_prefetch_map(&tdo);
            const int kvh = h / (p.H / p.KVH);
            const int ntiles = (r0 + C::kRows) / N;
            mbar_expect_tx(full_q, 2 * C::kQBytes);
            for (int c = 0; c < C::kChunks; ++c) {
                tma_load_4d(smem + c * C::kRows * 128, &tq, full_q, c * 64, h, r0, b);
                tma_load_4d(smem + C::kQBytes + c * C::kRows * 128, &tdo, full_q, c * 64, h, r0, b);
            }
            for (int t = 0; t < ntiles; ++t) {
                const int st = t % C::kStages;
                if (t >= C::kStages) mbar_wait(empty + st, ((t / C::kStages) - 1) & 1);
                mbar_expect_tx(full + st, 2 * C::kKvBytes);
                for (int c = 0; c < C::kChunks; ++c) {
                    tma_load_4d(sK(st) + c * N * 128, &tk, full + st, c * 64, kvh, t * N, b);
                    tma_load_4d(sV(st) + c * N * 128, &tv, full + st, c * 64, kvh, t * N, b);
                }
            }
        }
        return;
    }

    // a consumer warpgroup: 64 query rows.  S = Q K^T and dP = dO V^T with
    // both operands in shared memory, p and ds in registers, then dQ += dS K
    // with dS from registers (the dP accumulators rounded to E pairs are
    // the A fragments) and K read as a transposed B from the same tile.
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int rw = r0 + 64 * wg;  // the warpgroup's first row
    const int ntiles = rw / N + 1;  // the tiles holding a key <= its last row; the last is its diagonal
    const int rl[2] = {16 * warp + gq, 16 * warp + gq + 8};  // the thread's accumulator rows, from rw
    const float scale = p.scale;
    const float sl2 = scale * kLog2e;  // exp(scale x - m) = 2^(sl2 x - m log2(e))
    float ml2[2], linv[2], drow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const size_t ml = ((size_t)b * p.H + h) * p.T + rw + rl[i];
        ml2[i] = p.m[ml] * kLog2e;
        linv[i] = 1.0f / p.l[ml];
        drow[i] = p.di[ml];
    }
    const unsigned char* sQ = smem + wg * 64 * 128;  // its rows of each Q chunk
    const unsigned char* sDo = sQ + C::kQBytes;
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
    // S and dP: each tile's first k step overwrites them (scale_d 0); zeroed
    // in the loop, before the stage's wait, they would make ptxas fence and
    // serialize every wgmma (kernel 18's finding)
    float s[N / 2], dp[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.0f;
    uint32_t sa[N / 16][4];

    // S = Q K_t^T and dP = dO V_t^T, committed as two groups.  The fence
    // follows the wait: no branch may sit between a fence and its wgmma.
    auto issue_sdp = [&](int t) {
        const int st = t % C::kStages;
        mbar_wait(full + st, (t / C::kStages) & 1);
        const uint32_t qa = opaque(smem_addr(sQ)), oa = opaque(smem_addr(sDo));
        const uint32_t ka = opaque(smem_addr(sK(st))), va = opaque(smem_addr(sV(st)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * C::kRows * 128 + (kk % 4) * 32;
            const uint32_t koff = (kk / 4) * N * 128 + (kk % 4) * 32;
            wgmma_ss<N, E>(s, gmma_desc_sw128(qa + off, 16, 1024), gmma_desc_sw128(ka + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * C::kRows * 128 + (kk % 4) * 32;
            const uint32_t koff = (kk / 4) * N * 128 + (kk % 4) * 32;
            wgmma_ss<N, E>(dp, gmma_desc_sw128(oa + off, 16, 1024), gmma_desc_sw128(va + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();
    };
    // p = 2^(sl2 s - m log2(e)) * (1 / l): one FMA, ex2 and a product; 0
    // where the key follows the row, which happens on the diagonal tile only
    // (it starts at rw: key 8 j + 2 t4 + (e & 1) against row rl)
    auto probs = [&](int t) {
        const int past = t == ntiles - 1 ? 0 : N;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pr = ex2(fmaf(s[4 * j + e], sl2, -ml2[e >> 1])) * linv[e >> 1];
                s[4 * j + e] = 8 * j + 2 * t4 + (e & 1) > rl[e >> 1] + past ? 0.0f : pr;
            }
    };
    // ds = (dp - di) p scale, rounded to E pairs: the A fragments of key
    // step kk are the n8 tiles 2 kk and 2 kk + 1
    auto dsoft = [&]() {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) dp[i] = (dp[i] - drow[(i >> 1) & 1]) * s[i] * scale;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) sa[kk][r] = pack_x2<E>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    };
    // dQ += dS K_t, K_t read MN-major (a transposed B) from the stage's tile
    auto issue_dq = [&](int t) {
        const uint32_t ka = opaque(smem_addr(sK(t % C::kStages)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_rs_tb<HD, E>(dq, sa[kk], gmma_desc_sw128(ka + kk * 16 * 128, N * 128, 1024), 1);
        wgmma_commit();
    };
    auto dq_landed = [&]() {
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) fence_regs(sa[kk]);
    };
    auto release = [&](int t) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + t % C::kStages);  // this warp is done with the stage
    };

    mbar_wait(full_q, 0);
    for (int t = 0; t < ntiles; ++t) {
        issue_sdp(t);
        wgmma_wait<1>();  // S has landed, dP may still run
        fence_regs(s);
        probs(t);
        wgmma_wait<0>();
        fence_regs(dp);
        dsoft();
        issue_dq(t);
        wgmma_wait<0>();
        dq_landed();
        release(t);
    }

    // dQ in E, summed over the keys in key order, stored once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        E* dst = p.dq + (((size_t)b * p.T + rw + rl[i]) * p.H + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) = pack_x2<E>(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
}

// ---------------------------------------------------------------------------
// dK/dV: dv = sum p^T do, dk = sum ds^T q over the group's heads and rows
// (wgmma, TMA, a producer warpgroup, a work plan built on the host)
// ---------------------------------------------------------------------------

// One item of the work plan (ops/flash_attention.dkv_plan), eight ints: the
// batch, the KV head, the 64-key tile kj, which 128 columns of dK and dV it
// owns (half of hd at 256), the range [i0, i1) of the key tile's iterations
// (iteration i: query head kvh G + i / nq and query tile kj + i % nq, nq = T /
// 64 - kj, so each head starts at the diagonal tile), and the slot of f32
// partials it writes, or -1 when it is its key tile's only item and stores dK
// and dV in E itself.
struct __align__(16) DkvItem {
    int b, kvh, kj, half, i0, i1, slot, pad;
};

// Registers set the shape.  ptxas keeps every wgmma accumulator under the
// launch register count (the forward's finding), and a consumer holds dK and
// dV for 64 keys x 128 columns (64 + 64 registers) and S^T and dP^T for 64
// keys x 64 query rows (32 + 32): 192, which only a 256-thread block (a
// producer and one consumer warpgroup, up to 255 registers) can hold.  So a
// block is one item and one block an SM; at hd 256 an item owns half of hd,
// and the two halves both compute S^T and dP^T over all of it.
template <int HD>
struct DkvCfg {
    static constexpr int kKeys = 64;   // keys of an item: the M of every product
    static constexpr int kRows = 64;   // query rows of a stage: N of S^T and dP^T, K of the dV and dK products
    static constexpr int kCols = 128;  // columns of dK and dV an item owns
    static constexpr int kThreads = 256;
    static constexpr int kStages = HD == 128 ? 4 : 2;
    static constexpr int kChunks = HD / 64;         // 64-column chunks of a row (128-byte swizzled tiles)
    static constexpr uint32_t kTileBytes = 64 * HD * 2;  // K, V, and a stage's Q or dO
    static constexpr uint32_t kVals = 3 * kRows * 4;  // a stage's m, l and di
    // shared memory from a 1024-byte aligned base: K, V, the stages' [Q | dO |
    // m, l, di], the consumer's row values (m log2(e) and 1 / l, two buffers),
    // then the barriers (K and V's, each stage's full and empty)
    static constexpr uint32_t kStage0 = 2 * kTileBytes;
    static constexpr uint32_t kStageBytes = 2 * kTileBytes + 1024;
    static constexpr uint32_t kRowBuf = kStage0 + kStages * kStageBytes;
    static constexpr uint32_t kBars = kRowBuf + 2 * 2 * kRows * 4;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;  // + the base's alignment
};

template <int HD, class E>
__global__ void __launch_bounds__(DkvCfg<HD>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         const DkvItem* __restrict__ items, float* __restrict__ part_k, float* __restrict__ part_v,
                         const Params<E> p) {
    using C = DkvCfg<HD>;
    constexpr float kLog2e = 1.44269504088896341f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    unsigned char* sK = smem;
    unsigned char* sV = smem + C::kTileBytes;
    auto sQ = [&](int st) { return smem + C::kStage0 + st * C::kStageBytes; };
    auto sDo = [&](int st) { return sQ(st) + C::kTileBytes; };
    auto sVals = [&](int st) { return reinterpret_cast<float*>(sQ(st) + 2 * C::kTileBytes); };
    uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full = full_kv + 1;
    uint64_t* empty = full + C::kStages;

    const DkvItem it = items[blockIdx.x];  // the plan lists the longest items first
    const int G = p.H / p.KVH;
    const int nq = p.T / C::kRows - it.kj;  // the key tile's query tiles, from the diagonal down
    const int k0 = it.kj * C::kKeys;
    const int niter = it.i1 - it.i0;

    if (threadIdx.x == 0) {
        mbar_init(full_kv, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 4);  // each consumer warp once
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // the producer: one thread loads K and V once, then the Q and dO
        // tiles and the rows' m, l and di of each iteration into the ring
        if (threadIdx.x == 0) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            tma_prefetch_map(&tdo);
            mbar_expect_tx(full_kv, 2 * C::kTileBytes);
            for (int c = 0; c < C::kChunks; ++c) {
                tma_load_4d(sK + c * C::kKeys * 128, &tk, full_kv, c * 64, it.kvh, k0, it.b);
                tma_load_4d(sV + c * C::kKeys * 128, &tv, full_kv, c * 64, it.kvh, k0, it.b);
            }
            for (int n = 0; n < niter; ++n) {
                const int i = it.i0 + n;
                const int h = it.kvh * G + i / nq;
                const int t0 = (it.kj + i % nq) * C::kRows;
                const int st = n % C::kStages;
                if (n >= C::kStages) mbar_wait(empty + st, ((n / C::kStages) - 1) & 1);
                mbar_expect_tx(full + st, 2 * C::kTileBytes + C::kVals);
                for (int c = 0; c < C::kChunks; ++c) {
                    tma_load_4d(sQ(st) + c * C::kRows * 128, &tq, full + st, c * 64, h, t0, it.b);
                    tma_load_4d(sDo(st) + c * C::kRows * 128, &tdo, full + st, c * 64, h, t0, it.b);
                }
                const size_t row = ((size_t)it.b * p.H + h) * p.T + t0;
                bulk_load(sVals(st), p.m + row, C::kRows * 4, full + st);
                bulk_load(sVals(st) + C::kRows, p.l + row, C::kRows * 4, full + st);
                bulk_load(sVals(st) + 2 * C::kRows, p.di + row, C::kRows * 4, full + st);
            }
        }
        return;
    }

    // the consumer warpgroup: S^T = K Q^T and dP^T = V dO^T with both operands
    // in shared memory, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
    // from registers (the accumulators rounded to E pairs are the A
    // fragments) and dO and Q read as transposed B
    const int tid = threadIdx.x - 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int kr[2] = {16 * warp + gq, 16 * warp + gq + 8};  // the thread's accumulator rows: keys of the item
    const float sl2 = p.scale * kLog2e;  // exp(scale x - m) = 2^(sl2 x - m log2(e))
    const uint32_t half_off = it.half * 2 * C::kRows * 128;  // the item's two 64-column chunks of Q and dO
    float dk[C::kCols / 2], dv[C::kCols / 2];
#pragma unroll
    for (int i = 0; i < C::kCols / 2; ++i) dk[i] = dv[i] = 0.0f;
    // S^T and dP^T: each tile's first k step overwrites them (scale_d 0);
    // zeroing them in the loop, before the stage's wait, made ptxas insert a
    // fence of its own in that spin and serialize every wgmma (C7520)
    float s[C::kRows / 2], dp[C::kRows / 2];
#pragma unroll
    for (int i = 0; i < C::kRows / 2; ++i) s[i] = dp[i] = 0.0f;
    uint32_t pa[C::kRows / 16][4], sa[C::kRows / 16][4];

    mbar_wait(full_kv, 0);
    for (int n = 0; n < niter; ++n) {
        const int st = n % C::kStages;
        const bool diag = (it.i0 + n) % nq == 0;  // this query tile is the key tile's diagonal one
        mbar_wait(full + st, (n / C::kStages) & 1);
        const uint32_t ka = opaque(smem_addr(sK)), va = opaque(smem_addr(sV));
        const uint32_t qa = opaque(smem_addr(sQ(st))), oa = opaque(smem_addr(sDo(st)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
            wgmma_ss<C::kRows, E>(s, gmma_desc_sw128(ka + off, 16, 1024), gmma_desc_sw128(qa + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
            wgmma_ss<C::kRows, E>(dp, gmma_desc_sw128(va + off, 16, 1024), gmma_desc_sw128(oa + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        // while they run: the stage's m log2(e) and 1 / l, once a row
        const float* vals = sVals(st);
        float* rows = reinterpret_cast<float*>(smem + C::kRowBuf) + (n & 1) * 2 * C::kRows;
        const float x = vals[tid];  // m of row tid, then l of row tid - 64
        rows[tid] = tid < C::kRows ? x * kLog2e : rcp(x);
        named_barrier_sync(1, 128);
        wgmma_wait<1>();  // S^T has landed, dP^T may still run
        fence_regs(s);
        // p = 2^(sl2 s - m log2(e)) * (1 / l): one FMA, ex2 and a product; 0
        // where the key follows the row, which happens on the diagonal tile only
        const float2* m2 = reinterpret_cast<const float2*>(rows);
        const float2* li = reinterpret_cast<const float2*>(rows + C::kRows);
        const int past = diag ? 0 : C::kKeys;  // off the diagonal no key of the item follows a row
#pragma unroll
        for (int j = 0; j < C::kRows / 8; ++j) {
            const float2 mm = m2[4 * j + t4], ll = li[4 * j + t4];  // rows 8 j + 2 t4 and 8 j + 2 t4 + 1
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pr = ex2(fmaf(s[4 * j + e], sl2, -((e & 1) ? mm.y : mm.x))) * ((e & 1) ? ll.y : ll.x);
                s[4 * j + e] = kr[e >> 1] > 8 * j + 2 * t4 + (e & 1) + past ? 0.0f : pr;
            }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // ds = (dp - di) p scale; p and ds rounded to E pairs: the A
        // fragments of key step kk are the n8 tiles 2 kk and 2 kk + 1
        const float2* dd = reinterpret_cast<const float2*>(vals + 2 * C::kRows);
#pragma unroll
        for (int j = 0; j < C::kRows / 8; ++j) {
            const float2 d = dd[4 * j + t4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dp[4 * j + e] = (dp[4 * j + e] - ((e & 1) ? d.y : d.x)) * s[4 * j + e] * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                pa[kk][r] = pack_x2<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
                sa[kk][r] = pack_x2<E>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
            }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk)
            wgmma_rs_tb<C::kCols, E>(dv, pa[kk], gmma_desc_sw128(oa + half_off + kk * 16 * 128, C::kRows * 128, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk)
            wgmma_rs_tb<C::kCols, E>(dk, sa[kk], gmma_desc_sw128(qa + half_off + kk * 16 * 128, C::kRows * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(sa[kk]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }

    // the epilogue through shared memory (the ring is free now), so that the
    // stores are whole rows of 16 bytes a thread: E into dk and dv, or f32
    // into the item's partial slot
    constexpr int kOut = C::kCols + 8;  // f32 a staged row, padded against bank conflicts
    float* out = reinterpret_cast<float*>(smem + C::kStage0);  // [dK | dV][64 keys][kOut]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < C::kCols / 8; ++j) {
            float* o_k = out + kr[i] * kOut + 8 * j + 2 * t4;
            *reinterpret_cast<float2*>(o_k) = make_float2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
            *reinterpret_cast<float2*>(o_k + C::kKeys * kOut) = make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
        }
    named_barrier_sync(1, 128);
    if (it.slot < 0) {
        for (int u = tid; u < 2 * C::kKeys * C::kCols / 8; u += 128) {
            const int w = u / (C::kKeys * C::kCols / 8);  // 0: dK, 1: dV
            const int r = (u / (C::kCols / 8)) % C::kKeys, c = (u % (C::kCols / 8)) * 8;
            const float4 a = *reinterpret_cast<const float4*>(out + (w * C::kKeys + r) * kOut + c);
            const float4 z = *reinterpret_cast<const float4*>(out + (w * C::kKeys + r) * kOut + c + 4);
            E* dst = (w ? p.dv : p.dk) + (((size_t)it.b * p.T + k0 + r) * p.KVH + it.kvh) * HD + it.half * C::kCols + c;
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(pack_x2<E>(a.x, a.y), pack_x2<E>(a.z, a.w), pack_x2<E>(z.x, z.y), pack_x2<E>(z.z, z.w));
        }
    } else {  // a piece of a split key tile: f32 partials, added by the combine
        for (int u = tid; u < 2 * C::kKeys * C::kCols / 4; u += 128) {
            const int w = u / (C::kKeys * C::kCols / 4);
            const int r = (u / (C::kCols / 4)) % C::kKeys, c = (u % (C::kCols / 4)) * 4;
            float* dst = (w ? part_v : part_k) + ((size_t)it.slot * C::kKeys + r) * C::kCols + c;
            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(out + (w * C::kKeys + r) * kOut + c);
        }
    }
}

// Four f32 values rounded to E, stored at once (16 bytes in f32, 8 in the
// 16-bit types; the address aligned to that).
template <class E>
__device__ __forceinline__ void store4(E* dst, float a, float b, float c, float d) {
    if constexpr (sizeof(E) == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
    else
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack_x2<E>(a, b), pack_x2<E>(c, d));
}

// The combine of split key tiles: a block adds one key tile's pieces in
// piece order (table row: batch, KV head, key tile, column slice, first slot,
// pieces), 64 keys x 128 columns of dK and of dV in f32, and rounds the sums
// once to E.  Both families' dK/dV kernels write the partials it adds.
template <class E>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_combine_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                                 const int* __restrict__ table, E* dk, E* dv, int T, int KVH, int hd) {
    constexpr int kKeys = 64, kCols = 128;
    const int* u = table + 8 * blockIdx.x;
    const int b = u[0], kvh = u[1], kj = u[2], half = u[3], s0 = u[4], pieces = u[5];
    for (int i = threadIdx.x; i < kKeys * kCols / 4; i += 256) {
        const int r = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
        const size_t src = ((size_t)s0 * kKeys + r) * kCols + c;
        float4 ak = *reinterpret_cast<const float4*>(part_k + src);
        float4 av = *reinterpret_cast<const float4*>(part_v + src);
        for (int q = 1; q < pieces; ++q) {
            const size_t o = src + (size_t)q * kKeys * kCols;
            const float4 xk = *reinterpret_cast<const float4*>(part_k + o);
            const float4 xv = *reinterpret_cast<const float4*>(part_v + o);
            ak.x += xk.x;
            ak.y += xk.y;
            ak.z += xk.z;
            ak.w += xk.w;
            av.x += xv.x;
            av.y += xv.y;
            av.z += xv.z;
            av.w += xv.w;
        }
        const size_t dst = (((size_t)b * T + kj * kKeys + r) * KVH + kvh) * hd + half * kCols + c;
        store4<E>(dk + dst, ak.x, ak.y, ak.z, ak.w);
        store4<E>(dv + dst, av.x, av.y, av.z, av.w);
    }
}

// ---------------------------------------------------------------------------
// The wide family: the same three functions where the wgmma kernels stop, f32
// at any head_dim and bf16/f16 at head_dim 384 and up (CUDA cores, f32 FMA)
// ---------------------------------------------------------------------------

// Why CUDA cores.  f32 must be full f32 (the JAX package's "highest"
// precision): one TF32 pass keeps about three digits, and TF32 wgmma takes
// both operands K-major while V in P V is MN-major.  And a warpgroup's f32 O
// or dQ of 64 rows takes hd / 2 registers a thread, which with S and dP
// passes the 255-register limit above hd 256.  So a block here owns 128
// columns of its output (a column slice; hd / 128 blocks share a row tile
// and each recomputes the scores over all of hd) and keeps everything in
// f32: the bound is the f32 rate (67 TFLOP/s) for f32, and this simple
// design trades the 16-bit types' tensor-core rate for one code path.
//
// A block is 256 threads over a 64 x 64 tile of scores (S, or S^T in dK/dV)
// and a 64 x 128 slice of its output.  Thread (ty, tx) = (tid / 16, tid %
// 16) holds score rows ty + 16 i and columns tx + 16 j (i, j < 4), and
// output rows ty + 16 i at columns 4 tx + {0..3} and 64 + 4 tx + {0..3}: its
// score rows, so a row's softmax factors stay in the thread and a row's
// reductions are shuffles over 16 lanes.  Scores sum over head_dim in
// 32-column chunks staged in shared memory as f32 (four float4 loads give 64
// FMAs); the products with P or dS read a 128-column slice of V, K, Q or dO
// staged the same way.  Every sum runs in a fixed order, so a result is the
// same from run to run; the rounding points are the wgmma kernels' (p, and
// ds, rounded to E before each product, no-ops in f32).
struct WideCfg {
    static constexpr int kTile = 64;    // rows and keys of a score tile
    static constexpr int kCols = 128;   // output columns of a block
    static constexpr int kChunk = 32;   // head_dim columns of a staged chunk
    static constexpr int kThreads = 256;
    static constexpr int kCp = kChunk + 4;  // f32 a staged chunk row, padded against bank conflicts
    static constexpr int kPp = kTile + 4;   // f32 a row of staged P or dS
    static constexpr int kSp = kCols + 4;   // f32 a row of a staged slice
    static constexpr int kChunkFloats = kTile * kCp;
    static constexpr int kPFloats = kTile * kPp;
    static constexpr int kSliceFloats = kTile * kSp;
    // shared memory: the forward stages 2 chunks, P and a slice; dQ 4 chunks,
    // dS and a slice; dK/dV 4 chunks, P, dS and 2 slices
    static constexpr int kFwdBytes = (2 * kChunkFloats + kPFloats + kSliceFloats) * 4;
    static constexpr int kDqBytes = (4 * kChunkFloats + kPFloats + kSliceFloats) * 4;
    static constexpr int kDkvBytes = (4 * kChunkFloats + 2 * kPFloats + 2 * kSliceFloats) * 4;
};

// 64 rows of W columns from `src` (rows `stride` elements apart, 16-byte
// aligned) -> f32 rows of `pitch` floats at `dst`, eight values a thread a
// step.  One step at a time: unrolled, a slice's loads held 32 more
// registers and pushed the forward past 128, one block an SM, which was
// slower on an H100 for the forward and dQ, and faster by a few percent for
// dK/dV, one block an SM either way (experiments/
// ab_flash_wide_variants_torch.py, PERF.md §6).
template <int W, class E>
__device__ __forceinline__ void wide_stage(float* dst, int pitch, const E* src, long long stride) {
    constexpr int kGroups = W / 8;
#pragma unroll 1
    for (int n = 0; n < WideCfg::kTile * kGroups / WideCfg::kThreads; ++n) {
        const int u = threadIdx.x + n * WideCfg::kThreads;
        const int r = u / kGroups, g = u % kGroups;
        float a[8];
        load8<E>(src + r * stride + 8 * g, a);
        float* d = dst + r * pitch + 8 * g;
        *reinterpret_cast<float4*>(d) = make_float4(a[0], a[1], a[2], a[3]);
        *reinterpret_cast<float4*>(d + 4) = make_float4(a[4], a[5], a[6], a[7]);
    }
}

// acc[i][j] += the dot of staged chunk rows a[ty + 16 i] and b[tx + 16 j]
__device__ __forceinline__ void wide_dots(float (&acc)[4][4], const float* a, const float* b, int ty, int tx) {
#pragma unroll
    for (int c = 0; c < WideCfg::kChunk; c += 4) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * WideCfg::kCp + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 y = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * WideCfg::kCp + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][j] = fmaf(x[i].x, y.x, acc[i][j]);
                acc[i][j] = fmaf(x[i].y, y.y, acc[i][j]);
                acc[i][j] = fmaf(x[i].z, y.z, acc[i][j]);
                acc[i][j] = fmaf(x[i].w, y.w, acc[i][j]);
            }
        }
    }
}

__device__ __forceinline__ float comp(const float4& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// out[i][:] += sum over k of w[ty + 16 i][k] times the staged slice's row k
// at columns 4 tx + {0..3} and 64 + 4 tx + {0..3}, k in key order
__device__ __forceinline__ void wide_product(float (&out)[4][8], const float* w, const float* sl, int ty, int tx) {
#pragma unroll 2
    for (int k = 0; k < WideCfg::kTile; k += 4) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * WideCfg::kPp + k);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float4 lo = *reinterpret_cast<const float4*>(sl + (k + e) * WideCfg::kSp + 4 * tx);
            const float4 hi = *reinterpret_cast<const float4*>(sl + (k + e) * WideCfg::kSp + 64 + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float pe = comp(x[i], e);
                out[i][0] = fmaf(pe, lo.x, out[i][0]);
                out[i][1] = fmaf(pe, lo.y, out[i][1]);
                out[i][2] = fmaf(pe, lo.z, out[i][2]);
                out[i][3] = fmaf(pe, lo.w, out[i][3]);
                out[i][4] = fmaf(pe, hi.x, out[i][4]);
                out[i][5] = fmaf(pe, hi.y, out[i][5]);
                out[i][6] = fmaf(pe, hi.z, out[i][6]);
                out[i][7] = fmaf(pe, hi.w, out[i][7]);
            }
        }
    }
}

// a row's reduction over the 16 lanes that hold it
__device__ __forceinline__ float max16(float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// 8 output values of a thread's row, rounded to E: columns 4 tx.. and 64 + 4 tx..
template <class E>
__device__ __forceinline__ void wide_store(E* dst, const float (&v)[8], float f) {
    store4<E>(dst, v[0] * f, v[1] * f, v[2] * f, v[3] * f);
    store4<E>(dst + 64, v[4] * f, v[5] * f, v[6] * f, v[7] * f);
}

// The forward: a block is 64 query rows of one head and one column slice of
// o, walking the key tiles up to its diagonal: S over all of hd, the online
// softmax (p = 2^(scale log2(e) s - scale log2(e) max s), one FMA and ex2, as
// the wgmma kernel), O += P V over the slice; o = O / l.  Slice 0 writes m
// and l.
template <class E>
__global__ void __launch_bounds__(WideCfg::kThreads)
    flash_wide_fwd_kernel(const Params<E> p, int hd) {
    using C = WideCfg;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + C::kChunkFloats;
    float* sP = sK + C::kChunkFloats;
    float* sV = sP + C::kPFloats;
    const int slices = hd / C::kCols;
    const int h = blockIdx.x / slices, cs = blockIdx.x % slices, b = blockIdx.y;
    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first
    const int r0 = qi * C::kTile;
    const int kvh = h / (p.H / p.KVH);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float sl2 = p.scale * 1.44269504088896341f;
    const E* q = p.q + b * p.sqb + r0 * p.sqt + (long long)h * hd;
    const E* k = p.k + b * p.skb + (long long)kvh * hd;
    const E* v = p.v + b * p.svb + (long long)kvh * hd + cs * C::kCols;
    float m[4], l[4], o[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = 0.0f;
    }
    for (int t = 0; t <= qi; ++t) {
        float s[4][4] = {};
        const E* kt = k + (long long)t * C::kTile * p.skt;
        for (int c0 = 0; c0 < hd; c0 += C::kChunk) {
            __syncthreads();  // every thread is done with the last chunk, P and slice
            wide_stage<C::kChunk>(sQ, C::kCp, q + c0, p.sqt);
            wide_stage<C::kChunk>(sK, C::kCp, kt + c0, p.skt);
            __syncthreads();
            wide_dots(s, sQ, sK, ty, tx);
        }
        if (t == qi) {  // the diagonal tile: key tx + 16 j follows row ty + 16 i
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (tx + 16 * j > ty + 16 * i) s[i][j] = -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = m[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
            mx = max16(mx);
            const float ms = mx * sl2;
            const float corr = ex2(fmaf(m[i], sl2, -ms));  // 0 on the first tile (m = -inf)
            m[i] = mx;
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pr = ex2(fmaf(s[i][j], sl2, -ms));
                rs += pr;
                sP[(ty + 16 * i) * C::kPp + tx + 16 * j] = round_to<E>(pr);  // p in v's type for P V
            }
            l[i] = l[i] * corr + rs;
#pragma unroll
            for (int c = 0; c < 8; ++c) o[i][c] *= corr;
        }
        wide_stage<C::kCols>(sV, C::kSp, v + (long long)t * C::kTile * p.svt, p.svt);
        __syncthreads();
        wide_product(o, sP, sV, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float li = sum16(l[i]);
        const int row = r0 + ty + 16 * i;
        wide_store<E>(p.o + (((size_t)b * p.T + row) * p.H + h) * hd + cs * C::kCols + 4 * tx, o[i], 1.0f / li);
        if (cs == 0 && tx == 0) {
            const size_t ml = ((size_t)b * p.H + h) * p.T + row;
            p.m_out[ml] = __fmul_rn(m[i], p.scale);  // max of the scaled scores: the scale is monotone
            p.l_out[ml] = li;
        }
    }
}

// dQ: a block is 64 query rows of one head and one column slice of dq,
// walking the key tiles up to its diagonal in key order: S and dP over all
// of hd, p = 2^(scale log2(e) s - m log2(e)) * (1 / l), ds = (dp - di) p
// scale rounded to E, dQ += dS K over the slice.
template <class E>
__global__ void __launch_bounds__(WideCfg::kThreads)
    flash_wide_dq_kernel(const Params<E> p, int hd) {
    using C = WideCfg;
    constexpr float kLog2e = 1.44269504088896341f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + C::kChunkFloats;
    float* sDo = sK + C::kChunkFloats;
    float* sV = sDo + C::kChunkFloats;
    float* sDs = sV + C::kChunkFloats;
    float* sKs = sDs + C::kPFloats;
    const int slices = hd / C::kCols;
    const int h = blockIdx.x / slices, cs = blockIdx.x % slices, b = blockIdx.y;
    const int qi = gridDim.z - 1 - blockIdx.z;
    const int r0 = qi * C::kTile;
    const int kvh = h / (p.H / p.KVH);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float scale = p.scale, sl2 = scale * kLog2e;
    const E* q = p.q + b * p.sqb + r0 * p.sqt + (long long)h * hd;
    const E* dout = p.dout + b * p.sdb + r0 * p.sdt + (long long)h * hd;
    const E* k = p.k + b * p.skb + (long long)kvh * hd;
    const E* v = p.v + b * p.svb + (long long)kvh * hd;
    float ml2[4], linv[4], drow[4], dq[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const size_t ml = ((size_t)b * p.H + h) * p.T + r0 + ty + 16 * i;
        ml2[i] = p.m[ml] * kLog2e;
        linv[i] = 1.0f / p.l[ml];
        drow[i] = p.di[ml];
#pragma unroll
        for (int c = 0; c < 8; ++c) dq[i][c] = 0.0f;
    }
    for (int t = 0; t <= qi; ++t) {
        float s[4][4] = {}, dp[4][4] = {};
        const E* kt = k + (long long)t * C::kTile * p.skt;
        const E* vt = v + (long long)t * C::kTile * p.svt;
        for (int c0 = 0; c0 < hd; c0 += C::kChunk) {
            __syncthreads();
            wide_stage<C::kChunk>(sQ, C::kCp, q + c0, p.sqt);
            wide_stage<C::kChunk>(sK, C::kCp, kt + c0, p.skt);
            wide_stage<C::kChunk>(sDo, C::kCp, dout + c0, p.sdt);
            wide_stage<C::kChunk>(sV, C::kCp, vt + c0, p.svt);
            __syncthreads();
            wide_dots(s, sQ, sK, ty, tx);
            wide_dots(dp, sDo, sV, ty, tx);
        }
        const int past = t == qi ? 0 : C::kTile;  // off the diagonal no key follows a row
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pr = tx + 16 * j > ty + 16 * i + past ? 0.0f : ex2(fmaf(s[i][j], sl2, -ml2[i])) * linv[i];
                sDs[(ty + 16 * i) * C::kPp + tx + 16 * j] = round_to<E>((dp[i][j] - drow[i]) * pr * scale);
            }
        wide_stage<C::kCols>(sKs, C::kSp, kt + cs * C::kCols, p.skt);
        __syncthreads();
        wide_product(dq, sDs, sKs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        wide_store<E>(p.dq + (((size_t)b * p.T + r0 + ty + 16 * i) * p.H + h) * hd + cs * C::kCols + 4 * tx, dq[i],
                      1.0f);
}

// dK/dV: a block is one item of the wgmma kernel's work plan (64 keys of one
// KV head, a column slice, a range of its (query head, query tile)
// iterations from the diagonal down).  Each iteration: S^T and dP^T over all
// of hd (score rows are keys, columns query rows), p^T and ds^T rounded to
// E, dV += P^T dO and dK += dS^T Q over the slice.  dK and dV stay in
// registers over the item; a piece of a split key tile writes f32 partials
// for the combine.
template <class E>
__global__ void __launch_bounds__(WideCfg::kThreads, 1)
    flash_wide_dkv_kernel(const Params<E> p, int hd, const DkvItem* __restrict__ items, float* __restrict__ part_k,
                          float* __restrict__ part_v) {
    using C = WideCfg;
    constexpr float kLog2e = 1.44269504088896341f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sK = reinterpret_cast<float*>(smem_raw);
    float* sQ = sK + C::kChunkFloats;
    float* sV = sQ + C::kChunkFloats;
    float* sDo = sV + C::kChunkFloats;
    float* sP = sDo + C::kChunkFloats;
    float* sDs = sP + C::kPFloats;
    float* sQs = sDs + C::kPFloats;
    float* sDos = sQs + C::kSliceFloats;
    const DkvItem it = items[blockIdx.x];  // the plan lists the longest items first
    const int G = p.H / p.KVH;
    const int nq = p.T / C::kTile - it.kj;  // the key tile's query tiles, from the diagonal down
    const int k0 = it.kj * C::kTile;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float scale = p.scale, sl2 = scale * kLog2e;
    const E* k = p.k + it.b * p.skb + k0 * p.skt + (long long)it.kvh * hd;
    const E* v = p.v + it.b * p.svb + k0 * p.svt + (long long)it.kvh * hd;
    float dk[4][8], dv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.0f;
    for (int n = it.i0; n < it.i1; ++n) {
        const int h = it.kvh * G + n / nq;
        const int t0 = (it.kj + n % nq) * C::kTile;
        const int past = n % nq == 0 ? 0 : C::kTile;  // off the diagonal no key of the item follows a row
        const E* q = p.q + it.b * p.sqb + t0 * p.sqt + (long long)h * hd;
        const E* dout = p.dout + it.b * p.sdb + t0 * p.sdt + (long long)h * hd;
        float ml2[4], linv[4], dj[4];  // of the query rows tx + 16 j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const size_t ml = ((size_t)it.b * p.H + h) * p.T + t0 + tx + 16 * j;
            ml2[j] = p.m[ml] * kLog2e;
            linv[j] = 1.0f / p.l[ml];
            dj[j] = p.di[ml];
        }
        float s[4][4] = {}, dp[4][4] = {};
        for (int c0 = 0; c0 < hd; c0 += C::kChunk) {
            __syncthreads();
            wide_stage<C::kChunk>(sK, C::kCp, k + c0, p.skt);
            wide_stage<C::kChunk>(sQ, C::kCp, q + c0, p.sqt);
            wide_stage<C::kChunk>(sV, C::kCp, v + c0, p.svt);
            wide_stage<C::kChunk>(sDo, C::kCp, dout + c0, p.sdt);
            __syncthreads();
            wide_dots(s, sK, sQ, ty, tx);
            wide_dots(dp, sV, sDo, ty, tx);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pr = ty + 16 * i > tx + 16 * j + past ? 0.0f : ex2(fmaf(s[i][j], sl2, -ml2[j])) * linv[j];
                sP[(ty + 16 * i) * C::kPp + tx + 16 * j] = round_to<E>(pr);
                sDs[(ty + 16 * i) * C::kPp + tx + 16 * j] = round_to<E>((dp[i][j] - dj[j]) * pr * scale);
            }
        wide_stage<C::kCols>(sQs, C::kSp, q + it.half * C::kCols, p.sqt);
        wide_stage<C::kCols>(sDos, C::kSp, dout + it.half * C::kCols, p.sdt);
        __syncthreads();
        wide_product(dv, sP, sDos, ty, tx);
        wide_product(dk, sDs, sQs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = ty + 16 * i;
        if (it.slot < 0) {
            const size_t dst = (((size_t)it.b * p.T + k0 + key) * p.KVH + it.kvh) * hd + it.half * C::kCols + 4 * tx;
            wide_store<E>(p.dk + dst, dk[i], 1.0f);
            wide_store<E>(p.dv + dst, dv[i], 1.0f);
        } else {  // a piece of a split key tile: f32 partials, added by the combine
            const size_t dst = ((size_t)it.slot * C::kTile + key) * C::kCols + 4 * tx;
            wide_store<float>(part_k + dst, dk[i], 1.0f);
            wide_store<float>(part_v + dst, dv[i], 1.0f);
        }
    }
}

// ---------------------------------------------------------------------------

template <class E>
struct Tag {
    using type = E;
};

// f(Tag<E>) for the element type of `kind` (common.cuh's Kind), or an
// invalid value
template <class F>
int by_kind(int kind, F&& f) {
    if (kind == kF32) return f(Tag<float>{});
    if (kind == kBf16) return f(Tag<__nv_bfloat16>{});
    if (kind == kF16) return f(Tag<__half>{});
    return (int)cudaErrorInvalidValue;
}

// Shapes every kernel takes: hd a multiple of 128, T of 128.  The wgmma
// kernels take hd 128 and 256 in bf16 and f16 alone (wgmma_ok).
bool shapes_ok(int B, int T, int H, int KVH, int hd) {
    return B > 0 && B <= 65535 && T > 0 && T % 128 == 0 && T / 64 <= 65535 && H > 0 && KVH > 0 && H % KVH == 0 &&
           hd > 0 && hd % 128 == 0;
}

bool wgmma_ok(int kind, int hd) { return (kind == kBf16 || kind == kF16) && (hd == 128 || hd == 256); }

template <class E>
Params<E> make_params(const void* q, const void* k, const void* v, const void* dout, const float* m, const float* l,
                      const float* di, int T, int H, int KVH, long long sqb, long long sqt, long long skb,
                      long long skt, long long svb, long long svt, long long sdb, long long sdt, float scale) {
    Params<E> p = {};
    p.q = static_cast<const E*>(q);
    p.k = static_cast<const E*>(k);
    p.v = static_cast<const E*>(v);
    p.dout = static_cast<const E*>(dout);
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

template <class E> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <> constexpr CUtensorMapDataType tma_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// A tensor map over a [B, T, heads, hd] tensor of E read in place through its
// batch and token strides: boxes of 64 columns by `rows` tokens of one head,
// 128-byte swizzled.
template <class E>
int encode_rows(CUtensorMap* map, const E* base, int hd, int B, int T, int heads, long long sb, long long st,
                int rows) {
    // with one batch its stride is never used: any valid one will do
    const uint64_t sbb = B == 1 ? (uint64_t)T * st * 2 : (uint64_t)sb * 2;
    const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)T, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)hd * 2, (uint64_t)st * 2, sbb};
    const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
    return encode_16bit_sw128(map, tma_type<E>(), base, 4, dims, strides, box);
}

// The three tensor maps of the forward (boxes of the block's query rows or a
// stage's keys) and its launch.
template <int HD, class E>
int launch_fwd(const Params<E>& p, int B, cudaStream_t stream) {
    using C = FwdCfg<HD>;
    CUtensorMap tq, tk, tv;
    int e = encode_rows(&tq, p.q, HD, B, p.T, p.H, p.sqb, p.sqt, C::kRows);
    if (e == 0) e = encode_rows(&tk, p.k, HD, B, p.T, p.KVH, p.skb, p.skt, C::kKeys);
    if (e == 0) e = encode_rows(&tv, p.v, HD, B, p.T, p.KVH, p.svb, p.svt, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a =
        cudaFuncSetAttribute(flash_fwd_kernel<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_fwd_kernel<HD, E><<<dim3(p.H, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk, tv, p);
    return (int)cudaGetLastError();
}

// The four tensor maps of a backward kernel: boxes of `rows` query rows of q
// and do, and of `keys` keys of k and v.
template <class E>
int encode_bwd(CUtensorMap& tq, CUtensorMap& tk, CUtensorMap& tv, CUtensorMap& tdo, const Params<E>& p, int hd, int B,
               int rows, int keys) {
    int e = encode_rows(&tq, p.q, hd, B, p.T, p.H, p.sqb, p.sqt, rows);
    if (e == 0) e = encode_rows(&tk, p.k, hd, B, p.T, p.KVH, p.skb, p.skt, keys);
    if (e == 0) e = encode_rows(&tv, p.v, hd, B, p.T, p.KVH, p.svb, p.svt, keys);
    if (e == 0) e = encode_rows(&tdo, p.dout, hd, B, p.T, p.H, p.sdb, p.sdt, rows);
    return e;
}

// The dK/dV kernel's launch, one block an item of the plan.
template <int HD, class E>
int launch_dkv(const Params<E>& p, int B, const DkvItem* items, int n_items, float* part_k, float* part_v,
               cudaStream_t stream) {
    using C = DkvCfg<HD>;
    CUtensorMap tq, tk, tv, tdo;
    const int e = encode_bwd(tq, tk, tv, tdo, p, HD, B, C::kRows, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_bwd_dkv_kernel<HD, E><<<n_items, C::kThreads, C::kBytes, stream>>>(tq, tk, tv, tdo, items, part_k, part_v, p);
    return (int)cudaGetLastError();
}

// The dQ kernel's launch: a block the kRows query rows of one head, the
// longest rows first.
template <int HD, class E>
int launch_dq(const Params<E>& p, int B, cudaStream_t stream) {
    using C = DqCfg<HD>;
    CUtensorMap tq, tk, tv, tdo;
    const int e = encode_bwd(tq, tk, tv, tdo, p, HD, B, C::kRows, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a =
        cudaFuncSetAttribute(flash_bwd_dq_kernel<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_bwd_dq_kernel<HD, E><<<dim3(p.H, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk, tv, tdo, p);
    return (int)cudaGetLastError();
}

// A wide-family kernel's launch over `grid` with `bytes` of shared memory.
template <class K, class... Args>
int launch_wide(K kernel, dim3 grid, int bytes, cudaStream_t stream, Args... args) {
    const cudaError_t a = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (a != cudaSuccess) return (int)a;
    kernel<<<grid, WideCfg::kThreads, bytes, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// Every entry takes `kind` (common.cuh's Kind: f32, bf16 or f16), the type
// of q, k, v, do and the outputs.  The plain entries run the wgmma kernels
// (bf16 or f16, hd 128 or 256), the _wide ones the wide family (any of the
// three types, hd a multiple of 128); each refuses what its kernels do not
// take.  T is a multiple of 128 and outputs are packed.  An entry returns a
// CUDA error, or kTmaError + the CUresult of cuTensorMapEncodeTiled when a
// tensor map cannot be encoded (nothing is launched then).

// o [B, T, H, hd], m, l [B, H, T] f32.
BNB_EXPORT int bnb_flash_attention_causal_fwd(const void* q, const void* k, const void* v, void* o, float* m,
                                              float* l, int B, int T, int H, int KVH, int hd, long long sqb,
                                              long long sqt, long long skb, long long skt, long long svb,
                                              long long svt, float scale, int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || !wgmma_ok(kind, hd)) return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        if constexpr (sizeof(E) == 4) {
            return (int)cudaErrorInvalidValue;
        } else {
            Params<E> p = make_params<E>(q, k, v, nullptr, nullptr, nullptr, nullptr, T, H, KVH, sqb, sqt, skb, skt,
                                         svb, svt, 0, 0, scale);
            p.o = static_cast<E*>(o);
            p.m_out = m;
            p.l_out = l;
            return hd == 128 ? launch_fwd<128>(p, B, stream) : launch_fwd<256>(p, B, stream);
        }
    });
}

BNB_EXPORT int bnb_flash_attention_causal_fwd_wide(const void* q, const void* k, const void* v, void* o, float* m,
                                                   float* l, int B, int T, int H, int KVH, int hd, long long sqb,
                                                   long long sqt, long long skb, long long skt, long long svb,
                                                   long long svt, float scale, int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd)) return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        Params<E> p = make_params<E>(q, k, v, nullptr, nullptr, nullptr, nullptr, T, H, KVH, sqb, sqt, skb, skt, svb,
                                     svt, 0, 0, scale);
        p.o = static_cast<E*>(o);
        p.m_out = m;
        p.l_out = l;
        return launch_wide(flash_wide_fwd_kernel<E>, dim3(H * (hd / WideCfg::kCols), B, T / WideCfg::kTile),
                           WideCfg::kFwdBytes, stream, p, hd);
    });
}

// dk, dv [B, T, KVH, hd], through the work plan `items` (n_items DkvItem, one
// block each); part_k and part_v hold the f32 partials of split key tiles
// ([slots][64][128]; NULL when nothing is split), which
// bnb_flash_attention_causal_bwd_dkv_combine adds.
BNB_EXPORT int bnb_flash_attention_causal_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                                  const float* m, const float* l, const float* di, void* dk,
                                                  void* dv, float* part_k, float* part_v, const void* items,
                                                  int n_items, int B, int T, int H, int KVH, int hd, long long sqb,
                                                  long long sqt, long long skb, long long skt, long long svb,
                                                  long long svt, long long sdb, long long sdt, float scale, int kind,
                                                  cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || !wgmma_ok(kind, hd) || n_items <= 0 || items == nullptr)
        return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        if constexpr (sizeof(E) == 4) {
            return (int)cudaErrorInvalidValue;
        } else {
            Params<E> p =
                make_params<E>(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt, scale);
            p.dk = static_cast<E*>(dk);
            p.dv = static_cast<E*>(dv);
            const DkvItem* it = static_cast<const DkvItem*>(items);
            return hd == 128 ? launch_dkv<128>(p, B, it, n_items, part_k, part_v, stream)
                             : launch_dkv<256>(p, B, it, n_items, part_k, part_v, stream);
        }
    });
}

BNB_EXPORT int bnb_flash_attention_causal_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                                                       const float* m, const float* l, const float* di, void* dk,
                                                       void* dv, float* part_k, float* part_v, const void* items,
                                                       int n_items, int B, int T, int H, int KVH, int hd,
                                                       long long sqb, long long sqt, long long skb, long long skt,
                                                       long long svb, long long svt, long long sdb, long long sdt,
                                                       float scale, int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || n_items <= 0 || items == nullptr) return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        Params<E> p = make_params<E>(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt, scale);
        p.dk = static_cast<E*>(dk);
        p.dv = static_cast<E*>(dv);
        return launch_wide(flash_wide_dkv_kernel<E>, dim3(n_items), WideCfg::kDkvBytes, stream, p, hd,
                           static_cast<const DkvItem*>(items), part_k, part_v);
    });
}

// The split key tiles of a dK/dV plan: `table` [n_units][8] int32 (batch, KV
// head, key tile, column slice, first slot, pieces), part_k, part_v
// [slots][64][128] f32 -> their rows of dk, dv [B, T, KVH, hd] of `kind`.
BNB_EXPORT int bnb_flash_attention_causal_bwd_dkv_combine(const float* part_k, const float* part_v,
                                                          const void* table, int n_units, void* dk, void* dv, int T,
                                                          int KVH, int hd, int kind, cudaStream_t stream) {
    if (n_units <= 0 || T <= 0 || T % 64 || KVH <= 0 || hd <= 0 || hd % 128) return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        flash_bwd_dkv_combine_kernel<E><<<n_units, 256, 0, stream>>>(
            part_k, part_v, static_cast<const int*>(table), static_cast<E*>(dk), static_cast<E*>(dv), T, KVH, hd);
        return (int)cudaGetLastError();
    });
}

// dq [B, T, H, hd].
BNB_EXPORT int bnb_flash_attention_causal_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                                 const float* m, const float* l, const float* di, void* dq, int B,
                                                 int T, int H, int KVH, int hd, long long sqb, long long sqt,
                                                 long long skb, long long skt, long long svb, long long svt,
                                                 long long sdb, long long sdt, float scale, int kind,
                                                 cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || !wgmma_ok(kind, hd)) return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        if constexpr (sizeof(E) == 4) {
            return (int)cudaErrorInvalidValue;
        } else {
            Params<E> p =
                make_params<E>(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt, scale);
            p.dq = static_cast<E*>(dq);
            return hd == 128 ? launch_dq<128>(p, B, stream) : launch_dq<256>(p, B, stream);
        }
    });
}

BNB_EXPORT int bnb_flash_attention_causal_bwd_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                                                      const float* m, const float* l, const float* di, void* dq,
                                                      int B, int T, int H, int KVH, int hd, long long sqb,
                                                      long long sqt, long long skb, long long skt, long long svb,
                                                      long long svt, long long sdb, long long sdt, float scale,
                                                      int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd)) return (int)cudaErrorInvalidValue;
    return by_kind(kind, [&](auto tag) -> int {
        using E = typename decltype(tag)::type;
        Params<E> p = make_params<E>(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt, scale);
        p.dq = static_cast<E*>(dq);
        return launch_wide(flash_wide_dq_kernel<E>, dim3(H * (hd / WideCfg::kCols), B, T / WideCfg::kTile),
                           WideCfg::kDqBytes, stream, p, hd);
    });
}
