// Causal flash attention of the training path (no cache): the forward, the
// dK/dV and the dQ kernel, T a multiple of 128, in three families: the wgmma
// kernels take bf16 and f16 at head_dim 128, 256, 384 and 512, and the
// forward at every head_dim from 640 too (its streamed instance); three-pass
// TF32 wgmma instances of all three take f32 at head_dim 128 and 256; the
// wide family (at the end of the file) takes f32 from head_dim 384 (any
// multiple of 128), and bf16 and f16 dK/dV and dQ where the wgmma kernels
// stop, from head_dim 640.
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
//   one at hd 256 and up (FwdCfg says why); at hd 384 and 512 the block owns
//   half of o's columns, and the two blocks of a row tile each compute S
//   over all of hd.  One producer thread loads Q once and the K tiles and
//   the block's V slices of the KV head, from key 0 up to the diagonal, with
//   TMA into a two-stage ring of 128-byte-swizzled tiles (full mbarriers,
//   and empty ones for K and V apart; 128 keys a stage at hd 128, 64 at hd
//   256 and 384, 32 at hd 512: 160-192 KB).  A consumer runs S = Q K^T on
//   wgmma with both operands in shared memory, the softmax in registers (the
//   mask only on the tiles that reach the diagonal), and O += P V on wgmma
//   with P from registers (the S accumulators rounded to E are the A
//   fragments) and V as a transposed B.  At hd 128 the diagonal tile's last 64 keys follow
//   every row of the first warpgroup: it computes them masked.
// * dK/dV (sm90.cuh): a block is one item of a work plan built on the host
//   (ops/flash_attention.dkv_plan): 64 keys of one KV head, 128 columns of
//   dK and dV (a slice of hd above 128), and a range of the key tile's
//   iterations over its group's query heads and the 64-row query tiles from
//   the diagonal down.  A producer thread loads K and V once and each
//   iteration's Q and dO tiles with TMA, and the rows' m, l, di by bulk
//   copies, into a ring (four stages at hd 128, two at 256; at 384 and 512
//   one stage of the item's 128 columns, the rest of hd streamed through a
//   ring of 64-column chunks: DkvCfg says why).  One consumer
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
//   hd 128, one from hd 256, and a producer warp (DqCfg says why); at hd 384
//   and 512 the block owns half of dq's columns, and the two blocks of a row
//   tile each compute S and dP over all of hd.  One producer thread loads Q
//   and dO once, and the K and V tiles of the KV head, from key 0 up to the
//   block's last row, with TMA into a two-stage ring of 64-key
//   128-byte-swizzled tiles (at 384 and 512 a stage holds the K tile's slice
//   alone, and K's other chunks and V's stream through a ring of 64-column
//   chunks).  A consumer runs S = Q K^T and dP = dO V^T on wgmma from shared
//   memory, p and ds in registers (the mask only on its diagonal tile; m
//   log2(e), 1 / l and di read once a row), and dQ += dS K on wgmma with dS
//   from registers and K read as a transposed B from the same stage.  dQ
//   stays in f32 registers over the walk, summed in key order (no atomics,
//   no split of a row's keys), and is stored once.
// * dK/dV in f32 at hd 128 and 256 (Tf32DkvCfg says why): the same plan,
//   every product as three TF32 passes (big * big + big * small + small *
//   big) on wgmma; S^T and dP^T by two consumer warpgroups, then dV^T = dO^T
//   P and dK^T = Q^T dS with P and dS through shared memory, since TF32 takes
//   no transposed operand.
// * dQ in f32 at hd 128 and 256 (Tf32DqCfg says why): a block 64 query rows
//   of one head, S and dP by two consumer warpgroups as three TF32 passes,
//   then dQ^T = K^T dS^T with dS through shared memory, each group over half
//   of hd.
// * The forward in f32 at hd 128 and 256 (Tf32FwdCfg says why): a block 64
//   query rows of one head, S = Q K^T and the softmax by one consumer
//   warpgroup as three TF32 passes, then O^T += V^T P^T with P through
//   shared memory by both, each over half of hd.
// * The forward in bf16 and f16 from hd 640 (StreamedCfg says why): a block
//   64 query rows of one head and at most 256 columns of o, S over all of hd
//   from 64-column chunks of K (and of Q, past hd 1024) streamed through a
//   ring, one producer warp.
// * Causal work only: tiles above the diagonal are never loaded (a dQ
//   consumer stops at its own diagonal tile).  Blocks with the most tiles
//   launch first.
// * Fixed order everywhere, so a result is the same from run to run.
#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

// E: the element type of q, k, v, do and the outputs (bf16 or f16 on the
// wgmma kernels; f32 on the TF32 instances; f32, bf16 or f16 on the wide
// family)
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
//
// Above hd 256 all of O would take hd / 2 registers (192 or 256), past
// what a thread holds beside S and P.  So at hd 384 and 512 a block owns a
// column slice of o, half of hd (kCols: 192 or 256 columns, O in 96 or 128
// registers), as the hd 256 block does otherwise: S over all of hd from Q
// and the whole K tile, P V over the V tile's slice.  The two blocks of a
// row tile each compute S, 1.5 times the least work.  Slice 0 writes m and
// l.  Shared memory binds there (227 KB a block): Q and two stages of a K
// tile and a V slice take 48 + 2 (48 + 24) = 192 KB at hd 384 with 64-key
// stages, and 64 + 2 (64 + 32) = 256 KB at hd 512, so hd 512 takes 32-key
// stages (160 KB).  On an H100 a third stage at hd 512 ran no faster,
// 32-key stages at hd 384 36% slower, a tile's S, softmax and P V in series
// 5-8% slower, and two consumer warpgroups that split S's sum over hd
// instead of recomputing it spilled at hd 512 and gained 1-2% at hd 384
// (experiments/ab_flash_fwd_sliced_torch.py; the split variant's source is
// not kept).
template <int HD>
struct FwdCfg {
    static constexpr int kConsumers = HD == 128 ? 2 : 1;
    static constexpr bool kOverlap = kConsumers == 1;
    static constexpr int kRows = 64 * kConsumers;  // query rows of a block
    static constexpr int kThreads = 128 * (1 + kConsumers);
    static constexpr int kCols = HD <= 256 ? HD : HD / 2;  // columns of o a block owns
    static constexpr int kSlices = HD / kCols;             // blocks a row tile
    static constexpr int kKeys = HD == 128 ? 128 : HD == 512 ? 32 : 64;  // keys of a ring stage
    static constexpr int kStages = 2;
    static constexpr int kChunks = HD / 64;  // 64-column chunks of a row (128-byte swizzled tiles)
    static constexpr uint32_t kQBytes = kRows * HD * 2;
    static constexpr uint32_t kKBytes = kKeys * HD * 2;     // a K tile
    static constexpr uint32_t kVBytes = kKeys * kCols * 2;  // the block's slice of a V tile
    // shared memory from a 1024-byte aligned base: Q, the stages' [K | V], the
    // barriers (Q's, then K full, V full, K empty and V empty for each stage)
    static constexpr uint32_t kStage0 = kQBytes;
    static constexpr uint32_t kBars = kStage0 + kStages * (kKBytes + kVBytes);
    static constexpr uint32_t kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;  // + the base's alignment
    static_assert(HD % 128 == 0 && HD <= 512 && kCols <= 256 && kBytes <= 232448, "no wgmma forward at this hd");
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
    auto sK = [&](int st) { return smem + C::kStage0 + st * (C::kKBytes + C::kVBytes); };
    auto sV = [&](int st) { return sK(st) + C::kKBytes; };

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x / C::kSlices, cs = blockIdx.x % C::kSlices, b = blockIdx.y;  // cs: the column slice
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
        // the producer: one thread issues every load; the K tiles, and column
        // slice cs of the V tiles, of KV head h / (H / KVH) from key 0 up to
        // the block's last row
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
                mbar_expect_tx(full_k + st, C::kKBytes);
                for (int c = 0; c < C::kChunks; ++c)
                    tma_load_4d(sK(st) + c * N * 128, &tk, full_k + st, c * 64, kvh, t * N, b);
                if (t >= C::kStages) mbar_wait(empty_v + st, par);
                mbar_expect_tx(full_v + st, C::kVBytes);
                for (int c = 0; c < C::kCols / 64; ++c)
                    tma_load_4d(sV(st) + c * N * 128, &tv, full_v + st, cs * C::kCols + c * 64, kvh, t * N, b);
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
    float o[C::kCols / 2];
#pragma unroll
    for (int i = 0; i < C::kCols / 2; ++i) o[i] = 0.0f;
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
            wgmma_rs_tb<C::kCols, E>(o, pa[kk], gmma_desc_sw128(va + kk * 16 * 128, N * 128, 1024), 1);
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
        for (int i = 0; i < C::kCols / 2; ++i) o[i] *= corr[(i >> 1) & 1];
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
        E* dst = p.o + (((size_t)b * p.T + row[i]) * p.H + h) * HD + cs * C::kCols;
#pragma unroll
        for (int j = 0; j < C::kCols / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
                pack_x2<E>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        if (cs == 0 && t4 == 0) {  // every slice has the same m and l: slice 0 writes them
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
//
// Above hd 256 all of dQ would take hd / 2 registers (192 or 256), past
// what a thread holds beside S, dP and dS.  So at hd 384 and 512 a block
// owns a column slice of dq, half of hd (kCols: 192 or 256 columns, dQ in
// 96 or 128 registers: hd 256's footprint), as the forward's block owns one
// of o: S and dP over all of hd, dQ += dS K over the K tile's slice; the two
// blocks of a row tile each compute S and dP, 5 products where 3 are the
// least work.  Shared memory binds there (227 KB a block): Q and dO stay
// resident (96 / 128 KB), and a whole K and V tile of 64 keys would take as
// much again.  So a ring stage holds only the tile's K in the block's
// columns (24 / 32 KB: the dQ product and S over those columns read it),
// and K's other 64-column chunks and every chunk of V stream through a
// second ring of 8 KB chunk stages, in that order, into S and dP, one
// commit group a chunk, so S and dP stay m64n64 products (kernel 18's
// design above hd 256): two stages and six chunk stages at hd 384 (193 KB),
// one stage and eight chunk stages at hd 512 (225 KB).  On an H100 80GB
// HBM3 at 700 W (B 1, T 2048, H 8, bf16) this ran 0.159 / 0.205 ms at hd
// 384 / 512; four chunk stages 8 / 2% slower, three 25 / 37%, eight at hd
// 384 3%, a third stage at hd 384 even, two stages and four chunk stages at
// hd 512 (the layout written first) 3% slower, and a stage holding the K
// and the V slice, with 16 KB chunks of both outside them, 9-10% slower
// (experiments/ab_flash_dq_sliced_torch.py; 214 / 233 registers, no
// spills, no C75xx).
template <int HD>
struct DqCfg {
    static constexpr int kConsumers = HD == 128 ? 2 : 1;
    static constexpr int kRows = 64 * kConsumers;  // query rows of a block
    static constexpr int kThreads = 128 * kConsumers + 32;
    static constexpr int kKeys = 64;  // keys of a ring stage
    static constexpr int kStages = HD == 512 ? 1 : 2;
    static constexpr int kChunks = HD / 64;  // 64-column chunks of a row (128-byte swizzled tiles)
    static constexpr int kCols = HD <= 256 ? HD : HD / 2;  // columns of dq a block owns
    static constexpr int kSlices = HD / kCols;             // blocks a row tile
    static constexpr int kColChunks = kCols / 64;          // of the chunks, the block's
    static constexpr int kOtherK = kChunks - kColChunks;    // K's chunks outside them
    // chunks a key tile streams through the chunk ring: K's other chunks,
    // then all of V's (none up to hd 256)
    static constexpr int kStream = kSlices > 1 ? kOtherK + kChunks : 0;
    static constexpr int kChunkStages = kStream ? (HD == 384 ? 6 : 8) : 0;
    static constexpr uint32_t kQBytes = kRows * HD * 2;   // Q, and dO
    static constexpr uint32_t kKvBytes = kKeys * HD * 2;  // a K or a V tile
    static constexpr uint32_t kChunkBytes = kKeys * 128;  // a 64-column chunk of a K or V tile
    // a stage: [K | V] tiles, or the K tile's slice
    static constexpr uint32_t kStageBytes = kStream ? kKeys * kCols * 2 : 2 * kKvBytes;
    // shared memory from a 1024-byte aligned base: Q, dO, the stages, the
    // chunk ring, the barriers (Q and dO's, then each stage's full and empty,
    // each chunk stage's full and empty)
    static constexpr uint32_t kStage0 = 2 * kQBytes;
    static constexpr uint32_t kRing0 = kStage0 + kStages * kStageBytes;
    static constexpr uint32_t kBars = kRing0 + kChunkStages * kChunkBytes;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages + 2 * kChunkStages) * 8 + 1024;  // + alignment
    static_assert(HD % 128 == 0 && HD <= 512 && kCols <= 256 && kBytes <= 232448, "no wgmma dQ at this hd");
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
    uint64_t* full_c = empty + C::kStages;
    uint64_t* empty_c = full_c + C::kChunkStages;
    auto sK = [&](int st) { return smem + C::kStage0 + st * C::kStageBytes; };
    auto sV = [&](int st) { return sK(st) + C::kKvBytes; };
    auto sChunk = [&](int sa) { return smem + C::kRing0 + sa * C::kChunkBytes; };  // chunk stage sa

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x / C::kSlices, cs = blockIdx.x % C::kSlices, b = blockIdx.y;  // cs: the column slice
    const int r0 = qi * C::kRows;
    const int wg = threadIdx.x / 128;  // a consumer warpgroup, or kConsumers: the producer warp
    // above hd 256: the first 64-column chunk of the block's columns, and the
    // j-th of K's chunks outside them
    const int c0 = cs * C::kColChunks;
    auto other = [&](int j) { return j < c0 ? j : j + C::kColChunks; };

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 4 * C::kConsumers);  // each consumer warp once
        }
        for (int sa = 0; sa < C::kChunkStages; ++sa) {
            mbar_init(full_c + sa, 1);
            mbar_init(empty_c + sa, 4 * C::kConsumers);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == C::kConsumers) {
        // the producer: one thread loads Q and dO once, then the K and V
        // tiles of KV head h / (H / KVH) from key 0 up to the block's last
        // row: whole into a stage, or above hd 256 K's other chunks into the
        // chunk ring, the K tile's slice into a stage, V's chunks into the
        // chunk ring
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
            if constexpr (C::kStream > 0) {
                auto load_chunk = [&](int a, const CUtensorMap* map, int col, int t) {  // chunk a of the stream
                    const int sa = a % C::kChunkStages;
                    if (a >= C::kChunkStages) mbar_wait(empty_c + sa, ((a / C::kChunkStages) - 1) & 1);
                    mbar_expect_tx(full_c + sa, C::kChunkBytes);
                    tma_load_4d(sChunk(sa), map, full_c + sa, col, kvh, t * N, b);
                };
                for (int t = 0; t < ntiles; ++t) {
                    const int a0 = t * C::kStream;
                    for (int j = 0; j < C::kOtherK; ++j) load_chunk(a0 + j, &tk, other(j) * 64, t);
                    const int st = t % C::kStages;
                    if (t >= C::kStages) mbar_wait(empty + st, ((t / C::kStages) - 1) & 1);
                    mbar_expect_tx(full + st, C::kStageBytes);
                    for (int c = 0; c < C::kColChunks; ++c)
                        tma_load_4d(sK(st) + c * N * 128, &tk, full + st, (c0 + c) * 64, kvh, t * N, b);
                    for (int j = 0; j < C::kChunks; ++j) load_chunk(a0 + C::kOtherK + j, &tv, j * 64, t);
                }
            } else {
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
        }
        return;
    }

    // a consumer warpgroup: 64 query rows.  S = Q K^T and dP = dO V^T with
    // both operands in shared memory, p and ds in registers, then dQ += dS K
    // (over the block's columns) with dS from registers (the dP accumulators
    // rounded to E pairs are the A fragments) and K read as a transposed B
    // from the same stage.
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
    float dq[C::kCols / 2];
#pragma unroll
    for (int i = 0; i < C::kCols / 2; ++i) dq[i] = 0.0f;
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
    // dQ += dS K_t, K_t read MN-major (a transposed B) from the stage's
    // tile, or its slice
    auto issue_dq = [&](int t) {
        const uint32_t ka = opaque(smem_addr(sK(t % C::kStages)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
            wgmma_rs_tb<C::kCols, E>(dq, sa[kk], gmma_desc_sw128(ka + kk * 16 * 128, N * 128, 1024), 1);
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
    if constexpr (C::kStream == 0) {
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
    } else {
        // above hd 256: S over K's chunks outside the block's columns, then
        // over the stage's slice, and dP over V's chunks, one commit group a
        // chunk; a chunk stage goes back once the next group is issued and
        // its own has landed.  Each wait comes before its fence.
        auto release_chunk = [&](int a) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_c + a % C::kChunkStages);  // this warp is done with the chunk stage
        };
        for (int t = 0; t < ntiles; ++t) {
            const int st = t % C::kStages;
            const int a0 = t * C::kStream;
#pragma unroll
            for (int j = 0; j < C::kOtherK; ++j) {
                const int a = a0 + j;
                mbar_wait(full_c + a % C::kChunkStages, (a / C::kChunkStages) & 1);
                const uint32_t qa = opaque(smem_addr(sQ)) + other(j) * C::kRows * 128;
                const uint32_t ka = opaque(smem_addr(sChunk(a % C::kChunkStages)));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<N, E>(s, gmma_desc_sw128(qa + kk * 32, 16, 1024), gmma_desc_sw128(ka + kk * 32, 16, 1024),
                                   j > 0 || kk > 0);
                wgmma_commit();
                if (j > 0) {
                    wgmma_wait<1>();
                    release_chunk(a - 1);
                }
            }
            mbar_wait(full + st, (t / C::kStages) & 1);
            const uint32_t qa = opaque(smem_addr(sQ)) + c0 * C::kRows * 128, ka = opaque(smem_addr(sK(st)));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::kCols / 16; ++kk) {
                const uint32_t off = (kk / 4) * C::kRows * 128 + (kk % 4) * 32;
                const uint32_t koff = (kk / 4) * N * 128 + (kk % 4) * 32;
                wgmma_ss<N, E>(s, gmma_desc_sw128(qa + off, 16, 1024), gmma_desc_sw128(ka + koff, 16, 1024), 1);
            }
            wgmma_commit();
            wgmma_wait<1>();
            release_chunk(a0 + C::kOtherK - 1);
#pragma unroll
            for (int j = 0; j < C::kChunks; ++j) {
                const int a = a0 + C::kOtherK + j;
                mbar_wait(full_c + a % C::kChunkStages, (a / C::kChunkStages) & 1);
                const uint32_t oa = opaque(smem_addr(sDo)) + j * C::kRows * 128;
                const uint32_t va = opaque(smem_addr(sChunk(a % C::kChunkStages)));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<N, E>(dp, gmma_desc_sw128(oa + kk * 32, 16, 1024), gmma_desc_sw128(va + kk * 32, 16, 1024),
                                   j > 0 || kk > 0);
                wgmma_commit();
                if (j > 0) {  // at j 1 S has landed too
                    wgmma_wait<1>();
                    release_chunk(a - 1);
                }
            }
            fence_regs(s);
            probs(t);  // while V's last chunk runs
            wgmma_wait<0>();
            fence_regs(dp);
            release_chunk(a0 + C::kStream - 1);
            dsoft();
            issue_dq(t);
            wgmma_wait<0>();
            dq_landed();
            release(t);
        }
    }

    // dQ in E (the block's columns), summed over the keys in key order,
    // stored once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        E* dst = p.dq + (((size_t)b * p.T + rw + rl[i]) * p.H + h) * HD + cs * C::kCols;
#pragma unroll
        for (int j = 0; j < C::kCols / 8; ++j)
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
// block is one item and one block an SM; above hd 128 an item owns 128
// columns of hd, and the hd / 128 items of a key tile all compute S^T and
// dP^T over all of it (1.5, 2 and 2.5 times the least work at hd 256, 384
// and 512).
//
// Shared memory binds above hd 256 (227 KB a block): K and V stay resident
// (96 KB at hd 384, 128 at 512), and Q and dO for 64 rows over all of hd
// would take as much again.  So there a ring stage holds only the item's
// 128 columns of Q and dO (the dV and dK products read them) and the rows'
// m, l, di, and the other 64-column chunks of Q and dO stream through a
// second ring, 16 KB a chunk stage, into S^T and dP^T first: one stage and
// four chunk stages (194 / 227 KB), so S^T and dP^T stay m64n64 products.
// On an H100 80GB HBM3 at 700 W (B 1, T 2048, H 8, bf16) this ran 0.213 /
// 0.355 ms at hd 384 / 512; three or six chunk stages, or two stages and
// three chunk stages, ran 0-18% slower; a first design that cut each stage
// into sub-tiles of 32 or 16 query rows over all of hd (two stages, S^T and
// dP^T on m64n32 / m64n16) 0.283 / 0.712, and one stage of 64 / 32 rows
// 0.278 / 0.574 (experiments/ab_flash_dkv_sliced_torch.py; the sub-tile
// source is not kept).
template <int HD>
struct DkvCfg {
    static constexpr int kKeys = 64;   // keys of an item: the M of every product
    static constexpr int kRows = 64;   // query rows of a stage: N of S^T and dP^T, K of the dV and dK products
    static constexpr int kCols = 128;  // columns of dK and dV an item owns
    static constexpr int kThreads = 256;
    static constexpr int kChunks = HD / 64;  // 64-column chunks of a row (128-byte swizzled tiles)
    static constexpr int kStageChunks = HD <= 256 ? kChunks : 2;  // of them in a stage: all of hd, or the item's
    static constexpr int kOther = kChunks - kStageChunks;         // the rest, streamed through the chunk ring
    static constexpr int kStages = HD == 128 ? 4 : HD == 256 ? 2 : 1;
    static constexpr int kChunkStages = kOther ? 4 : 0;
    static constexpr uint32_t kKvBytes = kKeys * HD * 2;              // K, or V
    static constexpr uint32_t kQBytes = kRows * kStageChunks * 128;  // a stage's Q, or dO
    static constexpr uint32_t kChunkBytes = kRows * 128;             // a chunk of Q, or of dO
    static constexpr uint32_t kVals = 3 * kRows * 4;                 // a stage's m, l and di
    // shared memory from a 1024-byte aligned base: K, V, the chunk ring's [Q |
    // dO], the stages' [Q | dO | m, l, di] (the next stage on a 1024-byte
    // boundary), the consumer's row values (m log2(e) and 1 / l, two
    // buffers), then the barriers (K and V's, each stage's full and empty,
    // each chunk stage's full and empty)
    static constexpr uint32_t kRing0 = 2 * kKvBytes;
    static constexpr uint32_t kStage0 = kRing0 + kChunkStages * 2 * kChunkBytes;
    static constexpr uint32_t kStageBytes = 2 * kQBytes + (kStages > 1 ? 1024 : kVals);
    static constexpr uint32_t kRowBuf = kStage0 + kStages * kStageBytes;
    static constexpr uint32_t kBars = kRowBuf + 2 * 2 * kRows * 4;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages + 2 * kChunkStages) * 8 + 1024;  // + alignment
    // the epilogue stages [dK | dV][64 keys][kCols + 8] f32 (69,632 bytes)
    // after the loop: over the ring up to hd 256, and from the base above,
    // where K and V (free by then) hold it and the rings may not
    static constexpr uint32_t kEpilogue = HD <= 256 ? kStage0 : 0;
    static_assert(HD % 128 == 0 && HD <= 512 && kVals <= 1024, "no wgmma dK/dV at this hd");
    static_assert(kBytes <= 232448 && kEpilogue + 2 * kKeys * (kCols + 8) * 4 <= kRowBuf, "shared memory");
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
    unsigned char* sV = smem + C::kKvBytes;
    auto sQ = [&](int st) { return smem + C::kStage0 + st * C::kStageBytes; };
    auto sDo = [&](int st) { return sQ(st) + C::kQBytes; };
    auto sVals = [&](int st) { return reinterpret_cast<float*>(sQ(st) + 2 * C::kQBytes); };
    auto sChunk = [&](int sa) { return smem + C::kRing0 + sa * 2 * C::kChunkBytes; };  // [Q | dO] chunk stage sa
    uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full = full_kv + 1;
    uint64_t* empty = full + C::kStages;
    uint64_t* full_c = empty + C::kStages;
    uint64_t* empty_c = full_c + C::kChunkStages;

    const DkvItem it = items[blockIdx.x];  // the plan lists the longest items first
    const int G = p.H / p.KVH;
    const int nq = p.T / C::kRows - it.kj;  // the key tile's query tiles, from the diagonal down
    const int k0 = it.kj * C::kKeys;
    const int niter = it.i1 - it.i0;
    // the first 64-column chunk a stage holds, and the chunk ring's j-th of
    // each iteration: the chunks of hd outside the item's columns, in order
    const int c0 = HD <= 256 ? 0 : 2 * it.half;
    auto other = [&](int j) { return j < c0 ? j : j + 2; };

    if (threadIdx.x == 0) {
        mbar_init(full_kv, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 4);  // each consumer warp once
        }
        for (int sa = 0; sa < C::kChunkStages; ++sa) {
            mbar_init(full_c + sa, 1);
            mbar_init(empty_c + sa, 4);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // the producer: one thread loads K and V once, then each iteration's
        // Q and dO chunks outside the item's columns into the chunk ring, and
        // its stage: Q and dO (all of hd, or the item's columns) and the
        // rows' m, l and di
        if (threadIdx.x == 0) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            tma_prefetch_map(&tdo);
            mbar_expect_tx(full_kv, 2 * C::kKvBytes);
            for (int c = 0; c < C::kChunks; ++c) {
                tma_load_4d(sK + c * C::kKeys * 128, &tk, full_kv, c * 64, it.kvh, k0, it.b);
                tma_load_4d(sV + c * C::kKeys * 128, &tv, full_kv, c * 64, it.kvh, k0, it.b);
            }
            for (int n = 0; n < niter; ++n) {
                const int i = it.i0 + n;
                const int h = it.kvh * G + i / nq;
                const int t0 = (it.kj + i % nq) * C::kRows;
                if constexpr (C::kOther > 0) {
                    for (int j = 0; j < C::kOther; ++j) {
                        const int a = n * C::kOther + j, sa = a % C::kChunkStages;
                        if (a >= C::kChunkStages) mbar_wait(empty_c + sa, ((a / C::kChunkStages) - 1) & 1);
                        mbar_expect_tx(full_c + sa, 2 * C::kChunkBytes);
                        tma_load_4d(sChunk(sa), &tq, full_c + sa, other(j) * 64, h, t0, it.b);
                        tma_load_4d(sChunk(sa) + C::kChunkBytes, &tdo, full_c + sa, other(j) * 64, h, t0, it.b);
                    }
                }
                const int st = n % C::kStages;
                if (n >= C::kStages) mbar_wait(empty + st, ((n / C::kStages) - 1) & 1);
                mbar_expect_tx(full + st, 2 * C::kQBytes + C::kVals);
                for (int c = 0; c < C::kStageChunks; ++c) {
                    tma_load_4d(sQ(st) + c * C::kRows * 128, &tq, full + st, (c0 + c) * 64, h, t0, it.b);
                    tma_load_4d(sDo(st) + c * C::kRows * 128, &tdo, full + st, (c0 + c) * 64, h, t0, it.b);
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
    // the item's two 64-column chunks of Q and dO in a stage, and the K and
    // V chunks a stage's columns meet
    const uint32_t half_off = (HD <= 256 ? it.half : 0) * 2 * C::kRows * 128;
    const uint32_t kv_off = c0 * C::kKeys * 128;
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
    auto release_chunk = [&](auto a) {  // a generic lambda: compiled only where a chunk ring exists
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_c + a % C::kChunkStages);  // this warp is done with the chunk stage
    };

    mbar_wait(full_kv, 0);
    for (int n = 0; n < niter; ++n) {
        const int st = n % C::kStages;
        const bool diag = (it.i0 + n) % nq == 0;  // this query tile is the key tile's diagonal one
        // S^T and dP^T over the chunks of the chunk ring, one commit group a
        // chunk; a chunk's stage goes back once the next chunk's group is
        // issued and its own has landed
        if constexpr (C::kOther > 0) {
#pragma unroll
            for (int j = 0; j < C::kOther; ++j) {
                const int a = n * C::kOther + j;
                mbar_wait(full_c + a % C::kChunkStages, (a / C::kChunkStages) & 1);
                const uint32_t ka = opaque(smem_addr(sK)), va = opaque(smem_addr(sV));
                const uint32_t qa = opaque(smem_addr(sChunk(a % C::kChunkStages))), oa = qa + C::kChunkBytes;
                const uint32_t c_off = other(j) * C::kKeys * 128;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<C::kRows, E>(s, gmma_desc_sw128(ka + c_off + kk * 32, 16, 1024),
                                          gmma_desc_sw128(qa + kk * 32, 16, 1024), j > 0 || kk > 0);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<C::kRows, E>(dp, gmma_desc_sw128(va + c_off + kk * 32, 16, 1024),
                                          gmma_desc_sw128(oa + kk * 32, 16, 1024), j > 0 || kk > 0);
                wgmma_commit();
                if (j > 0) {
                    wgmma_wait<1>();
                    release_chunk(a - 1);
                }
            }
        }
        mbar_wait(full + st, (n / C::kStages) & 1);
        const uint32_t ka = opaque(smem_addr(sK)), va = opaque(smem_addr(sV));
        const uint32_t qa = opaque(smem_addr(sQ(st))), oa = opaque(smem_addr(sDo(st)));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kStageChunks * 4; ++kk) {
            const uint32_t off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
            wgmma_ss<C::kRows, E>(s, gmma_desc_sw128(ka + kv_off + off, 16, 1024), gmma_desc_sw128(qa + off, 16, 1024),
                                  C::kOther > 0 || kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < C::kStageChunks * 4; ++kk) {
            const uint32_t off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
            wgmma_ss<C::kRows, E>(dp, gmma_desc_sw128(va + kv_off + off, 16, 1024),
                                  gmma_desc_sw128(oa + off, 16, 1024), C::kOther > 0 || kk > 0);
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
        if constexpr (C::kOther > 0) release_chunk(n * C::kOther + C::kOther - 1);
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

    // the epilogue through shared memory (free now: DkvCfg::kEpilogue), so that the
    // stores are whole rows of 16 bytes a thread: E into dk and dv, or f32
    // into the item's partial slot
    constexpr int kOut = C::kCols + 8;  // f32 a staged row, padded against bank conflicts
    float* out = reinterpret_cast<float*>(smem + C::kEpilogue);  // [dK | dV][64 keys][kOut]
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
// dK/dV in f32 at head_dim 128 and 256: three-pass TF32 wgmma, TMA, two
// consumer warpgroups and a producer warp, the same work plan and combine
// ---------------------------------------------------------------------------

// f32 must keep the JAX package's "highest" precision (FLASH_TOLERANCES'
// 1e-4 of a gradient's largest magnitude), and one TF32 pass keeps about
// three digits.  So every product runs as three TF32 passes, big * big +
// big * small + small * big with f32 accumulation, x = big + small split by
// tf32_split (big and small each rounded to TF32: about 2^-21 of the
// product): 3 x 2 T^2 hd H flops over the causal half at 495 TFLOP/s, 0.417
// ms at B 1, T 2048, H 32 over 8, hd 128 on an H100, against 1.03 ms for
// the same flops at the 67 TFLOP/s of f32 FMA.
//
// TF32 wgmma reads both operands K-major, and a 16-bit dV += P^T dO reads dO
// as a transposed B, which TF32 does not take.  So the products are S^T = K
// Q^T and dP^T = V dO^T (M the item's 64 keys, N 64 query rows, K hd: Q and
// dO K-major as TMA lands them), then dV^T = dO^T P and dK^T = Q^T dS (M
// hd, N keys, K the query rows): P and dS go to shared memory as [key][row]
// tiles, K-major for that product, and dO^T and Q^T are A fragments loaded
// from the raw tiles into registers and split there.  K and V, the A of S^T
// and dP^T, stay raw too and are split as they are loaded; only B operands
// need their small half in shared memory.
//
// Registers and shared memory set the shape.  dK^T and dV^T over 128 columns
// take 128 registers a thread of one warpgroup, S^T and dP^T 64 more, and a
// split A fragment 8 a k step: past 255.  So a block is two consumer
// warpgroups and a producer warp (288 threads, which ptxas on CUDA 12.9
// gives 168 registers, as three warpgroups): group 0 runs S^T, turns it into
// P and runs dV^T, group 1 runs dP^T, turns it into dS (with p read back
// from the P tile) and runs dK^T, so group 0 goes on to the next S^T while
// group 1 runs dK^T.  A group holds its 128 columns of dV^T or dK^T (64
// registers), S^T or dP^T (32; then the dV^T or dK^T product's wgmma
// accumulator) and two sets of a k step's split A (16).  Shared memory holds K and V raw
// (64 / 128 KB at hd 128 / 256), one [key][row] tile pair of P or dS, big
// and small (32 KB; dS overwrites P once group 0's dV product is done), and
// a ring of 32 KB stages: an iteration passes hd / 32 stages of a 32-column
// chunk of Q and of dO (each group splits its own tile in place, big, and
// beside it, small: the B of S^T or dP^T), then one of dO's and one of Q's
// item columns, raw (the A of the dV and dK products).  Four stages at hd
// 128, two at 256; m, l and di ride two 768-byte slots of their own.
template <int HD>
struct Tf32DkvCfg {
    static constexpr int kKeys = 64;    // keys of an item: M of S^T and dP^T, N of dV^T and dK^T
    static constexpr int kRows = 64;    // query rows of an iteration
    static constexpr int kCols = 128;   // columns of dK and dV an item owns (64 a consumer group)
    static constexpr int kThreads = 288;
    static constexpr int kChunks = HD / 32;     // 32-column f32 chunks of a row: 128-byte swizzled tiles
    static constexpr int kUses = kChunks + 2;   // ring stages an iteration: the chunks, then dO's and Q's item columns
    static constexpr int kStages = HD == 128 ? 4 : 2;
    static constexpr uint32_t kTile = 64 * 128;        // a 64-row tile of one chunk (8 KB)
    static constexpr uint32_t kKvBytes = kKeys * HD * 4;
    static constexpr uint32_t kStageBytes = 4 * kTile;  // [Q big | Q small | dO big | dO small], or 4 raw tiles
    static constexpr uint32_t kVals = 3 * kRows * 4;    // an iteration's m, l and di
    // shared memory from a 1024-byte aligned base: K, V, the P / dS tiles
    // ([big | small][row tile][64 keys][32 rows]), the ring, two slots of m,
    // l and di, the barriers (K and V's, each stage's full and empty, each
    // slot's full and empty)
    static constexpr uint32_t kP0 = 2 * kKvBytes;
    static constexpr uint32_t kRing0 = kP0 + 4 * kTile;
    static constexpr uint32_t kVals0 = kRing0 + kStages * kStageBytes;
    static constexpr uint32_t kBars = kVals0 + 2 * kVals;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages + 2 * 2) * 8 + 1024;  // + alignment
    // the epilogue stages [dK | dV][64 keys][kCols + 8] f32 (69,632 bytes)
    // from the base, over K, V and P, free by then
    static_assert((HD == 128 || HD == 256) && kVals % 16 == 0, "no TF32 dK/dV at this hd");
    static_assert(kBytes <= 232448 && 2 * kKeys * (kCols + 8) * 4 <= kRing0, "shared memory");
};

// The byte offset of f32 element (row, col) of a 128-byte-swizzled tile of
// 32-column rows (row r's 16-byte chunks XOR-ed with r % 8).
__device__ __forceinline__ uint32_t sw128_f32(int row, int col) {
    return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

// Thread t of a group splits a 64 x 32 f32 tile at `tile` in place (big)
// and writes the small halves one tile further (the same swizzle).
__device__ __forceinline__ void split_tile(unsigned char* tile, int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float4* b = reinterpret_cast<float4*>(tile) + t + 128 * j;
        const float4 x = *b;
        uint4 hi, lo;
        tf32_split(x.x, hi.x, lo.x);
        tf32_split(x.y, hi.y, lo.y);
        tf32_split(x.z, hi.z, lo.z);
        tf32_split(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(b) = hi;
        *reinterpret_cast<uint4*>(tile + 64 * 128 + (t + 128 * j) * 16) = lo;
    }
}

// Four f32 values of a raw tile at `tile` (offsets o0..o3) as the big and
// small TF32 halves of an A fragment: a[0..3] big, a[4..7] small.
__device__ __forceinline__ void load_split4(uint32_t* a, const unsigned char* tile, uint32_t o0, uint32_t o1,
                                            uint32_t o2, uint32_t o3) {
    const uint32_t o[4] = {o0, o1, o2, o3};
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(*reinterpret_cast<const float*>(tile + o[i]), a[i], a[4 + i]);
}

// The three passes of one k step into d: big * big (overwriting d where
// first), big * small, small * big; `a` as load_split4's, db_big and
// db_small the B tile's halves.
__device__ __forceinline__ void tf32x3(float (&d)[32], const uint32_t* a, uint64_t db_big, uint64_t db_small,
                                       int scale_d) {
    wgmma_rs_tf32_n64(d, a[0], a[1], a[2], a[3], db_big, scale_d);
    wgmma_rs_tf32_n64(d, a[0], a[1], a[2], a[3], db_small, 1);
    wgmma_rs_tf32_n64(d, a[4], a[5], a[6], a[7], db_big, 1);
}

template <int HD>
__global__ void __launch_bounds__(Tf32DkvCfg<HD>::kThreads, 1)
    flash_tf32_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const DkvItem* __restrict__ items, float* __restrict__ part_k, float* __restrict__ part_v,
                          const Params<float> p) {
    using C = Tf32DkvCfg<HD>;
    constexpr float kLog2e = 1.44269504088896341f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    unsigned char* sK = smem;
    unsigned char* sV = smem + C::kKvBytes;
    unsigned char* sP = smem + C::kP0;
    auto stage = [&](int st) { return smem + C::kRing0 + st * C::kStageBytes; };
    auto vals_of = [&](int n) { return reinterpret_cast<float*>(smem + C::kVals0 + (n & 1) * C::kVals); };
    uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full = full_kv + 1;
    uint64_t* empty = full + C::kStages;
    uint64_t* full_v = empty + C::kStages;
    uint64_t* empty_v = full_v + 2;

    const DkvItem it = items[blockIdx.x];  // the plan lists the longest items first
    const int G = p.H / p.KVH;
    const int nq = p.T / C::kRows - it.kj;  // the key tile's query tiles, from the diagonal down
    const int k0 = it.kj * C::kKeys;
    const int niter = it.i1 - it.i0;
    const int c0 = it.half * (C::kCols / 32);  // the item's first 32-column chunk

    if (threadIdx.x == 0) {
        mbar_init(full_kv, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 8);  // each consumer warp once
        }
        for (int s = 0; s < 2; ++s) {
            mbar_init(full_v + s, 1);
            mbar_init(empty_v + s, 8);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 256) {
        // the producer warp: one thread loads K and V once, then each
        // iteration's m, l, di, its chunks of Q and dO, and the item's
        // columns of dO and of Q
        if (threadIdx.x == 256) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            tma_prefetch_map(&tdo);
            mbar_expect_tx(full_kv, 2 * C::kKvBytes);
            for (int c = 0; c < C::kChunks; ++c) {
                tma_load_4d(sK + c * C::kTile, &tk, full_kv, c * 32, it.kvh, k0, it.b);
                tma_load_4d(sV + c * C::kTile, &tv, full_kv, c * 32, it.kvh, k0, it.b);
            }
            int a = 0;
            for (int n = 0; n < niter; ++n) {
                const int i = it.i0 + n;
                const int h = it.kvh * G + i / nq;
                const int t0 = (it.kj + i % nq) * C::kRows;
                if (n >= 2) mbar_wait(empty_v + (n & 1), ((n >> 1) - 1) & 1);
                mbar_expect_tx(full_v + (n & 1), C::kVals);
                const size_t row = ((size_t)it.b * p.H + h) * p.T + t0;
                float* vals = vals_of(n);
                bulk_load(vals, p.m + row, C::kRows * 4, full_v + (n & 1));
                bulk_load(vals + C::kRows, p.l + row, C::kRows * 4, full_v + (n & 1));
                bulk_load(vals + 2 * C::kRows, p.di + row, C::kRows * 4, full_v + (n & 1));
                for (int u = 0; u < C::kUses; ++u, ++a) {
                    const int st = a % C::kStages;
                    if (a >= C::kStages) mbar_wait(empty + st, ((a / C::kStages) - 1) & 1);
                    unsigned char* s = stage(st);
                    if (u < C::kChunks) {  // chunk u of Q and of dO, each into its big tile
                        mbar_expect_tx(full + st, 2 * C::kTile);
                        tma_load_4d(s, &tq, full + st, u * 32, h, t0, it.b);
                        tma_load_4d(s + 2 * C::kTile, &tdo, full + st, u * 32, h, t0, it.b);
                    } else {  // the item's four chunks of dO, then of Q
                        const CUtensorMap* map = u == C::kChunks ? &tdo : &tq;
                        mbar_expect_tx(full + st, 4 * C::kTile);
                        for (int j = 0; j < 4; ++j) tma_load_4d(s + j * C::kTile, map, full + st, (c0 + j) * 32, h, t0, it.b);
                    }
                }
            }
        }
        return;
    }

    // the consumer groups: r 0 runs S^T = K Q^T, P, and dV^T += dO^T P; r 1
    // dP^T = V dO^T, dS, and dK^T += Q^T dS, with the same code on their own
    // tiles.  Group 0 goes on to the next S^T while group 1 runs dK^T.
    const int r = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int kr[2] = {16 * warp + gq, 16 * warp + gq + 8};  // the thread's accumulator rows of S^T / dP^T: keys
    const float sl2 = p.scale * kLog2e;  // exp(scale x - m) = 2^(sl2 x - m log2(e))
    const unsigned char* sA = r ? sV : sK;  // this group's A of S^T or dP^T
    // dV^T (group 0) or dK^T (group 1), two 64-column m tiles, summed in f32
    // round-to-nearest: each iteration's product goes to a wgmma accumulator
    // first (acc, free once S^T or dP^T became P or dS), since the tensor
    // cores' f32 sums truncate and one chain over every iteration of an item
    // drifted 7e-5 of the largest gradient at T 2048 on an H100
    float dacc[2][32], acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dacc[0][i] = dacc[1][i] = acc[i] = 0.0f;
    uint32_t fa[2][8];  // split A of a k step (big 0..3, small 4..7), two sets in flight
    auto release = [&](int a, int count) {
        __syncwarp();
        if (lane == 0) mbar_arrive_cnt(empty + a % C::kStages, count);  // this warp is done with the stage
    };
    // P (or dS) as big and small [key][row] tiles: the thread's values of
    // accumulator step j, rows kr[i]
    auto p_off = [&](int j, int i) { return (j >> 2) * C::kTile + sw128_f32(kr[i], 8 * (j & 3) + 2 * t4); };
    auto store_split = [&](const float (&x)[32]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                uint2 hi, lo;
                tf32_split(x[4 * j + 2 * i], hi.x, lo.x);
                tf32_split(x[4 * j + 2 * i + 1], hi.y, lo.y);
                *reinterpret_cast<uint2*>(sP + p_off(j, i)) = hi;
                *reinterpret_cast<uint2*>(sP + 2 * C::kTile + p_off(j, i)) = lo;
            }
    };

    mbar_wait(full_kv, 0);
    int a = 0;
    for (int n = 0; n < niter; ++n) {
        const bool diag = (it.i0 + n) % nq == 0;  // this query tile is the key tile's diagonal one
        // S^T (or dP^T) over the chunks, a commit group a k step; a chunk's
        // stage goes back once the group after its last has been issued and
        // its own have landed
        // (rolled: unrolled, the hoisted addresses of hd 256's eight chunks
        // spilled at ptxas's 168 registers)
#pragma unroll 1
        for (int c = 0; c < C::kChunks; ++c) {
            const int st = (a + c) % C::kStages;
            mbar_wait(full + st, ((a + c) / C::kStages) & 1);
            unsigned char* tb = stage(st) + r * 2 * C::kTile;  // Q's tile, or dO's
            split_tile(tb, t);
            fence_proxy_async();
            named_barrier_sync(1 + r, 128);
            const unsigned char* ta = sA + c * C::kTile;
            const uint32_t ba = opaque(smem_addr(tb));
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {  // A set kk % 2
                load_split4(fa[kk & 1], ta, sw128_f32(kr[0], 8 * kk + t4), sw128_f32(kr[1], 8 * kk + t4),
                            sw128_f32(kr[0], 8 * kk + t4 + 4), sw128_f32(kr[1], 8 * kk + t4 + 4));
                wgmma_fence();
                tf32x3(acc, fa[kk & 1], gmma_desc_sw128(ba + kk * 32, 16, 1024),
                       gmma_desc_sw128(ba + C::kTile + kk * 32, 16, 1024), c > 0 || kk > 0);
                wgmma_commit();
                wgmma_wait<1>();  // the group before this one has landed (none before the first)
                fence_regs(fa[(kk & 1) ^ 1]);
                if (kk == 0 && c > 0) release(a + c - 1, 1);  // chunk c - 1's last group
            }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(fa[1]);
        release(a + C::kChunks - 1, 1);

        float* vals = vals_of(n);
        mbar_wait(full_v + (n & 1), (n >> 1) & 1);
        if (r == 0) {
            // m log2(e) and 1 / l of the iteration's rows, in place, once a row
            const float x = vals[t];
            vals[t] = t < C::kRows ? x * kLog2e : rcp(x);
            named_barrier_sync(1, 128);
            // p = 2^(sl2 s - m log2(e)) * (1 / l): one FMA, ex2 and a product;
            // 0 where the key follows the row (the diagonal tile only)
            const float2* m2 = reinterpret_cast<const float2*>(vals);
            const float2* li = reinterpret_cast<const float2*>(vals + C::kRows);
            const int past = diag ? 0 : C::kKeys;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float2 mm = m2[4 * j + t4], ll = li[4 * j + t4];  // rows 8 j + 2 t4 and 8 j + 2 t4 + 1
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float pr = ex2(fmaf(acc[4 * j + e], sl2, -((e & 1) ? mm.y : mm.x))) * ((e & 1) ? ll.y : ll.x);
                    acc[4 * j + e] = kr[e >> 1] > 8 * j + 2 * t4 + (e & 1) + past ? 0.0f : pr;
                }
            }
            if (n > 0) named_barrier_sync(7, 256);  // group 1's last dK^T product is done with dS
            store_split(acc);
            fence_proxy_async();
            named_barrier_sync(1, 128);  // all of P is in place for this group's wgmma
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_v + (n & 1));
            named_barrier_arrive(3, 256);  // and for group 1
        } else {
            // ds = (dp - di) p scale, p as P's big + small (within 2^-21 of it)
            named_barrier_sync(3, 256);
            const float2* dd = reinterpret_cast<const float2*>(vals + 2 * C::kRows);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float2 d = dd[4 * j + t4];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float2 hi = *reinterpret_cast<const float2*>(sP + p_off(j, i));
                    const float2 lo = *reinterpret_cast<const float2*>(sP + 2 * C::kTile + p_off(j, i));
                    acc[4 * j + 2 * i] = (acc[4 * j + 2 * i] - d.x) * (hi.x + lo.x) * p.scale;
                    acc[4 * j + 2 * i + 1] = (acc[4 * j + 2 * i + 1] - d.y) * (hi.y + lo.y) * p.scale;
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_v + (n & 1));
            named_barrier_sync(4, 256);  // group 0's dV^T product is done with P
            store_split(acc);
            fence_proxy_async();
            named_barrier_sync(2, 128);  // all of dS is in place for this group's wgmma
        }

        // dV^T += dO^T P (group 0, the stage of dO's item columns) or dK^T +=
        // Q^T dS (group 1, Q's): A split from the stage's raw tiles as it is
        // loaded, a commit group a k step, each m tile into acc first
        const int u = a + C::kChunks + r;
        mbar_wait(full + u % C::kStages, (u / C::kStages) & 1);
        const uint32_t pa = opaque(smem_addr(sP));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            // rows 64 mt + 16 warp + gq (+ 8) of the product: tile 2 mt + warp / 2
            const unsigned char* raw = stage(u % C::kStages) + (2 * mt + warp / 2) * C::kTile;
            const int mcol = 16 * (warp & 1) + gq;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {  // A set kk % 2
                load_split4(fa[kk & 1], raw, sw128_f32(8 * kk + t4, mcol), sw128_f32(8 * kk + t4, mcol + 8),
                            sw128_f32(8 * kk + t4 + 4, mcol), sw128_f32(8 * kk + t4 + 4, mcol + 8));
                wgmma_fence();
                const uint32_t b = pa + (kk >> 2) * C::kTile + (kk & 3) * 32;
                tf32x3(acc, fa[kk & 1], gmma_desc_sw128(b, 16, 1024), gmma_desc_sw128(b + 2 * C::kTile, 16, 1024),
                       kk > 0);
                wgmma_commit();
                if (kk > 0) {
                    wgmma_wait<1>();
                    fence_regs(fa[(kk & 1) ^ 1]);
                }
            }
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(fa[1]);
#pragma unroll
            for (int i = 0; i < 32; ++i) dacc[mt][i] += acc[i];
        }
        release(u, 2);  // the stage is this group's alone: each of its warps counts twice
        if (r == 0)
            named_barrier_arrive(4, 256);  // P may take dS
        else if (n + 1 < niter)
            named_barrier_arrive(7, 256);  // the tile may take the next P
        a += C::kUses;
    }

    // the epilogue through shared memory (K, V and P are free now), so that
    // the stores are whole rows of 16 bytes a thread: f32 into dk and dv, or
    // into the item's partial slot
    constexpr int kOut = C::kCols + 8;  // f32 a staged row, padded against bank conflicts
    float* out = reinterpret_cast<float*>(smem);  // [dK | dV][64 keys][kOut]
    named_barrier_sync(6, 256);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = 8 * j + 2 * t4 + (e & 1), col = 64 * mt + 16 * warp + gq + 8 * (e >> 1);
                out[((1 - r) * C::kKeys + key) * kOut + col] = dacc[mt][4 * j + e];  // group 0 holds dV
            }
    named_barrier_sync(6, 256);
    const int tid = threadIdx.x;
    if (it.slot < 0) {
        for (int u = tid; u < 2 * C::kKeys * C::kCols / 4; u += 256) {
            const int w = u / (C::kKeys * C::kCols / 4);  // 0: dK, 1: dV
            const int rr = (u / (C::kCols / 4)) % C::kKeys, c = (u % (C::kCols / 4)) * 4;
            float* dst = (w ? p.dv : p.dk) + (((size_t)it.b * p.T + k0 + rr) * p.KVH + it.kvh) * HD + it.half * C::kCols + c;
            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(out + (w * C::kKeys + rr) * kOut + c);
        }
    } else {  // a piece of a split key tile: f32 partials, added by the combine
        for (int u = tid; u < 2 * C::kKeys * C::kCols / 4; u += 256) {
            const int w = u / (C::kKeys * C::kCols / 4);
            const int rr = (u / (C::kCols / 4)) % C::kKeys, c = (u % (C::kCols / 4)) * 4;
            float* dst = (w ? part_v : part_k) + ((size_t)it.slot * C::kKeys + rr) * C::kCols + c;
            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(out + (w * C::kKeys + rr) * kOut + c);
        }
    }
}

// ---------------------------------------------------------------------------
// dQ in f32 at head_dim 128 and 256: three-pass TF32 wgmma, TMA, two consumer
// warpgroups and a producer warp
// ---------------------------------------------------------------------------

// The products run as the TF32 dK/dV's do (Tf32DkvCfg): three TF32 passes
// each, 3 x 2 T^2 hd H flops over the causal half at 495 TFLOP/s, 0.3125 ms
// at B 1, T 2048, H 32 over 8, hd 128 on an H100, against 0.77 ms for the
// same flops at the 67 TFLOP/s of f32 FMA.
//
// TF32 wgmma reads both operands K-major, and the 16-bit dQ += dS K reads K
// as a transposed B.  So a block runs S = Q K^T and dP = dO V^T (M its 64
// query rows, N the tile's 64 keys, K hd: K and V K-major as TMA lands them,
// split in place in the ring stage by the group that reads them), then dQ^T
// = K^T dS^T (M hd in 64-row m tiles, N the 64 rows, K the keys): dS goes to
// shared memory as a [row][key] tile pair, big and small, K-major for that
// product, and K^T is an A fragment loaded from the tile's raw columns, read
// once more through the ring, and split in registers.  Q and dO, the A of S
// and dP, stay raw and resident and are split as they are loaded.
//
// Registers set the shape: dQ over 64 rows x hd in f32 takes hd / 2
// registers a thread of one warpgroup, beside S, dP, a fresh accumulator and
// the split A fragments: past the 168 ptxas gives a 288-thread block.  So a
// block is two consumer warpgroups and a producer warp, as the TF32 dK/dV's:
// group 0 runs S and turns it into P, which it leaves in the dS tile; group 1
// runs dP and turns it into dS (reading p back from the tile); then each
// group runs dQ^T over its half of hd's m tiles (32 / 64 registers at hd 128
// / 256).  m log2(e), 1 / l and di belong to the block's rows: each thread
// reads its two rows' once.  Each key tile's dQ^T product lands in a fresh
// wgmma accumulator and is added in f32 (the tensor cores' f32 sums
// truncate: Tf32DkvCfg), so dQ is summed in key order and stored once.
//
// Shared memory: Q and dO raw (64 / 128 KB at hd 128 / 256), the dS tile
// pair (32 KB: [big | small][key chunk][64 rows][32 keys]) and a ring of 32
// KB stages: a key tile passes hd / 32 stages of a 32-column chunk of K and
// of V (each split in place: big, and beside it, small), then hd / 128 of
// K's raw columns (the A of dQ^T: at hd 128 one stage both groups read, at
// 256 one a group).  Four stages at hd 128, two at 256: 224 KB either way.
// On an H100 80GB HBM3 at 700 W (B 1, T 2048, H 32 over 8 at hd 128, H 16
// over 16 at hd 256) this ran 0.752-0.755 / 0.778-0.789 ms against the wide
// dQ's 1.82-1.86 / 3.19; three stages at hd 128 1-2% slower, big rounded by
// cvt.rna 15% / 11% slower, and the S loop's 16 A offsets held over the walk
// spilled at hd 256 (experiments/ab_flash_dq_tf32_torch.py; 158 / 168
// registers, no spills, no C75xx).
template <int HD>
struct Tf32DqCfg {
    static constexpr int kRows = 64;   // query rows of a block: M of S and dP, N of dQ^T
    static constexpr int kKeys = 64;   // keys of a tile: N of S and dP, K of dQ^T
    static constexpr int kThreads = 288;
    static constexpr int kChunks = HD / 32;     // 32-column f32 chunks of a row: 128-byte swizzled tiles
    static constexpr int kKStages = HD / 128;   // stages of K's raw columns a key tile, 128 columns each
    static constexpr int kUses = kChunks + kKStages;  // ring stages a key tile
    static constexpr int kMt = HD / 128;        // 64-row m tiles of dQ^T a group owns
    static constexpr int kStages = HD == 128 ? 4 : 2;
    static constexpr uint32_t kTile = 64 * 128;          // a 64-row tile of one chunk (8 KB)
    static constexpr uint32_t kQBytes = kRows * HD * 4;  // Q, and dO
    static constexpr uint32_t kStageBytes = 4 * kTile;   // [K big | K small | V big | V small], or 4 raw tiles of K
    // shared memory from a 1024-byte aligned base: Q, dO, the dS tiles, the
    // ring, the barriers (Q and dO's, each stage's full and empty)
    static constexpr uint32_t kDs0 = 2 * kQBytes;
    static constexpr uint32_t kRing0 = kDs0 + 4 * kTile;
    static constexpr uint32_t kBars = kRing0 + kStages * kStageBytes;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;  // + alignment
    static_assert((HD == 128 || HD == 256) && kBytes <= 232448, "no TF32 dQ at this hd");
};

template <int HD>
__global__ void __launch_bounds__(Tf32DqCfg<HD>::kThreads, 1)
    flash_tf32_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         const Params<float> p) {
    using C = Tf32DqCfg<HD>;
    constexpr float kLog2e = 1.44269504088896341f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    unsigned char* sQ = smem;
    unsigned char* sDo = smem + C::kQBytes;
    unsigned char* sDs = smem + C::kDs0;
    auto stage = [&](int st) { return smem + C::kRing0 + st * C::kStageBytes; };
    uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full = full_q + 1;
    uint64_t* empty = full + C::kStages;

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = qi * C::kRows;
    const int ntiles = qi + 1;  // the key tiles up to the diagonal one

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 8);  // each consumer warp once
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 256) {
        // the producer warp: one thread loads Q and dO once, then for each
        // key tile of KV head h / (H / KVH) its chunks of K and of V, and
        // K's raw columns
        if (threadIdx.x == 256) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            tma_prefetch_map(&tdo);
            const int kvh = h / (p.H / p.KVH);
            mbar_expect_tx(full_q, 2 * C::kQBytes);
            for (int c = 0; c < C::kChunks; ++c) {
                tma_load_4d(sQ + c * C::kTile, &tq, full_q, c * 32, h, r0, b);
                tma_load_4d(sDo + c * C::kTile, &tdo, full_q, c * 32, h, r0, b);
            }
            int a = 0;
            for (int t = 0; t < ntiles; ++t) {
                for (int u = 0; u < C::kUses; ++u, ++a) {
                    const int st = a % C::kStages;
                    if (a >= C::kStages) mbar_wait(empty + st, ((a / C::kStages) - 1) & 1);
                    unsigned char* s = stage(st);
                    if (u < C::kChunks) {  // chunk u of K and of V, each into its big tile
                        mbar_expect_tx(full + st, 2 * C::kTile);
                        tma_load_4d(s, &tk, full + st, u * 32, kvh, t * C::kKeys, b);
                        tma_load_4d(s + 2 * C::kTile, &tv, full + st, u * 32, kvh, t * C::kKeys, b);
                    } else {  // four raw chunks of K: columns 128 (u - kChunks)..
                        const int c0 = 4 * (u - C::kChunks);
                        mbar_expect_tx(full + st, 4 * C::kTile);
                        for (int j = 0; j < 4; ++j)
                            tma_load_4d(s + j * C::kTile, &tk, full + st, (c0 + j) * 32, kvh, t * C::kKeys, b);
                    }
                }
            }
        }
        return;
    }

    // the consumer groups: r 0 runs S = Q K^T and P, r 1 dP = dO V^T and dS,
    // with the same code on their own tiles; then each runs dQ^T += K^T dS^T
    // over its m tiles
    const int r = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int rl[2] = {16 * warp + gq, 16 * warp + gq + 8};  // the thread's accumulator rows of S / dP: query rows
    const float sl2 = p.scale * kLog2e;  // exp(scale x - m) = 2^(sl2 x - m log2(e))
    // group 0: m log2(e) and 1 / l of its rows; group 1: di
    float rv[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const size_t ml = ((size_t)b * p.H + h) * p.T + r0 + rl[i];
        if (r == 0) {
            rv[0][i] = p.m[ml] * kLog2e;
            rv[1][i] = 1.0f / p.l[ml];
        } else {
            rv[0][i] = p.di[ml];
            rv[1][i] = 0.0f;
        }
    }
    const unsigned char* sA = r ? sDo : sQ;  // this group's A of S or dP
    // dQ^T, this group's m tiles (m tile r kMt + mt: hd columns 64 (r kMt +
    // mt)..), summed in f32 round-to-nearest: each key tile's product goes
    // to a wgmma accumulator first (acc, free once S or dP became P or dS)
    float dacc[C::kMt][32], acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        acc[i] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < C::kMt; ++mt) dacc[mt][i] = 0.0f;
    }
    uint32_t fa[2][8];  // split A of a k step (big 0..3, small 4..7), two sets in flight
    auto release = [&](int a, int count) {
        __syncwarp();
        if (lane == 0) mbar_arrive_cnt(empty + a % C::kStages, count);  // this warp is done with the stage
    };
    // P, then dS, in the [row][key] tiles: the thread's values of accumulator
    // step j, rows rl[i]
    auto ds_off = [&](int j, int i) { return (j >> 2) * C::kTile + sw128_f32(rl[i], 8 * (j & 3) + 2 * t4); };

    // the A fragments of S and dP: (row rl[i], column 8 kk + t4 (+ 4)) of a
    // chunk is sw128_f32's rl[i] 128 + 4 t4 + (((2 kk (+ 1)) ^ gq) << 4), as
    // rl[i] % 8 = gq; the swizzle term is rebuilt in each chunk (opaque), not
    // held as 16 offsets over the walk
    const uint32_t arow = rl[0] * 128 + 4 * t4;
    mbar_wait(full_q, 0);
    int a = 0;
    for (int kt = 0; kt < ntiles; ++kt) {
        // S (or dP) over the chunks, a commit group a k step; a chunk's stage
        // goes back once the group after its last has been issued and its own
        // have landed (rolled, as the TF32 dK/dV's)
#pragma unroll 1
        for (int c = 0; c < C::kChunks; ++c) {
            const int st = (a + c) % C::kStages;
            mbar_wait(full + st, ((a + c) / C::kStages) & 1);
            unsigned char* tb = stage(st) + r * 2 * C::kTile;  // K's tile, or V's
            split_tile(tb, t);
            fence_proxy_async();
            named_barrier_sync(1 + r, 128);
            const unsigned char* ta = sA + c * C::kTile + arow;
            const uint32_t ba = opaque(smem_addr(tb));
            const uint32_t sw = opaque((uint32_t)gq << 4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {  // A set kk % 2
                const uint32_t x0 = sw ^ (kk << 5), x1 = x0 ^ 16;
                load_split4(fa[kk & 1], ta, x0, x0 + 1024, x1, x1 + 1024);
                wgmma_fence();
                tf32x3(acc, fa[kk & 1], gmma_desc_sw128(ba + kk * 32, 16, 1024),
                       gmma_desc_sw128(ba + C::kTile + kk * 32, 16, 1024), c > 0 || kk > 0);
                wgmma_commit();
                wgmma_wait<1>();  // the group before this one has landed (none before the first)
                fence_regs(fa[(kk & 1) ^ 1]);
                if (kk == 0 && c > 0) release(a + c - 1, 1);  // chunk c - 1's last group
            }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(fa[1]);
        release(a + C::kChunks - 1, 1);

        if (r == 0) {
            // p = 2^(sl2 s - m log2(e)) * (1 / l): one FMA, ex2 and a product;
            // 0 where the key follows the row (the diagonal tile only)
            const int past = kt == ntiles - 1 ? 0 : C::kKeys;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float pr = ex2(fmaf(acc[4 * j + e], sl2, -rv[0][e >> 1])) * rv[1][e >> 1];
                    acc[4 * j + e] = 8 * j + 2 * t4 + (e & 1) > rl[e >> 1] + past ? 0.0f : pr;
                }
            if (kt > 0) named_barrier_sync(7, 256);  // group 1's last dQ^T product is done with dS
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    *reinterpret_cast<float2*>(sDs + ds_off(j, i)) =
                        make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
            named_barrier_arrive(3, 256);  // P is in place for group 1
        } else {
            // ds = (dp - di) p scale, p as group 0 left it, split into the
            // big and small tiles for dQ^T's B
            named_barrier_sync(3, 256);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float2 pr = *reinterpret_cast<const float2*>(sDs + ds_off(j, i));
                    const float d0 = (acc[4 * j + 2 * i] - rv[0][i]) * pr.x * p.scale;
                    const float d1 = (acc[4 * j + 2 * i + 1] - rv[0][i]) * pr.y * p.scale;
                    uint2 hi, lo;
                    tf32_split(d0, hi.x, lo.x);
                    tf32_split(d1, hi.y, lo.y);
                    *reinterpret_cast<uint2*>(sDs + ds_off(j, i)) = hi;
                    *reinterpret_cast<uint2*>(sDs + 2 * C::kTile + ds_off(j, i)) = lo;
                }
            fence_proxy_async();
        }
        named_barrier_sync(4, 256);  // all of dS is in place for both groups' wgmma

        // dQ^T += K^T dS^T over this group's m tiles: A split from the raw
        // stage of K's columns as it is loaded, a commit group a k step, each
        // m tile into acc first
        const int u = a + C::kChunks + (C::kKStages > 1 ? r : 0);
        mbar_wait(full + u % C::kStages, (u / C::kStages) & 1);
        const uint32_t pa = opaque(smem_addr(sDs));
#pragma unroll
        for (int mt = 0; mt < C::kMt; ++mt) {
            // rows 16 warp + gq (+ 8) of m tile r kMt + mt: hd columns of raw
            // chunk 2 (m tile % 2) + warp / 2 of the stage
            const int m = r * C::kMt + mt;
            const unsigned char* raw = stage(u % C::kStages) + (2 * (m & 1) + warp / 2) * C::kTile;
            const int mcol = 16 * (warp & 1) + gq;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {  // A set kk % 2
                load_split4(fa[kk & 1], raw, sw128_f32(8 * kk + t4, mcol), sw128_f32(8 * kk + t4, mcol + 8),
                            sw128_f32(8 * kk + t4 + 4, mcol), sw128_f32(8 * kk + t4 + 4, mcol + 8));
                wgmma_fence();
                const uint32_t bd = pa + (kk >> 2) * C::kTile + (kk & 3) * 32;
                tf32x3(acc, fa[kk & 1], gmma_desc_sw128(bd, 16, 1024), gmma_desc_sw128(bd + 2 * C::kTile, 16, 1024),
                       kk > 0);
                wgmma_commit();
                if (kk > 0) {
                    wgmma_wait<1>();
                    fence_regs(fa[(kk & 1) ^ 1]);
                }
            }
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(fa[1]);
#pragma unroll
            for (int i = 0; i < 32; ++i) dacc[mt][i] += acc[i];
        }
        release(u, C::kKStages > 1 ? 2 : 1);  // at hd 256 the stage is this group's alone: each warp counts twice
        if (r == 1 && kt + 1 < ntiles) named_barrier_arrive(7, 256);  // the tile may take the next P
        a += C::kUses;
    }

    // dq in f32, summed over the keys in key order, stored once: the thread
    // holds rows 8 j + 2 t4 + (e & 1) at hd columns 64 m + 16 warp + gq + 8 (e
    // >> 1) of its m tiles
#pragma unroll
    for (int mt = 0; mt < C::kMt; ++mt) {
        const int col = 64 * (r * C::kMt + mt) + 16 * warp + gq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = r0 + 8 * j + 2 * t4 + (e & 1);
                p.dq[(((size_t)b * p.T + row) * p.H + h) * HD + col + 8 * (e >> 1)] = dacc[mt][4 * j + e];
            }
    }
}

// ---------------------------------------------------------------------------
// The forward in f32 at head_dim 128 and 256: three-pass TF32 wgmma, TMA, two
// consumer warpgroups and a producer warp
// ---------------------------------------------------------------------------

// The products run as the TF32 dK/dV's do (Tf32DkvCfg): three TF32 passes
// each, 3 x 2 products of 2 hd flops a (row, key) pair of the causal half at
// 495 TFLOP/s, 0.2083 ms at B 1, T 2048, H 32 over 8, hd 128 on an H100,
// against 0.513 ms for the same flops at the 67 TFLOP/s of f32 FMA.
//
// TF32 wgmma reads both operands K-major, and the 16-bit O += P V reads V as
// a transposed B.  So a block runs S = Q K^T (M its 64 query rows, N the
// tile's 64 keys, K hd: K K-major as TMA lands it, split in place in the ring
// stage), then O^T += V^T P^T (M hd in 64-row m tiles, N the 64 rows, K the
// keys): P goes to shared memory as a [row][key] tile pair, big and small,
// K-major for that product, and V^T is an A fragment loaded from V's raw
// columns and split in registers, as the TF32 dQ builds K^T.  Q stays raw and
// resident and is split as it is loaded.  With O held transposed, a query row
// is an accumulator column: the online softmax's correction and the final
// 1 / l are a factor a column, staged in shared memory beside P.
//
// Registers set the shape.  ptxas gives a 288-thread block 168 registers a
// thread, and O^T over 64 rows x hd takes hd / 2 of a warpgroup's, beside S
// (two chains, below: 64), a fresh accumulator and two sets of a k step's
// split A (16).  So a block is two consumer warpgroups and a producer warp,
// and each group owns half of O^T's m tiles: group 0 runs S, the online
// softmax and P, then its half of O^T += V^T P^T; group 1 its half, while
// group 0 goes on to the next S.  Each tile's product lands in a fresh wgmma
// accumulator and is added in f32 round-to-nearest, O^T = O^T corr + acc
// (the tensor cores' f32 sums truncate: Tf32DkvCfg).  For the same reason
// S's big * big passes chain in one accumulator and its two small passes in
// another, added once a tile: one chain of all three held o to 7.3e-6 /
// 7.9e-6 of the plain version at T 2048, against the gate's 1e-5 (two: 3.5e-6
// / 3.3e-6).  At hd 256 group 0's two m tiles wait in shared memory between
// its products (in registers beside S they spilled at 168).  Pipelining the
// groups at hd 128 instead (group 0's S and softmax of tile t + 1 against
// group 1's whole O^T for tile t, through two P buffers) made ptxas
// serialize every wgmma (C7513) in each variant tried.  On an H100 80GB HBM3
// at 700 W (B 1, T 2048, H 32 over 8 at hd 128, H 16 over 16 at hd 256) this
// ran 0.5988-0.6008 / 0.5505-0.5603 ms against the wide forward's
// 1.0925-1.1261 / 1.7194-1.7205; one chain for S 5% faster at hd 128, three
// or five stages there and two at hd 256 0-2% slower, the pipelined design
// 0.66-0.72 (experiments/ab_flash_fwd_tf32_torch.py; 167 / 165 registers, no
// spills, no C75xx).
//
// Shared memory: Q raw (32 / 64 KB at hd 128 / 256), the P tile pair (32
// KB: [big | small][key chunk][64 rows][32 keys]), at hd 256 group 0's half
// of O^T (32 KB), the rows' corrections and their final l, and a ring of 32
// KB stages: a key tile passes hd / 64 stages of two 32-column chunks of K
// (each split in place: big, and beside it, small), then hd / 128 stages of
// V's raw columns (the A of O^T: at hd 128 one both groups read, at 256 one
// a group).  Four stages at hd 128, three at 256: 193 / 225 KB.
template <int HD>
struct Tf32FwdCfg {
    static constexpr int kRows = 64;  // query rows of a block: M of S, N of O^T
    static constexpr int kKeys = 64;  // keys of a tile: N of S, K of O^T
    static constexpr int kThreads = 288;
    static constexpr int kChunks = HD / 32;       // 32-column f32 chunks of a row: 128-byte swizzled tiles
    static constexpr int kKStages = kChunks / 2;  // stages of K a key tile, two chunks each
    static constexpr int kVStages = HD / 128;     // stages of V's raw columns a key tile, 128 each
    static constexpr int kUses = kKStages + kVStages;  // ring stages a key tile
    static constexpr int kMt = HD / 128;  // 64-row m tiles of O^T a group owns: r kMt..
    static constexpr bool kStashO = HD == 256;  // group 0's m tiles in shared memory between its products
    static constexpr int kStages = HD == 128 ? 4 : 3;
    static constexpr uint32_t kTile = 64 * 128;          // a 64-row tile of one chunk (8 KB)
    static constexpr uint32_t kQBytes = kRows * HD * 4;
    static constexpr uint32_t kStageBytes = 4 * kTile;   // [K big | K small] of two chunks, or 4 raw tiles of V
    static constexpr uint32_t kOBytes = kStashO ? kMt * 32 * 128 * 4 : 0;
    // shared memory from a 1024-byte aligned base: Q, the P tiles, group 0's
    // O^T, the ring, the corrections and l (64 f32 each), the barriers (Q's,
    // each stage's full and empty)
    static constexpr uint32_t kP0 = kQBytes;
    static constexpr uint32_t kO0 = kP0 + 4 * kTile;
    static constexpr uint32_t kRing0 = kO0 + kOBytes;
    static constexpr uint32_t kVals0 = kRing0 + kStages * kStageBytes;
    static constexpr uint32_t kBars = kVals0 + 2 * kRows * 4;
    static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;  // + alignment
    static_assert((HD == 128 || HD == 256) && kBytes <= 232448, "no TF32 forward at this hd");
};

template <int HD>
__global__ void __launch_bounds__(Tf32FwdCfg<HD>::kThreads, 1)
    flash_tf32_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params<float> p) {
    using C = Tf32FwdCfg<HD>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    unsigned char* sQ = smem;
    unsigned char* sP = smem + C::kP0;
    auto stage = [&](int st) { return smem + C::kRing0 + st * C::kStageBytes; };
    float* vals = reinterpret_cast<float*>(smem + C::kVals0);  // [the rows' corrections | l]
    uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBars);
    uint64_t* full = full_q + 1;
    uint64_t* empty = full + C::kStages;

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x, b = blockIdx.y;
    const int r0 = qi * C::kRows;
    const int ntiles = qi + 1;  // the key tiles up to the diagonal one

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < C::kStages; ++st) {
            mbar_init(full + st, 1);
            mbar_init(empty + st, 8);  // each consumer warp once
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 256) {
        // the producer warp: one thread loads Q once, then for each key tile
        // of KV head h / (H / KVH) its chunks of K, two a stage, and V's raw
        // columns
        if (threadIdx.x == 256) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            const int kvh = h / (p.H / p.KVH);
            mbar_expect_tx(full_q, C::kQBytes);
            for (int c = 0; c < C::kChunks; ++c) tma_load_4d(sQ + c * C::kTile, &tq, full_q, c * 32, h, r0, b);
            int a = 0;
            for (int t = 0; t < ntiles; ++t) {
                for (int u = 0; u < C::kUses; ++u, ++a) {
                    const int st = a % C::kStages;
                    if (a >= C::kStages) mbar_wait(empty + st, ((a / C::kStages) - 1) & 1);
                    unsigned char* s = stage(st);
                    if (u < C::kKStages) {  // chunks 2 u and 2 u + 1 of K, each into its big tile
                        mbar_expect_tx(full + st, 2 * C::kTile);
                        for (int j = 0; j < 2; ++j)
                            tma_load_4d(s + 2 * j * C::kTile, &tk, full + st, (2 * u + j) * 32, kvh, t * C::kKeys, b);
                    } else {  // four raw chunks of V: columns 128 (u - kKStages)..
                        const int c0 = 4 * (u - C::kKStages);
                        mbar_expect_tx(full + st, 4 * C::kTile);
                        for (int j = 0; j < 4; ++j)
                            tma_load_4d(s + j * C::kTile, &tv, full + st, (c0 + j) * 32, kvh, t * C::kKeys, b);
                    }
                }
            }
        }
        return;
    }

    // the consumer groups: r 0 runs S = Q K^T, the softmax and P, then both
    // run O^T += V^T P^T over their m tiles
    const int r = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int rl[2] = {16 * warp + gq, 16 * warp + gq + 8};  // the thread's accumulator rows of S: query rows
    const float sl2 = p.scale * 1.44269504088896341f;       // scale * log2(e): exp(scale x) = 2^(sl2 x)
    // O^T, this group's m tiles (m tile r kMt + mt: hd columns 64 m..),
    // summed in f32 round-to-nearest: each key tile's product goes to a
    // wgmma accumulator first (acc; group 0's S before it)
    float dacc[C::kMt][32], acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        acc[i] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < C::kMt; ++mt) dacc[mt][i] = 0.0f;
    }
    uint32_t fa[2][8];  // split A of a k step (big 0..3, small 4..7), two sets in flight
    auto release = [&](int a, int count) {
        __syncwarp();
        if (lane == 0) mbar_arrive_cnt(empty + a % C::kStages, count);  // this warp is done with the stage
    };
    // group 0's m tiles at hd 256 between its products: float4 i of the
    // thread's values at (i, t), conflict-free
    float4* o_stash = reinterpret_cast<float4*>(smem + C::kO0) + t;
    auto stash_o = [&](bool load) {
#pragma unroll
        for (int i = 0; i < 8 * C::kMt; ++i) {
            float* d = &dacc[i >> 3][4 * (i & 7)];
            if (load) {
                const float4 x = o_stash[128 * i];
                d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
            } else {
                o_stash[128 * i] = make_float4(d[0], d[1], d[2], d[3]);
            }
        }
    };

    // O^T = O^T corr + V^T P^T over this group's m tiles for the key tile at
    // ring use a: A split from the raw stage of V's columns as it is loaded,
    // a commit group a k step, each m tile into acc first
    auto add_pv = [&](int a) {
        const int u = a + C::kKStages + (C::kVStages > 1 ? r : 0);  // at hd 128 both groups read one stage
        mbar_wait(full + u % C::kStages, (u / C::kStages) & 1);
        const uint32_t pa = opaque(smem_addr(sP));
        const float2* corr = reinterpret_cast<const float2*>(vals);
#pragma unroll
        for (int mt = 0; mt < C::kMt; ++mt) {
            // rows 16 warp + gq (+ 8) of the stage's m tile sm: hd columns of
            // raw chunk 2 sm + warp / 2
            const int sm = C::kVStages > 1 ? mt : r;
            const unsigned char* raw = stage(u % C::kStages) + (2 * sm + warp / 2) * C::kTile;
            const int mcol = 16 * (warp & 1) + gq;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {  // A set kk % 2
                load_split4(fa[kk & 1], raw, sw128_f32(8 * kk + t4, mcol), sw128_f32(8 * kk + t4, mcol + 8),
                            sw128_f32(8 * kk + t4 + 4, mcol), sw128_f32(8 * kk + t4 + 4, mcol + 8));
                wgmma_fence();
                const uint32_t bd = pa + (kk >> 2) * C::kTile + (kk & 3) * 32;
                tf32x3(acc, fa[kk & 1], gmma_desc_sw128(bd, 16, 1024), gmma_desc_sw128(bd + 2 * C::kTile, 16, 1024),
                       kk > 0);
                wgmma_commit();
                if (kk > 0) {
                    wgmma_wait<1>();
                    fence_regs(fa[(kk & 1) ^ 1]);
                }
            }
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(fa[1]);
            // the thread's columns: query rows 8 j + 2 t4 + (e & 1)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float2 c = corr[4 * j + t4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dacc[mt][4 * j + e] = fmaf(dacc[mt][4 * j + e], (e & 1) ? c.y : c.x, acc[4 * j + e]);
            }
        }
        release(u, C::kVStages > 1 ? 2 : 1);  // at hd 256 the stage is this group's alone: each warp counts twice
    };

    if (r == 0) {
        float m[2] = {-INFINITY, -INFINITY};  // the row max of the unscaled scores
        float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum
        float acc2[32];                       // S's small passes (acc holds its big * big ones)
        // the A fragments of S: (row rl[i], column 8 kk + t4 (+ 4)) of a chunk
        // is sw128_f32's rl[i] 128 + 4 t4 + (((2 kk (+ 1)) ^ gq) << 4), as
        // rl[i] % 8 = gq; the swizzle term is rebuilt in each chunk (opaque),
        // as the TF32 dQ's
        const uint32_t arow = rl[0] * 128 + 4 * t4;
        // chunk c of S for the key tile at ring use a, a commit group a k
        // step; a stage goes back once the group after its last has been
        // issued and its own have landed.  `first` (chunk 0) starts both
        // chains with a scale_d of 0 known at compile time: with it known
        // only at run time the loop spilled at hd 256
        auto s_chunk = [&](int a, int c, auto first) {  // first: std::true_type for chunk 0
            const int sa = a + c / 2;  // the ring use of chunk c's stage
            const int st = sa % C::kStages;
            if ((c & 1) == 0) mbar_wait(full + st, (sa / C::kStages) & 1);
            unsigned char* tb = stage(st) + (c & 1) * 2 * C::kTile;  // K's chunk c
            split_tile(tb, t);
            fence_proxy_async();
            named_barrier_sync(1, 128);
            const unsigned char* ta = sQ + c * C::kTile + arow;
            const uint32_t ba = opaque(smem_addr(tb));
            const uint32_t sw = opaque((uint32_t)gq << 4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {  // A set kk % 2
                const uint32_t x0 = sw ^ (kk << 5), x1 = x0 ^ 16;
                load_split4(fa[kk & 1], ta, x0, x0 + 1024, x1, x1 + 1024);
                wgmma_fence();
                const uint64_t db = gmma_desc_sw128(ba + kk * 32, 16, 1024);
                const uint64_t ds = gmma_desc_sw128(ba + C::kTile + kk * 32, 16, 1024);
                const uint32_t* f = fa[kk & 1];
                const int sd = decltype(first)::value && kk == 0 ? 0 : 1;
                wgmma_rs_tf32_n64(acc, f[0], f[1], f[2], f[3], db, sd);
                wgmma_rs_tf32_n64(acc2, f[0], f[1], f[2], f[3], ds, sd);
                wgmma_rs_tf32_n64(acc2, f[4], f[5], f[6], f[7], db, 1);
                wgmma_commit();
                wgmma_wait<1>();  // the group before this one has landed (none before the first)
                fence_regs(fa[(kk & 1) ^ 1]);
                if (kk == 0 && c > 0 && (c & 1) == 0) release(sa - 1, 2);  // the last stage's last group
            }
        };
        if constexpr (C::kStashO) stash_o(false);  // zeros
        mbar_wait(full_q, 0);
        int a = 0;
        for (int kt = 0; kt < ntiles; ++kt) {
            s_chunk(a, 0, std::true_type{});
#pragma unroll 1
            for (int c = 1; c < C::kChunks; ++c) s_chunk(a, c, std::false_type{});  // rolled, as the TF32 dK/dV's
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(acc2);
            fence_regs(fa[1]);
            release(a + C::kKStages - 1, 2);  // the K stages are this group's alone
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] += acc2[i];

            // the online softmax: p = 2^(sl2 s - sl2 m), one FMA and ex2, 0
            // where the key follows the row (the diagonal tile only: s = -inf
            // there); corr is the factor O takes before this tile's product
            const int past = kt == ntiles - 1 ? 0 : C::kKeys;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc[4 * j + e] = 8 * j + 2 * t4 + (e & 1) > rl[e >> 1] + past ? -INFINITY : acc[4 * j + e];
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
            float ms[2], corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                ms[i] = mx[i] * sl2;
                corr[i] = ex2(fmaf(m[i], sl2, -ms[i]));  // 0 on the first tile (m = -inf)
                m[i] = mx[i];
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                acc[i] = ex2(fmaf(acc[i], sl2, -ms[(i >> 1) & 1]));
                rs[(i >> 1) & 1] += acc[i];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];

            // P as the big and small [row][key] tiles (the thread's values of
            // accumulator step j, rows rl[i]), the rows' corrections beside
            // them
            if (kt > 0) named_barrier_sync(5, 256);  // group 1 is done with the last P
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const uint32_t off = (j >> 2) * C::kTile + sw128_f32(rl[i], 8 * (j & 3) + 2 * t4);
                    uint2 hi, lo;
                    tf32_split(acc[4 * j + 2 * i], hi.x, lo.x);
                    tf32_split(acc[4 * j + 2 * i + 1], hi.y, lo.y);
                    *reinterpret_cast<uint2*>(sP + off) = hi;
                    *reinterpret_cast<uint2*>(sP + 2 * C::kTile + off) = lo;
                }
            if (t4 == 0) {
                vals[rl[0]] = corr[0];
                vals[rl[1]] = corr[1];
            }
            fence_proxy_async();
            named_barrier_sync(1, 128);   // all of P is in place for this group's wgmma
            named_barrier_arrive(3, 256);  // and for group 1
            if constexpr (C::kStashO) stash_o(true);
            add_pv(a);
            if constexpr (C::kStashO) stash_o(false);
            a += C::kUses;
        }
        // m (of the scaled scores: the scale is monotone) and l; l also for
        // the division below
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
            if (t4 == 0) {
                const size_t ml = ((size_t)b * p.H + h) * p.T + r0 + rl[i];
                p.m_out[ml] = __fmul_rn(m[i], p.scale);
                p.l_out[ml] = l[i];
                vals[C::kRows + rl[i]] = l[i];
            }
        }
        if constexpr (C::kStashO) stash_o(true);
    } else {
        int a = 0;
        for (int kt = 0; kt < ntiles; ++kt) {
            named_barrier_sync(3, 256);  // P and the corrections of tile kt are in place
            add_pv(a);
            if (kt + 1 < ntiles) named_barrier_arrive(5, 256);  // the tile may take the next P
            a += C::kUses;
        }
    }
    named_barrier_sync(7, 256);  // l is in place

    // o = O / l in f32, stored once: the thread holds rows 8 j + 2 t4 + (e &
    // 1) at hd columns 64 m + 16 warp + gq + 8 (e >> 1) of its m tiles
    const float2* lf = reinterpret_cast<const float2*>(vals + C::kRows);
#pragma unroll
    for (int mt = 0; mt < C::kMt; ++mt) {
        const int col = 64 * (r * C::kMt + mt) + 16 * warp + gq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 lv = lf[4 * j + t4];
            const float inv[2] = {1.0f / lv.x, 1.0f / lv.y};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = r0 + 8 * j + 2 * t4 + (e & 1);
                p.o[(((size_t)b * p.T + row) * p.H + h) * HD + col + 8 * (e >> 1)] = dacc[mt][4 * j + e] * inv[e & 1];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// forward above hd 512 in bf16 and f16: o, m, l with head_dim streamed in
// chunks (wgmma, TMA, a producer warp)
// ---------------------------------------------------------------------------

// From hd 640 a half slice of O passes wgmma's widest N (256), and whole
// tiles no longer fit shared memory: at hd 1024 Q alone takes 128 KB and one
// 64-key K tile 128 KB, against 227 KB a block.  So a block owns 64 query
// rows of one head and a column slice of o of at most 256 columns (O in 128
// registers, hd 512's footprint; ceil(hd / 256) blocks a row tile, the last
// one 128 columns wide where hd / 128 is odd), and S = Q K^T runs over all
// of hd from 64-column chunks: each chunk of a 64-key K tile (8 KB) arrives
// through a ring of chunk stages, one commit group a chunk, so S stays an
// m64n64 product whatever hd is.  Q stays resident while it leaves room for
// eight chunk stages beside one V stage (up to hd 1024: 80-128 KB); above
// that each chunk stage brings Q's chunk beside K's.  A V stage holds the
// tile's 64 keys in the block's columns (32 KB) for O += P V (m64 n256 or
// n128); there are two where six chunk stages still fit beside them (up to
// hd 896), else one.  The work is ceil(hd / 256) computations of S a row
// tile: 3 at hd 640 and 768, 4 at 896 and 1024, 2 to 2.5 times the least.
// hd is a runtime value: one kernel serves every multiple of 128 from 640,
// its two slice widths two bodies of one template lambda.  p and the
// rounding points are flash_fwd_kernel's, and so are m and l.
//
// On an H100 80GB HBM3 at 700 W (B 1, T 2048, H 8, bf16) this ran 0.234 /
// 0.270 / 0.389 / 0.501 ms at hd 640 / 768 / 896 / 1024 (203 registers, no
// spills, no C75xx), against the wide forward's 4.03 / 5.62 / - / 9.56.
// Against it: two V stages at every hd (the layout written first) even, 1,
// 1 and 7% slower; one V stage at every hd 19, 22, 14 and 1% slower; Q
// streamed at every hd 25, 19, 27 and 2% slower; a ring of at most four
// stages 16, 21, 20 and 23% slower; blocks handed out head by head (the K
// and V of one or two heads in flight) 8 and 5% slower, 1 and 3% faster
// (experiments/ab_flash_fwd_streamed_torch.py).  Streaming Q doubles the L2
// reads of S and still moved 8-9.5 TB/s, so L2 does not bind here; the ring's
// depth does, and shared memory's bandwidth, which each m64n64 product's A
// and B reads fill as fully as its math fills the tensor cores, beside the
// TMA writes of every chunk (an estimate: no counter reads it).
struct StreamedCfg {
    static constexpr int kRows = 64;                       // query rows of a block
    static constexpr int kKeys = 64;                       // keys of a K or V tile
    static constexpr int kMaxCols = 256;                   // columns of o a block owns at most
    static constexpr int kThreads = 128 + 32;              // one consumer warpgroup, one producer warp
    static constexpr int kMaxVStages = 2;
    static constexpr uint32_t kChunkBytes = kRows * 128;   // a 64-column chunk of Q's rows or of a K tile
    static constexpr uint32_t kVBytes = kKeys * kMaxCols * 2;  // a V stage: the tile in the block's columns
    static constexpr int kResidentRing = 8;  // Q stays resident while this many chunk stages fit beside a V stage
    static constexpr int kTwoVRing = 6;      // two V stages while this many chunk stages fit beside them
    static constexpr int kMaxRing = 16;
    static constexpr uint32_t kBarBytes = (1 + 2 * kMaxVStages + 2 * kMaxRing) * 8;
    static constexpr uint32_t kData = 232448 - 1024 - kBarBytes;  // for Q, the V stages and the ring
    static_assert(kRows == kKeys, "a K chunk and a Q chunk share a stage's layout");
};

// Where a block's shared memory goes at one hd, from a 1024-byte aligned
// base: Q (when resident), the V stages, the chunk ring (each stage a K chunk,
// after Q's chunk when Q streams), the barriers (Q's, each V stage's full and
// empty, each chunk stage's full and empty).
struct StreamedLayout {
    int chunks;            // hd / 64
    int slices;            // blocks a row tile
    int resident;          // Q stays in shared memory
    int vshift;            // log2 of the V stages (1 or 2)
    int ring;              // chunk stages
    uint32_t q_bytes;      // Q's resident bytes (0 when it streams)
    uint32_t stage_bytes;  // a chunk stage
    uint32_t ring0, bars, bytes;
};

inline StreamedLayout streamed_layout(int hd) {
    using C = StreamedCfg;
    StreamedLayout s;
    s.chunks = hd / 64;
    s.slices = (hd + C::kMaxCols - 1) / C::kMaxCols;
    s.q_bytes = s.chunks * C::kChunkBytes;
    s.resident = s.q_bytes + C::kVBytes + C::kResidentRing * C::kChunkBytes <= C::kData;
    if (!s.resident) s.q_bytes = 0;
    s.stage_bytes = (s.resident ? 1 : 2) * C::kChunkBytes;
    s.vshift = s.q_bytes + 2 * C::kVBytes + C::kTwoVRing * s.stage_bytes <= C::kData ? 1 : 0;
    const uint32_t v = (1u << s.vshift) * C::kVBytes;
    const uint32_t fit = (C::kData - s.q_bytes - v) / s.stage_bytes;
    s.ring = fit < (uint32_t)C::kMaxRing ? (int)fit : C::kMaxRing;
    s.ring0 = s.q_bytes + v;
    s.bars = s.ring0 + s.ring * s.stage_bytes;
    s.bytes = s.bars + C::kBarBytes + 1024;  // + the base's alignment
    return s;
}

template <class E>
__global__ void __launch_bounds__(StreamedCfg::kThreads, 1)
    flash_streamed_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const Params<E> p, const StreamedLayout lay) {
    using C = StreamedCfg;
    constexpr int N = C::kKeys;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + lay.bars);
    uint64_t* full_v = full_q + 1;
    uint64_t* empty_v = full_v + C::kMaxVStages;
    uint64_t* full_c = empty_v + C::kMaxVStages;
    uint64_t* empty_c = full_c + lay.ring;
    auto sV = [&](int st) { return smem + lay.q_bytes + st * C::kVBytes; };
    auto sStage = [&](int sa) { return smem + lay.ring0 + sa * lay.stage_bytes; };

    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x / lay.slices, cs = blockIdx.x % lay.slices, b = blockIdx.y;  // cs: the column slice
    const int r0 = qi * C::kRows;
    const int hd = lay.chunks * 64;
    const int cols = min(C::kMaxCols, hd - cs * C::kMaxCols);  // 256, or 128 in a last slice
    const int ntiles = qi + 1;  // the tiles holding a key <= the block's last row; the last is its diagonal
    // tile t's V stage, and the parity of its fill
    auto vst = [&](int t) { return t & ((1 << lay.vshift) - 1); };
    auto vpar = [&](int t) { return (uint32_t)(t >> lay.vshift) & 1u; };

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int st = 0; st < (1 << lay.vshift); ++st) {
            mbar_init(full_v + st, 1);
            mbar_init(empty_v + st, 4);  // each consumer warp once
        }
        for (int sa = 0; sa < lay.ring; ++sa) {
            mbar_init(full_c + sa, 1);
            mbar_init(empty_c + sa, 4);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // the producer: one thread loads Q once (when resident), then for
        // each K tile of KV head h / (H / KVH) from key 0 up to the block's
        // diagonal its chunks into the ring (each after Q's chunk when Q
        // streams) and its slice cs of V into a stage
        if (threadIdx.x == 128) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            const int kvh = h / (p.H / p.KVH);
            if (lay.resident) {
                mbar_expect_tx(full_q, lay.q_bytes);
                for (int c = 0; c < lay.chunks; ++c) tma_load_4d(smem + c * C::kChunkBytes, &tq, full_q, c * 64, h, r0, b);
            }
            int sa = 0, pass = 0;  // the next chunk stage, and how often the ring has been filled
            for (int t = 0; t < ntiles; ++t) {
                for (int c = 0; c < lay.chunks; ++c) {
                    if (pass > 0) mbar_wait(empty_c + sa, (pass - 1) & 1);
                    unsigned char* dst = sStage(sa);
                    mbar_expect_tx(full_c + sa, lay.stage_bytes);
                    if (!lay.resident) {
                        tma_load_4d(dst, &tq, full_c + sa, c * 64, h, r0, b);
                        dst += C::kChunkBytes;
                    }
                    tma_load_4d(dst, &tk, full_c + sa, c * 64, kvh, t * N, b);
                    if (++sa == lay.ring) {
                        sa = 0;
                        ++pass;
                    }
                }
                const int st = vst(t);
                if (t >= (1 << lay.vshift)) mbar_wait(empty_v + st, vpar(t) ^ 1u);
                mbar_expect_tx(full_v + st, cols * N * 2);
                for (int c = 0; c < cols / 64; ++c)
                    tma_load_4d(sV(st) + c * N * 128, &tv, full_v + st, cs * C::kMaxCols + c * 64, kvh, t * N, b);
            }
        }
        return;
    }

    // the consumer warpgroup: 64 query rows, S = Q K^T chunk by chunk and
    // O += P V over the block's W columns on wgmma, the online softmax in
    // registers
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int row[2] = {r0 + 16 * warp + gq, r0 + 16 * warp + gq + 8};
    const float sl2 = p.scale * 1.44269504088896341f;  // scale * log2(e): exp(scale x) = 2^(sl2 x)
    const uint32_t q_res = smem_addr(smem);            // Q's first chunk, when resident
    const uint32_t k_off = lay.resident ? 0u : C::kChunkBytes;  // K's chunk in a stage

    auto body = [&](auto width) {
        constexpr int W = decltype(width)::value;
        float m[2] = {-INFINITY, -INFINITY};  // the row max of the unscaled scores
        float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum
        float o[W / 2];
#pragma unroll
        for (int i = 0; i < W / 2; ++i) o[i] = 0.0f;
        float s[N / 2];
        uint32_t pa[N / 16][4];
        float corr[2];
        int sa = 0;
        uint32_t phase = 0;  // the next chunk stage, and the parity of its fill

        auto release = [&](uint64_t* bars) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bars);  // this warp is done with the stage
        };
        // chunk c of S = Q K_t^T into s, committed as one group; the first
        // chunk's first step overwrites s (scale_d 0, known at compile
        // time).  The addresses come before the wait, the fence after it: no
        // branch may sit between a fence and its wgmma.
        auto s_chunk = [&](int c, auto first) {
            const uint32_t st = opaque(smem_addr(sStage(sa)));
            const uint32_t qa = lay.resident ? opaque(q_res) + c * C::kChunkBytes : st;
            const uint32_t ka = st + k_off;
            mbar_wait(full_c + sa, phase);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<N, E>(s, gmma_desc_sw128(qa + kk * 32, 16, 1024), gmma_desc_sw128(ka + kk * 32, 16, 1024),
                               decltype(first)::value && kk == 0 ? 0 : 1);
            wgmma_commit();
        };
        auto advance = [&]() {
            if (++sa == lay.ring) {
                sa = 0;
                phase ^= 1;
            }
        };
        // S of tile t over every chunk; a chunk stage goes back once the next
        // chunk's group is issued and its own has landed.  Returns the last
        // chunk's stage, whose group may still run.
        auto issue_s = [&]() {
            s_chunk(0, std::true_type{});
            int prev = sa;
            advance();
#pragma unroll 1
            for (int c = 1; c < lay.chunks; ++c) {
                s_chunk(c, std::false_type{});
                wgmma_wait<1>();
                release(empty_c + prev);
                prev = sa;
                advance();
            }
            return prev;
        };
        // O += P V_t over the block's columns, committed as one group
        auto issue_pv = [&](int t) {
            const int st = vst(t);
            mbar_wait(full_v + st, vpar(t));
            const uint32_t va = opaque(smem_addr(sV(st)));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < N / 16; ++kk)
                wgmma_rs_tb<W, E>(o, pa[kk], gmma_desc_sw128(va + kk * 16 * 128, N * 128, 1024), 1);
            wgmma_commit();
        };
        // the online softmax of tile t (flash_fwd_kernel's), p kept in s
        // while the last tile's P V product still reads pa
        auto softmax = [&](int t) {
            if (t * N + N - 1 > r0) {  // the diagonal tile: key t N + 8 j + 2 t4 + (e & 1) after row[e / 2]
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
            for (int i = 0; i < N / 2; ++i) {
                s[i] = ex2(fmaf(s[i], sl2, -ms[(i >> 1) & 1]));
                rs[(i >> 1) & 1] += s[i];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
        };
        // p rounded to E pairs: the A fragments of the PV product (key step
        // kk: n8 tiles 2 kk, 2 kk + 1)
        auto to_pa = [&]() {
#pragma unroll
            for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
                for (int r = 0; r < 4; ++r) pa[kk][r] = pack_x2<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        };
        auto pv_landed = [&]() {
            fence_regs(o);
#pragma unroll
            for (int kk = 0; kk < N / 16; ++kk) fence_regs(pa[kk]);
        };

        if (lay.resident) mbar_wait(full_q, 0);
        int last = issue_s();
        wgmma_wait<0>();
        fence_regs(s);
        release(empty_c + last);
        softmax(0);
        to_pa();
        for (int t = 1; t < ntiles; ++t) {
            last = issue_s();
            issue_pv(t - 1);
            wgmma_wait<1>();  // S_t has landed, P V_{t-1} may still run
            fence_regs(s);
            release(empty_c + last);
            softmax(t);
            wgmma_wait<0>();
            pv_landed();
            release(empty_v + vst(t - 1));
#pragma unroll
            for (int i = 0; i < W / 2; ++i) o[i] *= corr[(i >> 1) & 1];
            to_pa();
        }
        issue_pv(ntiles - 1);
        wgmma_wait<0>();
        pv_landed();
        release(empty_v + vst(ntiles - 1));

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
            const float inv = 1.0f / l[i];
            E* dst = p.o + (((size_t)b * p.T + row[i]) * p.H + h) * hd + cs * C::kMaxCols;
#pragma unroll
            for (int j = 0; j < W / 8; ++j)
                *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
                    pack_x2<E>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
            if (cs == 0 && t4 == 0) {  // every slice has the same m and l: slice 0 writes them
                const size_t ml = ((size_t)b * p.H + h) * p.T + row[i];
                p.m_out[ml] = __fmul_rn(m[i], p.scale);  // max of the scaled scores: the scale is monotone
                p.l_out[ml] = l[i];
            }
        }
    };
    if (cols == C::kMaxCols)
        body(std::integral_constant<int, C::kMaxCols>{});
    else
        body(std::integral_constant<int, 128>{});
}

// ---------------------------------------------------------------------------
// The wide family: the same three functions where the other kernels stop, f32
// from head_dim 384, and bf16/f16 dK/dV and dQ from head_dim 640 (CUDA
// cores, f32 FMA); its forward also takes bf16/f16 from 640 through its C
// entry, which the route no longer calls there
// ---------------------------------------------------------------------------

// Why CUDA cores.  f32 must keep full f32 precision (the JAX package's
// "highest"): one TF32 pass keeps about three digits, so the tensor cores
// take f32 only as three TF32 passes, with both operands K-major, which the
// three kernels above do at hd 128 and 256; the f32 forward from hd 384 (Q
// alone takes 96 KB and O^T passes a warpgroup's registers there), f32
// dK/dV from hd 384 (K and V alone take 192 KB) and f32 dQ from hd 384 (Q
// and dO alone take 192 KB), stay here.  And a
// warpgroup's f32 O or dQ of 64 rows takes hd / 2 registers a thread, which
// with S and dP passes the 255-register limit above hd 256.  The 16-bit forward and dQ cut O and dQ
// in two column slices on wgmma up to hd 512 (FwdCfg, DqCfg; the forward
// from hd 640 in slices of 256 columns, StreamedCfg), and dK/dV holds
// 128-column slices and streams the rest of hd in chunks up to hd 512
// (DkvCfg); from hd 640 a half slice of dQ passes wgmma's widest N, 256,
// and K and V (160 KB) leave too little room for dK/dV's rings.  So a block
// here owns 128 columns of its output (a column slice; hd / 128 blocks share a
// row tile and each recomputes the scores over all of hd) and keeps everything
// in f32: the bound is the f32 rate (67 TFLOP/s) for f32, and this simple
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
// kernels take bf16 and f16 alone, up to hd 512.
bool shapes_ok(int B, int T, int H, int KVH, int hd) {
    return B > 0 && B <= 65535 && T > 0 && T % 128 == 0 && T / 64 <= 65535 && H > 0 && KVH > 0 && H % KVH == 0 &&
           hd > 0 && hd % 128 == 0;
}

bool wgmma_ok(int kind, int hd) { return (kind == kBf16 || kind == kF16) && hd <= 512; }

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
template <> constexpr CUtensorMapDataType tma_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }

// A tensor map over a [B, T, heads, hd] tensor of E read in place through its
// batch and token strides: boxes of 128 bytes of columns (64 16-bit values,
// 32 f32) by `rows` tokens of one head, 128-byte swizzled.
template <class E>
int encode_rows(CUtensorMap* map, const E* base, int hd, int B, int T, int heads, long long sb, long long st,
                int rows) {
    constexpr uint64_t es = sizeof(E);
    // with one batch its stride is never used: any valid one will do
    const uint64_t sbb = B == 1 ? (uint64_t)T * st * es : (uint64_t)sb * es;
    const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)T, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)hd * es, (uint64_t)st * es, sbb};
    const uint32_t box[4] = {128 / (uint32_t)es, 1, (uint32_t)rows, 1};
    return encode_sw128(map, tma_type<E>(), base, 4, dims, strides, box);
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
    flash_fwd_kernel<HD, E><<<dim3(p.H * C::kSlices, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk,
                                                                                                      tv, p);
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

// The TF32 dK/dV kernel's launch (f32), one block an item of the plan:
// boxes of 64 rows of 32 f32 columns.
template <int HD>
int launch_tf32_dkv(const Params<float>& p, int B, const DkvItem* items, int n_items, float* part_k, float* part_v,
                    cudaStream_t stream) {
    using C = Tf32DkvCfg<HD>;
    CUtensorMap tq, tk, tv, tdo;
    const int e = encode_bwd(tq, tk, tv, tdo, p, HD, B, C::kRows, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a = cudaFuncSetAttribute(flash_tf32_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_tf32_dkv_kernel<HD><<<n_items, C::kThreads, C::kBytes, stream>>>(tq, tk, tv, tdo, items, part_k, part_v, p);
    return (int)cudaGetLastError();
}

// The TF32 dQ kernel's launch (f32): a block 64 query rows of one head, the
// longest rows first; boxes of 64 rows of 32 f32 columns.
template <int HD>
int launch_tf32_dq(const Params<float>& p, int B, cudaStream_t stream) {
    using C = Tf32DqCfg<HD>;
    CUtensorMap tq, tk, tv, tdo;
    const int e = encode_bwd(tq, tk, tv, tdo, p, HD, B, C::kRows, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a =
        cudaFuncSetAttribute(flash_tf32_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_tf32_dq_kernel<HD><<<dim3(p.H, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk, tv, tdo, p);
    return (int)cudaGetLastError();
}

// The TF32 forward's launch (f32): a block 64 query rows of one head, the
// longest rows first; boxes of 64 rows of 32 f32 columns.
template <int HD>
int launch_tf32_fwd(const Params<float>& p, int B, cudaStream_t stream) {
    using C = Tf32FwdCfg<HD>;
    CUtensorMap tq, tk, tv;
    int e = encode_rows(&tq, p.q, HD, B, p.T, p.H, p.sqb, p.sqt, C::kRows);
    if (e == 0) e = encode_rows(&tk, p.k, HD, B, p.T, p.KVH, p.skb, p.skt, C::kKeys);
    if (e == 0) e = encode_rows(&tv, p.v, HD, B, p.T, p.KVH, p.svb, p.svt, C::kKeys);
    if (e != 0) return e;
    const cudaError_t a =
        cudaFuncSetAttribute(flash_tf32_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
    if (a != cudaSuccess) return (int)a;
    flash_tf32_fwd_kernel<HD><<<dim3(p.H, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(tq, tk, tv, p);
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
    flash_bwd_dq_kernel<HD, E><<<dim3(p.H * C::kSlices, B, p.T / C::kRows), C::kThreads, C::kBytes, stream>>>(
        tq, tk, tv, tdo, p);
    return (int)cudaGetLastError();
}

// The streamed forward's launch (bf16, f16 above hd 512): a block 64 query
// rows of one head and a column slice, the longest rows first; boxes of 64
// rows of 64 columns of q, k and v.
template <class E>
int launch_streamed_fwd(const Params<E>& p, int B, int hd, cudaStream_t stream) {
    using C = StreamedCfg;
    CUtensorMap tq, tk, tv;
    int e = encode_rows(&tq, p.q, hd, B, p.T, p.H, p.sqb, p.sqt, C::kRows);
    if (e == 0) e = encode_rows(&tk, p.k, hd, B, p.T, p.KVH, p.skb, p.skt, C::kKeys);
    if (e == 0) e = encode_rows(&tv, p.v, hd, B, p.T, p.KVH, p.svb, p.svt, C::kKeys);
    if (e != 0) return e;
    const StreamedLayout lay = streamed_layout(hd);
    const cudaError_t a = cudaFuncSetAttribute(flash_streamed_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)lay.bytes);
    if (a != cudaSuccess) return (int)a;
    flash_streamed_fwd_kernel<E><<<dim3(p.H * lay.slices, B, p.T / C::kRows), C::kThreads, lay.bytes, stream>>>(
        tq, tk, tv, p, lay);
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

// Every entry takes `kind` (common.cuh's Kind: f32, bf16 or f16), the type of
// q, k, v, do and the outputs.  The plain entries run the wgmma kernels (bf16
// or f16 at hd 128, 256, 384 and 512), the _streamed one the forward above
// (bf16 or f16 from hd 640), the _tf32 ones the TF32 forward, dK/dV
// and dQ (f32 at hd 128 and 256), the _wide ones the wide family (any of the three
// types, hd a multiple of 128); each refuses what its kernels do not take.  T
// is a multiple of 128 and outputs are packed.  An entry returns a CUDA
// error, or kTmaError + the CUresult of cuTensorMapEncodeTiled when a tensor
// map cannot be encoded (nothing is launched then).

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
            if (hd == 128) return launch_fwd<128>(p, B, stream);
            if (hd == 256) return launch_fwd<256>(p, B, stream);
            return hd == 384 ? launch_fwd<384>(p, B, stream) : launch_fwd<512>(p, B, stream);
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

// The streamed instance: bf16 or f16 (kind kBf16, kF16) above hd 512 alone.
BNB_EXPORT int bnb_flash_attention_causal_fwd_streamed(const void* q, const void* k, const void* v, void* o, float* m,
                                                       float* l, int B, int T, int H, int KVH, int hd, long long sqb,
                                                       long long sqt, long long skb, long long skt, long long svb,
                                                       long long svt, float scale, int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || (kind != kBf16 && kind != kF16) || hd <= 512) return (int)cudaErrorInvalidValue;
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
            return launch_streamed_fwd<E>(p, B, hd, stream);
        }
    });
}

// The three-pass TF32 instance: f32 (kind kF32) at hd 128 and 256 alone.
BNB_EXPORT int bnb_flash_attention_causal_fwd_tf32(const void* q, const void* k, const void* v, void* o, float* m,
                                                   float* l, int B, int T, int H, int KVH, int hd, long long sqb,
                                                   long long sqt, long long skb, long long skt, long long svb,
                                                   long long svt, float scale, int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || kind != kF32 || (hd != 128 && hd != 256)) return (int)cudaErrorInvalidValue;
    Params<float> p = make_params<float>(q, k, v, nullptr, nullptr, nullptr, nullptr, T, H, KVH, sqb, sqt, skb, skt,
                                         svb, svt, 0, 0, scale);
    p.o = static_cast<float*>(o);
    p.m_out = m;
    p.l_out = l;
    return hd == 128 ? launch_tf32_fwd<128>(p, B, stream) : launch_tf32_fwd<256>(p, B, stream);
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
            if (hd == 128) return launch_dkv<128>(p, B, it, n_items, part_k, part_v, stream);
            if (hd == 256) return launch_dkv<256>(p, B, it, n_items, part_k, part_v, stream);
            return hd == 384 ? launch_dkv<384>(p, B, it, n_items, part_k, part_v, stream)
                             : launch_dkv<512>(p, B, it, n_items, part_k, part_v, stream);
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

// The three-pass TF32 instance: f32 (kind kF32) at hd 128 and 256 alone.
BNB_EXPORT int bnb_flash_attention_causal_bwd_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                                                       const float* m, const float* l, const float* di, void* dk,
                                                       void* dv, float* part_k, float* part_v, const void* items,
                                                       int n_items, int B, int T, int H, int KVH, int hd,
                                                       long long sqb, long long sqt, long long skb, long long skt,
                                                       long long svb, long long svt, long long sdb, long long sdt,
                                                       float scale, int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || kind != kF32 || (hd != 128 && hd != 256) || n_items <= 0 || items == nullptr)
        return (int)cudaErrorInvalidValue;
    Params<float> p = make_params<float>(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt,
                                         scale);
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    const DkvItem* it = static_cast<const DkvItem*>(items);
    return hd == 128 ? launch_tf32_dkv<128>(p, B, it, n_items, part_k, part_v, stream)
                     : launch_tf32_dkv<256>(p, B, it, n_items, part_k, part_v, stream);
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
            if (hd == 128) return launch_dq<128>(p, B, stream);
            if (hd == 256) return launch_dq<256>(p, B, stream);
            return hd == 384 ? launch_dq<384>(p, B, stream) : launch_dq<512>(p, B, stream);
        }
    });
}

// The three-pass TF32 instance: f32 (kind kF32) at hd 128 and 256 alone.
BNB_EXPORT int bnb_flash_attention_causal_bwd_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                                                      const float* m, const float* l, const float* di, void* dq,
                                                      int B, int T, int H, int KVH, int hd, long long sqb,
                                                      long long sqt, long long skb, long long skt, long long svb,
                                                      long long svt, long long sdb, long long sdt, float scale,
                                                      int kind, cudaStream_t stream) {
    if (!shapes_ok(B, T, H, KVH, hd) || kind != kF32 || (hd != 128 && hd != 256)) return (int)cudaErrorInvalidValue;
    Params<float> p = make_params<float>(q, k, v, dout, m, l, di, T, H, KVH, sqb, sqt, skb, skt, svb, svt, sdb, sdt,
                                         scale);
    p.dq = static_cast<float*>(dq);
    return hd == 128 ? launch_tf32_dq<128>(p, B, stream) : launch_tf32_dq<256>(p, B, stream);
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
