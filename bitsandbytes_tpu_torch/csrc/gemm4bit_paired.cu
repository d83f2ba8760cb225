// 4-bit GEMM and dequantize over the N-paired payload layout.
//
// Payload: P[n2, k] (uint8, [N/2, K]) holds weight rows 2*n2 (high nibble)
// and 2*n2+1 (low nibble) at column k.  Scales: absmax_t[b, n] (f32,
// [K/blocksize, N]), one per row and quantization block of `blocksize`
// columns along K.
//
// Kernels 2 and 5 replace the TPU kernels gemm_4bit_paired (_paired_kernel)
// and gemm_4bit_paired_dq (_paired_kernel_dq) of the JAX package's
// ops/pallas/gemm4bit_paired.py:
//   out[M, N] = A[M, K] @ dequant(P)^T,   A bf16, f16 or f32
// with bf16-rounded unit codes, an f32 partial dot per quant block scaled by
// the block's f32 absmax, all sums in f32 (_subdot_accum).  Bound on the H100
// at decode M: bytes.  The payload (N*K/2 B) and the scales (N*K/blocksize*4
// B, or 1 B and a 256th of 4 B nested) dominate; A and out are small, and the
// products (2*M*N*K) are far under the tensor cores' rate, but not under the
// CUDA cores': at M 8 one layer's four linears take 0.052 ms of f32 FMAs
// against a 0.037 ms byte bound.
// bf16 and f16 A (blocksize % 32 == 0, every quantization blocksize) run
// gemm_4bit_paired_tc_kernel (below): the products on mma.sync, a payload
// byte decoded into A registers by one table load, a cp.async ring that keeps
// three stages of 128 rows x 128 columns in flight, the payload read once per
// call up to M 32 and A read from L2 once per 128 rows of N, K cut into at
// most 8 splits to fill the SMs.  What still holds it back is in PERF.md: a
// fixed cost per call, and the decode's shared-memory loads and issue slots
// (in probe builds the copies alone, without the decode, ran faster).
// f32 A has no exact tensor-core product (TF32 would break its contract), so
// it keeps gemm_4bit_paired_kernel, the CUDA-core body, as does a blocksize
// that is not a multiple of 32 (which the ops-level wrappers take with scales
// made by hand): A is read exactly in f32 (the TPU kernel splits an f32 A into
// bf16 hi + lo for its MXU).  One warp owns one row pair n2 and streams
// P[n2, :] with 8-byte loads along K (a warp reads 256 contiguous bytes per
// step).  A's rows are staged in shared memory in its own type, 32 KB a K
// tile (M*K*2 bytes does not fit at K = 14336), and reused by the block's 8
// warps.  The TPU kernel carries its sum across an ordered K grid axis; here
// the K loop runs inside the block and a warp shuffle reduces the lanes, so
// no block order is assumed.  Each block takes 8 rows of A; larger M is a
// grid dimension.
//
// dequantize_paired_kernel (kernel 3; kernel 6 on NestedScales) replaces
// dequantize_paired_fast (_paired_dequant_kernel) of the same file:
//   W[N, K] = dtype(unit(code) * absmax)   (the scale product in exact f32,
//                                            rounded to bf16, f16 or f32)
// Bound: bytes, most of them written: N*K/2 of payload and the scales are
// read, N*K*sizeof(dtype) written (78% of the bytes in bf16, 88% in f32), so
// the floor on this card is a store-only pass over W (zero_()).  A body that
// gives each thread one 8-byte load and its 16 outputs, a block per 2 KB of
// payload, holds near half the copy rate: in probe builds it kept most of its
// time without its stores and without its loads alike (latency per thread,
// not the write stream).  So a block owns a tile of 8 row pairs (one a warp)
// x 1024 columns.  Each lane issues its 4 (16-bit W) or 8 (f32 W) payload loads,
// 8 or 4 bytes each, before anything waits on them; meanwhile the block
// stages the tile's scales in shared memory, each read once, one a thread (a
// contiguous run of absmax_t along N for each quantization block, or its u8
// codes and s2 decoded through the 256-entry table).  Then each store
// instruction of a warp writes 512 contiguous bytes of one row of W (16 bytes
// a lane: whole 32-byte sectors, never one sector across two instructions).
// Probes on the card chose this (PERF.md §6) over a persistent grid that
// held the next tile's loads in registers (slower: its registers left
// fewer blocks on an SM), scales loaded by each lane (the nested instance slower,
// the more so the wider the tile), evict-first and TMA bulk stores (slower
// alone and before the matmul that reads W), and 8 columns a lane in f32
// (two 16-byte stores splitting sectors: far slower).  Every shape the wrappers
// take runs it: any even N, K % 8 == 0 (blocksize >= 8 divides K, so 8
// columns never straddle a quantization block), tiles partial in N or K
// masked.  What still holds it back: 43% over the store floor in bf16
// (gate_up 0.108 against 0.076 ms), the reads and the scale staging.
//
// The _dq entry points replace gemm_4bit_paired_dq (_paired_kernel_dq) and
// dequantize_paired_fast_dq (_paired_dequant_kernel_dq): the same two
// kernels with a double-quantized absmax decoded where the scale is loaded,
//   scale[kb, n] = fma(code2(u8_t[kb, n]), s2[(n*KB + kb) >> 8], offset)
// u8_t [K/blocksize, N] uint8 dynamic-map codes, s2 one f32 per 256 first-
// level blocks in flat (n-major) order, KB = K/blocksize.  code2 is the
// dynamic map's piecewise-linear segment decode, computed once per block
// into a 256-entry shared-memory table with a fused multiply-add, exactly as
// the JAX package's jitted decode rounds it (dynamic_segments.py); the scale
// is a second fused multiply-add.  So a nested state gives the bits of its
// resolved f32 absmax, and the kernels read 1 B of scale per 64 weights
// instead of 4 B.  The second-level index is computed per scale, so a column
// whose blocks cross a 256-boundary (KB = 224 for Llama's down) needs no
// precomputed planes; the TPU kernel builds those because it cannot gather.
//
// Kernels 7 and 8 replace gemm_4bit_paired_nt (_paired_nt_kernel) and, with
// the nested scales, gemm_4bit_paired_nt_dq (_paired_nt_kernel_dq): the
// 4-bit matmul backward
//   grad_A[M, K] = g[M, N] @ dequant(P)[N, K]
// with the TPU kernel's numerics (_nt_accum): for each K quantization block,
// g[m, n] (bf16, f16 or f32) times that block's scale of row n, rounded to
// bf16 unless g is f32, times the bf16-rounded unit code, summed over N in
// f32, the result cast to g's type.  Bound on the H100 at M <= 32: bytes (the
// payload N*K/2, its scales, g and the result; the products, 2*M*N*K, are far
// under the tensor cores' rate).  The TPU kernel runs its products on the
// MXU; here, for bf16 and f16 g, gemm_4bit_paired_nt_tc_kernel runs them as
// mma.sync.m16n8k16 (bf16 in, f32 accumulators), with the scale folded into
// the A operand exactly as _nt_accum folds it (A = bf16(g * scale), B = the
// unit codes, which are exact in bf16).  So one payload byte, two rows of one
// column, is one B register: a 256-entry shared-memory table, one copy per
// lane, turns it into the register with one conflict-free load.  A block owns 128 output
// columns and every row of g up to 32, so each payload byte is read and
// decoded once per call up to M 32, once per 32 rows above.  A four-stage
// cp.async ring keeps 128 rows of N a stage in flight (each row pair's 128
// contiguous payload bytes, its scales chunk-major, g's 128 columns); a
// nested state's u8 codes and second-level scales are staged as well and
// decoded in place before the stage's barrier.  The grid is ceil(K/128)
// column tiles x S splits of N x ceil(M/32), S <= 8 chosen by the wrapper to
// fill whole waves of SMs (ops/gemm4bit_paired.nt_plan); with S > 1 each
// split writes f32 partials and nt_reduce_kernel adds them in split order,
// so a call gives the same bits every run.  What still holds it back is in
// PERF.md: the payload stream, as for kernel 11 in gemm4bit.cu, whose tile
// body this kernel follows.
// f32 g has no exact tensor-core product (TF32 would break its contract), so
// it keeps the CUDA-core body gemm_4bit_paired_nt_kernel, as does a
// blocksize that is not a multiple of 32: each warp owns 256 columns, 8 a
// lane (8-byte payload loads), walks the block's rows two at a time with g
// staged in shared memory 1024 columns at a time, 8 rows of g a block; the
// grid splits N (ops/gemm4bit_paired._nt_splits) into f32 partials added in
// split order by the same second pass.
#include "common.cuh"

namespace {

constexpr int kGemmWarps = 8;    // row pairs per block
constexpr int kGemmMT = 8;       // rows of A per block
constexpr int kGemmTileBytes = 32768;  // A's staged K tile, all 8 rows
constexpr int kLaneCols = 8;     // payload bytes (columns) per lane and step

// Scales of a plain state: the f32 absmax, stored [K/blocksize, N].
struct F32Scales {
    static constexpr int kTable = 1;
    const float* absmax_t;
    int N;
    __device__ __forceinline__ void prologue(float*, int, int) const {}
    __device__ __forceinline__ float2 load(const float*, int blk, int n2) const {
        return *reinterpret_cast<const float2*>(absmax_t + (size_t)blk * N + 2 * n2);
    }
    // the dequantize's staging: the scale of row n in quantization block blk
    __device__ __forceinline__ float scale(const float*, int blk, int n) const {
        return absmax_t[(size_t)blk * N + n];
    }
    // the tensor-core kernel's staging: the scale at flat offset off (blk * N + n) into dst
    __device__ __forceinline__ void stage(float* dst, size_t off, bool live) const {
        cp_async4(dst, live ? absmax_t + off : absmax_t, live);
    }
};

// Scales of a double-quantized state, decoded where they are loaded.
struct NestedScales {
    static constexpr int kTable = 256;
    const uint8_t* codes_t;
    const float* s2;
    const float* offset;  // one float on the device: no host read per call
    int N;
    int KB;
    DynDecode dec;
    __device__ __forceinline__ void prologue(float* table, int tid, int nthreads) const {
        for (int i = tid; i < 256; i += nthreads) table[i] = dyn_decode(dec, i);
    }
    __device__ __forceinline__ float2 load(const float* table, int blk, int n2) const {
        const uchar2 q = *reinterpret_cast<const uchar2*>(codes_t + (size_t)blk * N + 2 * n2);
        const long long f = (long long)(2 * n2) * KB + blk;  // flat first-level block of row 2*n2
        const float off = __ldg(offset);
        return make_float2(__fmaf_rn(table[q.x], s2[f >> 8], off),
                           __fmaf_rn(table[q.y], s2[(f + KB) >> 8], off));
    }
    __device__ __forceinline__ float scale(const float* table, int blk, int n) const {
        const long long f = (long long)n * KB + blk;
        return __fmaf_rn(table[codes_t[(size_t)blk * N + n]], s2[f >> 8], __ldg(offset));
    }
    // the tensor-core kernel's decode of a staged code q and second-level scale s
    __device__ __forceinline__ float decode(const float* table, uint32_t q, float s, float off) const {
        return __fmaf_rn(table[q], s, off);
    }
};

template <class TA, class TOut, class Scales>
__global__ void __launch_bounds__(kGemmWarps * 32)
gemm_4bit_paired_kernel(const TA* __restrict__ A, const uint8_t* __restrict__ P,
                        Scales scales, TOut* __restrict__ out,
                        int M, int N, int K, int blocksize, Units16 units) {
    constexpr int kGemmKT = kGemmTileBytes / (kGemmMT * (int)sizeof(TA));  // 2048, or 1024 for f32
    constexpr int kVec = 16 / (int)sizeof(TA);  // elements per 16-byte copy
    __shared__ float s_units[16];
    __shared__ float s_table[Scales::kTable];
    __shared__ __align__(16) TA s_a[kGemmMT * kGemmKT];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 16) s_units[tid] = units.v[tid];
    scales.prologue(s_table, tid, kGemmWarps * 32);  // read after the first K tile's barrier

    const int n2 = blockIdx.x * kGemmWarps + warp;
    const bool active = n2 < (N >> 1);
    const int m0 = blockIdx.y * kGemmMT;
    const int mrows = min(kGemmMT, M - m0);
    const uint8_t* prow = P + (size_t)n2 * K;

    float acc_hi[kGemmMT];
    float acc_lo[kGemmMT];
#pragma unroll
    for (int m = 0; m < kGemmMT; ++m) acc_hi[m] = acc_lo[m] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kGemmKT) {
        const int kt = min(kGemmKT, K - k0);  // a multiple of 32: K % blocksize == 0, blocksize >= 32
        __syncthreads();  // the previous tile is consumed
        const int vecs = kt / kVec;
        for (int i = tid; i < mrows * vecs; i += kGemmWarps * 32) {
            const int m = i / vecs;
            const int v = i - m * vecs;
            *reinterpret_cast<uint4*>(s_a + m * kGemmKT + v * kVec) =
                *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k0 + v * kVec);
        }
        __syncthreads();
        if (!active) continue;

        for (int kk = lane * kLaneCols; kk < kt; kk += 32 * kLaneCols) {
            const uint2 pb = *reinterpret_cast<const uint2*>(prow + k0 + kk);
            const int blk = (k0 + kk) / blocksize;  // 8 columns never straddle a block
            const float2 sc = scales.load(s_table, blk, n2);
            float whi[kLaneCols], wlo[kLaneCols];
#pragma unroll
            for (int j = 0; j < kLaneCols; ++j) {
                const uint32_t word = j < 4 ? pb.x : pb.y;
                const uint32_t b = (word >> (8 * (j & 3))) & 0xFFu;
                whi[j] = s_units[b >> 4];
                wlo[j] = s_units[b & 15u];
            }
#pragma unroll
            for (int m = 0; m < kGemmMT; ++m) {
                if (m < mrows) {
                    float a[kLaneCols];
                    load8(s_a + m * kGemmKT + kk, a);
                    float shi = a[0] * whi[0];
                    shi += a[1] * whi[1]; shi += a[2] * whi[2]; shi += a[3] * whi[3];
                    shi += a[4] * whi[4]; shi += a[5] * whi[5]; shi += a[6] * whi[6];
                    shi += a[7] * whi[7];
                    float slo = a[0] * wlo[0];
                    slo += a[1] * wlo[1]; slo += a[2] * wlo[2]; slo += a[3] * wlo[3];
                    slo += a[4] * wlo[4]; slo += a[5] * wlo[5]; slo += a[6] * wlo[6];
                    slo += a[7] * wlo[7];
                    acc_hi[m] += shi * sc.x;
                    acc_lo[m] += slo * sc.y;
                }
            }
        }
    }

#pragma unroll
    for (int m = 0; m < kGemmMT; ++m) {
        acc_hi[m] = warp_sum(acc_hi[m]);
        acc_lo[m] = warp_sum(acc_lo[m]);
    }
    if (active && lane == 0) {
#pragma unroll
        for (int m = 0; m < kGemmMT; ++m) {
            if (m < mrows) {
                const size_t o = (size_t)(m0 + m) * N + 2 * n2;
                if constexpr (sizeof(TOut) == 4) {
                    *reinterpret_cast<float2*>(out + o) = make_float2(acc_hi[m], acc_lo[m]);
                } else {
                    *reinterpret_cast<uint32_t*>(out + o) = pack2<TOut>(acc_hi[m], acc_lo[m]);
                }
            }
        }
    }
}

// bf16 and f16 A with blocksize % 32 == 0: tensor cores (kernels 2 and 5).
// The weight is the mma's m16 operand and A the n8 operand, so the mma's
// reduction axis is K and its rows are N.  An m16 tile is 8 row pairs: row
// q is 2 n2 and row q + 8 is 2 n2 + 1, so the two nibbles of one payload
// byte are the same lane's rows q and q + 8.  Of each 32-column chunk, a
// lane (q = lane / 4, t = lane % 4) takes the payload bytes 8t..8t+3 of its
// row pair as the logical reduction indices 2t, 2t+1, 2t+8, 2t+9 of the
// chunk's first k16 step and 8t+4..8t+7 as those of its second (the same
// permutation for A, so the sum is unchanged): one 8-byte payload load is
// the A registers of two steps, each byte one load from a 256-entry table
// (byte -> its two unit codes in A's type, exact in bf16 and in f16; one copy
// per lane, entry b of lane l at word 32 b + l) and a byte permute per
// register, and one 16-byte load of a row of A is the B registers of both.
// The C fragment's rows are the row pair's two rows n, so a lane's scales of
// a quantization block are one float2, absmax_t[blk, 2 n2].
//   Per quantization block the k16 steps go into a zeroed fragment, which is
// then added into the running f32 sum times the block's f32 scale: the
// structure of _subdot_accum, and the same order for both scale loaders, so
// kernel 5 gives kernel 2's bits on the resolved absmax.
//   A block owns kFwTN = 128 rows of N (one m16 tile a warp: no cross-warp
// sum) and up to 32 rows of A (MI n8 tiles, zero rows padding M; above 32,
// M is a grid dimension), so the payload is read once per call up to M 32.
// A three-stage cp.async ring (two blocks resident on an SM at every MI;
// four stages, five, and 256-column stages were slower in probe builds)
// holds a stage of kFwTK = 128 columns: each row pair's
// 128 contiguous payload bytes, the scales of the stage's four 32-column
// chunks (slot c holds the scale of the quantization block that chunk c
// lies in, so the step that ends a block reads slot c), and A's 128 columns
// in its type.  A nested state's u8 codes and second-level scales are
// staged too and decoded in place by the thread that copied them, before the
// stage's barrier (kernel 8's way).  A is read from L2 once per 128 rows of
// N.  The grid is N/128 row tiles x S splits of K x ceil(M/32); S <= 8, whole
// quantization blocks and whole stages a split, chosen by the wrapper to fill
// the resident blocks of one wave (ops/gemm4bit_paired.gemm_plan); with S > 1
// each split writes f32 partials and nt_reduce_kernel adds them in split
// order, so a call gives the same bits every run.
constexpr int kFwWarps = 8;
constexpr int kFwThreads = kFwWarps * 32;
constexpr int kFwTN = 128;             // rows of N a block: one m16 tile a warp
constexpr int kFwTK = 128;             // columns of K a stage: eight k16 steps
constexpr int kFwMT = 32;              // rows of A a block
constexpr int kFwChunks = kFwTK / 32;  // 32-column chunks a stage: one scale slot each

// The four A registers of one k16 step from a payload word (bytes at the
// lane's logical k 2t, 2t+1, 2t+8, 2t+9): rows q (high nibbles, the table
// entries' low halves) and q + 8 (low nibbles).
__device__ __forceinline__ void a_from_word(const uint32_t* lp, uint32_t w, uint32_t* a) {
    const uint32_t t0 = lp[(w & 0xFFu) << 5], t1 = lp[((w >> 8) & 0xFFu) << 5];
    const uint32_t t2 = lp[((w >> 16) & 0xFFu) << 5], t3 = lp[(w >> 24) << 5];
    a[0] = __byte_perm(t0, t1, 0x5410);
    a[1] = __byte_perm(t0, t1, 0x7632);
    a[2] = __byte_perm(t2, t3, 0x5410);
    a[3] = __byte_perm(t2, t3, 0x7632);
}

template <class TA> __device__ __forceinline__ void mma_t(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    if constexpr (std::is_same<TA, __half>::value)
        mma_f16(c, a, b0, b1);
    else
        mma_bf16(c, a, b0, b1);
}

template <int MI>
struct FwLayout {
    static constexpr int kStages = 3;  // two blocks an SM at every MI (four were slower at M 8 and 16; PERF.md)
    static constexpr int kPayStride = kFwTK + 32;   // bytes a staged row pair: pairs 8 banks apart
    static constexpr int kAStride = kFwTK + 32;     // elements a staged row of A: rows 16 banks apart
    static_assert(kPayStride / 4 % 32 == 8 && kAStride * 2 / 4 % 32 == 16, "conflict-free fragment loads");
    static constexpr int kPay = (kFwTN / 2) * kPayStride;
    static constexpr int kSc = kFwChunks * kFwTN * 4;
    static constexpr int kCodes = kFwChunks * kFwTN;  // a nested state's u8 codes, as kSc
    static constexpr int kA = MI * 8 * kAStride * 2;
    static constexpr int kStage = kPay + kSc + kCodes + kA;
    static constexpr int kTables = 256 * 32 * 4 + 1024;  // s_pair (256 u32 x 32 lanes), the nested map (256 f32)
    static constexpr int kBytes = kTables + kStages * kStage;
    static_assert(kPay % 16 == 0 && kSc % 16 == 0 && kCodes % 16 == 0 && kA % 16 == 0, "16-byte aligned");
};

template <class TA, class Scales, int MI>
__global__ void __launch_bounds__(kFwThreads, 2)
gemm_4bit_paired_tc_kernel(const TA* __restrict__ A, const uint8_t* __restrict__ P, Scales scales,
                           float* __restrict__ part, void* __restrict__ out, int out_f32, int M, int N, int K,
                           int blocksize, int k_per_split, Units16 units) {
    using L = FwLayout<MI>;
    constexpr int kStages = L::kStages;
    constexpr bool kNested = Scales::kTable > 1;
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* s_pair = reinterpret_cast<uint32_t*>(smem);
    float* s_table = reinterpret_cast<float*>(smem + 256 * 32 * 4);
    unsigned char* ring = smem + L::kTables;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_lo = blockIdx.x * kFwTN;
    const int k_lo = blockIdx.y * k_per_split;  // whole quantization blocks and whole stages
    const int k_hi = min(K, k_lo + k_per_split);
    const int m0 = blockIdx.z * kFwMT;
    const int stages = (k_hi - k_lo + kFwTK - 1) / kFwTK;
    const int pairs = (min(N, n_lo + kFwTN) - n_lo) / 2;  // live row pairs of the tile

    // Copies, each thread's sources fixed but for a stride a stage: 16-byte
    // payload chunks (a row pair's in neighbouring lanes), A's 16-byte
    // chunks, and the scales of a slot's rows in neighbouring lanes.
    constexpr int kRowChunks = kFwTK / 16;
    constexpr int kPayCopies = (kFwTN / 2) * kRowChunks / kFwThreads;
    constexpr int kAChunks = MI * 8 * (kFwTK / 8);
    constexpr int kACopies = (kAChunks + kFwThreads - 1) / kFwThreads;
    const uint8_t* p_src[kPayCopies];
    int p_dst[kPayCopies], p_col[kPayCopies];
    bool p_ok[kPayCopies];
#pragma unroll
    for (int j = 0; j < kPayCopies; ++j) {
        const int i = tid + j * kFwThreads;
        const int pair = i / kRowChunks, c = i % kRowChunks;
        p_ok[j] = pair < pairs;
        p_col[j] = k_lo + 16 * c;  // K % 32 == 0: 16 columns are all in or all out
        p_src[j] = P + (size_t)(n_lo / 2 + pair) * K + k_lo + 16 * c;
        p_dst[j] = pair * L::kPayStride + 16 * c;
    }
    const TA* a_src[kACopies];
    int a_dst[kACopies], a_col[kACopies];
    bool a_ok[kACopies];
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
        const int i = tid + j * kFwThreads;
        const int m = i / (kFwTK / 8), c = i % (kFwTK / 8);
        a_ok[j] = m0 + m < M;
        a_col[j] = k_lo + 8 * c;
        a_src[j] = A + (size_t)(m0 + m) * K + k_lo + 8 * c;
        a_dst[j] = L::kPay + L::kSc + L::kCodes + (m * L::kAStride + 8 * c) * 2;
    }
    // Scale copies.  Plain: one 4-byte scale a copy.  Nested: a quad of four
    // rows of one slot a thread: its four u8 codes as one 4-byte copy (plain
    // loads where rows of codes_t are not 4-byte aligned) and its four
    // second-level scales.  Each copy walks its chunk's quantization block
    // along with the stages (blk, and rem: the chunk's place in the block),
    // so the stage loop divides by nothing.
    constexpr int kUnit = kNested ? 4 : 1;  // rows a scale copy covers
    constexpr int kUnitsAll = kFwChunks * kFwTN / kUnit;
    constexpr int kUnits = (kUnitsAll + kFwThreads - 1) / kFwThreads;
    const int per_blk = blocksize / 32;  // chunks a quantization block
    int s_blk[kUnits], s_rem[kUnits], s_col[kUnits], s_dst[kUnits], s_live[kUnits];
    size_t s_row[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
        const int i = tid + j * kFwThreads;
        const int c = i / (kFwTN / kUnit), r = (i % (kFwTN / kUnit)) * kUnit;
        const int chunk = k_lo / 32 + c;
        s_blk[j] = chunk / per_blk;
        s_rem[j] = chunk % per_blk;
        s_col[j] = k_lo + 32 * c;  // at stage 0
        s_dst[j] = c * kFwTN + r;
        s_row[j] = (size_t)n_lo + r;
        s_live[j] = i < kUnitsAll ? min(max(N - n_lo - r, 0), kUnit) : 0;  // live rows of the copy
    }
    const bool codes_vec = (N & 3) == 0;  // then a quad's rows are all live or all dead
    float offset = 0.0f;
    if constexpr (kNested) offset = __ldg(scales.offset);

    auto load = [&](int s, int slot) {
        unsigned char* st = ring + slot * L::kStage;
        const int ks = s * kFwTK;
#pragma unroll
        for (int j = 0; j < kPayCopies; ++j) {
            const bool live = p_ok[j] && p_col[j] + ks < k_hi;
            cp_async16(st + p_dst[j], live ? p_src[j] + ks : P, live);
        }
#pragma unroll
        for (int j = 0; j < kACopies; ++j) {
            if (kAChunks % kFwThreads && tid + j * kFwThreads >= kAChunks) continue;  // no zeros past the last
            const bool live = a_ok[j] && a_col[j] + ks < k_hi;
            cp_async16(st + a_dst[j], live ? a_src[j] + ks : A, live);
        }
#pragma unroll
        for (int j = 0; j < kUnits; ++j) {
            if (kUnitsAll % kFwThreads && tid + j * kFwThreads >= kUnitsAll) continue;
            const int live = s_col[j] + ks < k_hi ? s_live[j] : 0;
            float* sd = reinterpret_cast<float*>(st + L::kPay) + s_dst[j];
            if constexpr (kNested) {
                const size_t off = (size_t)s_blk[j] * scales.N + s_row[j];
                unsigned char* cd = st + L::kPay + L::kSc + s_dst[j];
                if (codes_vec) {
                    cp_async4(cd, live ? scales.codes_t + off : scales.codes_t, live > 0);
                } else {
#pragma unroll
                    for (int x = 0; x < 4; ++x) cd[x] = x < live ? scales.codes_t[off + x] : 0;
                }
                const long long f = (long long)s_row[j] * scales.KB + s_blk[j];  // flat first-level block
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    cp_async4(sd + x, x < live ? scales.s2 + ((f + x * scales.KB) >> 8) : scales.s2, x < live);
            } else {
                scales.stage(sd, (size_t)s_blk[j] * scales.N + s_row[j], live > 0);
            }
            // the next stage: this chunk 128 columns on
            s_rem[j] += kFwChunks;
            while (s_rem[j] >= per_blk) {
                s_rem[j] -= per_blk;
                ++s_blk[j];
            }
        }
    };
    // A nested stage's scales, decoded in place from this thread's own copies
    // (rows past N and chunks past the split are never read).
    auto decode = [&](int s) {
        if constexpr (kNested) {
            unsigned char* st = ring + (s % kStages) * L::kStage;
#pragma unroll
            for (int j = 0; j < kUnits; ++j) {
                const int live = s_col[j] + s * kFwTK < k_hi ? s_live[j] : 0;
                const uint32_t c4 = *reinterpret_cast<const uint32_t*>(st + L::kPay + L::kSc + s_dst[j]);
                float* sd = reinterpret_cast<float*>(st + L::kPay) + s_dst[j];
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    if (x < live) sd[x] = scales.decode(s_table, (c4 >> (8 * x)) & 0xFFu, sd[x], offset);
            }
        }
    };

    // the first stages in flight, then the tables (read after the loop's first barrier)
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < stages) load(s, s);
        cp_async_commit();
    }
    for (int i = tid; i < 256 * 32; i += kFwThreads) {
        const float hi = units.v[i >> 9], lo = units.v[(i >> 5) & 15];  // entry i >> 5, lane i & 31
        s_pair[i] = std::is_same<TA, __half>::value ? pack2<__half>(hi, lo) : pack_bf16x2(hi, lo);
    }
    scales.prologue(s_table, tid, kFwThreads);
    if constexpr (kNested) __syncthreads();  // the first decode reads the map before the loop's first barrier

    // This lane's part of the mma: m16 tile `warp` (row pairs 8 warp + q),
    // rows of A q of each n8 tile, and of each 32-column chunk the columns
    // 8t..8t+3 (its first k16 step) and 8t+4..8t+7 (its second): one 8-byte
    // payload load and one 16-byte load of a row of A feed two mma.
    const int q = lane >> 2, t = lane & 3;
    const uint32_t* lp = s_pair + lane;  // this lane's copy of the table
    const int chunks_per_blk = blocksize / 32;
    int left = chunks_per_blk;  // chunks to the end of the current quantization block
    float acc[MI][4], frag[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mi][x] = frag[mi][x] = 0.0f;

    for (int s = 0; s < stages; ++s) {
        cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
        decode(s);
        __syncthreads();  // stage s is complete everywhere; the slot of stage s - 1 is free
        const int nxt = s + kStages - 1;
        if (nxt < stages) load(nxt, nxt % kStages);
        cp_async_commit();

        const unsigned char* st = ring + (s % kStages) * L::kStage;
        const uint2* pw = reinterpret_cast<const uint2*>(st + (warp * 8 + q) * L::kPayStride) + t;
        const float* ssc = reinterpret_cast<const float*>(st + L::kPay) + 2 * (warp * 8 + q);
        const uint4* sa = reinterpret_cast<const uint4*>(st + L::kPay + L::kSc + L::kCodes) + q * (L::kAStride / 8) + t;
        auto chunk = [&](int c) {
            const uint2 w = pw[4 * c];
            uint32_t a0[4], a1[4];
            a_from_word(lp, w.x, a0);
            a_from_word(lp, w.y, a1);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                const uint4 b = sa[mi * L::kAStride + 4 * c];  // 8 rows a tile: mi * 8 * kAStride / 8
                mma_t<TA>(frag[mi], a0, b.x, b.y);
                mma_t<TA>(frag[mi], a1, b.z, b.w);
            }
            if (--left == 0) {  // the block ends with this chunk: its scales are in slot c
                const float2 sc = *reinterpret_cast<const float2*>(ssc + c * kFwTN);
#pragma unroll
                for (int mi = 0; mi < MI; ++mi) {
                    acc[mi][0] += frag[mi][0] * sc.x;
                    acc[mi][1] += frag[mi][1] * sc.x;
                    acc[mi][2] += frag[mi][2] * sc.y;
                    acc[mi][3] += frag[mi][3] * sc.y;
#pragma unroll
                    for (int x = 0; x < 4; ++x) frag[mi][x] = 0.0f;
                }
                left = chunks_per_blk;
            }
        };
        const int live = min(kFwTK, k_hi - k_lo - s * kFwTK) / 32;  // chunks inside the split
        if (live == kFwChunks) {
#pragma unroll
            for (int c = 0; c < kFwChunks; ++c) chunk(c);
        } else {
            for (int c = 0; c < live; ++c) chunk(c);
        }
    }
    cp_async_wait<0>();

    // c[h] and c[2 + h] are rows n and n + 1 of A's row 2t + h
    const int n = n_lo + 2 * (warp * 8 + q);
    if (n >= N) return;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + mi * 8 + 2 * t + h;
            if (m >= M) continue;
            const float lo = acc[mi][h], hi = acc[mi][2 + h];
            if (part)
                *reinterpret_cast<float2*>(part + ((size_t)blockIdx.y * M + m) * N + n) = make_float2(lo, hi);
            else if (out_f32)
                *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)m * N + n) = make_float2(lo, hi);
            else
                *reinterpret_cast<uint32_t*>(static_cast<TA*>(out) + (size_t)m * N + n) = pack2<TA>(lo, hi);
        }
}

// The dequantize's tile: 8 row pairs (one a warp) x 1024 columns, one tile a
// block, the grid one block a tile.
constexpr int kDqThreads = 256;
constexpr int kDqRows = kDqThreads / 32;   // row pairs a tile
constexpr int kDqCols = 1024;              // columns a tile
constexpr int kDqSlots = kDqCols / 8 + 1;  // quantization blocks a tile can touch (blocksize >= 8)

// A byte v of a lane's payload word.
__device__ __forceinline__ uint32_t payload_byte(uint32_t w, int v) { return (w >> (8 * v)) & 0xFFu; }
__device__ __forceinline__ uint32_t payload_byte(uint2 w, int v) { return payload_byte(v < 4 ? w.x : w.y, v & 3); }

template <class TOut, class Scales>
__global__ void __launch_bounds__(kDqThreads)
dequantize_paired_kernel(const uint8_t* __restrict__ P, Scales scales, TOut* __restrict__ W, int N, int K,
                         int blocksize, Units16 units) {
    constexpr int V = 16 / sizeof(TOut);   // columns of one store: 16 bytes of one row
    constexpr int U = kDqCols / (32 * V);  // a lane's stores a row in a tile
    using Word = std::conditional_t<V == 8, uint2, uint32_t>;  // the payload bytes of one store
    __shared__ float s_units[16];
    __shared__ float s_table[Scales::kTable];
    __shared__ __align__(8) float s_sc[kDqSlots * 2 * kDqRows];  // [quantization block][row of the tile]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tiles_k = (K + kDqCols - 1) / kDqCols;
    const int rg = blockIdx.x / tiles_k;
    const int k0 = (blockIdx.x - rg * tiles_k) * kDqCols;
    const int n2 = rg * kDqRows + warp;
    const bool live = n2 < (N >> 1);

    // the payload first: its loads are in flight while the scales are staged
    Word p[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int k = k0 + j * 32 * V + lane * V;
        if (live && k < K) p[j] = __ldcs(reinterpret_cast<const Word*>(P + (size_t)n2 * K + k));
    }
    if (threadIdx.x < 16) s_units[threadIdx.x] = units.v[threadIdx.x];
    scales.prologue(s_table, threadIdx.x, kDqThreads);
    __syncthreads();
    // the tile's scales, each read (and decoded) once: quantization blocks
    // first..first + slots - 1 of its 16 rows, neighbouring threads on neighbouring rows
    const int first = k0 / blocksize;
    const int slots = (min(k0 + kDqCols, K) - 1) / blocksize - first + 1;
    const int rows = min(2 * kDqRows, N - 2 * rg * kDqRows);
    for (int i = threadIdx.x; i < slots * 2 * kDqRows; i += kDqThreads) {
        const int r = i % (2 * kDqRows);
        if (r < rows) s_sc[i] = scales.scale(s_table, first + i / (2 * kDqRows), 2 * rg * kDqRows + r);
    }
    __syncthreads();
    if (!live) return;
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int k = k0 + j * 32 * V + lane * V;
        if (k < K) {
            const float2 s =
                *reinterpret_cast<const float2*>(s_sc + (k / blocksize - first) * 2 * kDqRows + 2 * warp);
            float hi[V], lo[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const uint32_t b = payload_byte(p[j], v);
                hi[v] = __fmul_rn(s_units[b >> 4], s.x);
                lo[v] = __fmul_rn(s_units[b & 15u], s.y);
            }
            store16(W + (size_t)(2 * n2) * K + k, hi);
            store16(W + (size_t)(2 * n2 + 1) * K + k, lo);
        }
    }
}

constexpr int kNtWarps = 8;
constexpr int kNtMT = 8;                            // rows of g per block
constexpr int kNtKT = kNtWarps * 32 * kLaneCols;    // 2048 columns of K per block
constexpr int kNtNC = 1024;                         // columns of g staged per step (32 KB f32)

// part[split, m, k]: block (kx, split, mt) sums rows [split*rows, ...) of N.
template <class TG, class Scales>
__global__ void __launch_bounds__(kNtWarps * 32)
gemm_4bit_paired_nt_kernel(const TG* __restrict__ G, const uint8_t* __restrict__ P, Scales scales,
                           float* __restrict__ part, int M, int N, int K, int blocksize,
                           int rows_per_split, Units16 units) {
    __shared__ float s_units[16];
    __shared__ float s_table[Scales::kTable];
    __shared__ float s_g[kNtMT * kNtNC];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 16) s_units[tid] = units.v[tid];
    scales.prologue(s_table, tid, kNtWarps * 32);  // read after the first staging barrier

    const int k = blockIdx.x * kNtKT + warp * 32 * kLaneCols + lane * kLaneCols;
    const bool active = k < K;  // K % 32 == 0: a lane's 8 columns are all in or all out
    const int blk = k / blocksize;  // 8 columns never straddle a block
    const int n_lo = blockIdx.y * rows_per_split;  // rows_per_split is even
    const int n_hi = min(N, n_lo + rows_per_split);
    const int m0 = blockIdx.z * kNtMT;
    const int mrows = min(kNtMT, M - m0);

    float acc[kNtMT][kLaneCols];
#pragma unroll
    for (int m = 0; m < kNtMT; ++m)
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) acc[m][j] = 0.0f;

    for (int c0 = n_lo; c0 < n_hi; c0 += kNtNC) {
        const int nc = min(kNtNC, n_hi - c0);  // even
        __syncthreads();  // the previous chunk is consumed
        for (int i = tid; i < kNtMT * nc; i += kNtWarps * 32) {
            const int m = i / nc;
            const int c = i - m * nc;
            float v = 0.0f;
            if (m < mrows) v = to_f32(G[(size_t)(m0 + m) * N + c0 + c]);
            s_g[m * kNtNC + c] = v;
        }
        __syncthreads();
        if (!active) continue;

#pragma unroll 2
        for (int r = 0; r < nc; r += 2) {
            const int n2 = (c0 + r) >> 1;
            const uint2 pb = *reinterpret_cast<const uint2*>(P + (size_t)n2 * K + k);
            const float2 sc = scales.load(s_table, blk, n2);
            float whi[kLaneCols], wlo[kLaneCols];
#pragma unroll
            for (int j = 0; j < kLaneCols; ++j) {
                const uint32_t word = j < 4 ? pb.x : pb.y;
                const uint32_t b = (word >> (8 * (j & 3))) & 0xFFu;
                whi[j] = s_units[b >> 4];
                wlo[j] = s_units[b & 15u];
            }
#pragma unroll
            for (int m = 0; m < kNtMT; ++m) {
                if (m < mrows) {
                    float ghi = __fmul_rn(s_g[m * kNtNC + r], sc.x);
                    float glo = __fmul_rn(s_g[m * kNtNC + r + 1], sc.y);
                    if constexpr (sizeof(TG) == 2) {  // bf16 or f16 g: the product rounds to bf16
                        ghi = round_to<__nv_bfloat16>(ghi);
                        glo = round_to<__nv_bfloat16>(glo);
                    }
#pragma unroll
                    for (int j = 0; j < kLaneCols; ++j) {
                        acc[m][j] += ghi * whi[j];
                        acc[m][j] += glo * wlo[j];
                    }
                }
            }
        }
    }
    if (!active) return;
#pragma unroll
    for (int m = 0; m < kNtMT; ++m) {
        if (m < mrows) {
            float* dst = part + ((size_t)blockIdx.y * M + m0 + m) * K + k;
            reinterpret_cast<float4*>(dst)[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        }
    }
}

// out[m, k] = sum over splits, in split order, of part[split, m, k].
template <class TOut>
__global__ void __launch_bounds__(256)
nt_reduce_kernel(const float* __restrict__ part, TOut* __restrict__ out, long long mk, int splits) {
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    if (i >= mk) return;
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s += part[(size_t)sp * mk + i];
    out[i] = from_f32<TOut>(s);
}

// bf16 and f16 g with blocksize % 32 == 0: tensor cores.  The mma's
// reduction axis is N.  A block owns kPtTK = 128 output columns (two column
// groups of 64, four warps each) and every row of g up to 32 (MI
// m16 tiles, zero rows padding M), and walks its split of N in stages of
// kPtTN rows.  Warp w takes column group w % kCH and the k16 groups w / kCH,
// w / kCH + kKG, ... of every stage.
//   B: one paired payload byte holds rows 2p (high nibble) and 2p+1 of one
// column, which is exactly a B fragment register once each unit code is
// bf16 (the low half is the even row): s_pair turns the byte into it with
// one shared-memory load, no arithmetic.  The table is held once per lane
// (entry b of lane l at word 32 b + l, 32 KB), so random bytes never meet in
// a bank (a single copy lost time to bank conflicts; PERF.md).  Lane (q = lane / 4, t = lane % 4)
// of a k16 group needs row pairs t and t + 4, and reads two 4-byte words of
// each: columns 4q..4q+3 and 32+4q..32+4q+3 of its warp's 64.  So n8 tile e
// holds the columns 4j + e (e < 4) or 32 + 4j + e - 4 (e >= 4) of logical
// column j, and each tile lies inside one 32-column chunk, which lies inside
// one quantization block; the epilogue undoes the permutation.
//   A: g * scale rounded to bf16, _nt_accum's numerics.  A lane's A
// fragment is g at its rows q, q+8 and reduction indices 2t, 2t+1, 2t+8,
// 2t+9, the rows of the same two row pairs, times their scales at its
// chunk's quantization block: one fragment set per block, two where the
// warp's two chunks fall in different blocks (blocksize 32, or 96, ...).
//   A four-stage cp.async ring holds a stage's payload (16-byte copies of
// each row pair's kPtTK contiguous bytes), its scales chunk-major (one slot per
// quantization block the tile touches, kPtTN scales a slot) and g's kPtTN
// columns.  A nested state's u8 codes and their second-level scales are
// staged too, and decoded in place (NestedScales, the bits of the resolved
// absmax) by the thread that copied them, between its wait and the barrier.  Rows
// past the split stage zeros in g and in the scales, so their A is 0.
constexpr int kPtWarps = 8;
constexpr int kPtThreads = kPtWarps * 32;
constexpr int kPtTK = 128;          // output columns a block (256 was slower at M 16; PERF.md)
constexpr int kPtTN = 128;          // rows of N a stage: eight k16 groups, 64 row pairs
constexpr int kPtMT = 32;           // rows of g a block
constexpr int kPtStages = 4;        // cp.async ring depth
constexpr int kPtGStride = kPtTN + 8;  // elements a staged row of g (conflict-free A reads)

template <int MI>
struct PtLayout {
    static constexpr int kCH = kPtTK / 64;         // column groups, one warp each
    static constexpr int kKG = kPtWarps / kCH;  // warps of a column group
    static constexpr int kChunks = kPtTK / 32;     // 32-column chunks: at most this many quant blocks
    static constexpr int kPayStride = kPtTK + 32;  // bytes a staged row pair: 4 pairs apart shift the banks by 8
    static_assert(kPayStride / 4 % 32 == 8, "conflict-free payload words");
    static constexpr int kPay = (kPtTN / 2) * kPayStride;
    static constexpr int kSc = kChunks * kPtTN * 4;
    static constexpr int kG = MI * 16 * kPtGStride * 2;
    static constexpr int kCodes = kChunks * kPtTN;  // a nested state's u8 codes, as kSc
    static constexpr int kStage = kPay + kSc + kG + kCodes;
    static constexpr int kTables = 256 * 32 * 4 + 1024;  // s_pair (256 u32 x 32 lanes), the nested map (256 f32)
    static constexpr int kRedStride = kPtTK + 1;   // f32 a row of a warp's sums (conflict-free stores)
    static constexpr int kRed = kKG * MI * 16 * kRedStride * 4;
    static constexpr int kBytes = kTables + (kPtStages * kStage > kRed ? kPtStages * kStage : kRed);
    static_assert(kPay % 16 == 0 && kSc % 16 == 0 && kG % 16 == 0 && kStage % 16 == 0, "16-byte aligned");
};

// Two 16-bit g values (a 4-byte pair, low address first) as f32.
template <class T> __device__ __forceinline__ float2 pair_f32(uint32_t w) {
    if constexpr (std::is_same<T, __half>::value) {
        return __half22float2(*reinterpret_cast<const __half2*>(&w));
    } else {
        return unpack_bf16x2(w);
    }
}

// The A fragment of one m16 tile: g words (row q: cols 2t and 2t+8; row q+8:
// the same) times the scales of rows (2t, 2t+1) and (2t+8, 2t+9), bf16.
template <class TG>
__device__ __forceinline__ void a_fragment(const uint32_t* gw, float2 slo, float2 shi, uint32_t* a) {
    const float2 g0 = pair_f32<TG>(gw[0]), g1 = pair_f32<TG>(gw[1]);  // row q
    const float2 g2 = pair_f32<TG>(gw[2]), g3 = pair_f32<TG>(gw[3]);  // row q + 8
    a[0] = pack_bf16x2(__fmul_rn(g0.x, slo.x), __fmul_rn(g0.y, slo.y));
    a[1] = pack_bf16x2(__fmul_rn(g2.x, slo.x), __fmul_rn(g2.y, slo.y));
    a[2] = pack_bf16x2(__fmul_rn(g1.x, shi.x), __fmul_rn(g1.y, shi.y));
    a[3] = pack_bf16x2(__fmul_rn(g3.x, shi.x), __fmul_rn(g3.y, shi.y));
}

template <class TG, class Scales, int MI>
__global__ void __launch_bounds__(kPtThreads, MI == 1 ? 2 : 1)
gemm_4bit_paired_nt_tc_kernel(const TG* __restrict__ G, const uint8_t* __restrict__ P, Scales scales,
                              float* __restrict__ part, TG* __restrict__ out, int M, int N, int K,
                              int blocksize, int rows_per_split, Units16 units) {
    using L = PtLayout<MI>;
    constexpr bool kNested = Scales::kTable > 1;
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* s_pair = reinterpret_cast<uint32_t*>(smem);
    float* s_table = reinterpret_cast<float*>(smem + 256 * 32 * 4);
    unsigned char* ring = smem + L::kTables;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int i = tid; i < 256 * 32; i += kPtThreads) s_pair[i] = pack_bf16x2(units.v[i >> 9], units.v[(i >> 5) & 15]);
    scales.prologue(s_table, tid, kPtThreads);
    if constexpr (kNested) __syncthreads();  // the first decode reads the map before the loop's first barrier

    const int k0 = blockIdx.x * kPtTK;
    const int n_lo = blockIdx.y * rows_per_split;  // a multiple of 64
    const int n_hi = min(N, n_lo + rows_per_split);
    const int m0 = blockIdx.z * kPtMT;
    const int stages = (n_hi - n_lo + kPtTN - 1) / kPtTN;
    const int blk0 = k0 / blocksize;
    const int nblk = (min(K, k0 + kPtTK) - 1) / blocksize - blk0 + 1;  // quant blocks of the tile's columns
    const int KB = K / blocksize;
    const bool g_vec = (N & 7) == 0;  // rows of g 16-byte aligned: cp.async, else plain loads

    // Copies, each thread's sources fixed but for a stride a stage: 16-byte
    // payload chunks (a row pair's in neighbouring lanes), 4-byte scales
    // (a slot's rows in neighbouring lanes) and g's 16-byte chunks.
    constexpr int kRowCopies = kPtTK / 16;
    constexpr int kPayCopies = (kPtTN / 2) * kRowCopies / kPtThreads;
    constexpr int kGChunks = MI * 16 * (kPtTN / 8);
    constexpr int kGCopies = (kGChunks + kPtThreads - 1) / kPtThreads;
    const uint8_t* p_src[kPayCopies];
    int p_pair[kPayCopies], p_dst[kPayCopies];
    bool p_ok[kPayCopies];
#pragma unroll
    for (int j = 0; j < kPayCopies; ++j) {
        const int i = tid + j * kPtThreads;
        const int c = i % kRowCopies;
        p_pair[j] = i / kRowCopies;
        p_ok[j] = k0 + 16 * c < K;  // K % 32 == 0: 16 columns are all in or all out
        p_src[j] = P + (size_t)(n_lo / 2 + p_pair[j]) * K + k0 + 16 * c;
        p_dst[j] = p_pair[j] * L::kPayStride + 16 * c;
    }
    // Scale copies.  Plain: one 4-byte scale a copy, a slot's rows in
    // neighbouring lanes.  Nested: a quad of four rows of one slot a thread:
    // its four u8 codes as one 4-byte copy (plain loads where rows of codes_t
    // are not 4-byte aligned) and its four second-level scales, decoded in
    // place by the same thread once its copies have landed.  No load is held
    // in a register across a barrier: that cost a stage's latency (PERF.md).
    constexpr int kUnit = kNested ? 4 : 1;  // rows a scale copy covers
    constexpr int kUnitsAll = L::kChunks * kPtTN / kUnit;
    constexpr int kUnits = (kUnitsAll + kPtThreads - 1) / kPtThreads;
    size_t s_off[kUnits];
    long long s_flat[kUnits];
    int s_row[kUnits], s_dst[kUnits];
    bool s_ok[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
        const int i = tid + j * kPtThreads;
        const int b = i / (kPtTN / kUnit);  // the slot: quant block blk0 + b
        s_row[j] = (i % (kPtTN / kUnit)) * kUnit;
        s_ok[j] = i < kUnitsAll && b < nblk;
        s_dst[j] = b * kPtTN + s_row[j];
        s_off[j] = (size_t)(blk0 + b) * N + n_lo + s_row[j];
        s_flat[j] = (long long)(n_lo + s_row[j]) * KB + blk0 + b;
    }
    const bool codes_vec = (N & 3) == 0;  // then a quad's rows are all live or all dead
    const TG* g_src[kGCopies];
    int g_col[kGCopies], g_dst[kGCopies];
    bool g_ok[kGCopies];
#pragma unroll
    for (int j = 0; j < kGCopies; ++j) {
        const int i = tid + j * kPtThreads;
        const int m = i / (kPtTN / 8);
        g_col[j] = (i % (kPtTN / 8)) * 8;
        g_ok[j] = i < kGChunks && m0 + m < M;
        g_src[j] = G + (size_t)(m0 + m) * N + n_lo + g_col[j];
        g_dst[j] = L::kPay + L::kSc + (m * kPtGStride + g_col[j]) * 2;
    }
    const size_t p_step = (size_t)(kPtTN / 2) * K;
    const long long f_step = (long long)kPtTN * KB;
    float offset = 0.0f;
    if constexpr (kNested) offset = __ldg(scales.offset);

    auto load = [&](int s, int slot) {
        unsigned char* st = ring + slot * L::kStage;
        const int rem = n_hi - (n_lo + s * kPtTN);  // rows of this stage inside the split
#pragma unroll
        for (int j = 0; j < kPayCopies; ++j) {
            const bool live = p_ok[j] && 2 * p_pair[j] < rem;
            cp_async16(st + p_dst[j], live ? p_src[j] + s * p_step : P, live);
        }
#pragma unroll
        for (int j = 0; j < kUnits; ++j) {
            // a copy with nothing to read still writes its zeros: none past the last unit
            if (kUnitsAll % kPtThreads && tid + j * kPtThreads >= kUnitsAll) continue;
            const int live = s_ok[j] ? min(max(rem - s_row[j], 0), kUnit) : 0;  // live rows of the copy
            const size_t off = s_off[j] + (size_t)s * kPtTN;
            float* sd = reinterpret_cast<float*>(st + L::kPay) + s_dst[j];
            if constexpr (kNested) {
                unsigned char* cd = st + L::kPay + L::kSc + L::kG + s_dst[j];
                const long long f = s_flat[j] + s * f_step;
                if (codes_vec) {
                    cp_async4(cd, live ? scales.codes_t + off : scales.codes_t, live > 0);
                } else {
#pragma unroll
                    for (int x = 0; x < 4; ++x) cd[x] = x < live ? scales.codes_t[off + x] : 0;
                }
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    cp_async4(sd + x, x < live ? scales.s2 + ((f + x * KB) >> 8) : scales.s2, x < live);
            } else {
                scales.stage(sd, off, live > 0);
            }
        }
        if (g_vec) {
#pragma unroll
            for (int j = 0; j < kGCopies; ++j) {
                if (j * kPtThreads + tid < kGChunks) {
                    const bool live = g_ok[j] && g_col[j] < rem;  // rem is a multiple of 8 or all of a stage
                    cp_async16(st + g_dst[j], live ? g_src[j] + s * kPtTN : G, live);
                }
            }
        } else {
            const int n0 = n_lo + s * kPtTN;
            TG* sg = reinterpret_cast<TG*>(st + L::kPay + L::kSc);
            for (int j = tid; j < MI * 16 * kPtTN; j += kPtThreads) {
                const int m = j / kPtTN, c = j % kPtTN;
                sg[m * kPtGStride + c] =
                    m0 + m < M && n0 + c < n_hi ? G[(size_t)(m0 + m) * N + n0 + c] : from_f32<TG>(0.0f);
            }
        }
    };
    // A nested stage's scales, decoded in place from this thread's own copies
    // (dead rows 0).
    auto decode = [&](int s) {
        if constexpr (kNested) {
            unsigned char* st = ring + (s % kPtStages) * L::kStage;
            const int rem = n_hi - (n_lo + s * kPtTN);
#pragma unroll
            for (int j = 0; j < kUnits; ++j) {
                if (!s_ok[j]) continue;
                const int live = min(max(rem - s_row[j], 0), 4);
                const uint32_t c4 = *reinterpret_cast<const uint32_t*>(st + L::kPay + L::kSc + L::kG + s_dst[j]);
                float* sd = reinterpret_cast<float*>(st + L::kPay) + s_dst[j];
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    sd[x] = x < live ? scales.decode(s_table, (c4 >> (8 * x)) & 0xFFu, sd[x], offset) : 0.0f;
            }
        }
    };

    // This thread's part of the mma: column group ch, k16 groups kg + kKG i, lane (q, t).
    const int ch = warp % L::kCH, kg = warp / L::kCH;
    const int q = lane >> 2, t = lane & 3;
    const int slot0 = (k0 + 64 * ch) / blocksize - blk0;       // quant block of the warp's chunk 0
    const int slot1 = (k0 + 64 * ch + 32) / blocksize - blk0;  // and of its chunk 1
    const bool two = slot0 != slot1;                           // the same for the whole warp

    float acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[mi][e][x] = 0.0f;

#pragma unroll
    for (int s = 0; s < kPtStages - 1; ++s) {
        if (s < stages) load(s, s);
        cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
        cp_async_wait<kPtStages - 2>();  // this thread's copies of stage s have landed
        decode(s);
        __syncthreads();  // stage s is complete everywhere; the slot of stage s - 1 is free
        const int nxt = s + kPtStages - 1;
        if (nxt < stages) load(nxt, nxt % kPtStages);
        cp_async_commit();

        const unsigned char* st = ring + (s % kPtStages) * L::kStage;
        const float* ssc = reinterpret_cast<const float*>(st + L::kPay);
        const uint32_t* sg = reinterpret_cast<const uint32_t*>(st + L::kPay + L::kSc);  // g pairs
#pragma unroll
        for (int i = 0; i < 8 / L::kKG; ++i) {
            const int grp = kg + L::kKG * i;
            const uint32_t* pw =
                reinterpret_cast<const uint32_t*>(st + (grp * 8 + t) * L::kPayStride + ch * 64) + q;
            // pair t: chunk 0, chunk 1; pair t + 4 (4 pairs = kPayStride words on)
            const uint32_t w00 = pw[0], w01 = pw[8], w10 = pw[L::kPayStride], w11 = pw[L::kPayStride + 8];
            uint32_t b0[8], b1[8];
            const uint32_t* lp = s_pair + lane;  // this lane's copy of the table
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                b0[j] = lp[((w00 >> (8 * j)) & 0xFFu) << 5];
                b0[4 + j] = lp[((w01 >> (8 * j)) & 0xFFu) << 5];
                b1[j] = lp[((w10 >> (8 * j)) & 0xFFu) << 5];
                b1[4 + j] = lp[((w11 >> (8 * j)) & 0xFFu) << 5];
            }
            const int r = grp * 16 + 2 * t;  // rows r, r + 1, r + 8, r + 9 of the stage
            const float2 lo0 = *reinterpret_cast<const float2*>(ssc + slot0 * kPtTN + r);
            const float2 hi0 = *reinterpret_cast<const float2*>(ssc + slot0 * kPtTN + r + 8);
            float2 lo1 = lo0, hi1 = hi0;
            if (two) {
                lo1 = *reinterpret_cast<const float2*>(ssc + slot1 * kPtTN + r);
                hi1 = *reinterpret_cast<const float2*>(ssc + slot1 * kPtTN + r + 8);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                const uint32_t* gq = sg + (mi * 16 + q) * (kPtGStride / 2) + r / 2;
                const uint32_t gw[4] = {gq[0], gq[4], gq[8 * (kPtGStride / 2)], gq[8 * (kPtGStride / 2) + 4]};
                uint32_t a0[4], a1[4];
                a_fragment<TG>(gw, lo0, hi0, a0);
                if (two) {
                    a_fragment<TG>(gw, lo1, hi1, a1);
                } else {
#pragma unroll
                    for (int x = 0; x < 4; ++x) a1[x] = a0[x];
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) mma_bf16(acc[mi][e], a0, b0[e], b1[e]);
#pragma unroll
                for (int e = 4; e < 8; ++e) mma_bf16(acc[mi][e], a1, b0[e], b1[e]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the warps' sums now

    // red[kg][m][column]: logical column j = 2t + x of tile e is the physical
    // column 32 (e / 4) + 4j + e % 4 of the warp's 64.
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                    const int row = kg * MI * 16 + mi * 16 + q + 8 * h;
                    const int col = ch * 64 + 32 * (e >> 2) + 8 * t + 4 * x + (e & 3);
                    red[row * L::kRedStride + col] = acc[mi][e][2 * h + x];
                }
    __syncthreads();
    for (int i = tid; i < MI * 16 * kPtTK; i += kPtThreads) {
        const int m = i / kPtTK, c = i % kPtTK;
        const int k = k0 + c;
        if (m0 + m >= M || k >= K) continue;
        float v = red[m * L::kRedStride + c];
#pragma unroll
        for (int g = 1; g < L::kKG; ++g) v += red[(g * MI * 16 + m) * L::kRedStride + c];  // warp order
        if (part)
            part[((size_t)blockIdx.y * M + m0 + m) * K + k] = v;
        else
            out[(size_t)(m0 + m) * K + k] = from_f32<TG>(v);
    }
}

Units16 load_units(const float* units) {
    Units16 u;
    for (int i = 0; i < 16; ++i) u.v[i] = units[i];
    return u;
}

bool gemm_shape_ok(int M, int N, int K, int blocksize) {
    return M > 0 && N % 2 == 0 && blocksize >= 32 && blocksize % 8 == 0 && K % blocksize == 0;
}

bool dequant_shape_ok(int N, int K, int blocksize) {
    return N % 2 == 0 && blocksize >= 8 && blocksize % 8 == 0 && K % blocksize == 0;
}

template <class TA, class TOut, class Scales>
void launch_gemm_t(const void* A, const uint8_t* P, const Scales& sc, void* out, int M, int N, int K,
                   int blocksize, const Units16& u, cudaStream_t stream) {
    const dim3 grid((N / 2 + kGemmWarps - 1) / kGemmWarps, (M + kGemmMT - 1) / kGemmMT);
    gemm_4bit_paired_kernel<TA, TOut, Scales><<<grid, kGemmWarps * 32, 0, stream>>>(
        static_cast<const TA*>(A), P, sc, static_cast<TOut*>(out), M, N, K, blocksize, u);
}

template <class TA, class Scales, int MI>
int launch_gemm_tc(const void* A, const uint8_t* P, const Scales& sc, float* part, void* out, int out_f32, int M,
                   int N, int K, int blocksize, int k_per_split, int splits, const Units16& u, cudaStream_t stream) {
    using L = FwLayout<MI>;
    const cudaError_t e = cudaFuncSetAttribute(gemm_4bit_paired_tc_kernel<TA, Scales, MI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + kFwTN - 1) / kFwTN, splits, (M + kFwMT - 1) / kFwMT);
    gemm_4bit_paired_tc_kernel<TA, Scales, MI><<<grid, kFwThreads, L::kBytes, stream>>>(
        static_cast<const TA*>(A), P, sc, splits > 1 ? part : nullptr, out, out_f32, M, N, K, blocksize,
        k_per_split, u);
    if (splits > 1) {  // queued at once behind it: no host round trip between the two
        const long long mn = (long long)M * N;
        const unsigned blocks = (unsigned)((mn + 255) / 256);
        if (out_f32)
            nt_reduce_kernel<float><<<blocks, 256, 0, stream>>>(part, static_cast<float*>(out), mn, splits);
        else
            nt_reduce_kernel<TA><<<blocks, 256, 0, stream>>>(part, static_cast<TA*>(out), mn, splits);
    }
    return (int)cudaGetLastError();
}

template <class TA, class Scales>
int launch_gemm_tc_m(const void* A, const uint8_t* P, const Scales& sc, float* part, void* out, int out_f32, int M,
                     int N, int K, int blocksize, int k_per_split, int splits, const Units16& u,
                     cudaStream_t stream) {
    if (M <= 8)
        return launch_gemm_tc<TA, Scales, 1>(A, P, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits,
                                             u, stream);
    if (M <= 16)
        return launch_gemm_tc<TA, Scales, 2>(A, P, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits,
                                             u, stream);
    return launch_gemm_tc<TA, Scales, 4>(A, P, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits, u,
                                         stream);
}

// The shapes and the split plan, checked before anything is read: splits of
// K covering it, none empty.  The caller chooses the kernel (tc,
// ops/gemm4bit_paired._gemm_uses_tc); the tensor-core one takes 16-bit A,
// blocksize % 32 == 0, splits of whole quantization blocks and whole stages
// (k_per_split a multiple of both) and partials for more than one split; the
// CUDA-core one one split.
bool gemm_args_ok(int M, int N, int K, int blocksize, int k_per_split, int splits, int tc, const float* part,
                  int a_kind) {
    if (!gemm_shape_ok(M, N, K, blocksize) || k_per_split < 1 || splits < 1
        || (long long)k_per_split * (splits - 1) >= K || (long long)k_per_split * splits < K)
        return false;
    if (a_kind != kF32 && a_kind != kBf16 && a_kind != kF16) return false;
    if (tc)
        return a_kind != kF32 && blocksize % 32 == 0 && k_per_split % blocksize == 0 && k_per_split % kFwTK == 0
               && (splits == 1 || part != nullptr);
    return splits == 1;
}

// out in A's type, or f32 when out_f32 (an f32 A writes f32).
template <class Scales>
int launch_gemm(const void* A, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N, int K,
                int blocksize, int k_per_split, int splits, int tc, const float* units, int a_kind, int out_f32,
                cudaStream_t stream) {
    const Units16 u = load_units(units);
    if (tc) {
        if (a_kind == kBf16)
            return launch_gemm_tc_m<__nv_bfloat16>(A, P, sc, part, out, out_f32, M, N, K, blocksize, k_per_split,
                                                   splits, u, stream);
        return launch_gemm_tc_m<__half>(A, P, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits, u,
                                        stream);
    }
    switch (a_kind) {
        case kF32: launch_gemm_t<float, float>(A, P, sc, out, M, N, K, blocksize, u, stream); break;
        case kBf16:
            if (out_f32) launch_gemm_t<__nv_bfloat16, float>(A, P, sc, out, M, N, K, blocksize, u, stream);
            else launch_gemm_t<__nv_bfloat16, __nv_bfloat16>(A, P, sc, out, M, N, K, blocksize, u, stream);
            break;
        default:
            if (out_f32) launch_gemm_t<__half, float>(A, P, sc, out, M, N, K, blocksize, u, stream);
            else launch_gemm_t<__half, __half>(A, P, sc, out, M, N, K, blocksize, u, stream);
    }
    return (int)cudaGetLastError();
}

template <class TOut, class Scales>
void launch_dequant_t(const uint8_t* P, const Scales& sc, void* W, int N, int K, int blocksize,
                      const Units16& u, cudaStream_t stream) {
    const long long tiles = (long long)((N / 2 + kDqRows - 1) / kDqRows) * ((K + kDqCols - 1) / kDqCols);
    if (tiles > 0)
        dequantize_paired_kernel<TOut, Scales><<<(unsigned)tiles, kDqThreads, 0, stream>>>(
            P, sc, static_cast<TOut*>(W), N, K, blocksize, u);
}

template <class Scales>
int launch_dequant(const uint8_t* P, const Scales& sc, void* W, int N, int K, int blocksize,
                   const float* units, int out_kind, cudaStream_t stream) {
    const Units16 u = load_units(units);
    switch (out_kind) {
        case kF32: launch_dequant_t<float>(P, sc, W, N, K, blocksize, u, stream); break;
        case kBf16: launch_dequant_t<__nv_bfloat16>(P, sc, W, N, K, blocksize, u, stream); break;
        case kF16: launch_dequant_t<__half>(P, sc, W, N, K, blocksize, u, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <class TG, class Scales>
void launch_nt_t(const void* G, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N,
                 int K, int blocksize, int rows_per_split, int splits, const Units16& u, cudaStream_t stream) {
    const dim3 grid((K + kNtKT - 1) / kNtKT, splits, (M + kNtMT - 1) / kNtMT);
    gemm_4bit_paired_nt_kernel<TG, Scales><<<grid, kNtWarps * 32, 0, stream>>>(
        static_cast<const TG*>(G), P, sc, part, M, N, K, blocksize, rows_per_split, u);
    const long long mk = (long long)M * K;
    nt_reduce_kernel<TG><<<(unsigned)((mk + 255) / 256), 256, 0, stream>>>(part, static_cast<TG*>(out), mk,
                                                                           splits);
}

template <class TG, class Scales, int MI>
int launch_nt_tc(const void* G, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N, int K,
                 int blocksize, int rows_per_split, int splits, const Units16& u, cudaStream_t stream) {
    using L = PtLayout<MI>;
    const cudaError_t e = cudaFuncSetAttribute(gemm_4bit_paired_nt_tc_kernel<TG, Scales, MI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((K + kPtTK - 1) / kPtTK, splits, (M + kPtMT - 1) / kPtMT);
    gemm_4bit_paired_nt_tc_kernel<TG, Scales, MI><<<grid, kPtThreads, L::kBytes, stream>>>(
        static_cast<const TG*>(G), P, sc, splits > 1 ? part : nullptr, static_cast<TG*>(out), M, N, K, blocksize,
        rows_per_split, u);
    if (splits > 1) {  // queued at once behind it: no host round trip between the two
        const long long mk = (long long)M * K;
        nt_reduce_kernel<TG><<<(unsigned)((mk + 255) / 256), 256, 0, stream>>>(part, static_cast<TG*>(out), mk,
                                                                               splits);
    }
    return (int)cudaGetLastError();
}

template <class TG, class Scales>
int launch_nt_tc_m(const void* G, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N, int K,
                   int blocksize, int rows_per_split, int splits, const Units16& u, cudaStream_t stream) {
    if (M <= 16)
        return launch_nt_tc<TG, Scales, 1>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream);
    return launch_nt_tc<TG, Scales, 2>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream);
}

// The shapes and the split plan, checked before anything is read: rows of
// whole quant blocks; splits of even rows covering N, none empty.  The
// caller chooses the kernel (tc, ops/gemm4bit_paired._nt_uses_tc); the
// tensor-core one takes 16-bit g, blocksize % 32 == 0, rows_per_split % 64
// == 0 (g's 16-byte copies start aligned) and partials for more than one
// split, the CUDA-core one partials always.
bool nt_args_ok(int M, int N, int K, int blocksize, int rows_per_split, int splits, int tc, const float* part,
                int g_kind) {
    if (!gemm_shape_ok(M, N, K, blocksize) || rows_per_split < 2 || rows_per_split % 2 || splits < 1
        || (long long)rows_per_split * (splits - 1) >= N || (long long)rows_per_split * splits < N)
        return false;
    if (g_kind != kF32 && g_kind != kBf16 && g_kind != kF16) return false;
    if (tc)
        return g_kind != kF32 && blocksize % 32 == 0 && rows_per_split % 64 == 0 && (splits == 1 || part != nullptr);
    return part != nullptr;
}

template <class Scales>
int launch_nt(const void* G, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N,
              int K, int blocksize, int rows_per_split, int splits, int tc, const float* units, int g_kind,
              cudaStream_t stream) {
    const Units16 u = load_units(units);
    if (tc) {
        if (g_kind == kBf16)
            return launch_nt_tc_m<__nv_bfloat16>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u,
                                                 stream);
        return launch_nt_tc_m<__half>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream);
    }
    switch (g_kind) {
        case kF32: launch_nt_t<float>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream); break;
        case kBf16:
            launch_nt_t<__nv_bfloat16>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream);
            break;
        default: launch_nt_t<__half>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream);
    }
    return (int)cudaGetLastError();
}

bool nested_scales(const uint8_t* codes_t, const float* s2, const float* offset, int N, int K,
                   int blocksize, const DynDecode* dec, NestedScales* out) {
    if (dec->nseg < 1 || dec->nseg > kMaxSegments) return false;
    out->codes_t = codes_t;
    out->s2 = s2;
    out->offset = offset;
    out->N = N;
    out->KB = K / blocksize;
    out->dec = *dec;
    return true;
}

}  // namespace

// A [M, K] (a_kind: 0 f32, 1 bf16, 2 f16); out [M, N] in A's type, or f32 when
// out_f32.  Columns [s*k_per_split, (s+1)*k_per_split) of K go to split s.
// tc != 0 runs the tensor-core kernel, which takes bf16 and f16 A at
// blocksize % 32 == 0 and splits of whole quantization blocks and 128-column
// stages; part [splits, M, N] f32 scratch is unread, and may be NULL, for one
// split.  tc == 0 runs the CUDA-core kernel, one split.  A plan the chosen
// kernel cannot take is refused.
BNB_EXPORT int bnb_gemm_4bit_paired(const void* A, const uint8_t* P, const float* absmax_t, float* part,
                                    void* out, int M, int N, int K, int blocksize, int k_per_split, int splits,
                                    int tc, const float* units, int a_kind, int out_f32, cudaStream_t stream) {
    if (!gemm_args_ok(M, N, K, blocksize, k_per_split, splits, tc, part, a_kind)) return (int)cudaErrorInvalidValue;
    return launch_gemm(A, P, F32Scales{absmax_t, N}, part, out, M, N, K, blocksize, k_per_split, splits, tc, units,
                       a_kind, out_f32, stream);
}

// W [N, K] (out_kind as a_kind).
BNB_EXPORT int bnb_dequantize_paired(const uint8_t* P, const float* absmax_t, void* W,
                                     int N, int K, int blocksize, const float* units, int out_kind,
                                     cudaStream_t stream) {
    if (!dequant_shape_ok(N, K, blocksize)) return (int)cudaErrorInvalidValue;
    return launch_dequant(P, F32Scales{absmax_t, N}, W, N, K, blocksize, units, out_kind, stream);
}

// codes_t [K/blocksize, N] uint8, s2 [ceil(N*K/blocksize / 256)] f32 and offset [1]
// f32 on the device; dec on the host.  The plan as bnb_gemm_4bit_paired's.
BNB_EXPORT int bnb_gemm_4bit_paired_dq(const void* A, const uint8_t* P, const uint8_t* codes_t,
                                       const float* s2, const float* offset, float* part, void* out, int M,
                                       int N, int K, int blocksize, int k_per_split, int splits, int tc,
                                       const float* units, const DynDecode* dec, int a_kind, int out_f32,
                                       cudaStream_t stream) {
    NestedScales sc;
    if (!gemm_args_ok(M, N, K, blocksize, k_per_split, splits, tc, part, a_kind)
        || !nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc))
        return (int)cudaErrorInvalidValue;
    return launch_gemm(A, P, sc, part, out, M, N, K, blocksize, k_per_split, splits, tc, units, a_kind, out_f32,
                       stream);
}

BNB_EXPORT int bnb_dequantize_paired_dq(const uint8_t* P, const uint8_t* codes_t, const float* s2,
                                        const float* offset, void* W, int N, int K, int blocksize,
                                        const float* units, const DynDecode* dec, int out_kind,
                                        cudaStream_t stream) {
    NestedScales sc;
    if (!dequant_shape_ok(N, K, blocksize)
        || !nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc))
        return (int)cudaErrorInvalidValue;
    return launch_dequant(P, sc, W, N, K, blocksize, units, out_kind, stream);
}

// G [M, N] (g_kind as a_kind); out [M, K] in G's type.  Rows
// [s*rows_per_split, (s+1)*rows_per_split) of N go to split s.  tc != 0 runs
// the tensor-core kernel, which takes bf16 and f16 g at blocksize % 32 == 0
// and rows_per_split a multiple of 64; part [splits, M, K] f32 scratch is
// unread, and may be NULL, for one split.  tc == 0 runs the CUDA-core kernel,
// part always given.  A plan the chosen kernel cannot take is refused.
BNB_EXPORT int bnb_gemm_4bit_paired_nt(const void* G, const uint8_t* P, const float* absmax_t,
                                       float* part, void* out, int M, int N, int K, int blocksize,
                                       int rows_per_split, int splits, int tc, const float* units,
                                       int g_kind, cudaStream_t stream) {
    if (!nt_args_ok(M, N, K, blocksize, rows_per_split, splits, tc, part, g_kind))
        return (int)cudaErrorInvalidValue;
    return launch_nt(G, P, F32Scales{absmax_t, N}, part, out, M, N, K, blocksize, rows_per_split, splits, tc, units,
                     g_kind, stream);
}

BNB_EXPORT int bnb_gemm_4bit_paired_nt_dq(const void* G, const uint8_t* P, const uint8_t* codes_t,
                                          const float* s2, const float* offset, float* part, void* out,
                                          int M, int N, int K, int blocksize, int rows_per_split,
                                          int splits, int tc, const float* units, const DynDecode* dec,
                                          int g_kind, cudaStream_t stream) {
    NestedScales sc;
    if (!nt_args_ok(M, N, K, blocksize, rows_per_split, splits, tc, part, g_kind)
        || !nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc))
        return (int)cudaErrorInvalidValue;
    return launch_nt(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, tc, units, g_kind,
                     stream);
}
