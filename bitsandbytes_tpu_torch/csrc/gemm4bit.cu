// 4-bit GEMM, dequantize and backward GEMM over the K-adjacent payload.
//
// Payload: B[n, j] (uint8, [N, K/2], the checkpoint interop byte order, the
// JAX package's "2d"/"flat" layouts) holds column k = 2j of row n in its high
// nibble and k = 2j + 1 in its low nibble.  Scales: absmax[n * K/blocksize +
// k / blocksize] (f32, [N, K/blocksize] row-major, the flat block order).
// Every weight is dequantized as the reference library and the JAX package's
// default tier compute it: the exact f32 product code[q] * absmax, rounded to
// the operand's type.  (The TPU kernels rebuild each scale as bf16 hi + lo,
// which keeps about 16 bits of it; the port does not copy that.)
//
// gemm_4bit_fused_kernel replaces the TPU kernel gemm_4bit_fused
// (_gemm4bit_kernel) of the JAX package's ops/pallas/gemm4bit.py:
//   out[M, N] = A[M, K] @ dequant(B)^T,   A bf16, f16 or f32, sums in f32.
// Bound on the H100 at decode M: bytes (N*K/2 of payload, N*K/blocksize*4 of
// scales); at M = 8 the f32 multiply-adds on the CUDA cores come close (M*N*K
// of them).  One warp owns two rows n and streams each with 16-byte loads (32
// columns a lane, a warp covers 1024 columns a step).  A's rows are staged in
// shared memory in its own type, 32 KB a K tile, 8 rows of A per block and
// reused by the block's 8 warps; larger M is a grid dimension.  The TPU kernel
// carries its sum over an ordered K grid axis; here the K loop runs inside the
// block and a warp shuffle adds the lanes, so no block order is assumed.
//
// dequantize_4bit_2d_kernel replaces dequantize_4bit_pallas (_dequant4_kernel):
//   W[n] = dtype(code[q] * absmax[n / blocksize])   over the flat element order
// Bound: bytes (n/2 read, n*sizeof(dtype) written).  One thread reads 8 payload
// bytes and writes 16 values with 16-byte stores; 16 elements never straddle a
// quantization block (blocksize % 16 == 0), and a tail thread goes bytewise, so
// any element count and any 2-D shape whose rows hold whole blocks is taken.
//
// Kernel 11 replaces gemm_4bit_nt_fused (_gemm4bit_nt_kernel): the 4-bit
// matmul backward
//   grad_A[M, K] = g[M, N] @ dequant(B)[N, K],   the weight rounded to g's type,
// sums in f32, the result in g's type.  Bound at M <= 32: bytes (the payload
// N*K/2, the f32 absmax N*K/blocksize*4, g M*N*2 and the result M*K*2; the
// products are 2*M*N*K, far under the tensor cores' rate).  The TPU kernel runs
// its products on the MXU with M padded to 16; here, for bf16 and f16 g,
// gemm_4bit_nt_tc_kernel runs them as mma.sync.m16n8k16 with f32 accumulators
// (mma's reduction axis is N: g is the A operand, by ldmatrix; the weight the
// B operand).  A block owns 128 output columns and every row of g up to 32
// (zero rows pad M to 16 or 32), so each payload byte is read and decoded once
// per call up to M 32, once per 32 rows above.  A four-stage cp.async ring
// keeps 128 rows of N a stage in flight: each row's 64 contiguous payload
// bytes (16-byte copies), the scale of each of its 32-column chunks (a row's
// copies in neighbouring lanes, so they leave as one request), and g's 128
// columns.  Each weight is decoded once (the codebook in shared memory,
// __fmul_rn, two values rounded and packed by one conversion) straight into
// the B fragment registers: a B register pairs two consecutive rows of one
// column, so a lane decodes one payload word from each of four rows and
// shared memory holds no decoded tile.  What still holds it back: the
// payload's 64-byte row strips stream from device memory well under the
// card's copy rate, and the decode (two codebook loads a payload byte) is not
// fully hidden behind them (PERF.md).
// The grid is ceil(K/128) column tiles x S splits of N x ceil(M/32), S <= 8
// chosen by the wrapper to fill whole waves of SMs (ops/gemm4bit_paired.nt_plan);
// with S > 1 each split writes f32 partials and a second pass adds them in
// split order, so a call gives the same bits every run.  f32 g has no exact
// tensor-core product (TF32 would break its contract), so it keeps the
// CUDA-core body, gemm_4bit_nt_f32_kernel: 8 columns a lane, 8 rows of g a
// block, g staged 1024 columns at a time, exact fmaf.
#include "common.cuh"

namespace {

// The 16 entries of a 4-bit codebook, exact f32.
struct Code16 {
    float v[16];
};

// --- kernel 9 ---------------------------------------------------------------

constexpr int kGemmWarps = 8;
constexpr int kGemmRows = 2;                 // rows of N per warp
constexpr int kGemmMT = 8;                   // rows of A per block
constexpr int kGemmTileBytes = 32768;        // A's staged K tile, all 8 rows
constexpr int kLaneK = 32;                   // columns per lane and step (16 payload bytes)

template <class TA, class TOut>
__global__ void __launch_bounds__(kGemmWarps * 32)
gemm_4bit_fused_kernel(const TA* __restrict__ A, const uint8_t* __restrict__ B,
                       const float* __restrict__ absmax, TOut* __restrict__ out, int M, int N, int K,
                       int blocksize, Code16 code) {
    constexpr int kKT = kGemmTileBytes / (kGemmMT * (int)sizeof(TA));  // 2048 (16-bit A), 1024 (f32)
    constexpr int kVec = 16 / (int)sizeof(TA);                          // A values per 16-byte load
    static_assert(kKT % (32 * kLaneK) == 0, "a K tile holds whole warp steps");
    __shared__ float s_code[16];
    __shared__ __align__(16) TA s_a[kGemmMT * kKT];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 16) s_code[tid] = code.v[tid];

    const int n0 = (blockIdx.x * kGemmWarps + warp) * kGemmRows;
    const int m0 = blockIdx.y * kGemmMT;
    const int mrows = min(kGemmMT, M - m0);
    const int KB = K / blocksize;
    const size_t row_bytes = (size_t)(K / 2);

    float acc[kGemmMT][kGemmRows];
#pragma unroll
    for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
        for (int r = 0; r < kGemmRows; ++r) acc[m][r] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kKT) {
        const int kt = min(kKT, K - k0);  // a multiple of 32: K % blocksize == 0, blocksize >= 32
        __syncthreads();                  // the previous tile is consumed (and s_code is set)
        const int vecs = kt / kVec;
        for (int i = tid; i < mrows * vecs; i += kGemmWarps * 32) {
            const int m = i / vecs;
            const int v = i - m * vecs;
            *reinterpret_cast<uint4*>(s_a + m * kKT + v * kVec) =
                *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k0 + v * kVec);
        }
        __syncthreads();
        if (n0 >= N) continue;

        for (int kk = lane * kLaneK; kk < kt; kk += 32 * kLaneK) {
            const int k = k0 + kk;
            uint4 pb[kGemmRows];
            float sc[kGemmRows];
#pragma unroll
            for (int r = 0; r < kGemmRows; ++r) {
                const int n = n0 + r;
                if (n < N) {
                    pb[r] = *reinterpret_cast<const uint4*>(B + (size_t)n * row_bytes + k / 2);
                    sc[r] = absmax[(size_t)n * KB + k / blocksize];  // 32 columns never straddle a block
                } else {
                    pb[r] = make_uint4(0u, 0u, 0u, 0u);
                    sc[r] = 0.0f;
                }
            }
#pragma unroll
            for (int sub = 0; sub < 4; ++sub) {  // 8 columns: one 4-byte word of each row
                float w[kGemmRows][8];
#pragma unroll
                for (int r = 0; r < kGemmRows; ++r) {
                    const uint32_t word = sub == 0 ? pb[r].x : sub == 1 ? pb[r].y : sub == 2 ? pb[r].z : pb[r].w;
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        const uint32_t b = (word >> (8 * t)) & 0xFFu;
                        w[r][2 * t] = round_to<TA>(__fmul_rn(s_code[b >> 4], sc[r]));
                        w[r][2 * t + 1] = round_to<TA>(__fmul_rn(s_code[b & 15u], sc[r]));
                    }
                }
#pragma unroll
                for (int m = 0; m < kGemmMT; ++m) {
                    if (m < mrows) {
                        float a[8];
                        load8(s_a + m * kKT + kk + sub * 8, a);
#pragma unroll
                        for (int r = 0; r < kGemmRows; ++r)
#pragma unroll
                            for (int j = 0; j < 8; ++j) acc[m][r] = fmaf(a[j], w[r][j], acc[m][r]);
                    }
                }
            }
        }
    }
    if (n0 >= N) return;
#pragma unroll
    for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
        for (int r = 0; r < kGemmRows; ++r) acc[m][r] = warp_sum(acc[m][r]);
    if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kGemmMT; ++m)
#pragma unroll
            for (int r = 0; r < kGemmRows; ++r)
                if (m < mrows && n0 + r < N) out[(size_t)(m0 + m) * N + n0 + r] = from_f32<TOut>(acc[m][r]);
    }
}

// --- kernel 10 --------------------------------------------------------------

constexpr int kDqThreads = 256;

template <class TOut>
__global__ void __launch_bounds__(kDqThreads)
dequantize_4bit_2d_kernel(const uint8_t* __restrict__ B, const float* __restrict__ absmax,
                          TOut* __restrict__ W, long long n, int blocksize, Code16 code) {
    __shared__ float s_code[16];
    if (threadIdx.x < 16) s_code[threadIdx.x] = code.v[threadIdx.x];
    __syncthreads();

    const long long i = (long long)blockIdx.x * kDqThreads + threadIdx.x;
    const long long e0 = i * 16;
    if (e0 >= n) return;
    const float sc = absmax[e0 / blocksize];
    if (e0 + 16 <= n) {
        const uint2 pb = *reinterpret_cast<const uint2*>(B + i * 8);
        float v[16];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const uint32_t b = ((t < 4 ? pb.x : pb.y) >> (8 * (t & 3))) & 0xFFu;
            v[2 * t] = __fmul_rn(s_code[b >> 4], sc);
            v[2 * t + 1] = __fmul_rn(s_code[b & 15u], sc);
        }
        if constexpr (sizeof(TOut) == 4) {
            float4* dst = reinterpret_cast<float4*>(W + e0);
#pragma unroll
            for (int s = 0; s < 4; ++s) dst[s] = make_float4(v[4 * s], v[4 * s + 1], v[4 * s + 2], v[4 * s + 3]);
        } else {
            uint4* dst = reinterpret_cast<uint4*>(W + e0);
#pragma unroll
            for (int s = 0; s < 2; ++s)
                dst[s] = make_uint4(pack2<TOut>(v[8 * s], v[8 * s + 1]), pack2<TOut>(v[8 * s + 2], v[8 * s + 3]),
                                    pack2<TOut>(v[8 * s + 4], v[8 * s + 5]), pack2<TOut>(v[8 * s + 6], v[8 * s + 7]));
        }
    } else {
        for (long long e = e0; e < n; ++e) {
            const uint32_t b = B[e >> 1];
            const uint32_t q = (e & 1) ? (b & 15u) : (b >> 4);
            W[e] = from_f32<TOut>(__fmul_rn(s_code[q], sc));
        }
    }
}

// --- kernel 11 ---------------------------------------------------------------

// f32 g: the CUDA-core body, exact f32 products (tensor cores have none).
constexpr int kNtWarps = 8;
constexpr int kNtMT = 8;                              // rows of g per block
constexpr int kNtLaneK = 8;                           // columns per lane (4 payload bytes)
constexpr int kNtKT = kNtWarps * 32 * kNtLaneK;       // 2048 columns of K per block
constexpr int kNtNC = 1024;                           // columns of g staged per step (32 KB f32)

// Block (kx, split, mt) sums rows [split*rows, ...) of N into part[split, m, k],
// or straight into out when part is null (one split).
__global__ void __launch_bounds__(kNtWarps * 32)
gemm_4bit_nt_f32_kernel(const float* __restrict__ G, const uint8_t* __restrict__ B,
                        const float* __restrict__ absmax, float* __restrict__ part, float* __restrict__ out,
                        int M, int N, int K, int blocksize, int rows_per_split, Code16 code) {
    __shared__ float s_code[16];
    __shared__ float s_g[kNtMT * kNtNC];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 16) s_code[tid] = code.v[tid];

    const int k = blockIdx.x * kNtKT + warp * 32 * kNtLaneK + lane * kNtLaneK;
    const bool active = k < K;  // K % 32 == 0: a lane's 8 columns are all in or all out
    const int KB = K / blocksize;
    const int blk = k / blocksize;  // 8 columns never straddle a block
    const size_t row_bytes = (size_t)(K / 2);
    const int n_lo = blockIdx.y * rows_per_split;
    const int n_hi = min(N, n_lo + rows_per_split);
    const int m0 = blockIdx.z * kNtMT;
    const int mrows = min(kNtMT, M - m0);

    float acc[kNtMT][kNtLaneK];
#pragma unroll
    for (int m = 0; m < kNtMT; ++m)
#pragma unroll
        for (int j = 0; j < kNtLaneK; ++j) acc[m][j] = 0.0f;

    for (int c0 = n_lo; c0 < n_hi; c0 += kNtNC) {
        const int nc = min(kNtNC, n_hi - c0);
        __syncthreads();  // the previous chunk is consumed (and s_code is set)
        for (int i = tid; i < kNtMT * nc; i += kNtWarps * 32) {
            const int m = i / nc;
            const int c = i - m * nc;
            s_g[m * kNtNC + c] = m < mrows ? G[(size_t)(m0 + m) * N + c0 + c] : 0.0f;
        }
        __syncthreads();
        if (!active) continue;

#pragma unroll 2
        for (int r = 0; r < nc; ++r) {
            const int n = c0 + r;
            const uint32_t word = *reinterpret_cast<const uint32_t*>(B + (size_t)n * row_bytes + k / 2);
            const float sc = absmax[(size_t)n * KB + blk];
            float w[kNtLaneK];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const uint32_t b = (word >> (8 * t)) & 0xFFu;
                w[2 * t] = __fmul_rn(s_code[b >> 4], sc);
                w[2 * t + 1] = __fmul_rn(s_code[b & 15u], sc);
            }
#pragma unroll
            for (int m = 0; m < kNtMT; ++m) {
                if (m < mrows) {
                    const float gm = s_g[m * kNtNC + r];
#pragma unroll
                    for (int j = 0; j < kNtLaneK; ++j) acc[m][j] = fmaf(gm, w[j], acc[m][j]);
                }
            }
        }
    }
    if (!active) return;
#pragma unroll
    for (int m = 0; m < kNtMT; ++m) {
        if (m < mrows) {
            float* dst = part ? part + ((size_t)blockIdx.y * M + m0 + m) * K + k : out + (size_t)(m0 + m) * K + k;
            reinterpret_cast<float4*>(dst)[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        }
    }
}

// bf16 and f16 g: tensor cores.  A block owns kTcTK output columns and every
// row of g up to kTcMT (one or two m16 tiles, zero rows padding M), and walks
// its split of N in stages of kTcTN rows.  Warp w takes the column half w & 1
// (64 columns, eight n8 tiles) and the k16 groups w >> 1, (w >> 1) + 4, ... of
// every stage.  The decode builds the mma's B fragments in registers, with no
// decoded tile in shared memory: lane (q = lane / 4, t = lane % 4) reads one
// payload word (8 columns) from each of the rows 2t, 2t+1, 2t+8 and 2t+9 of a
// k16 group, and packs the weights of two consecutive rows of one column,
// which is a B fragment register.  So n8 tile e of a warp holds the physical
// columns 8q + e (its logical column q); the epilogue undoes that
// permutation.  The four warps of a column half meet in shared memory at the
// end and are added in warp order.
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcTK = 128;                    // output columns a block: 64 payload bytes a row
constexpr int kTcCH = kTcTK / 64;             // column groups of 64 (one a warp)
constexpr int kTcKG = kTcWarps / kTcCH;       // warps of a column group
constexpr int kTcTN = 128;                    // rows of N a stage: eight k16 groups
constexpr int kTcMT = 32;                     // rows of g a block
constexpr int kTcStages = 4;                  // cp.async ring depth
constexpr int kTcChunks = kTcTK / 32;         // 32-column chunks of a row: 16 payload bytes, one scale
constexpr int kTcPayStride = kTcTK / 2 + 16;  // bytes a staged payload row (conflict-free word reads)
static_assert(kTcPayStride / 4 * 2 % 32 == 8, "two rows apart shift the banks by 8");
constexpr int kTcScStride = kTcTN + 8;        // scales a staged chunk (conflict-free reads)
constexpr int kTcGStride = kTcTN + 8;         // elements a staged row of g
constexpr int kTcRedStride = kTcTK + 8;       // f32 a row of a warp's sums
static_assert(kTcTN % (16 * kTcKG) == 0 && (kTcTN * kTcChunks) % kTcThreads == 0, "whole k16 groups a warp");

// Dynamic shared memory, in bytes: the codebook, then the ring (payload,
// scales chunk-major, g), which the epilogue reuses for the warps' sums.
struct TcLayout {
    static constexpr int kPay = kTcTN * kTcPayStride;
    static constexpr int kSc = kTcChunks * kTcScStride * 4;
    static constexpr int kG = kTcMT * kTcGStride * 2;
    static constexpr int kStage = kPay + kSc + kG;
    static constexpr int kRing = 64;
    static constexpr int kRed = kTcKG * kTcMT * kTcRedStride * 4;
    static constexpr int kBytes = kRing + (kTcStages * kStage > kRed ? kTcStages * kStage : kRed);
    static_assert(kPay % 16 == 0 && kSc % 16 == 0 && kStage % 16 == 0, "16-byte aligned");
};

// Two f32 values rounded to nearest in a 16-bit T, packed low address first
// (the bits of pack2<T>, in one conversion).
template <class T> __device__ __forceinline__ uint32_t pack2_rn(float lo, float hi) {
    if constexpr (std::is_same<T, __half>::value) {
        __half2 h = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&h);
    } else {
        return pack_bf16x2(lo, hi);
    }
}

template <class T> __device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    if constexpr (std::is_same<T, __half>::value)
        mma_f16(c, a, b0, b1);
    else
        mma_bf16(c, a, b0, b1);
}

// The codebook entry whose byte offset (nibble * 4) sits in byte j of x.
__device__ __forceinline__ float code_at(const unsigned char* s_code, uint32_t x, int j) {
    return *reinterpret_cast<const float*>(s_code + __byte_perm(x, 0u, 0x4440u + j));
}

// B fragments of eight n8 tiles from the payload words of two consecutive
// rows (w0, w1) and their scales: tile e gets (W[row 0][col e], W[row 1][col
// e]), column e being nibble e of the word in payload order (the high nibble
// of each byte first).
template <class TG>
__device__ __forceinline__ void decode_pairs(uint32_t w0, uint32_t w1, float s0, float s1,
                                             const unsigned char* s_code, uint32_t* b) {
    // every nibble times 4, a byte offset into the codebook, in its byte
    const uint32_t h0 = (w0 >> 2) & 0x3C3C3C3Cu, l0 = (w0 << 2) & 0x3C3C3C3Cu;
    const uint32_t h1 = (w1 >> 2) & 0x3C3C3C3Cu, l1 = (w1 << 2) & 0x3C3C3C3Cu;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        b[2 * j] = pack2_rn<TG>(__fmul_rn(code_at(s_code, h0, j), s0), __fmul_rn(code_at(s_code, h1, j), s1));
        b[2 * j + 1] = pack2_rn<TG>(__fmul_rn(code_at(s_code, l0, j), s0), __fmul_rn(code_at(s_code, l1, j), s1));
    }
}

template <class TG, int MI>
__global__ void __launch_bounds__(kTcThreads)
gemm_4bit_nt_tc_kernel(const TG* __restrict__ G, const uint8_t* __restrict__ B, const float* __restrict__ absmax,
                       float* __restrict__ part, TG* __restrict__ out, int M, int N, int K, int blocksize,
                       int rows_per_split, Code16 code) {
    extern __shared__ __align__(16) unsigned char smem[];
    const unsigned char* s_code = smem;
    unsigned char* ring = smem + TcLayout::kRing;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 16) reinterpret_cast<float*>(smem)[tid] = code.v[tid];

    const int k0 = blockIdx.x * kTcTK;
    const int n_lo = blockIdx.y * rows_per_split;  // a multiple of 64
    const int n_hi = min(N, n_lo + rows_per_split);
    const int m0 = blockIdx.z * kTcMT;
    const int KB = K / blocksize;
    const size_t row_bytes = (size_t)(K / 2);
    const bool g_vec = (N & 7) == 0;  // rows of g 16-byte aligned: cp.async, else plain loads
    const int stages = (n_hi - n_lo + kTcTN - 1) / kTcTN;

    // Copies: 16-byte payload chunks and 4-byte scales, one of each per
    // 32-column chunk of a row, and g's 16-byte chunks.  Each thread's
    // sources are fixed but for a stride a stage, so a stage's copies cost a
    // compare and an add each.  Columns past K and rows past the split read
    // nothing and stage zeros, so their weights decode to 0 (code * 0).
    constexpr int kPayCopies = kTcTN * kTcChunks / kTcThreads;
    constexpr int kGChunks = MI * 16 * (kTcTN / 8);
    constexpr int kGCopies = (kGChunks + kTcThreads - 1) / kTcThreads;
    const uint8_t* p_src[kPayCopies];
    const float* s_src[kPayCopies];
    int c_row[kPayCopies], p_dst[kPayCopies], s_dst[kPayCopies];
    bool c_ok[kPayCopies];
#pragma unroll
    for (int j = 0; j < kPayCopies; ++j) {
        // row-major: a row's chunks are neighbouring lanes, so its payload
        // bytes and its scales each go out as one request
        const int i = tid + j * kTcThreads;
        const int c = i % kTcChunks;
        c_row[j] = i / kTcChunks;
        c_ok[j] = k0 + 32 * c < K;
        p_src[j] = B + (size_t)(n_lo + c_row[j]) * row_bytes + (k0 + 32 * c) / 2;
        s_src[j] = absmax + (size_t)(n_lo + c_row[j]) * KB + (k0 + 32 * c) / blocksize;
        p_dst[j] = c_row[j] * kTcPayStride + c * 16;
        s_dst[j] = TcLayout::kPay + (c * kTcScStride + c_row[j]) * 4;
    }
    const TG* g_src[kGCopies];
    int g_col[kGCopies], g_dst[kGCopies];
    bool g_ok[kGCopies];
#pragma unroll
    for (int j = 0; j < kGCopies; ++j) {
        const int i = tid + j * kTcThreads;
        const int m = i / (kTcTN / 8);
        g_col[j] = (i % (kTcTN / 8)) * 8;
        g_ok[j] = i < kGChunks && m0 + m < M;
        g_src[j] = G + (size_t)(m0 + m) * N + n_lo + g_col[j];
        g_dst[j] = TcLayout::kPay + TcLayout::kSc + (m * kTcGStride + g_col[j]) * 2;
    }
    const size_t p_step = (size_t)kTcTN * row_bytes, s_step = (size_t)kTcTN * KB;

    auto load = [&](int s, int slot) {
        unsigned char* st = ring + slot * TcLayout::kStage;
        const int rem = n_hi - (n_lo + s * kTcTN);  // rows of this stage inside the split
#pragma unroll
        for (int j = 0; j < kPayCopies; ++j) {
            const bool live = c_ok[j] && c_row[j] < rem;
            cp_async16(st + p_dst[j], live ? p_src[j] + s * p_step : B, live);
            cp_async4(st + s_dst[j], live ? s_src[j] + s * s_step : absmax, live);
        }
        if (g_vec) {
#pragma unroll
            for (int j = 0; j < kGCopies; ++j) {
                if (j * kTcThreads + tid < kGChunks) {
                    const bool live = g_ok[j] && g_col[j] < rem;  // rem is a multiple of 8 or all of a stage
                    cp_async16(st + g_dst[j], live ? g_src[j] + s * kTcTN : G, live);
                }
            }
        } else {
            const int n0 = n_lo + s * kTcTN;
            TG* sg = reinterpret_cast<TG*>(st + TcLayout::kPay + TcLayout::kSc);
            for (int j = tid; j < MI * 16 * kTcTN; j += kTcThreads) {
                const int m = j / kTcTN, c = j % kTcTN;
                sg[m * kTcGStride + c] =
                    m0 + m < M && n0 + c < n_hi ? G[(size_t)(m0 + m) * N + n0 + c] : from_f32<TG>(0.0f);
            }
        }
    };

    // This thread's part of the mma: column half ch, k16 groups kg + 4i, lane (q, t).
    const int ch = warp % kTcCH, kg = warp / kTcCH;
    const int q = lane >> 2, t = lane & 3;
    const int wbyte = ch * 32 + 4 * q;           // its payload word within a staged row
    const int wchunk = (ch * 64 + 8 * q) / 32;   // the 32-column chunk (and scale) of that word

    float acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[mi][e][x] = 0.0f;

#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
        if (s < stages) load(s, s);
        cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
        cp_async_wait<kTcStages - 2>();
        __syncthreads();  // stage s has landed everywhere; the slot of stage s - 1 is free
        if (s + kTcStages - 1 < stages) load(s + kTcStages - 1, (s + kTcStages - 1) % kTcStages);
        cp_async_commit();

        const unsigned char* st = ring + (s % kTcStages) * TcLayout::kStage;
        const TG* sg = reinterpret_cast<const TG*>(st + TcLayout::kPay + TcLayout::kSc);
#pragma unroll
        for (int i = 0; i < kTcTN / (16 * kTcKG); ++i) {
            const int r0 = (kg + kTcKG * i) * 16 + 2 * t;  // rows r0, r0 + 1, r0 + 8, r0 + 9
            const float* ssc = reinterpret_cast<const float*>(st + TcLayout::kPay) + wchunk * kTcScStride + r0;
            const unsigned char* pay = st + r0 * kTcPayStride + wbyte;
            uint32_t b0[8], b1[8];
            decode_pairs<TG>(*reinterpret_cast<const uint32_t*>(pay),
                             *reinterpret_cast<const uint32_t*>(pay + kTcPayStride), ssc[0], ssc[1], s_code, b0);
            decode_pairs<TG>(*reinterpret_cast<const uint32_t*>(pay + 8 * kTcPayStride),
                             *reinterpret_cast<const uint32_t*>(pay + 9 * kTcPayStride), ssc[8], ssc[9], s_code, b1);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                uint32_t a[4];
                ldsm_x4(a, sg + (mi * 16 + (lane & 15)) * kTcGStride + (kg + kTcKG * i) * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int e = 0; e < 8; ++e) mma16816<TG>(acc[mi][e], a, b0[e], b1[e]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the warps' sums now

    // red[kg][m][column]: tile e's logical columns 2t, 2t+1 are the physical
    // columns 8 * 2t + e and 8 * (2t + 1) + e of the warp's half.
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float* row = red + (kg * kTcMT + mi * 16 + q + 8 * h) * kTcRedStride + ch * 64 + e;
                row[16 * t] = acc[mi][e][2 * h];
                row[16 * t + 8] = acc[mi][e][2 * h + 1];
            }
    __syncthreads();
    for (int i = tid; i < MI * 16 * kTcTK; i += kTcThreads) {
        const int m = i / kTcTK, c = i % kTcTK;
        const int k = k0 + c;
        if (m0 + m >= M || k >= K) continue;
        float v = red[m * kTcRedStride + c];
#pragma unroll
        for (int g = 1; g < kTcKG; ++g) v += red[(g * kTcMT + m) * kTcRedStride + c];  // warp order
        if (part)
            part[((size_t)blockIdx.y * M + m0 + m) * K + k] = v;
        else
            out[(size_t)(m0 + m) * K + k] = from_f32<TG>(v);
    }
}

// out[m, k] = sum over splits, in split order, of part[split, m, k].
template <class TOut>
__global__ void __launch_bounds__(256)
splits_reduce_kernel(const float* __restrict__ part, TOut* __restrict__ out, long long mk, int splits) {
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    if (i >= mk) return;
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s += part[(size_t)sp * mk + i];
    out[i] = from_f32<TOut>(s);
}

Code16 load_code(const float* code) {
    Code16 c;
    for (int i = 0; i < 16; ++i) c.v[i] = code[i];
    return c;
}

bool shape_ok(int N, int K, int blocksize) {
    return N > 0 && blocksize >= 32 && blocksize % 32 == 0 && K > 0 && K % blocksize == 0;
}

template <class TA, class TOut>
void launch_gemm(const void* A, const uint8_t* B, const float* absmax, void* out, int M, int N, int K,
                 int blocksize, const Code16& code, cudaStream_t stream) {
    const int rows = kGemmWarps * kGemmRows;
    const dim3 grid((N + rows - 1) / rows, (M + kGemmMT - 1) / kGemmMT);
    gemm_4bit_fused_kernel<TA, TOut><<<grid, kGemmWarps * 32, 0, stream>>>(
        static_cast<const TA*>(A), B, absmax, static_cast<TOut*>(out), M, N, K, blocksize, code);
}

template <class TA>
int launch_gemm_out(const void* A, const uint8_t* B, const float* absmax, void* out, int M, int N, int K,
                    int blocksize, const Code16& code, int out_f32, cudaStream_t stream) {
    if (out_f32)
        launch_gemm<TA, float>(A, B, absmax, out, M, N, K, blocksize, code, stream);
    else
        launch_gemm<TA, TA>(A, B, absmax, out, M, N, K, blocksize, code, stream);
    return (int)cudaGetLastError();
}

template <class T>
void launch_dequant(const uint8_t* B, const float* absmax, void* W, long long n, int blocksize,
                    const Code16& code, cudaStream_t stream) {
    const long long threads = (n + 15) / 16;
    const long long grid = (threads + kDqThreads - 1) / kDqThreads;
    dequantize_4bit_2d_kernel<T><<<(unsigned)grid, kDqThreads, 0, stream>>>(
        B, absmax, static_cast<T*>(W), n, blocksize, code);
}

void launch_nt_f32(const float* G, const uint8_t* B, const float* absmax, float* part, float* out, int M, int N,
                   int K, int blocksize, int rows_per_split, int splits, const Code16& code, cudaStream_t stream) {
    const dim3 grid((K + kNtKT - 1) / kNtKT, splits, (M + kNtMT - 1) / kNtMT);
    gemm_4bit_nt_f32_kernel<<<grid, kNtWarps * 32, 0, stream>>>(G, B, absmax, splits > 1 ? part : nullptr, out, M, N,
                                                               K, blocksize, rows_per_split, code);
    if (splits > 1) {
        const long long mk = (long long)M * K;
        splits_reduce_kernel<float><<<(unsigned)((mk + 255) / 256), 256, 0, stream>>>(part, out, mk, splits);
    }
}

template <class TG, int MI>
int launch_nt_tc(const TG* G, const uint8_t* B, const float* absmax, float* part, TG* out, int M, int N, int K,
                 int blocksize, int rows_per_split, int splits, const Code16& code, cudaStream_t stream) {
    const cudaError_t e = cudaFuncSetAttribute(gemm_4bit_nt_tc_kernel<TG, MI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, TcLayout::kBytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((K + kTcTK - 1) / kTcTK, splits, (M + kTcMT - 1) / kTcMT);
    gemm_4bit_nt_tc_kernel<TG, MI><<<grid, kTcThreads, TcLayout::kBytes, stream>>>(
        G, B, absmax, splits > 1 ? part : nullptr, out, M, N, K, blocksize, rows_per_split, code);
    if (splits > 1) {  // queued at once behind it: no host round trip between the two
        const long long mk = (long long)M * K;
        splits_reduce_kernel<TG><<<(unsigned)((mk + 255) / 256), 256, 0, stream>>>(part, out, mk, splits);
    }
    return (int)cudaGetLastError();
}

template <class TG>
int launch_nt(const void* G, const uint8_t* B, const float* absmax, float* part, void* out, int M, int N, int K,
              int blocksize, int rows_per_split, int splits, const Code16& code, cudaStream_t stream) {
    if (rows_per_split % 64) return (int)cudaErrorInvalidValue;  // splits start 16-byte aligned in g
    const TG* g = static_cast<const TG*>(G);
    TG* o = static_cast<TG*>(out);
    if (M <= 16)
        return launch_nt_tc<TG, 1>(g, B, absmax, part, o, M, N, K, blocksize, rows_per_split, splits, code, stream);
    return launch_nt_tc<TG, 2>(g, B, absmax, part, o, M, N, K, blocksize, rows_per_split, splits, code, stream);
}

}  // namespace

// A [M, K] (a_kind: 0 f32, 1 bf16, 2 f16), B [N, K/2] uint8, absmax [N*K/blocksize]
// f32; out [M, N] in A's type, or f32 when out_f32.  code on the host.
BNB_EXPORT int bnb_gemm_4bit_fused(const void* A, const uint8_t* B, const float* absmax, void* out, int M,
                                   int N, int K, int blocksize, const float* code, int a_kind, int out_f32,
                                   cudaStream_t stream) {
    if (M <= 0 || !shape_ok(N, K, blocksize)) return (int)cudaErrorInvalidValue;
    const Code16 c = load_code(code);
    switch (a_kind) {
        case kF32: return launch_gemm_out<float>(A, B, absmax, out, M, N, K, blocksize, c, 1, stream);
        case kBf16: return launch_gemm_out<__nv_bfloat16>(A, B, absmax, out, M, N, K, blocksize, c, out_f32, stream);
        case kF16: return launch_gemm_out<__half>(A, B, absmax, out, M, N, K, blocksize, c, out_f32, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// B: the packed bytes of n elements in the flat order; absmax [ceil(n/blocksize)]
// f32; W [n] (out_kind: 0 f32, 1 bf16, 2 f16).  code on the host.
BNB_EXPORT int bnb_dequantize_4bit_2d(const uint8_t* B, const float* absmax, void* W, long long n,
                                      int blocksize, const float* code, int out_kind, cudaStream_t stream) {
    if (n <= 0 || blocksize < 16 || blocksize % 16) return (int)cudaErrorInvalidValue;
    const Code16 c = load_code(code);
    switch (out_kind) {
        case kF32: launch_dequant<float>(B, absmax, W, n, blocksize, c, stream); break;
        case kBf16: launch_dequant<__nv_bfloat16>(B, absmax, W, n, blocksize, c, stream); break;
        case kF16: launch_dequant<__half>(B, absmax, W, n, blocksize, c, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// G [M, N] (g_kind as a_kind); part [splits, M, K] f32 scratch (unread, and may
// be NULL, for one split); out [M, K] in G's type.  Rows [s*rows_per_split,
// (s+1)*rows_per_split) of N go to split s; for bf16 and f16 g rows_per_split
// is a multiple of 64 (g's 16-byte copies start aligned).
BNB_EXPORT int bnb_gemm_4bit_nt_fused(const void* G, const uint8_t* B, const float* absmax, float* part,
                                      void* out, int M, int N, int K, int blocksize, int rows_per_split,
                                      int splits, const float* code, int g_kind, cudaStream_t stream) {
    if (M <= 0 || !shape_ok(N, K, blocksize) || rows_per_split < 1 || splits < 1
        || (long long)rows_per_split * (splits - 1) >= N || (long long)rows_per_split * splits < N
        || (splits > 1 && part == nullptr))
        return (int)cudaErrorInvalidValue;
    const Code16 c = load_code(code);
    switch (g_kind) {
        case kF32:
            launch_nt_f32(static_cast<const float*>(G), B, absmax, part, static_cast<float*>(out), M, N, K,
                          blocksize, rows_per_split, splits, c, stream);
            return (int)cudaGetLastError();
        case kBf16:
            return launch_nt<__nv_bfloat16>(G, B, absmax, part, out, M, N, K, blocksize, rows_per_split, splits, c,
                                            stream);
        case kF16:
            return launch_nt<__half>(G, B, absmax, part, out, M, N, K, blocksize, rows_per_split, splits, c, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
