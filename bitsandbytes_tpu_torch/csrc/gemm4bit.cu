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
// gemm_4bit_nt_fused_kernel replaces gemm_4bit_nt_fused (_gemm4bit_nt_kernel):
// the 4-bit matmul backward
//   grad_A[M, K] = g[M, N] @ dequant(B)[N, K],   the weight rounded to g's type,
// sums in f32, the result in g's type.  Bound at small M: bytes.  As kernel 7
// (csrc/gemm4bit_paired.cu): each warp owns 256 consecutive columns, 8 a lane
// (one 4-byte payload load a row, coalesced along K), g's rows staged in
// shared memory 1024 columns at a time as f32; the grid splits N so that the
// 4096 output columns of gate_up fill the card, each split writes f32 partials
// and a second pass adds them in split order (the same bits every run).
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

// --- kernel 11 --------------------------------------------------------------

constexpr int kNtWarps = 8;
constexpr int kNtMT = 8;                              // rows of g per block
constexpr int kNtLaneK = 8;                           // columns per lane (4 payload bytes)
constexpr int kNtKT = kNtWarps * 32 * kNtLaneK;       // 2048 columns of K per block
constexpr int kNtNC = 1024;                           // columns of g staged per step (32 KB f32)

// part[split, m, k]: block (kx, split, mt) sums rows [split*rows, ...) of N.
template <class TG>
__global__ void __launch_bounds__(kNtWarps * 32)
gemm_4bit_nt_fused_kernel(const TG* __restrict__ G, const uint8_t* __restrict__ B,
                          const float* __restrict__ absmax, float* __restrict__ part, int M, int N, int K,
                          int blocksize, int rows_per_split, Code16 code) {
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
            s_g[m * kNtNC + c] = m < mrows ? to_f32(G[(size_t)(m0 + m) * N + c0 + c]) : 0.0f;
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
                w[2 * t] = round_to<TG>(__fmul_rn(s_code[b >> 4], sc));
                w[2 * t + 1] = round_to<TG>(__fmul_rn(s_code[b & 15u], sc));
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
            float* dst = part + ((size_t)blockIdx.y * M + m0 + m) * K + k;
            reinterpret_cast<float4*>(dst)[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        }
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

template <class TG>
void launch_nt(const void* G, const uint8_t* B, const float* absmax, float* part, void* out, int M, int N,
               int K, int blocksize, int rows_per_split, int splits, const Code16& code, cudaStream_t stream) {
    const dim3 grid((K + kNtKT - 1) / kNtKT, splits, (M + kNtMT - 1) / kNtMT);
    gemm_4bit_nt_fused_kernel<TG><<<grid, kNtWarps * 32, 0, stream>>>(
        static_cast<const TG*>(G), B, absmax, part, M, N, K, blocksize, rows_per_split, code);
    const long long mk = (long long)M * K;
    splits_reduce_kernel<TG><<<(unsigned)((mk + 255) / 256), 256, 0, stream>>>(
        part, static_cast<TG*>(out), mk, splits);
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

// G [M, N] (g_kind as a_kind); part [splits, M, K] f32 scratch; out [M, K] in G's
// type.  Rows [s*rows_per_split, (s+1)*rows_per_split) of N go to split s.
BNB_EXPORT int bnb_gemm_4bit_nt_fused(const void* G, const uint8_t* B, const float* absmax, float* part,
                                      void* out, int M, int N, int K, int blocksize, int rows_per_split,
                                      int splits, const float* code, int g_kind, cudaStream_t stream) {
    if (M <= 0 || !shape_ok(N, K, blocksize) || rows_per_split < 1 || splits < 1
        || (long long)rows_per_split * (splits - 1) >= N || (long long)rows_per_split * splits < N)
        return (int)cudaErrorInvalidValue;
    const Code16 c = load_code(code);
    switch (g_kind) {
        case kF32: launch_nt<float>(G, B, absmax, part, out, M, N, K, blocksize, rows_per_split, splits, c, stream); break;
        case kBf16: launch_nt<__nv_bfloat16>(G, B, absmax, part, out, M, N, K, blocksize, rows_per_split, splits, c, stream); break;
        case kF16: launch_nt<__half>(G, B, absmax, part, out, M, N, K, blocksize, rows_per_split, splits, c, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
