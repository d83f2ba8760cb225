// 4-bit GEMM and dequantize over the N-paired payload layout.
//
// Payload: P[n2, k] (uint8, [N/2, K]) holds weight rows 2*n2 (high nibble)
// and 2*n2+1 (low nibble) at column k.  Scales: absmax_t[b, n] (f32,
// [K/blocksize, N]), one per row and quantization block of `blocksize`
// columns along K.
//
// gemm_4bit_paired_kernel replaces the TPU kernel gemm_4bit_paired
// (_paired_kernel) of the JAX package's ops/pallas/gemm4bit_paired.py:
//   out[M, N] = A[M, K] @ dequant(P)^T,   A bf16, f16 or f32
// with bf16-rounded unit codes, an f32 partial dot per lane and quant block
// scaled by the block's f32 absmax, all sums in f32.  A is read exactly in
// f32 (the TPU kernel splits an f32 A into bf16 hi + lo for its MXU).
// Bound on the H100 at decode M: bytes.  The payload (N*K/2 B) and absmax
// (N*K/blocksize*4 B) dominate; A and out are small.  One warp owns one row
// pair n2 and streams P[n2, :] with 8-byte loads along K (a warp reads 256
// contiguous bytes per step).  A's rows are staged in shared memory in its own
// type, 32 KB a K tile (M*K*2 bytes does not fit at K = 14336), and reused by
// the block's 8 warps.
// The TPU kernel carries its sum across an ordered K grid axis; here the K
// loop runs inside the block and a warp shuffle reduces the lanes, so no
// block order is assumed.  Each block takes 8 rows of A; larger M is a grid
// dimension.
//
// dequantize_paired_kernel replaces dequantize_paired_fast
// (_paired_dequant_kernel) of the same file:
//   W[N, K] = dtype(unit(code) * absmax)   (the scale product in exact f32;
//                                            dtype bf16, f16 or f32)
// Bound: bytes (N*K/2 read, N*K*sizeof(dtype) written).  One thread reads 8
// payload bytes and writes 8 values to each of rows 2*n2 and 2*n2+1, 16-byte
// stores coalesced along K.
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
// gemm_4bit_paired_nt_kernel replaces gemm_4bit_paired_nt (_paired_nt_kernel)
// and, with the nested scales, gemm_4bit_paired_nt_dq (_paired_nt_kernel_dq):
// the 4-bit matmul backward
//   grad_A[M, K] = g[M, N] @ dequant(P)[N, K]
// with the TPU kernel's numerics (_nt_accum): for each K quantization block,
// g[m, n] (bf16, f16 or f32) times that block's scale of row n, rounded to
// bf16 unless g is f32, times the bf16-rounded unit code, summed over N in
// f32, the result cast to g's type.  Bound on the H100 at small M: bytes (the payload, N*K/2
// B, and its scales).  The sum runs over N while the output has only K
// columns (4096 for gate_up), so tiling K alone would leave most SMs idle:
// the grid splits N as well, each block writes its f32 partial sums, and a
// second pass adds the partials in split order (the same bits every run,
// where f32 atomics would not be).  Within a block each warp owns 256
// columns, 8 a lane (8-byte payload loads, coalesced along K), and walks
// the block's rows two at a time (one payload byte holds both); g's rows
// are staged in shared memory 1024 columns at a time and read as
// broadcasts.  Each block takes 8 rows of g; larger M is a grid dimension.
#include "common.cuh"

constexpr int kMaxSegments = 40;

// The half map's segments (functional/dynamic_segments.kernel_table): code
// i decodes as +-fma(float(a - sub[k]), step[k], add[k]), a = |i - zero_idx|
// in segment k (the last k with start[k] <= a).
struct DynDecode {
    int zero_idx;
    int nseg;
    int start[kMaxSegments];
    int sub[kMaxSegments];
    float step[kMaxSegments];
    float add[kMaxSegments];
};

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
        for (int i = tid; i < 256; i += nthreads) {
            const int d = i - dec.zero_idx;
            const int a = d < 0 ? -d : d;
            int k = 0;
            while (k + 1 < dec.nseg && a >= dec.start[k + 1]) ++k;
            const float v = __fmaf_rn((float)(a - dec.sub[k]), dec.step[k], dec.add[k]);
            table[i] = d < 0 ? -v : v;
        }
    }
    __device__ __forceinline__ float2 load(const float* table, int blk, int n2) const {
        const uchar2 q = *reinterpret_cast<const uchar2*>(codes_t + (size_t)blk * N + 2 * n2);
        const long long f = (long long)(2 * n2) * KB + blk;  // flat first-level block of row 2*n2
        const float off = __ldg(offset);
        return make_float2(__fmaf_rn(table[q.x], s2[f >> 8], off),
                           __fmaf_rn(table[q.y], s2[(f + KB) >> 8], off));
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

constexpr int kDqThreads = 256;

template <class TOut, class Scales>
__global__ void __launch_bounds__(kDqThreads)
dequantize_paired_kernel(const uint8_t* __restrict__ P, Scales scales,
                         TOut* __restrict__ W, int N, int K, int blocksize,
                         Units16 units) {
    __shared__ float s_units[16];
    __shared__ float s_table[Scales::kTable];
    if (threadIdx.x < 16) s_units[threadIdx.x] = units.v[threadIdx.x];
    scales.prologue(s_table, threadIdx.x, kDqThreads);
    __syncthreads();

    const long long idx = (long long)blockIdx.x * kDqThreads + threadIdx.x;
    const int kv = K / 8;
    if (idx >= (long long)(N >> 1) * kv) return;
    const int n2 = (int)(idx / kv);
    const int k = (int)(idx - (long long)n2 * kv) * 8;

    const uint2 pb = *reinterpret_cast<const uint2*>(P + (size_t)n2 * K + k);
    const float2 sc = scales.load(s_table, k / blocksize, n2);
    float hi[8], lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? pb.x : pb.y;
        const uint32_t b = (word >> (8 * (j & 3))) & 0xFFu;
        hi[j] = s_units[b >> 4] * sc.x;
        lo[j] = s_units[b & 15u] * sc.y;
    }
    store8(W + (size_t)(2 * n2) * K + k, hi);
    store8(W + (size_t)(2 * n2 + 1) * K + k, lo);
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

// out in A's type, or f32 when out_f32 (an f32 A writes f32).
template <class Scales>
int launch_gemm(const void* A, const uint8_t* P, const Scales& sc, void* out, int M, int N,
                int K, int blocksize, const float* units, int a_kind, int out_f32, cudaStream_t stream) {
    const Units16 u = load_units(units);
    switch (a_kind) {
        case kF32: launch_gemm_t<float, float>(A, P, sc, out, M, N, K, blocksize, u, stream); break;
        case kBf16:
            if (out_f32) launch_gemm_t<__nv_bfloat16, float>(A, P, sc, out, M, N, K, blocksize, u, stream);
            else launch_gemm_t<__nv_bfloat16, __nv_bfloat16>(A, P, sc, out, M, N, K, blocksize, u, stream);
            break;
        case kF16:
            if (out_f32) launch_gemm_t<__half, float>(A, P, sc, out, M, N, K, blocksize, u, stream);
            else launch_gemm_t<__half, __half>(A, P, sc, out, M, N, K, blocksize, u, stream);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <class TOut, class Scales>
void launch_dequant_t(const uint8_t* P, const Scales& sc, void* W, int N, int K, int blocksize,
                      const Units16& u, cudaStream_t stream) {
    const long long total = (long long)(N / 2) * (K / 8);
    if (total > 0) {
        const long long grid = (total + kDqThreads - 1) / kDqThreads;
        dequantize_paired_kernel<TOut, Scales><<<(unsigned)grid, kDqThreads, 0, stream>>>(
            P, sc, static_cast<TOut*>(W), N, K, blocksize, u);
    }
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

template <class Scales>
int launch_nt(const void* G, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N,
              int K, int blocksize, int rows_per_split, int splits, const float* units, int g_kind,
              cudaStream_t stream) {
    if (!gemm_shape_ok(M, N, K, blocksize) || rows_per_split < 2 || rows_per_split % 2 || splits < 1
        || (long long)rows_per_split * (splits - 1) >= N || (long long)rows_per_split * splits < N)
        return (int)cudaErrorInvalidValue;
    const Units16 u = load_units(units);
    switch (g_kind) {
        case kF32: launch_nt_t<float>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream); break;
        case kBf16:
            launch_nt_t<__nv_bfloat16>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream);
            break;
        case kF16: launch_nt_t<__half>(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, u, stream); break;
        default: return (int)cudaErrorInvalidValue;
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

// A [M, K] (a_kind: 0 f32, 1 bf16, 2 f16); out [M, N] in A's type, or f32 when out_f32.
BNB_EXPORT int bnb_gemm_4bit_paired(const void* A, const uint8_t* P, const float* absmax_t,
                                    void* out, int M, int N, int K, int blocksize,
                                    const float* units, int a_kind, int out_f32, cudaStream_t stream) {
    if (!gemm_shape_ok(M, N, K, blocksize)) return (int)cudaErrorInvalidValue;
    return launch_gemm(A, P, F32Scales{absmax_t, N}, out, M, N, K, blocksize, units, a_kind, out_f32,
                       stream);
}

// W [N, K] (out_kind as a_kind).
BNB_EXPORT int bnb_dequantize_paired(const uint8_t* P, const float* absmax_t, void* W,
                                     int N, int K, int blocksize, const float* units, int out_kind,
                                     cudaStream_t stream) {
    if (!dequant_shape_ok(N, K, blocksize)) return (int)cudaErrorInvalidValue;
    return launch_dequant(P, F32Scales{absmax_t, N}, W, N, K, blocksize, units, out_kind, stream);
}

// codes_t [K/blocksize, N] uint8, s2 [ceil(N*K/blocksize / 256)] f32 and offset [1]
// f32 on the device; dec on the host.
BNB_EXPORT int bnb_gemm_4bit_paired_dq(const void* A, const uint8_t* P, const uint8_t* codes_t,
                                       const float* s2, const float* offset, void* out, int M, int N,
                                       int K, int blocksize, const float* units,
                                       const DynDecode* dec, int a_kind, int out_f32, cudaStream_t stream) {
    NestedScales sc;
    if (!gemm_shape_ok(M, N, K, blocksize)
        || !nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc))
        return (int)cudaErrorInvalidValue;
    return launch_gemm(A, P, sc, out, M, N, K, blocksize, units, a_kind, out_f32, stream);
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

// G [M, N] (g_kind as a_kind); part [splits, M, K] f32 scratch; out [M, K]
// in G's type.  Rows [s*rows_per_split, (s+1)*rows_per_split) of N go to split s.
BNB_EXPORT int bnb_gemm_4bit_paired_nt(const void* G, const uint8_t* P, const float* absmax_t,
                                       float* part, void* out, int M, int N, int K, int blocksize,
                                       int rows_per_split, int splits, const float* units,
                                       int g_kind, cudaStream_t stream) {
    return launch_nt(G, P, F32Scales{absmax_t, N}, part, out, M, N, K, blocksize, rows_per_split,
                     splits, units, g_kind, stream);
}

BNB_EXPORT int bnb_gemm_4bit_paired_nt_dq(const void* G, const uint8_t* P, const uint8_t* codes_t,
                                          const float* s2, const float* offset, float* part, void* out,
                                          int M, int N, int K, int blocksize, int rows_per_split,
                                          int splits, const float* units, const DynDecode* dec,
                                          int g_kind, cudaStream_t stream) {
    NestedScales sc;
    if (!nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc)) return (int)cudaErrorInvalidValue;
    return launch_nt(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, units, g_kind,
                     stream);
}
