// 4-bit GEMM and dequantize over the N-paired payload layout.
//
// Payload: P[n2, k] (uint8, [N/2, K]) holds weight rows 2*n2 (high nibble)
// and 2*n2+1 (low nibble) at column k.  Scales: absmax_t[b, n] (f32,
// [K/blocksize, N]), one per row and quantization block of `blocksize`
// columns along K.
//
// gemm_4bit_paired_kernel replaces the TPU kernel gemm_4bit_paired
// (_paired_kernel) of the JAX package's ops/pallas/gemm4bit_paired.py:
//   out[M, N] = A[M, K] @ dequant(P)^T
// with bf16-rounded unit codes, an f32 partial dot per lane and quant block
// scaled by the block's f32 absmax, all sums in f32.
// Bound on the H100 at decode M: bytes.  The payload (N*K/2 B) and absmax
// (N*K/blocksize*4 B) dominate; A and out are small.  One warp owns one row
// pair n2 and streams P[n2, :] with 8-byte loads along K (a warp reads 256
// contiguous bytes per step).  A's rows are staged in shared memory in K tiles
// (M*K*2 bytes does not fit at K = 14336) and reused by the block's 8 warps.
// The TPU kernel carries its sum across an ordered K grid axis; here the K
// loop runs inside the block and a warp shuffle reduces the lanes, so no
// block order is assumed.  Each block takes 8 rows of A; larger M is a grid
// dimension.
//
// dequantize_paired_kernel replaces dequantize_paired_fast
// (_paired_dequant_kernel) of the same file:
//   W[N, K] = bf16(unit(code) * absmax)   (the scale product in exact f32)
// Bound: bytes (N*K/2 read, N*K*2 written).  One thread reads 8 payload
// bytes and writes 8 bf16 values to each of rows 2*n2 and 2*n2+1, 16-byte
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
// g[m, n] times that block's scale of row n, rounded to bf16 unless g is
// f32, times the bf16-rounded unit code, summed over N in f32, the result
// cast to g's type.  Bound on the H100 at small M: bytes (the payload, N*K/2
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
constexpr int kGemmKT = 2048;    // K columns of A staged per tile (32 KB)
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

template <bool kOutBf16, class Scales>
__global__ void __launch_bounds__(kGemmWarps * 32)
gemm_4bit_paired_kernel(const __nv_bfloat16* __restrict__ A, const uint8_t* __restrict__ P,
                        Scales scales, void* __restrict__ out,
                        int M, int N, int K, int blocksize, Units16 units) {
    __shared__ float s_units[16];
    __shared__ float s_table[Scales::kTable];
    __shared__ __align__(16) __nv_bfloat16 s_a[kGemmMT * kGemmKT];

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
        const int vecs = kt / 8;
        for (int i = tid; i < mrows * vecs; i += kGemmWarps * 32) {
            const int m = i / vecs;
            const int v = i - m * vecs;
            *reinterpret_cast<uint4*>(s_a + m * kGemmKT + v * 8) =
                *reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k0 + v * 8);
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
                    const uint4 a = *reinterpret_cast<const uint4*>(s_a + m * kGemmKT + kk);
                    const float2 a0 = unpack_bf16x2(a.x), a1 = unpack_bf16x2(a.y);
                    const float2 a2 = unpack_bf16x2(a.z), a3 = unpack_bf16x2(a.w);
                    float shi = a0.x * whi[0];
                    shi += a0.y * whi[1]; shi += a1.x * whi[2]; shi += a1.y * whi[3];
                    shi += a2.x * whi[4]; shi += a2.y * whi[5]; shi += a3.x * whi[6];
                    shi += a3.y * whi[7];
                    float slo = a0.x * wlo[0];
                    slo += a0.y * wlo[1]; slo += a1.x * wlo[2]; slo += a1.y * wlo[3];
                    slo += a2.x * wlo[4]; slo += a2.y * wlo[5]; slo += a3.x * wlo[6];
                    slo += a3.y * wlo[7];
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
                if (kOutBf16) {
                    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + o) =
                        pack_bf16x2(acc_hi[m], acc_lo[m]);
                } else {
                    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
                        make_float2(acc_hi[m], acc_lo[m]);
                }
            }
        }
    }
}

constexpr int kDqThreads = 256;

template <class Scales>
__global__ void __launch_bounds__(kDqThreads)
dequantize_paired_kernel(const uint8_t* __restrict__ P, Scales scales,
                         __nv_bfloat16* __restrict__ W, int N, int K, int blocksize,
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
    uint4 vh, vl;
    vh.x = pack_bf16x2(hi[0], hi[1]); vh.y = pack_bf16x2(hi[2], hi[3]);
    vh.z = pack_bf16x2(hi[4], hi[5]); vh.w = pack_bf16x2(hi[6], hi[7]);
    vl.x = pack_bf16x2(lo[0], lo[1]); vl.y = pack_bf16x2(lo[2], lo[3]);
    vl.z = pack_bf16x2(lo[4], lo[5]); vl.w = pack_bf16x2(lo[6], lo[7]);
    *reinterpret_cast<uint4*>(W + (size_t)(2 * n2) * K + k) = vh;
    *reinterpret_cast<uint4*>(W + (size_t)(2 * n2 + 1) * K + k) = vl;
}

constexpr int kNtWarps = 8;
constexpr int kNtMT = 8;                            // rows of g per block
constexpr int kNtKT = kNtWarps * 32 * kLaneCols;    // 2048 columns of K per block
constexpr int kNtNC = 1024;                         // columns of g staged per step (32 KB f32)

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// part[split, m, k]: block (kx, split, mt) sums rows [split*rows, ...) of N.
template <bool kGBf16, class Scales>
__global__ void __launch_bounds__(kNtWarps * 32)
gemm_4bit_paired_nt_kernel(const void* __restrict__ G, const uint8_t* __restrict__ P, Scales scales,
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
            if (m < mrows) {
                const size_t o = (size_t)(m0 + m) * N + c0 + c;
                v = kGBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(G)[o])
                           : static_cast<const float*>(G)[o];
            }
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
                    if (kGBf16) {
                        ghi = round_bf16(ghi);
                        glo = round_bf16(glo);
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
template <bool kOutBf16>
__global__ void __launch_bounds__(256)
nt_reduce_kernel(const float* __restrict__ part, void* __restrict__ out, long long mk, int splits) {
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    if (i >= mk) return;
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s += part[(size_t)sp * mk + i];
    if (kOutBf16)
        static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(s);
    else
        static_cast<float*>(out)[i] = s;
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

template <class Scales>
int launch_gemm(const void* A, const uint8_t* P, const Scales& sc, void* out, int M, int N,
                int K, int blocksize, const float* units, int out_bf16, cudaStream_t stream) {
    const Units16 u = load_units(units);
    const dim3 grid((N / 2 + kGemmWarps - 1) / kGemmWarps, (M + kGemmMT - 1) / kGemmMT);
    const auto* a = static_cast<const __nv_bfloat16*>(A);
    if (out_bf16)
        gemm_4bit_paired_kernel<true, Scales><<<grid, kGemmWarps * 32, 0, stream>>>(
            a, P, sc, out, M, N, K, blocksize, u);
    else
        gemm_4bit_paired_kernel<false, Scales><<<grid, kGemmWarps * 32, 0, stream>>>(
            a, P, sc, out, M, N, K, blocksize, u);
    return (int)cudaGetLastError();
}

template <class Scales>
int launch_dequant(const uint8_t* P, const Scales& sc, void* W, int N, int K, int blocksize,
                   const float* units, cudaStream_t stream) {
    const Units16 u = load_units(units);
    const long long total = (long long)(N / 2) * (K / 8);
    if (total > 0) {
        const long long grid = (total + kDqThreads - 1) / kDqThreads;
        dequantize_paired_kernel<Scales><<<(unsigned)grid, kDqThreads, 0, stream>>>(
            P, sc, static_cast<__nv_bfloat16*>(W), N, K, blocksize, u);
    }
    return (int)cudaGetLastError();
}

template <class Scales>
int launch_nt(const void* G, const uint8_t* P, const Scales& sc, float* part, void* out, int M, int N,
              int K, int blocksize, int rows_per_split, int splits, const float* units, int g_bf16,
              cudaStream_t stream) {
    if (!gemm_shape_ok(M, N, K, blocksize) || rows_per_split < 2 || rows_per_split % 2 || splits < 1
        || (long long)rows_per_split * (splits - 1) >= N || (long long)rows_per_split * splits < N)
        return (int)cudaErrorInvalidValue;
    const Units16 u = load_units(units);
    const dim3 grid((K + kNtKT - 1) / kNtKT, splits, (M + kNtMT - 1) / kNtMT);
    if (g_bf16)
        gemm_4bit_paired_nt_kernel<true, Scales><<<grid, kNtWarps * 32, 0, stream>>>(
            G, P, sc, part, M, N, K, blocksize, rows_per_split, u);
    else
        gemm_4bit_paired_nt_kernel<false, Scales><<<grid, kNtWarps * 32, 0, stream>>>(
            G, P, sc, part, M, N, K, blocksize, rows_per_split, u);
    const long long mk = (long long)M * K;
    const unsigned rgrid = (unsigned)((mk + 255) / 256);
    if (g_bf16)
        nt_reduce_kernel<true><<<rgrid, 256, 0, stream>>>(part, out, mk, splits);
    else
        nt_reduce_kernel<false><<<rgrid, 256, 0, stream>>>(part, out, mk, splits);
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

BNB_EXPORT int bnb_gemm_4bit_paired(const void* A, const uint8_t* P, const float* absmax_t,
                                    void* out, int M, int N, int K, int blocksize,
                                    const float* units, int out_bf16, cudaStream_t stream) {
    if (!gemm_shape_ok(M, N, K, blocksize)) return (int)cudaErrorInvalidValue;
    return launch_gemm(A, P, F32Scales{absmax_t, N}, out, M, N, K, blocksize, units, out_bf16,
                       stream);
}

BNB_EXPORT int bnb_dequantize_paired(const uint8_t* P, const float* absmax_t, void* W,
                                     int N, int K, int blocksize, const float* units,
                                     cudaStream_t stream) {
    if (!dequant_shape_ok(N, K, blocksize)) return (int)cudaErrorInvalidValue;
    return launch_dequant(P, F32Scales{absmax_t, N}, W, N, K, blocksize, units, stream);
}

// codes_t [K/blocksize, N] uint8, s2 [ceil(N*K/blocksize / 256)] f32 and offset [1]
// f32 on the device; dec on the host.
BNB_EXPORT int bnb_gemm_4bit_paired_dq(const void* A, const uint8_t* P, const uint8_t* codes_t,
                                       const float* s2, const float* offset, void* out, int M, int N,
                                       int K, int blocksize, const float* units,
                                       const DynDecode* dec, int out_bf16, cudaStream_t stream) {
    NestedScales sc;
    if (!gemm_shape_ok(M, N, K, blocksize)
        || !nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc))
        return (int)cudaErrorInvalidValue;
    return launch_gemm(A, P, sc, out, M, N, K, blocksize, units, out_bf16, stream);
}

BNB_EXPORT int bnb_dequantize_paired_dq(const uint8_t* P, const uint8_t* codes_t, const float* s2,
                                        const float* offset, void* W, int N, int K, int blocksize,
                                        const float* units, const DynDecode* dec,
                                        cudaStream_t stream) {
    NestedScales sc;
    if (!dequant_shape_ok(N, K, blocksize)
        || !nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc))
        return (int)cudaErrorInvalidValue;
    return launch_dequant(P, sc, W, N, K, blocksize, units, stream);
}

// G [M, N] bf16 (g_bf16) or f32; part [splits, M, K] f32 scratch; out [M, K]
// in G's type.  Rows [s*rows_per_split, (s+1)*rows_per_split) of N go to split s.
BNB_EXPORT int bnb_gemm_4bit_paired_nt(const void* G, const uint8_t* P, const float* absmax_t,
                                       float* part, void* out, int M, int N, int K, int blocksize,
                                       int rows_per_split, int splits, const float* units,
                                       int g_bf16, cudaStream_t stream) {
    return launch_nt(G, P, F32Scales{absmax_t, N}, part, out, M, N, K, blocksize, rows_per_split,
                     splits, units, g_bf16, stream);
}

BNB_EXPORT int bnb_gemm_4bit_paired_nt_dq(const void* G, const uint8_t* P, const uint8_t* codes_t,
                                          const float* s2, const float* offset, float* part, void* out,
                                          int M, int N, int K, int blocksize, int rows_per_split,
                                          int splits, const float* units, const DynDecode* dec,
                                          int g_bf16, cudaStream_t stream) {
    NestedScales sc;
    if (!nested_scales(codes_t, s2, offset, N, K, blocksize, dec, &sc)) return (int)cudaErrorInvalidValue;
    return launch_nt(G, P, sc, part, out, M, N, K, blocksize, rows_per_split, splits, units, g_bf16,
                     stream);
}
