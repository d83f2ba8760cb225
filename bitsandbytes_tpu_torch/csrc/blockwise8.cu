// Blockwise 8-bit quantize and dequantize against a codebook of up to 256
// entries (the dynamic map by default).
//
// quantize_blockwise8_kernel replaces the TPU kernel quantize_blockwise_pallas
// (_q_kernel) of the JAX package's ops/pallas/blockwise8.py:
//   absmax = max |x| over the block
//   scaled = clip(x * (1 / absmax), -1, 1)       (inf below FLT_MIN, qt_scale)
//   q      = #{midpoints m_i : m_i < scaled}     (NaN ranks 0)
// with the optional stochastic move to the neighbouring code entry, the
// uniforms given per element (the TPU kernel's "u" mode).
// Bound on the H100: bytes (4 B read, 1 B written per element, plus 4 B of
// absmax per block).  The design is kernel 1's streaming tile (quant_tile.cuh):
// a CUDA block owns R runs of 4096 contiguous f32 elements (16384 a tile,
// 8192 in stochastic mode), each lane 16 of a run in registers, every load
// issued before any is used, so the input is read once; the absmax a shuffle
// max over the lanes of a block up to 512, combined across warps in shared
// memory above; a lane's 16 codes one 16-byte store.  The rank of sorted
// midpoints is a bucket lookup: the scaled value's sign, exponent and top
// mantissa bits index a table built on the host per codebook
// (ops/blockwise8.bucket_table), at a resolution where no bucket holds more
// than one midpoint (six mantissa bits for the dynamic map, 23.6 KB); its
// 8-byte entry holds the count of midpoints below the bucket and the next
// midpoint, so one shared load and one compare give the count.  A sorted
// codebook that no table within 32 KB resolves (the unsigned dynamic map)
// takes an 8-step binary search over its midpoints in shared memory, an
// unsorted one the linear count.  The tile's loads are in flight while the
// block stages the table from device memory into shared memory, once per 64
// KB of input.  Buckets of three midpoints (16-byte entries, four mantissa
// bits, three shared loads an element) ran slower on the H100 (PERF.md §6).
//
// dequantize_blockwise8_kernel replaces dequantize_blockwise_pallas
// (_dq_kernel) of the same file:
//   out = code[q] * absmax[block]   (f32 product, then rounded to the output type)
// Bound: bytes (1 B read, 2 or 4 B written per element).  One thread reads 8
// codes with one 8-byte load, looks them up in a shared-memory table and
// writes 8 values; blocksize >= 32 keeps the 8 inside one block.
//
// The tiles take the blocksizes the JAX package's quantize_blockwise takes
// (quantize: powers of two 32..4096; dequantize: multiples of 8).  Its
// quantize_blockwise_with_code and dequantize_blockwise_with_code take any
// blocksize; the _any instances below serve the others, one CUDA block a
// quantization block (quantize: the block max, then the tile's rank) and one
// element a thread (dequantize).  They are written to be right, not fast.
//
// Built without --use_fast_math and with IEEE division: the codes must equal
// the JAX package's bit for bit.
#include <cuda_fp16.h>

#include "quant_tile.cuh"

namespace {

// The device table (ops/blockwise8._device_tables), in floats: the codebook
// padded to 256, its midpoints padded to 256 with +inf, then 2 * nh bucket
// entries {count (int bits), the next midpoint (+inf past the last)}.
constexpr int kMidOffset = 256;
constexpr int kBucketOffset = 512;
constexpr int kMaxBuckets = 4096;  // 32 KB of shared memory (ops/blockwise8.BUCKET_MAX_ENTRIES)

// How the kernel ranks, by the wrapper's choice (ops/blockwise8._device_tables).
enum RankMode { kLinear = 0, kSearch = 1, kBucket = 2 };

// #{mid < c} for sorted midpoints, c in [-1, 1] (not NaN).  |c|'s exponent
// and top mantissa bits, (bits << 1) >> shift, less lo (at least 0: smaller
// magnitudes share one bucket) index the buckets from zero, the +0 bucket;
// a negative c takes -1 - that index, so the index grows with c (-0 is -1).
// No bucket holds two midpoints, so its count below, plus one compare with
// the next midpoint, is the count.
__device__ __forceinline__ int rank_bucket(float c, const float2* zero, int shift, int lo) {
    const uint32_t b = __float_as_uint(c);
    const int mag = max((int)((b << 1) >> shift) - lo, 0);
    const float2 t = zero[mag ^ ((int)b >> 31)];  // -1 - mag for negative c
    return __float_as_int(t.x) + (c > t.y ? 1 : 0);
}

// #{mid < c} for sorted midpoints padded to 256 with +inf: a branch-free
// binary search, 8 dependent shared loads.
__device__ __forceinline__ int rank_search(float c, const float* mid) {
    int r = 0;
#pragma unroll
    for (int step = 128; step > 0; step >>= 1) r += mid[r + step - 1] < c ? step : 0;
    return r;
}

template <bool kStoch, int kRank>
__global__ void __launch_bounds__(kQtThreads, 2)
quantize_blockwise8_kernel(const float* __restrict__ x, const float* __restrict__ u, uint8_t* __restrict__ q,
                           float* __restrict__ absmax, long long n, int log2bs, const float* __restrict__ tables,
                           int ncode, int nh, int shift, int lo) {
    constexpr int R = kStoch ? 2 : 4;  // runs a tile
    __shared__ float s_wmax[R * kQtWarps];
    __shared__ __align__(16) float s_code[kStoch ? 256 : 1];
    __shared__ __align__(16) float s_mid[kRank == kBucket ? 1 : 256];
    __shared__ __align__(16) float2 s_bucket[kRank == kBucket ? kMaxBuckets : 1];

    const int tid = threadIdx.x;
    const long long base = (long long)blockIdx.x * (R * kQtRun) + tid * kQtLane;
    bool live[R];
    Raw16<float> raw[R]{};
    float uu[kStoch ? R : 1][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        live[r] = base + r * kQtRun < n;
        if (live[r]) load_raw16(x + base + r * kQtRun, raw[r]);
    }
    if constexpr (kStoch) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            Raw16<float> w{};
            if (live[r]) load_raw16(u + base + r * kQtRun, w);
            unpack16(w, uu[r]);  // no instructions: the words are the floats
        }
    }
    // the tables, while the tile's loads are in flight
    const float4* t4 = reinterpret_cast<const float4*>(tables);
    if (tid < 64) {
        if constexpr (kRank != kBucket) reinterpret_cast<float4*>(s_mid)[tid] = __ldg(t4 + kMidOffset / 4 + tid);
        if constexpr (kStoch) reinterpret_cast<float4*>(s_code)[tid] = __ldg(t4 + tid);
    }
    if constexpr (kRank == kBucket)  // 2 * nh entries, a whole number of 16-byte pairs
        for (int i = tid; i < nh; i += kQtThreads)
            reinterpret_cast<float4*>(s_bucket)[i] = __ldg(t4 + kBucketOffset / 4 + i);

    float v[R][16], m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        unpack16(raw[r], v[r]);
        m[r] = 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i) m[r] = fmaxf(m[r], fabsf(v[r][i]));
    }
    __syncthreads();  // the tables
    qt_block_max<R>(m, log2bs, s_wmax);

#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        const long long e = base + r * kQtRun;
        const float scale = qt_scale(m[r]);
        uint32_t qv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const float sc = v[r][i] * scale;
            const float c = fminf(fmaxf(sc, -1.0f), 1.0f);  // the clip; a NaN is ranked apart
            int k;
            if constexpr (kRank == kBucket) {
                k = rank_bucket(c, s_bucket + nh, shift, lo);
            } else if constexpr (kRank == kSearch) {
                k = rank_search(c, s_mid);
            } else {
                k = 0;
                for (int j = 0; j < ncode - 1; ++j) k += (s_mid[j] < c) ? 1 : 0;
            }
            if (isnan(sc)) k = 0;
            if constexpr (kStoch) {
                // the clip keeps a NaN, as in the JAX package: it moves nowhere
                const float s = isnan(sc) ? sc : c;
                const float lower = s_code[k];
                const int nb = min(max(k + (s > lower ? 1 : -1), 0), ncode - 1);
                const float gap = fabsf(s_code[nb] - lower);
                const float p = gap > 0.0f ? fabsf(s - lower) / fmaxf(gap, 1e-20f) : 0.0f;
                if (uu[r][i] < p) k = nb;
            }
            qv[i] = (uint32_t)k;
        }
        store_codes16(q + e, qv);
        if ((e & ((1LL << log2bs) - 1)) == 0) absmax[e >> log2bs] = m[r];
    }
}

template <bool kStoch, int kRank>
void launch_q8(const float* x, const float* u, uint8_t* q, float* absmax, long long n, int log2bs,
               const float* tables, int ncode, int nh, int shift, int lo, cudaStream_t stream) {
    constexpr long long tile = (kStoch ? 2 : 4) * kQtRun;
    const unsigned grid = (unsigned)((n + tile - 1) / tile);
    quantize_blockwise8_kernel<kStoch, kRank><<<grid, kQtThreads, 0, stream>>>(
        x, u, q, absmax, n, log2bs, tables, ncode, nh, shift, lo);
}

template <bool kStoch>
void launch_q8_rank(int rank, const float* x, const float* u, uint8_t* q, float* absmax, long long n, int log2bs,
                    const float* tables, int ncode, int nh, int shift, int lo, cudaStream_t stream) {
    if (rank == kBucket)
        launch_q8<kStoch, kBucket>(x, u, q, absmax, n, log2bs, tables, ncode, nh, shift, lo, stream);
    else if (rank == kSearch)
        launch_q8<kStoch, kSearch>(x, u, q, absmax, n, log2bs, tables, ncode, nh, shift, lo, stream);
    else
        launch_q8<kStoch, kLinear>(x, u, q, absmax, n, log2bs, tables, ncode, nh, shift, lo, stream);
}

constexpr int kDqThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDqThreads)
dequantize_blockwise8_kernel(const uint8_t* __restrict__ q, const float* __restrict__ absmax,
                             T* __restrict__ out, long long n, int blocksize,
                             const float* __restrict__ tables) {
    __shared__ float s_code[256];
    for (int i = threadIdx.x; i < 256; i += kDqThreads) s_code[i] = tables[i];
    __syncthreads();

    const long long i8 = ((long long)blockIdx.x * kDqThreads + threadIdx.x) * 8;
    if (i8 >= n) return;
    const uint2 w = *reinterpret_cast<const uint2*>(q + i8);
    const float am = absmax[i8 / blocksize];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? w.x : w.y;
        v[j] = s_code[(word >> (8 * (j & 3))) & 0xFFu] * am;
    }
    store8(out + i8, v);
}

constexpr int kAnyThreads = 256;

// Any blocksize: CUDA block b owns quantization block b.  Its threads stride
// over the block twice, once for the absmax (fmaxf, as the tile's) and once
// for the codes, ranked as the tile ranks them; the tables are read from
// device memory.
template <bool kStoch, int kRank>
__global__ void __launch_bounds__(kAnyThreads)
quantize_blockwise8_any_kernel(const float* __restrict__ x, const float* __restrict__ u, uint8_t* __restrict__ q,
                               float* __restrict__ absmax, int blocksize, const float* __restrict__ tables,
                               int ncode, int nh, int shift, int lo) {
    __shared__ float s_wmax[kAnyThreads / 32];
    const long long b0 = (long long)blockIdx.x * blocksize;
    float m = 0.0f;
    for (int i = threadIdx.x; i < blocksize; i += kAnyThreads) m = fmaxf(m, fabsf(x[b0 + i]));
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) s_wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    m = s_wmax[0];
    for (int w = 1; w < kAnyThreads / 32; ++w) m = fmaxf(m, s_wmax[w]);
    if (threadIdx.x == 0) absmax[blockIdx.x] = m;
    const float scale = qt_scale(m);
    const float* mid = tables + kMidOffset;
    const float2* zero = reinterpret_cast<const float2*>(tables + kBucketOffset) + nh;
    for (int i = threadIdx.x; i < blocksize; i += kAnyThreads) {
        const float sc = x[b0 + i] * scale;
        const float c = fminf(fmaxf(sc, -1.0f), 1.0f);
        int k;
        if constexpr (kRank == kBucket) {
            k = rank_bucket(c, zero, shift, lo);
        } else if constexpr (kRank == kSearch) {
            k = rank_search(c, mid);
        } else {
            k = 0;
            for (int j = 0; j < ncode - 1; ++j) k += (mid[j] < c) ? 1 : 0;
        }
        if (isnan(sc)) k = 0;
        if constexpr (kStoch) {
            const float s = isnan(sc) ? sc : c;
            const float lower = tables[k];
            const int nb = min(max(k + (s > lower ? 1 : -1), 0), ncode - 1);
            const float gap = fabsf(tables[nb] - lower);
            const float p = gap > 0.0f ? fabsf(s - lower) / fmaxf(gap, 1e-20f) : 0.0f;
            if (u[b0 + i] < p) k = nb;
        }
        q[b0 + i] = (uint8_t)k;
    }
}

template <bool kStoch>
void launch_q8_any(int rank, const float* x, const float* u, uint8_t* q, float* absmax, long long nb, int blocksize,
                   const float* tables, int ncode, int nh, int shift, int lo, cudaStream_t stream) {
    const unsigned grid = (unsigned)nb;
    if (rank == kBucket)
        quantize_blockwise8_any_kernel<kStoch, kBucket><<<grid, kAnyThreads, 0, stream>>>(
            x, u, q, absmax, blocksize, tables, ncode, nh, shift, lo);
    else if (rank == kSearch)
        quantize_blockwise8_any_kernel<kStoch, kSearch><<<grid, kAnyThreads, 0, stream>>>(
            x, u, q, absmax, blocksize, tables, ncode, nh, shift, lo);
    else
        quantize_blockwise8_any_kernel<kStoch, kLinear><<<grid, kAnyThreads, 0, stream>>>(
            x, u, q, absmax, blocksize, tables, ncode, nh, shift, lo);
}

// Any blocksize: one element a thread, its block's absmax at i / blocksize.
template <typename T>
__global__ void __launch_bounds__(kAnyThreads)
dequantize_blockwise8_any_kernel(const uint8_t* __restrict__ q, const float* __restrict__ absmax,
                                 T* __restrict__ out, long long n, int blocksize, const float* __restrict__ tables) {
    const long long i = (long long)blockIdx.x * kAnyThreads + threadIdx.x;
    if (i >= n) return;
    out[i] = from_f32<T>(__ldg(tables + q[i]) * absmax[i / blocksize]);
}

}  // namespace

// x, u (nullable), q, absmax: n elements in whole blocks, x and u 16-byte
// aligned, as q; blocksize a power of two, 32..4096.  tables: the device
// table above; ncode entries used.  rank: a RankMode; kBucket takes the
// table's 2 * nh buckets of at most one midpoint each, indexed as rank_bucket
// takes shift and lo; kSearch needs sorted midpoints.
BNB_EXPORT int bnb_quantize_blockwise8(const float* x, const float* u, uint8_t* q, float* absmax, long long n,
                                       int blocksize, const float* tables, int ncode, int rank, int nh, int shift,
                                       int lo, cudaStream_t stream) {
    int log2bs = 5;
    while (log2bs < 12 && (1 << log2bs) != blocksize) ++log2bs;
    if ((1 << log2bs) != blocksize || n % blocksize || ncode < 2 || ncode > 256 || rank < kLinear ||
        rank > kBucket || (rank == kBucket && (nh <= 0 || 2 * nh > kMaxBuckets || shift < 17 || shift > 24 || lo < 0)))
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        if (u != nullptr) launch_q8_rank<true>(rank, x, u, q, absmax, n, log2bs, tables, ncode, nh, shift, lo, stream);
        else launch_q8_rank<false>(rank, x, u, q, absmax, n, log2bs, tables, ncode, nh, shift, lo, stream);
    }
    return (int)cudaGetLastError();
}

// out_kind: 0 float32, 1 bfloat16, 2 float16.  tables as above (only the
// codebook part is read).
BNB_EXPORT int bnb_dequantize_blockwise8(const uint8_t* q, const float* absmax, void* out,
                                         long long n, int blocksize, const float* tables,
                                         int out_kind, cudaStream_t stream) {
    if (blocksize < 8 || blocksize % 8 || n % blocksize || out_kind < 0 || out_kind > 2)
        return (int)cudaErrorInvalidValue;
    const long long threads = n / 8;
    if (threads > 0) {
        const unsigned grid = (unsigned)((threads + kDqThreads - 1) / kDqThreads);
        if (out_kind == 0)
            dequantize_blockwise8_kernel<float><<<grid, kDqThreads, 0, stream>>>(
                q, absmax, static_cast<float*>(out), n, blocksize, tables);
        else if (out_kind == 1)
            dequantize_blockwise8_kernel<__nv_bfloat16><<<grid, kDqThreads, 0, stream>>>(
                q, absmax, static_cast<__nv_bfloat16*>(out), n, blocksize, tables);
        else
            dequantize_blockwise8_kernel<__half><<<grid, kDqThreads, 0, stream>>>(
                q, absmax, static_cast<__half*>(out), n, blocksize, tables);
    }
    return (int)cudaGetLastError();
}

// The _any instances: any blocksize >= 1, n a whole number of blocks, no
// alignment needed; the other arguments as above.
BNB_EXPORT int bnb_quantize_blockwise8_any(const float* x, const float* u, uint8_t* q, float* absmax, long long n,
                                           int blocksize, const float* tables, int ncode, int rank, int nh,
                                           int shift, int lo, cudaStream_t stream) {
    if (blocksize < 1 || n % blocksize || n / blocksize > 0x7fffffffLL || ncode < 2 || ncode > 256 ||
        rank < kLinear || rank > kBucket ||
        (rank == kBucket && (nh <= 0 || 2 * nh > kMaxBuckets || shift < 17 || shift > 24 || lo < 0)))
        return (int)cudaErrorInvalidValue;
    const long long nb = n / blocksize;
    if (nb > 0) {
        if (u != nullptr) launch_q8_any<true>(rank, x, u, q, absmax, nb, blocksize, tables, ncode, nh, shift, lo, stream);
        else launch_q8_any<false>(rank, x, u, q, absmax, nb, blocksize, tables, ncode, nh, shift, lo, stream);
    }
    return (int)cudaGetLastError();
}

BNB_EXPORT int bnb_dequantize_blockwise8_any(const uint8_t* q, const float* absmax, void* out, long long n,
                                             int blocksize, const float* tables, int out_kind, cudaStream_t stream) {
    if (blocksize < 1 || n % blocksize || out_kind < 0 || out_kind > 2) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const unsigned grid = (unsigned)((n + kAnyThreads - 1) / kAnyThreads);
        if (out_kind == 0)
            dequantize_blockwise8_any_kernel<float><<<grid, kAnyThreads, 0, stream>>>(
                q, absmax, static_cast<float*>(out), n, blocksize, tables);
        else if (out_kind == 1)
            dequantize_blockwise8_any_kernel<__nv_bfloat16><<<grid, kAnyThreads, 0, stream>>>(
                q, absmax, static_cast<__nv_bfloat16*>(out), n, blocksize, tables);
        else
            dequantize_blockwise8_any_kernel<__half><<<grid, kAnyThreads, 0, stream>>>(
                q, absmax, static_cast<__half*>(out), n, blocksize, tables);
    }
    return (int)cudaGetLastError();
}
