// Flash attention of new-token queries over a bf16 KV cache.
//
// Replaces the TPU kernel flash_attention_cached (_kernel / _flash_step) of
// the JAX package's ops/pallas/flash_cached.py, in its bf16-KV mode.
//
// q   [B, KVH, GT, hd]  bf16, GQA heads folded with positions: row r = g*T + t
// k,v [B, KVH, S, hd]   bf16 cache
// lengths [B]           int32, position of each slot's newest query token
// out [B, KVH, GT, hd]  bf16
// A row's query position is lengths[b] - (T-1) + (r mod T); it attends kv
// positions p <= q_pos (and p > q_pos - window when a window is given).
//
// Numerics follow the TPU kernel: the score is q.k in f32 from bf16 inputs,
// times hd^-0.5; masked scores are -1e30; the online softmax keeps m and l in
// f32; p is rounded to bf16 before the PV product; the result is divided by
// max(l, 1e-38).
//
// Bound on the H100: bytes.  Every live K and V row is read once per block
// (2 * hd * 2 B per position) and the score and PV work is ~4*hd flops per
// position and row, well under the card's rate at decode.  The TPU carries
// m/l/acc across an ordered S grid axis and still streams dead blocks; here
// one block owns 8 query rows (one per warp), loops over the cache in chunks
// of 64 positions inside the block, and stops at the last live position of
// its rows, so dead positions cost neither bytes nor compute.  Rows are
// independent, so a prefill chunk of up to 2048 folded rows is spread over
// blocks along grid.y.  The K chunk sits in shared memory with an odd word
// stride so that each lane's row (one kv position) is read without bank
// conflicts; V is read along hd, four dims per lane.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kHD = 128;                 // head dim this kernel takes
constexpr int kChunk = 64;               // kv positions per shared-memory chunk
constexpr int kWarps = 8;                // query rows per block
constexpr int kKStride = kHD + 2;        // padded K row, in bf16 elements (65 words)

__global__ void __launch_bounds__(kWarps * 32)
flash_cached_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int KVH, int GT, int S, int T,
                    int window, float scale) {
    __shared__ __align__(16) __nv_bfloat16 s_k[kChunk * kKStride];
    __shared__ __align__(16) __nv_bfloat16 s_v[kChunk * kHD];
    __shared__ float s_q[kWarps][kHD];
    __shared__ float s_p[kWarps][kChunk];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.x;  // b * KVH + h
    const int b = bh / KVH;
    const int r0 = blockIdx.y * kWarps;
    const int r = r0 + warp;
    const bool active = r < GT;
    const int length = lengths[b];
    const int q_pos = length - (T - 1) + (r % T);

    // the kv range any row of this block can attend
    const int nrows = min(kWarps, GT - r0);
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int i = 0; i < nrows; ++i) {
        const int p = length - (T - 1) + ((r0 + i) % T);
        qmin = min(qmin, p);
        qmax = max(qmax, p);
    }
    int s_lo = window > 0 ? max(0, qmin - window + 1) : 0;
    s_lo = (s_lo / kChunk) * kChunk;
    const int s_hi = min(S, qmax + 1);

    const size_t kv_base = (size_t)bh * S * kHD;
    if (active) {
        const __nv_bfloat16* qr = q + ((size_t)bh * GT + r) * kHD;
        for (int d = lane; d < kHD; d += 32) s_q[warp][d] = __bfloat162float(qr[d]);
    }

    float m = -1e30f, l = 0.0f;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int c0 = s_lo; c0 < s_hi; c0 += kChunk) {
        const int n = min(kChunk, s_hi - c0);
        __syncthreads();  // the previous chunk is consumed (and s_q is written)
        for (int i = tid; i < n * (kHD / 8); i += kWarps * 32) {
            const int row = i / (kHD / 8);
            const int c = (i - row * (kHD / 8)) * 8;
            const size_t g = kv_base + (size_t)(c0 + row) * kHD + c;
            const uint4 kk = *reinterpret_cast<const uint4*>(k + g);
            uint32_t* dk = reinterpret_cast<uint32_t*>(s_k + row * kKStride + c);
            dk[0] = kk.x; dk[1] = kk.y; dk[2] = kk.z; dk[3] = kk.w;
            *reinterpret_cast<uint4*>(s_v + row * kHD + c) = *reinterpret_cast<const uint4*>(v + g);
        }
        __syncthreads();
        if (!active) continue;

        float sc[2];
        bool ok[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int j = lane + 32 * h;
            const int kv_pos = c0 + j;
            ok[h] = j < n && kv_pos <= q_pos && (window <= 0 || kv_pos > q_pos - window);
            float dot = 0.0f;
            if (j < n) {
                const uint32_t* kr = reinterpret_cast<const uint32_t*>(s_k + j * kKStride);
#pragma unroll 8
                for (int w = 0; w < kHD / 2; ++w) {
                    const float2 kf = unpack_bf16x2(kr[w]);
                    dot += s_q[warp][2 * w] * kf.x;
                    dot += s_q[warp][2 * w + 1] * kf.y;
                }
            }
            sc[h] = ok[h] ? dot * scale : -1e30f;
        }
        const float m_new = fmaxf(m, warp_max(fmaxf(sc[0], sc[1])));
        const float p0 = ok[0] ? expf(sc[0] - m_new) : 0.0f;
        const float p1 = ok[1] ? expf(sc[1] - m_new) : 0.0f;
        const float corr = expf(m - m_new);
        l = l * corr + warp_sum(p0 + p1);
        m = m_new;
        s_p[warp][lane] = __bfloat162float(__float2bfloat16_rn(p0));
        s_p[warp][lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
        __syncwarp();
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[d] *= corr;
        for (int j = 0; j < n; ++j) {
            const float pj = s_p[warp][j];
            const uint2 vv = *reinterpret_cast<const uint2*>(s_v + j * kHD + lane * 4);
            const float2 v01 = unpack_bf16x2(vv.x), v23 = unpack_bf16x2(vv.y);
            acc[0] += pj * v01.x;
            acc[1] += pj * v01.y;
            acc[2] += pj * v23.x;
            acc[3] += pj * v23.y;
        }
        __syncwarp();  // s_p is read before the next chunk overwrites it
    }

    if (active) {
        const float denom = fmaxf(l, 1e-38f);
        uint2 o;
        o.x = pack_bf16x2(acc[0] / denom, acc[1] / denom);
        o.y = pack_bf16x2(acc[2] / denom, acc[3] / denom);
        *reinterpret_cast<uint2*>(out + ((size_t)bh * GT + r) * kHD + lane * 4) = o;
    }
}

}  // namespace

BNB_EXPORT int bnb_flash_attention_cached(const void* q, const void* k, const void* v,
                                          const int* lengths, void* out, int B, int KVH,
                                          int GT, int S, int hd, int T, int window,
                                          float scale, cudaStream_t stream) {
    if (hd != kHD || T <= 0 || GT <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid(B * KVH, (GT + kWarps - 1) / kWarps);
    flash_cached_kernel<<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out), KVH, GT,
        S, T, window, scale);
    return (int)cudaGetLastError();
}
