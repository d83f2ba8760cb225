// Flash attention of new-token queries over a KV cache: dense or paged, bf16
// or int8 KV.
//
// Replaces two TPU kernels of the JAX package's ops/pallas/flash_cached.py:
// flash_attention_cached (_kernel / _flash_step) in its bf16- and int8-KV
// modes, and flash_attention_paged (_paged_kernel / _flash_paged_jit), the
// same recurrence over a shared block pool walked through per-slot tables.
//
// q   [B, KVH, GT, hd]  bf16, GQA heads folded with positions: row r = g*T + t
// dense: k,v [B, KVH, S, hd], int8 scales ks,vs [B, KVH, S] f32
// paged: k,v [NB, KVH, BS, hd], int8 scales ks,vs [NB, KVH, BS] f32, tables
//        [B, MAXB] int32; logical position p of slot b lies in pool block
//        tables[b, p / BS] at row p % BS, and the logical length is MAXB * BS
// lengths [B]           int32, position of each slot's newest query token
// out [B, KVH, GT, hd]  bf16
// A row's query position is lengths[b] - (T-1) + (r mod T); it attends kv
// positions p <= q_pos (and p > q_pos - window when a window is given).
//
// Numerics follow the TPU kernel: the score is q.k in f32 from bf16 inputs
// (int8 codes are exact in bf16), times the position's K scale (int8), then
// times hd^-0.5; masked scores are -1e30; the online softmax keeps m and l in
// f32 from the unscaled p; p (times the position's V scale, int8) is rounded
// to bf16 before the PV product; the result is divided by max(l, 1e-38).
//
// Bound on the H100: bytes.  Every live K and V row is read once per block
// (2 * hd * 2 B per position in bf16, 2 * hd B + 8 B of scales in int8), and
// the score and PV work is ~4*hd flops per position and row, well under the
// card's rate at decode.  The TPU carries m/l/acc across an ordered S grid
// axis and still streams dead blocks; here one block owns 8 query rows (one
// per warp), loops over the cache in chunks of 64 positions inside the block,
// and stops at the last live position of its rows, so dead positions cost
// neither bytes nor compute.  Rows are independent, so a prefill chunk of up
// to 2048 folded rows is spread over blocks along grid.y.  The K chunk sits in
// shared memory with an odd word stride so that each lane's row (one kv
// position) is read without bank conflicts; V is read along hd, four dims per
// lane.  int8 K/V are widened to bf16 as they are staged, so both types share
// one compute loop.  The paged kernel stages the slot's table entries for its
// kv range in shared memory once, walks the same 64-position chunks from the
// same first position as the dense kernel (a chunk spans several pool blocks
// when BS < 64), and so gives the dense kernel's bits on a pool scattered
// from a dense cache.  It never reads a table entry past the block of the
// slot's last live position.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHD = 128;                 // head dim this kernel takes
constexpr int kChunk = 64;               // kv positions per shared-memory chunk
constexpr int kWarps = 8;                // query rows per block
constexpr int kKStride = kHD + 2;        // padded K row, in bf16 elements (65 words)
// dynamic shared memory a paged block may take without raising the limit:
// the static arrays take under 40 KB of the default 48 KB
constexpr size_t kTableInline = 8192;

template <typename KV, bool kPaged>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
             const KV* __restrict__ v, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ tables,
             const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int KVH, int GT,
             int S, int T, int window, float scale, int maxb, int bs_shift) {
    constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
    __shared__ __align__(16) __nv_bfloat16 s_k[kChunk * kKStride];
    __shared__ __align__(16) __nv_bfloat16 s_v[kChunk * kHD];
    __shared__ float s_q[kWarps][kHD];
    __shared__ float s_p[kWarps][kChunk];
    __shared__ float s_ks[kInt8 ? kChunk : 1];
    __shared__ float s_vs[kInt8 ? kChunk : 1];
    extern __shared__ int s_tbl[];  // paged: table entries of this block's kv range

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.x;  // b * KVH + h
    const int b = bh / KVH;
    const int h = bh - b * KVH;
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

    // row of a kv position in the [rows, hd] view of k/v (and index of its scale)
    const int tlo = s_lo >> bs_shift;
    auto row_of = [&](int pos) -> size_t {
        if constexpr (kPaged) {
            const size_t blk = (size_t)s_tbl[(pos >> bs_shift) - tlo];
            return ((blk * KVH + h) << bs_shift) + (pos & ((1 << bs_shift) - 1));
        } else {
            return (size_t)bh * S + pos;
        }
    };
    if constexpr (kPaged) {
        if (s_hi > s_lo) {
            const int n_tbl = ((s_hi - 1) >> bs_shift) - tlo + 1;
            for (int i = tid; i < n_tbl; i += kWarps * 32) s_tbl[i] = tables[(size_t)b * maxb + tlo + i];
        }
    }
    if (active) {
        const __nv_bfloat16* qr = q + ((size_t)bh * GT + r) * kHD;
        for (int d = lane; d < kHD; d += 32) s_q[warp][d] = __bfloat162float(qr[d]);
    }

    float m = -1e30f, l = 0.0f;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    constexpr int kPer = 16 / sizeof(KV);  // elements per 16-byte load
    constexpr int kLoads = kHD / kPer;     // 16-byte loads per row

    for (int c0 = s_lo; c0 < s_hi; c0 += kChunk) {
        const int n = min(kChunk, s_hi - c0);
        __syncthreads();  // the previous chunk is consumed (s_q, s_tbl are written)
        for (int i = tid; i < n * kLoads; i += kWarps * 32) {
            const int j = i / kLoads;
            const int c = (i - j * kLoads) * kPer;
            const size_t g = row_of(c0 + j) * kHD + c;
            const uint4 kk = *reinterpret_cast<const uint4*>(k + g);
            const uint4 vv = *reinterpret_cast<const uint4*>(v + g);
            uint32_t* dk = reinterpret_cast<uint32_t*>(s_k + j * kKStride + c);
            if constexpr (kInt8) {
                const int8_t* kb = reinterpret_cast<const int8_t*>(&kk);
                const int8_t* vb = reinterpret_cast<const int8_t*>(&vv);
                uint32_t w[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    dk[e] = pack_bf16x2((float)kb[2 * e], (float)kb[2 * e + 1]);
                    w[e] = pack_bf16x2((float)vb[2 * e], (float)vb[2 * e + 1]);
                }
                uint4* dv = reinterpret_cast<uint4*>(s_v + j * kHD + c);
                dv[0] = make_uint4(w[0], w[1], w[2], w[3]);
                dv[1] = make_uint4(w[4], w[5], w[6], w[7]);
            } else {
                dk[0] = kk.x; dk[1] = kk.y; dk[2] = kk.z; dk[3] = kk.w;
                *reinterpret_cast<uint4*>(s_v + j * kHD + c) = vv;
            }
        }
        if constexpr (kInt8) {
            if (tid < n) {
                const size_t rr = row_of(c0 + tid);
                s_ks[tid] = ks[rr];
                s_vs[tid] = vs[rr];
            }
        }
        __syncthreads();
        if (!active) continue;

        float sc[2];
        bool ok[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int j = lane + 32 * hh;
            const int kv_pos = c0 + j;
            ok[hh] = j < n && kv_pos <= q_pos && (window <= 0 || kv_pos > q_pos - window);
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
            if constexpr (kInt8) {
                sc[hh] = ok[hh] ? dot * s_ks[j] * scale : -1e30f;
            } else {
                sc[hh] = ok[hh] ? dot * scale : -1e30f;
            }
        }
        const float m_new = fmaxf(m, warp_max(fmaxf(sc[0], sc[1])));
        const float p0 = ok[0] ? expf(sc[0] - m_new) : 0.0f;
        const float p1 = ok[1] ? expf(sc[1] - m_new) : 0.0f;
        const float corr = expf(m - m_new);
        l = l * corr + warp_sum(p0 + p1);
        m = m_new;
        float w0 = p0, w1 = p1;
        if constexpr (kInt8) {
            w0 = ok[0] ? p0 * s_vs[lane] : 0.0f;
            w1 = ok[1] ? p1 * s_vs[lane + 32] : 0.0f;
        }
        s_p[warp][lane] = __bfloat162float(__float2bfloat16_rn(w0));
        s_p[warp][lane + 32] = __bfloat162float(__float2bfloat16_rn(w1));
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

template <typename KV, bool kPaged>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* tables, const int* lengths, void* out, int B, int KVH, int GT, int S, int T,
           int window, float scale, int maxb, int bs_shift, cudaStream_t stream) {
    const dim3 grid(B * KVH, (GT + kWarps - 1) / kWarps);
    const size_t dyn = kPaged ? (size_t)maxb * sizeof(int) : 0;
    if (dyn > kTableInline) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_kernel<KV, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (e != cudaSuccess) return (int)e;
    }
    flash_kernel<KV, kPaged><<<grid, kWarps * 32, dyn, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), ks, vs, tables, lengths, static_cast<__nv_bfloat16*>(out),
        KVH, GT, S, T, window, scale, maxb, bs_shift);
    return (int)cudaGetLastError();
}

}  // namespace

// ks/vs are NULL for a bf16 cache.
BNB_EXPORT int bnb_flash_attention_cached(const void* q, const void* k, const void* v,
                                          const float* ks, const float* vs, const int* lengths,
                                          void* out, int B, int KVH, int GT, int S, int hd, int T,
                                          int window, float scale, int int8_kv,
                                          cudaStream_t stream) {
    if (hd != kHD || T <= 0 || GT <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
    if (int8_kv)
        return launch<int8_t, false>(q, k, v, ks, vs, nullptr, lengths, out, B, KVH, GT, S, T,
                                     window, scale, 0, 0, stream);
    return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, nullptr, lengths, out, B, KVH,
                                        GT, S, T, window, scale, 0, 0, stream);
}

// ks/vs are NULL for a bf16 pool; bs must be a power of two.
BNB_EXPORT int bnb_flash_attention_paged(const void* q, const void* pool_k, const void* pool_v,
                                         const float* ks, const float* vs, const int* tables,
                                         const int* lengths, void* out, int B, int KVH, int GT,
                                         int maxb, int bs, int hd, int T, int window, float scale,
                                         int int8_kv, cudaStream_t stream) {
    if (hd != kHD || T <= 0 || GT <= 0 || maxb <= 0 || bs <= 0 || (bs & (bs - 1)))
        return (int)cudaErrorInvalidValue;
    const int bs_shift = __builtin_ctz((unsigned)bs);
    const int S = maxb * bs;
    if (int8_kv)
        return launch<int8_t, true>(q, pool_k, pool_v, ks, vs, tables, lengths, out, B, KVH, GT, S,
                                    T, window, scale, maxb, bs_shift, stream);
    return launch<__nv_bfloat16, true>(q, pool_k, pool_v, nullptr, nullptr, tables, lengths, out,
                                       B, KVH, GT, S, T, window, scale, maxb, bs_shift, stream);
}
