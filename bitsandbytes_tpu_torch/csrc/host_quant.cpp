// Host-side blockwise quantization kernels (C++/OpenMP).
//
// TPU-native framework analog of the reference's CPU backend
// (csrc/cpu_ops.cpp: OpenMP blockwise quant with codebook search): used to
// quantize multi-GB checkpoints at model-load time on the host CPU without
// occupying the TPU, via ctypes (bitsandbytes_tpu/utils/native.py).
//
// Semantics are bit-identical to the jnp oracle
// (bitsandbytes_tpu/functional/fourbit.py / blockwise.py):
//   scaled = clamp(x / max(absmax, 1e-38), -1, 1)
//   rank   = #{ midpoints < scaled }          (searchsorted-left)
//   pack   = (q[2j] << 4) | q[2j+1]           (high nibble first)

#include <cstdint>
#include <cmath>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float block_absmax(const float* x, int64_t len) {
    float m = 0.0f;
    for (int64_t i = 0; i < len; ++i) {
        float a = std::fabs(x[i]);
        if (a > m) m = a;
    }
    return m;
}

// rank = #{ mids[i] < v } over a sorted midpoint array (exact float compares,
// same as the oracle's searchsorted-left)
template <int NMID>
inline int rank_of(const float* mids, float v) {
    int lo = 0, hi = NMID;  // count in [lo, hi)
    while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (mids[mid] < v)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

}  // namespace

extern "C" {

// 4-bit blockwise quantize.
//   x:        [n] float32 (row-major flattened weight)
//   n:        element count (must be even)
//   mids:     [15] sorted midpoints of the sorted 16-entry codebook
//   order:    [16] rank -> bit-pattern map (identity for NF4)
//   blocksize
//   packed:   out, [n/2] uint8
//   absmax:   out, [ceil(n/blocksize)] float32
void bnb_tpu_quantize_4bit_host(const float* x, int64_t n, const float* mids,
                                const int32_t* order, int64_t blocksize,
                                uint8_t* packed, float* absmax) {
    const int64_t nblocks = (n + blocksize - 1) / blocksize;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const int64_t start = b * blocksize;
        const int64_t len = std::min(blocksize, n - start);
        const float am = block_absmax(x + start, len);
        absmax[b] = am;
        const float inv = 1.0f / std::max(am, 1e-38f);
        for (int64_t i = start; i < start + len; i += 2) {
            float v0 = std::fmin(std::fmax(x[i] * inv, -1.0f), 1.0f);
            int q0 = order[rank_of<15>(mids, v0)];
            int q1 = 0;
            if (i + 1 < start + len) {
                float v1 = std::fmin(std::fmax(x[i + 1] * inv, -1.0f), 1.0f);
                q1 = order[rank_of<15>(mids, v1)];
            }
            packed[i / 2] = static_cast<uint8_t>((q0 << 4) | q1);
        }
    }
}

// 8-bit blockwise quantize against a 256-entry sorted codebook.
void bnb_tpu_quantize_blockwise_host(const float* x, int64_t n,
                                     const float* mids /*[255]*/,
                                     int64_t blocksize, uint8_t* q,
                                     float* absmax) {
    const int64_t nblocks = (n + blocksize - 1) / blocksize;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const int64_t start = b * blocksize;
        const int64_t len = std::min(blocksize, n - start);
        const float am = block_absmax(x + start, len);
        absmax[b] = am;
        const float inv = 1.0f / std::max(am, 1e-38f);
        for (int64_t i = start; i < start + len; ++i) {
            float v = std::fmin(std::fmax(x[i] * inv, -1.0f), 1.0f);
            q[i] = static_cast<uint8_t>(rank_of<255>(mids, v));
        }
    }
}

// 4-bit blockwise dequantize (for host-side verification / CPU serving).
void bnb_tpu_dequantize_4bit_host(const uint8_t* packed, int64_t n,
                                  const float* code /*[16]*/,
                                  const float* absmax, int64_t blocksize,
                                  float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < n / 2; ++j) {
        const uint8_t byte = packed[j];
        const int64_t i0 = 2 * j, i1 = 2 * j + 1;
        out[i0] = code[byte >> 4] * absmax[i0 / blocksize];
        if (i1 < n) out[i1] = code[byte & 0xF] * absmax[i1 / blocksize];
    }
}

int bnb_tpu_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
