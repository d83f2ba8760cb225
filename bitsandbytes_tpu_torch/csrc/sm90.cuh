// Hopper (sm_90a) building blocks of the hand-written kernels: mbarriers, TMA
// tile loads from a tensor map, wgmma with its shared-memory descriptors, and
// setmaxnreg, named barriers.  Used by the causal flash attention forward and
// its dK/dV and dQ kernels (flash_attention.cu).
//
// Shared-memory tiles are the ones TMA writes with CU_TENSOR_MAP_SWIZZLE_128B:
// a box whose inner dimension is 64 16-bit values (128 bytes) lands as rows of
// 128 bytes, the 16-byte chunks of row r XOR-ed with r % 8, so 8 rows make a
// 1024-byte atom.  Every tile starts on a 1024-byte boundary.  A wider row
// (head_dim 128 or 256) is loaded as 64-column chunks, one tile after the
// other.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// After the initializing thread's mbar_init calls, before the block's barrier.
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more from asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}

// --- TMA ---------------------------------------------------------------------

// A box of `map` at the coordinates (innermost first) -> shared memory at
// dst; its bytes complete on `bar`.  One thread issues it.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], "
        "[%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
        "[%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// `bytes` contiguous bytes global -> shared (a multiple of 16, both addresses
// 16-byte aligned); they complete on `bar`.  One thread issues it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Host side.  An error of the encoding comes back as kTmaError + its
// CUresult (kTmaError + CUDA_ERROR_NOT_FOUND when libcuda has no
// cuTensorMapEncodeTiled); the entry points return it like a CUDA error.
constexpr int kTmaError = 10000;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime
// (the library does not link libcuda).
inline EncodeTiledFn encode_tiled_fn() {
    static const EncodeTiledFn fn = [] {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                                               &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
        return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(f) : nullptr;
    }();
    return fn;
}

// A tensor map of 16-bit values (`type`: CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 or
// _FLOAT16) of `rank` dimensions over `base`: sizes `dims` and boxes `box`
// innermost first, `strides` the byte strides of dimensions 1.., the box's
// rows 128-byte swizzled (box[0] must be 64).
inline int encode_16bit_sw128(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                              const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
    const EncodeTiledFn fn = encode_tiled_fn();
    if (fn == nullptr) return kTmaError + (int)CUDA_ERROR_NOT_FOUND;
    cuuint64_t d[5], s[4];
    cuuint32_t bx[5], es[5];
    for (int i = 0; i < rank; ++i) {
        d[i] = dims[i];
        bx[i] = box[i];
        es[i] = 1;
        if (i + 1 < rank) s[i] = strides[i];
    }
    const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, bx,
                          es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

// --- wgmma -------------------------------------------------------------------

// The descriptor of a 128-byte-swizzled 16-bit operand at shared address
// `saddr` (start address, leading and stride byte offsets in 16-byte units,
// layout 1 = 128B swizzle).
// * K-major (the reduction dimension contiguous, as Q and K are): rows of 64
//   k values, 8-row groups `sbo` = 1024 bytes apart, `lbo` unused (16); the k16
//   step j of a 64-column chunk starts 32 j bytes in.
// * MN-major (the output dimension contiguous, as V is for P V): rows of 64
//   n values, one row a k; `lbo` the bytes from one 64-column chunk of n to
//   the next, `sbo` from 8 rows of k to the next 8 (1024).
__device__ __forceinline__ uint64_t gmma_desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
           ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A shared address the compiler must take as new at this point: descriptors
// derived from it are rebuilt where they are used, not hoisted out of a loop
// into registers (16 of them at hd 256, two registers each).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("" : "+r"(x));
    return x;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x N] (+)= a[64 x 16] b[N x 16]^T, E (bf16 or f16) in, f32
// accumulate, both operands K-major in shared memory (descriptors da, db); d
// is added to where scale_d != 0.  The accumulator layout: warp w of the
// warpgroup holds rows 16 w + lane / 4 (d[4 j], d[4 j + 1]) and 8 more
// (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 (lane % 4) + {0, 1}.
template <int N, class E>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

// d[64 x N] (+)= a[64 x 16] b[16 x N], a from registers (warp w's rows 16 w..,
// the mma.sync m16n8k16 A fragment: the accumulator layout of a product
// before it, rounded to E pairs), b MN-major in shared memory (transposed B).
template <int N, class E>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

// The two 16-bit types differ in the instruction's type words alone (TY).
// The accumulator operands of an m64nNk16 product: N / 2 f32 registers.
#define BNB_D32 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define BNB_D64 BNB_D32, \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define BNB_D128 BNB_D64, \
    "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
    "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
    "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
    "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
    "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
    "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
    "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
    "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// "{%0, ..., %(n-1)}" of the accumulators
#define BNB_R32 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define BNB_R64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define BNB_R128 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

#define BNB_WGMMA_SS(NN, TY, REGS, DOUT, PA, PB, PS)                                                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" PS ", 0;\n"                                          \
                 "wgmma.mma_async.sync.aligned.m64n" NN "k16.f32." TY "." TY " {" REGS "}, %" PA ", %" PB  \
                 ", p, 1, 1, 0, 0;\n}\n"                                                                   \
                 : DOUT                                                                                   \
                 : "l"(da), "l"(db), "r"(scale_d))

#define BNB_WGMMA_RS_TB(NN, TY, REGS, DOUT, A0, A1, A2, A3, PB, PS)                                         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" PS ", 0;\n"                                          \
                 "wgmma.mma_async.sync.aligned.m64n" NN "k16.f32." TY "." TY " {" REGS "}, {%" A0 ", %" A1  \
                 ", %" A2 ", %" A3 "}, %" PB ", p, 1, 1, 1;\n}\n"                                          \
                 : DOUT                                                                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <>
__device__ __forceinline__ void wgmma_ss<64, __nv_bfloat16>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    BNB_WGMMA_SS("64", "bf16", BNB_R32, BNB_D32, "32", "33", "34");
}
template <>
__device__ __forceinline__ void wgmma_ss<64, __half>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    BNB_WGMMA_SS("64", "f16", BNB_R32, BNB_D32, "32", "33", "34");
}
template <>
__device__ __forceinline__ void wgmma_ss<128, __nv_bfloat16>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    BNB_WGMMA_SS("128", "bf16", BNB_R64, BNB_D64, "64", "65", "66");
}
template <>
__device__ __forceinline__ void wgmma_ss<128, __half>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    BNB_WGMMA_SS("128", "f16", BNB_R64, BNB_D64, "64", "65", "66");
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<128, __nv_bfloat16>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                                int scale_d) {
    BNB_WGMMA_RS_TB("128", "bf16", BNB_R64, BNB_D64, "64", "65", "66", "67", "68", "69");
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<128, __half>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                         int scale_d) {
    BNB_WGMMA_RS_TB("128", "f16", BNB_R64, BNB_D64, "64", "65", "66", "67", "68", "69");
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<256, __nv_bfloat16>(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                                                int scale_d) {
    BNB_WGMMA_RS_TB("256", "bf16", BNB_R128, BNB_D128, "128", "129", "130", "131", "132", "133");
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<256, __half>(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                                         int scale_d) {
    BNB_WGMMA_RS_TB("256", "f16", BNB_R128, BNB_D128, "128", "129", "130", "131", "132", "133");
}

#undef BNB_WGMMA_SS
#undef BNB_WGMMA_RS_TB
#undef BNB_R32
#undef BNB_R64
#undef BNB_R128
#undef BNB_D32
#undef BNB_D64
#undef BNB_D128

// --- named barriers ----------------------------------------------------------

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a multiple
// of 32: one warpgroup syncs without the others.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- register reallocation between warpgroups (all four warps execute it) ----

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
