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
// Kernel 9 replaces the TPU kernel gemm_4bit_fused (_gemm4bit_kernel) of the
// JAX package's ops/pallas/gemm4bit.py:
//   out[M, N] = A[M, K] @ dequant(B)^T,   A bf16, f16 or f32, sums in f32.
// Bound on the H100 at decode M: bytes (N*K/2 of payload, N*K/blocksize*4 of
// scales, or 1 B and a 256th of 4 B nested; A and out are small, and the
// products, 2*M*N*K, are far under the tensor cores' rate).  For bf16 and f16
// A, gemm_4bit_fused_tc_kernel (below) runs the products on mma.sync with the
// weight as the m16 operand: one payload byte, two consecutive k of one row,
// is one register of its fragment, decoded as code[q] * scale in exact f32
// and one packed conversion to A's type; a block owns 128 rows of N and up
// to 32 rows of A, so the payload is read once per call up to M 32, behind a
// cp.async ring of 128-column stages, and K is cut into at most 8 splits
// added in split order.  Its nested instance reads the double-quantized
// absmax (u8 codes, second-level scales, offset) through the same ring and
// decodes each scale in place, bit for bit the resolved absmax.  f32 A has
// no exact tensor-core product (TF32 would break its contract), so it keeps
// the CUDA-core body gemm_4bit_fused_f32_kernel: one warp owns two rows n and
// streams each with 16-byte loads (32 columns a lane), A staged in shared
// memory 1024 columns at a time, 8 rows of A per block (larger M is a grid
// dimension), a warp shuffle adds the lanes.
//
// dequantize_4bit_2d_kernel (kernel 10; its _dq entry on FlatNestedScales)
// replaces dequantize_4bit_pallas (_dequant4_kernel):
//   W[e] = dtype(code[q] * absmax[e / blocksize])   over the flat element order
// (q the high nibble of byte e/2 for even e, the low one for odd e; the product
// in exact f32).  Bound: bytes, most of them written (n/2 of payload and the
// scales read, n*sizeof(dtype) written: 78% of the bytes in bf16), so the floor
// on this card is a store-only pass over W (zero_()).  The design is kernel 3's
// (gemm4bit_paired.cu) over the flat order: a block owns a tile of 16384
// contiguous elements, the grid one block a tile.  Each lane issues its 8
// (16-bit W: 4 payload bytes each) or 16 (f32 W: 2 bytes each) payload loads
// before anything waits on them; meanwhile the block stages the tile's scales
// in shared memory, each read once, one a thread (at most 1025, at blocksize
// 16; the nested instance decodes each u8 code there through the 256-entry
// table).  Store j of a lane writes elements j*2048 + 8*tid.. (f32: j*1024 +
// 4*tid..), so a warp's store is 512 contiguous bytes, whole sectors; 8 (f32:
// 4) elements never straddle a quantization block (blocksize % 16 == 0), and a
// lane's scale slot advances by a fixed step, without a division.  The one
// piece that runs past n is written element by element, so no load reads past
// the payload's ceil(n/2) bytes and any element count is taken.  Probes on the
// H100 (PERF.md §6): the earlier body (8 payload bytes and 16 values a thread,
// two 16-byte stores that split sectors) took twice kernel 3's time; this one
// matched kernel 3 only once the codebook parameter stopped being indexed by a
// register (code_entry); a tile of 32768 elements was slower in f32 and even
// in bf16, and a branch-free copy of the loop for full tiles and 32-bit block
// divisions gained nothing.  What still holds it back: 42% over the store
// floor in bf16 (gate_up 0.108 against 0.076 ms), as kernel 3: the reads and
// the scale staging.
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

// --- scales: the f32 absmax, or a double-quantized one decoded in place -----

// absmax[f] (f32, the flat block order f = n * K/blocksize + kb).
struct FlatScales {
    static constexpr bool kNested = false;
    const float* absmax;
    __device__ __forceinline__ void prologue(float*, int, int) const {}
    __device__ __forceinline__ float offset_value() const { return 0.0f; }
    __device__ __forceinline__ float at(const float*, long long f, float) const { return absmax[f]; }
};

// A double-quantized absmax over the canonical dynamic map, in the flat block
// order (on this layout the storage order): fma(code2(codes[f]), s2[f >> 8],
// offset), both multiply-adds fused, so a nested state gives the bits of its
// resolved f32 absmax (QuantState.dequant_absmax).  table is the 256-entry map
// in shared memory, filled by prologue.
struct FlatNestedScales {
    static constexpr bool kNested = true;
    const uint8_t* codes;
    const float* s2;
    const float* offset;  // one float on the device: no host read per call
    DynDecode dec;
    __device__ __forceinline__ void prologue(float* table, int tid, int nthreads) const {
        for (int i = tid; i < 256; i += nthreads) table[i] = dyn_decode(dec, i);
    }
    __device__ __forceinline__ float offset_value() const { return __ldg(offset); }
    __device__ __forceinline__ float at(const float* table, long long f, float off) const {
        return __fmaf_rn(table[codes[f]], s2[f >> 8], off);
    }
};

// --- kernel 9, f32 A: the CUDA-core body ------------------------------------

constexpr int kGemmWarps = 8;
constexpr int kGemmRows = 2;                 // rows of N per warp
constexpr int kGemmMT = 8;                   // rows of A per block
constexpr int kGemmKT = 1024;                // A's staged K tile: 32 KB, all 8 rows
constexpr int kLaneK = 32;                   // columns per lane and step (16 payload bytes)
static_assert(kGemmKT % (32 * kLaneK) == 0, "a K tile holds whole warp steps");

template <class Scales>
__global__ void __launch_bounds__(kGemmWarps * 32)
gemm_4bit_fused_f32_kernel(const float* __restrict__ A, const uint8_t* __restrict__ B, Scales scales,
                           float* __restrict__ out, int M, int N, int K, int blocksize, Code16 code) {
    __shared__ float s_code[16];
    __shared__ float s_table[Scales::kNested ? 256 : 1];
    __shared__ __align__(16) float s_a[kGemmMT * kGemmKT];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 16) s_code[tid] = code.v[tid];
    scales.prologue(s_table, tid, kGemmWarps * 32);  // read after the first K tile's barrier
    const float off = scales.offset_value();

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

    for (int k0 = 0; k0 < K; k0 += kGemmKT) {
        const int kt = min(kGemmKT, K - k0);  // a multiple of 32: K % blocksize == 0, blocksize >= 32
        __syncthreads();                      // the previous tile is consumed (and the tables are set)
        const int vecs = kt / 4;
        for (int i = tid; i < mrows * vecs; i += kGemmWarps * 32) {
            const int m = i / vecs;
            const int v = i - m * vecs;
            *reinterpret_cast<float4*>(s_a + m * kGemmKT + v * 4) =
                *reinterpret_cast<const float4*>(A + (size_t)(m0 + m) * K + k0 + v * 4);
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
                    // 32 columns never straddle a block
                    sc[r] = scales.at(s_table, (long long)n * KB + k / blocksize, off);
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
                        w[r][2 * t] = __fmul_rn(s_code[b >> 4], sc[r]);
                        w[r][2 * t + 1] = __fmul_rn(s_code[b & 15u], sc[r]);
                    }
                }
#pragma unroll
                for (int m = 0; m < kGemmMT; ++m) {
                    if (m < mrows) {
                        float a[8];
                        load8(s_a + m * kGemmKT + kk + sub * 8, a);
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
                if (m < mrows && n0 + r < N) out[(size_t)(m0 + m) * N + n0 + r] = acc[m][r];
    }
}

// --- kernel 9, bf16 and f16 A: tensor cores ----------------------------------
//
// The weight is the mma's m16 operand and A the n8 operand, so the mma's
// reduction axis is K and its rows are N.  In the m16n8k16 A fragment each
// 32-bit register holds two consecutive k of one row, and on this layout one
// payload byte holds exactly that pair (the high nibble the lower k), so a
// byte decodes to one register: code[q] * scale in exact f32 for both
// nibbles, then one packed conversion to A's type (the weight
// A-type(code[q] * absmax) of the plain version, high nibble in the low half).
// Of each 32-column chunk (16 bytes of a row), lane (g = lane / 4, t = lane %
// 4) reads the payload word 4t..4t+3 of rows g and g + 8 of its warp's m16
// tile: bytes 4t and 4t+1 are its reduction indices 2t, 2t+1 and 2t+8, 2t+9 of
// the chunk's first k16 step, bytes 4t+2 and 4t+3 those of its second.  A is
// permuted alike: the lane's B registers are the columns 8t..8t+7 of its row
// of A, one 16-byte load for both steps.  The codebook is 16 f32 words in 16
// banks at the start of shared memory, so any lookup is free of conflicts and
// a nibble times 4 is its address.
//   A block owns kKfTN = 128 rows of N (one m16 tile a warp: no cross-warp
// sum) and up to 32 rows of A (MI n8 tiles, zero rows padding M; above 32, M
// is a grid dimension), so the payload is read once per call up to M 32.  A
// two-stage cp.async ring of kKfTK = 256 columns (128-byte row strips) holds
// each row's payload (16-byte copies), the scale of each (row, 32-column
// chunk) (the slot of chunk c holds the scale of the quantization block
// chunk c lies in; each copy walks its chunk's block along with the stages,
// so the loop divides by nothing), and A's columns in its type.  For a
// nested state, the slot of a block's first chunk in the stage takes the
// 4-byte word of the u8 codes that contains the block's code (any
// K/blocksize: the word is aligned, the code's byte within it is kept
// beside it) and its second-level scale; the thread that copied them decodes
// the scale in place before the stage's barrier and writes it to the slots
// of the block's chunks (kernel 8's way: no global load is held across a
// barrier).  Probe builds on the H100 chose these shapes (PERF.md):
// 128-column stages, three or four stages, more resident blocks, and a
// decode where each lane uses the scale all ran slower.  The plain instance
// keeps its slots row-major (a row's slots in neighbouring lanes share a
// sector), the nested one chunk-major (row-major ran 5-10% slower with its
// in-place decode).  The grid is N/128 row tiles x S splits
// of K x ceil(M/32); S <= 8, whole quantization blocks and whole stages a
// split (ops/gemm4bit._gemm2d_plan); with S > 1 each split writes f32
// partials and splits_reduce_kernel adds them in split order, so a call gives
// the same bits every run.
constexpr int kKfWarps = 8;
constexpr int kKfThreads = kKfWarps * 32;
constexpr int kKfTN = 128;             // rows of N a block: one m16 tile a warp
constexpr int kKfTK = 256;             // columns of K a stage: 128 payload bytes a row
constexpr int kKfMT = 32;              // rows of A a block
constexpr int kKfStages = 2;
constexpr int kKfChunks = kKfTK / 32;  // 32-column chunks a stage: one scale slot each
constexpr int kKfSlots = kKfChunks * kKfTN;

template <int MI, bool kNested>
struct KfLayout {
    static constexpr bool kRowMajor = !kNested;      // slot order: (row, chunk) or (chunk, row)
    static constexpr int kPayStride = kKfTK / 2 + 16;  // bytes a staged row: rows g = 0..7 in distinct banks
    static_assert(kPayStride % 16 == 0 && kPayStride / 16 % 2 == 1, "rows g = 0..7 four banks apart, mod 32");
    static constexpr int kAStride = kKfTK + 32;        // elements a staged row of A: 64 bytes on a bank row
    static_assert(kAStride * 2 % 128 == 64, "conflict-free 16-byte loads of A");
    static constexpr int kPay = kKfTN * kPayStride;
    static constexpr int kSc = kKfSlots * 4;
    static constexpr int kCodes = kNested ? kKfSlots * 4 : 0;  // a nested slot's 4-byte code word
    static constexpr int kShift = kNested ? kKfSlots : 0;      // its code's byte and the slots it fills
    static constexpr int kA = MI * 8 * kAStride * 2;
    static constexpr int kStage = kPay + kSc + kCodes + kShift + kA;
    static constexpr int kTables = 64 + (kNested ? 1024 : 0);  // the codebook, the nested map
    static constexpr int kBytes = kTables + kKfStages * kStage;
    static_assert(kPay % 16 == 0 && kSc % 16 == 0 && kCodes % 16 == 0 && kShift % 16 == 0 && kA % 16 == 0,
                  "16-byte aligned");
    // the slot of chunk c of row r
    static __device__ __forceinline__ int slot(int r, int c) { return kRowMajor ? r * kKfChunks + c : c * kKfTN + r; }
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

// The four registers of one payload word of one row with scale s: register j
// is byte j's two weights (its high nibble, the lower k, in the low half).
template <class TA>
__device__ __forceinline__ void decode_word(uint32_t w, float s, const unsigned char* s_code, uint32_t* r) {
    // every nibble times 4, a byte offset into the codebook, in its byte
    const uint32_t h = (w >> 2) & 0x3C3C3C3Cu, l = (w << 2) & 0x3C3C3C3Cu;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        r[j] = pack2_rn<TA>(__fmul_rn(code_at(s_code, h, j), s), __fmul_rn(code_at(s_code, l, j), s));
}

template <class TA, class Scales, int MI>
__global__ void __launch_bounds__(kKfThreads, 2)
gemm_4bit_fused_tc_kernel(const TA* __restrict__ A, const uint8_t* __restrict__ B, Scales scales,
                          float* __restrict__ part, void* __restrict__ out, int out_f32, int M, int N, int K,
                          int blocksize, int k_per_split, Code16 code) {
    using L = KfLayout<MI, Scales::kNested>;
    extern __shared__ __align__(16) unsigned char smem[];
    const unsigned char* s_code = smem;  // at offset 0: a nibble times 4 is its address
    float* s_table = reinterpret_cast<float*>(smem + 64);
    unsigned char* ring = smem + L::kTables;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_lo = blockIdx.x * kKfTN;
    const int k_lo = blockIdx.y * k_per_split;  // whole quantization blocks and whole stages
    const int k_hi = min(K, k_lo + k_per_split);
    const int m0 = blockIdx.z * kKfMT;
    const int stages = (k_hi - k_lo + kKfTK - 1) / kKfTK;
    const int rows = min(N - n_lo, kKfTN);  // live rows of the tile
    const int KB = K / blocksize;
    const size_t row_bytes = (size_t)(K / 2);

    // Copies, each thread's sources fixed but for a stride a stage: 16-byte
    // payload chunks (a row's in neighbouring lanes, so they leave as one
    // request), A's 16-byte chunks, and the 4-byte scale slots.
    constexpr int kPayCopies = kKfTN * kKfChunks / kKfThreads;  // one 16-byte copy a row's chunk
    constexpr int kAChunks = MI * 8 * (kKfTK / 8);
    constexpr int kACopies = (kAChunks + kKfThreads - 1) / kKfThreads;
    constexpr int kUnits = kKfSlots / kKfThreads;
    static_assert(kKfTN * kKfChunks % kKfThreads == 0 && kKfSlots % kKfThreads == 0, "whole copies a thread");
    const uint8_t* p_src[kPayCopies];
    int p_dst[kPayCopies], p_col[kPayCopies];
    bool p_ok[kPayCopies];
#pragma unroll
    for (int j = 0; j < kPayCopies; ++j) {
        const int i = tid + j * kKfThreads;
        const int r = i / kKfChunks, c = i % kKfChunks;
        p_ok[j] = r < rows;
        p_col[j] = k_lo + 32 * c;  // K % 32 == 0: 32 columns are all in or all out
        p_src[j] = B + (size_t)(n_lo + r) * row_bytes + (k_lo + 32 * c) / 2;
        p_dst[j] = r * L::kPayStride + 16 * c;
    }
    const TA* a_src[kACopies];
    int a_dst[kACopies], a_col[kACopies];
    bool a_ok[kACopies];
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
        const int i = tid + j * kKfThreads;
        const int m = i / (kKfTK / 8), c = i % (kKfTK / 8);
        a_ok[j] = m0 + m < M;
        a_col[j] = k_lo + 8 * c;
        a_src[j] = A + (size_t)(m0 + m) * K + k_lo + 8 * c;
        a_dst[j] = L::kPay + L::kSc + L::kCodes + L::kShift + (m * L::kAStride + 8 * c) * 2;
    }
    const int per_blk = blocksize / 32;  // chunks a quantization block
    int s_blk[kUnits], s_rem[kUnits], s_col[kUnits], s_slot[kUnits], s_c[kUnits];
    long long s_row[kUnits];  // the slot row's first flat block, n * KB
    bool s_ok[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
        const int i = tid + j * kKfThreads;  // neighbouring lanes, neighbouring slots
        const int r = L::kRowMajor ? i / kKfChunks : i % kKfTN, c = L::kRowMajor ? i % kKfChunks : i / kKfTN;
        const int chunk = k_lo / 32 + c;
        s_blk[j] = chunk / per_blk;
        s_rem[j] = chunk % per_blk;
        s_col[j] = k_lo + 32 * c;  // at stage 0
        s_c[j] = c;
        s_slot[j] = L::slot(r, c);
        s_row[j] = (long long)(n_lo + r) * KB;
        s_ok[j] = r < rows;
    }
    float offset = 0.0f;
    if constexpr (Scales::kNested) offset = scales.offset_value();

    auto load = [&](int s, int slot) {
        unsigned char* st = ring + slot * L::kStage;
        const int ks = s * kKfTK;
#pragma unroll
        for (int j = 0; j < kPayCopies; ++j) {
            const bool live = p_ok[j] && p_col[j] + ks < k_hi;
            cp_async16(st + p_dst[j], live ? p_src[j] + ks / 2 : B, live);
        }
#pragma unroll
        for (int j = 0; j < kACopies; ++j) {
            if (kAChunks % kKfThreads && tid + j * kKfThreads >= kAChunks) continue;  // no zeros past the last
            const bool live = a_ok[j] && a_col[j] + ks < k_hi;
            cp_async16(st + a_dst[j], live ? a_src[j] + ks : A, live);
        }
#pragma unroll
        for (int j = 0; j < kUnits; ++j) {
            const bool live = s_ok[j] && s_col[j] + ks < k_hi;
            const long long f = s_row[j] + s_blk[j];  // the flat block of the slot's scale
            float* sd = reinterpret_cast<float*>(st + L::kPay) + s_slot[j];
            if constexpr (Scales::kNested) {
                // the first chunk of a quantization block in the stage copies
                // its scale for the n chunks of the block the stage holds
                const int n = s_rem[j] == 0 || s_c[j] == 0 ? min(per_blk - s_rem[j], kKfChunks - s_c[j]) : 0;
                if (n && live) {
                    cp_async4(st + L::kPay + L::kSc + 4 * s_slot[j], scales.codes + (f & ~3ll), true);
                    cp_async4(sd, scales.s2 + (f >> 8), true);
                }
                st[L::kPay + L::kSc + L::kCodes + s_slot[j]] = (unsigned char)(n << 3 | (live ? f & 3 : 4));
            } else {
                cp_async4(sd, live ? scales.absmax + f : scales.absmax, live);
            }
            // the next stage: this chunk kKfTK columns on
            s_rem[j] += kKfChunks;
            while (s_rem[j] >= per_blk) {
                s_rem[j] -= per_blk;
                ++s_blk[j];
            }
        }
    };
    // A nested stage's scales, decoded in place from this thread's own
    // copies into the slots of the chunks of their block (chunk-major: the
    // next chunk of a row is kKfTN slots on; a dead slot, past N or past the
    // split, is 0).
    auto decode = [&](int s) {
        if constexpr (Scales::kNested) {
            unsigned char* st = ring + (s % kKfStages) * L::kStage;
#pragma unroll
            for (int j = 0; j < kUnits; ++j) {
                const uint32_t tag = st[L::kPay + L::kSc + L::kCodes + s_slot[j]];
                const int n = tag >> 3, sh = tag & 7;
                if (n == 0) continue;
                float* sd = reinterpret_cast<float*>(st + L::kPay) + s_slot[j];
                float v = 0.0f;
                if (sh < 4) {
                    const uint32_t word = *reinterpret_cast<const uint32_t*>(st + L::kPay + L::kSc + 4 * s_slot[j]);
                    v = __fmaf_rn(s_table[(word >> (8 * sh)) & 0xFFu], *sd, offset);
                }
                for (int x = 0; x < n; ++x) sd[x * kKfTN] = v;
            }
        }
    };

    // the first stages in flight, then the tables (read after the loop's first barrier)
#pragma unroll
    for (int s = 0; s < kKfStages - 1; ++s) {
        if (s < stages) load(s, s);
        cp_async_commit();
    }
    if (tid < 16) reinterpret_cast<float*>(smem)[tid] = code.v[tid];
    scales.prologue(s_table, tid, kKfThreads);
    if constexpr (Scales::kNested) __syncthreads();  // the first decode reads the map before the loop's first barrier

    // This lane's part of the mma: m16 tile `warp` (rows g and g + 8), rows
    // of A g of each n8 tile, and of each chunk the payload word t.
    const int g = lane >> 2, t = lane & 3;
    float acc[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mi][x] = 0.0f;

    for (int s = 0; s < stages; ++s) {
        cp_async_wait<kKfStages - 2>();  // this thread's copies of stage s have landed
        decode(s);
        __syncthreads();  // stage s is complete everywhere; the slot of stage s - 1 is free
        const int nxt = s + kKfStages - 1;
        if (nxt < stages) load(nxt, nxt % kKfStages);
        cp_async_commit();

        const unsigned char* st = ring + (s % kKfStages) * L::kStage;
        const unsigned char* pw = st + (warp * 16 + g) * L::kPayStride + 4 * t;
        const float* ssc = reinterpret_cast<const float*>(st + L::kPay);
        const uint4* sa = reinterpret_cast<const uint4*>(st + L::kPay + L::kSc + L::kCodes + L::kShift) +
                          g * (L::kAStride / 8) + t;
        auto chunk = [&](int c) {
            uint32_t w0[4], w1[4];  // rows g and g + 8: register j from byte j
            decode_word<TA>(*reinterpret_cast<const uint32_t*>(pw + 16 * c), ssc[L::slot(warp * 16 + g, c)], s_code,
                            w0);
            decode_word<TA>(*reinterpret_cast<const uint32_t*>(pw + 8 * L::kPayStride + 16 * c),
                            ssc[L::slot(warp * 16 + g + 8, c)], s_code, w1);
            const uint32_t a0[4] = {w0[0], w1[0], w0[1], w1[1]};  // the first k16 step
            const uint32_t a1[4] = {w0[2], w1[2], w0[3], w1[3]};  // the second
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                const uint4 b = sa[mi * L::kAStride + 4 * c];  // 8 rows a tile: mi * 8 * kAStride / 8
                mma16816<TA>(acc[mi], a0, b.x, b.y);
                mma16816<TA>(acc[mi], a1, b.z, b.w);
            }
        };
        const int live = min(kKfTK, k_hi - k_lo - s * kKfTK) / 32;  // chunks inside the split
        if (live == kKfChunks) {
#pragma unroll
            for (int c = 0; c < kKfChunks; ++c) chunk(c);
        } else {
            for (int c = 0; c < live; ++c) chunk(c);
        }
    }
    cp_async_wait<0>();

    // c[h] is row n = g + 8 (h >> 1) of the tile, row m = 2t + (h & 1) of A's tile mi
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const int n = n_lo + warp * 16 + g + 8 * (h >> 1);
            const int m = m0 + mi * 8 + 2 * t + (h & 1);
            if (n >= N || m >= M) continue;
            const float v = acc[mi][h];
            if (part)
                part[((size_t)blockIdx.y * M + m) * N + n] = v;
            else if (out_f32)
                static_cast<float*>(out)[(size_t)m * N + n] = v;
            else
                static_cast<TA*>(out)[(size_t)m * N + n] = from_f32<TA>(v);
        }
}

// --- kernel 10 --------------------------------------------------------------

// The dequantize's tile: kDqTile contiguous flat elements, one tile a block,
// the grid one block a tile.
constexpr int kDqThreads = 256;
constexpr int kDqTile = 16384;              // elements a tile
constexpr int kDqSlots = kDqTile / 16 + 1;  // quantization blocks a tile can touch (blocksize >= 16)

// code.v[i] by selects over constant indices.  Indexing the kernel parameter
// by a register makes every thread copy all 16 entries to local memory first:
// 64 bytes a thread, 117 MB at gate_up, which held kernel 10 well short of
// kernel 3 in probes on the H100.
__device__ __forceinline__ float code_entry(const Code16& code, int i) {
    float c = code.v[0];
#pragma unroll
    for (int k = 1; k < 16; ++k) c = i == k ? code.v[k] : c;
    return c;
}

template <class TOut, class Scales>
__global__ void __launch_bounds__(kDqThreads)
dequantize_4bit_2d_kernel(const uint8_t* __restrict__ B, Scales scales, TOut* __restrict__ W, long long n,
                          int blocksize, Code16 code) {
    constexpr int V = 16 / sizeof(TOut);                // elements of one 16-byte store
    constexpr int U = kDqTile / (kDqThreads * V);       // a lane's stores in a tile
    constexpr int kStep = kDqThreads * V;               // elements between a lane's stores
    using Word = std::conditional_t<V == 8, uint32_t, uint16_t>;  // the payload bytes of one store
    __shared__ float s_code[16];
    __shared__ float s_table[Scales::kNested ? 256 : 1];
    __shared__ float s_sc[kDqSlots];

    const int tid = threadIdx.x;
    const long long t0 = (long long)blockIdx.x * kDqTile;
    const int live = (int)min((long long)kDqTile, n - t0);  // elements of this tile

    // the payload first: its loads are in flight while the scales are staged.
    // Store j of a warp writes elements (j * kDqThreads + tid) * V..: 512
    // contiguous bytes, whole sectors.  A piece that runs past n is left to
    // the tail below, so no load reads past the payload's ceil(n/2) bytes.
    Word p[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int e = j * kStep + tid * V;
        if (e + V <= live) p[j] = __ldcs(reinterpret_cast<const Word*>(B + ((t0 + e) >> 1)));
    }
    if (tid < 16) s_code[tid] = code_entry(code, tid);
    scales.prologue(s_table, tid, kDqThreads);
    if constexpr (Scales::kNested) __syncthreads();  // the table, before the staging loop reads it
    // the tile's scales, each read (and decoded) once, one a thread:
    // quantization blocks first..first + slots - 1
    const long long first = t0 / blocksize;
    const int slots = (int)((t0 + live - 1) / blocksize - first) + 1;
    const float off = scales.offset_value();
    for (int i = tid; i < slots; i += kDqThreads) s_sc[i] = scales.at(s_table, first + i, off);
    __syncthreads();

    // a lane's slot walks by kStep elements a store: no division in the loop
    const int lead = (int)(t0 - first * blocksize);  // elements of block `first` before the tile
    int slot = (lead + tid * V) / blocksize, rem = (lead + tid * V) - slot * blocksize;
    const int step_q = kStep / blocksize, step_r = kStep - step_q * blocksize;
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int e = j * kStep + tid * V;
        if (e + V <= live) {  // V elements never straddle a quantization block (blocksize % 16 == 0)
            const float sc = s_sc[slot];
            float v[V];
#pragma unroll
            for (int t = 0; t < V / 2; ++t) {
                const uint32_t b = (p[j] >> (8 * t)) & 0xFFu;
                v[2 * t] = __fmul_rn(s_code[b >> 4], sc);
                v[2 * t + 1] = __fmul_rn(s_code[b & 15u], sc);
            }
            store16(W + t0 + e, v);
        } else if (e < live) {  // the partial last piece, element by element
            for (int x = e; x < live; ++x) {
                const long long g = t0 + x;
                const uint32_t b = B[g >> 1];
                const uint32_t q = (g & 1) ? (b & 15u) : (b >> 4);
                W[g] = from_f32<TOut>(__fmul_rn(s_code[q], s_sc[(lead + x) / blocksize]));
            }
        }
        slot += step_q;
        rem += step_r;
        if (rem >= blocksize) {
            rem -= blocksize;
            ++slot;
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

// out[i] = sum over splits, in split order, of part[split, i] (kernel 9's
// [M, N] partials, kernel 11's [M, K]).
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

template <class TA, class Scales, int MI>
int launch_gemm_tc(const void* A, const uint8_t* B, const Scales& sc, float* part, void* out, int out_f32, int M,
                   int N, int K, int blocksize, int k_per_split, int splits, const Code16& code, cudaStream_t stream) {
    using L = KfLayout<MI, Scales::kNested>;
    const cudaError_t e = cudaFuncSetAttribute(gemm_4bit_fused_tc_kernel<TA, Scales, MI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + kKfTN - 1) / kKfTN, splits, (M + kKfMT - 1) / kKfMT);
    gemm_4bit_fused_tc_kernel<TA, Scales, MI><<<grid, kKfThreads, L::kBytes, stream>>>(
        static_cast<const TA*>(A), B, sc, splits > 1 ? part : nullptr, out, out_f32, M, N, K, blocksize, k_per_split,
        code);
    if (splits > 1) {  // queued at once behind it: no host round trip between the two
        const long long mn = (long long)M * N;
        const unsigned blocks = (unsigned)((mn + 255) / 256);
        if (out_f32)
            splits_reduce_kernel<float><<<blocks, 256, 0, stream>>>(part, static_cast<float*>(out), mn, splits);
        else
            splits_reduce_kernel<TA><<<blocks, 256, 0, stream>>>(part, static_cast<TA*>(out), mn, splits);
    }
    return (int)cudaGetLastError();
}

template <class TA, class Scales>
int launch_gemm_tc_m(const void* A, const uint8_t* B, const Scales& sc, float* part, void* out, int out_f32, int M,
                     int N, int K, int blocksize, int k_per_split, int splits, const Code16& code,
                     cudaStream_t stream) {
    if (M <= 8)
        return launch_gemm_tc<TA, Scales, 1>(A, B, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits,
                                             code, stream);
    if (M <= 16)
        return launch_gemm_tc<TA, Scales, 2>(A, B, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits,
                                             code, stream);
    return launch_gemm_tc<TA, Scales, 4>(A, B, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits, code,
                                         stream);
}

// The shapes and the split plan, checked before anything is read: splits of
// K covering it, none empty.  The caller chooses the kernel (tc,
// ops/gemm4bit._gemm2d_uses_tc): the tensor-core one takes 16-bit A, splits
// of whole quantization blocks and whole stages (k_per_split a multiple of
// both) and partials for more than one split; the CUDA-core one f32 A, an f32
// out and one split.
bool gemm_args_ok(int M, int N, int K, int blocksize, int k_per_split, int splits, int tc, const float* part,
                  int a_kind, int out_f32) {
    if (M <= 0 || !shape_ok(N, K, blocksize) || k_per_split < 1 || splits < 1
        || (long long)k_per_split * (splits - 1) >= K || (long long)k_per_split * splits < K)
        return false;
    if (tc)
        return (a_kind == kBf16 || a_kind == kF16) && k_per_split % blocksize == 0 && k_per_split % kKfTK == 0
               && (splits == 1 || part != nullptr);
    return a_kind == kF32 && out_f32 && splits == 1;
}

// out in A's type, or f32 when out_f32.
template <class Scales>
int launch_gemm(const void* A, const uint8_t* B, const Scales& sc, float* part, void* out, int M, int N, int K,
                int blocksize, int k_per_split, int splits, int tc, const float* code, int a_kind, int out_f32,
                cudaStream_t stream) {
    const Code16 c = load_code(code);
    if (!tc) {
        const dim3 grid((N + kGemmWarps * kGemmRows - 1) / (kGemmWarps * kGemmRows), (M + kGemmMT - 1) / kGemmMT);
        gemm_4bit_fused_f32_kernel<Scales><<<grid, kGemmWarps * 32, 0, stream>>>(
            static_cast<const float*>(A), B, sc, static_cast<float*>(out), M, N, K, blocksize, c);
        return (int)cudaGetLastError();
    }
    if (a_kind == kBf16)
        return launch_gemm_tc_m<__nv_bfloat16>(A, B, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits,
                                               c, stream);
    return launch_gemm_tc_m<__half>(A, B, sc, part, out, out_f32, M, N, K, blocksize, k_per_split, splits, c, stream);
}

template <class Scales>
int launch_dequant(const uint8_t* B, const Scales& sc, void* W, long long n, int blocksize, const float* code,
                   int out_kind, cudaStream_t stream) {
    if (n <= 0 || blocksize < 16 || blocksize % 16) return (int)cudaErrorInvalidValue;
    const Code16 c = load_code(code);
    const unsigned grid = (unsigned)((n + kDqTile - 1) / kDqTile);
    switch (out_kind) {
        case kF32:
            dequantize_4bit_2d_kernel<float, Scales><<<grid, kDqThreads, 0, stream>>>(
                B, sc, static_cast<float*>(W), n, blocksize, c);
            break;
        case kBf16:
            dequantize_4bit_2d_kernel<__nv_bfloat16, Scales><<<grid, kDqThreads, 0, stream>>>(
                B, sc, static_cast<__nv_bfloat16*>(W), n, blocksize, c);
            break;
        case kF16:
            dequantize_4bit_2d_kernel<__half, Scales><<<grid, kDqThreads, 0, stream>>>(
                B, sc, static_cast<__half*>(W), n, blocksize, c);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

bool nested_ok(const DynDecode* dec) { return dec->nseg >= 1 && dec->nseg <= kMaxSegments; }

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
// Columns [s*k_per_split, (s+1)*k_per_split) of K go to split s.  tc != 0
// runs the tensor-core kernel, which takes bf16 and f16 A and splits of whole
// quantization blocks and 256-column stages; part [splits, M, N] f32 scratch
// is unread, and may be NULL, for one split.  tc == 0 runs the CUDA-core
// kernel: f32 A, f32 out, one split.  A plan the chosen kernel cannot take is
// refused.
BNB_EXPORT int bnb_gemm_4bit_fused(const void* A, const uint8_t* B, const float* absmax, float* part, void* out,
                                   int M, int N, int K, int blocksize, int k_per_split, int splits, int tc,
                                   const float* code, int a_kind, int out_f32, cudaStream_t stream) {
    if (!gemm_args_ok(M, N, K, blocksize, k_per_split, splits, tc, part, a_kind, out_f32))
        return (int)cudaErrorInvalidValue;
    return launch_gemm(A, B, FlatScales{absmax}, part, out, M, N, K, blocksize, k_per_split, splits, tc, code,
                       a_kind, out_f32, stream);
}

// codes [N*K/blocksize] uint8 over the canonical dynamic map, s2
// [ceil(N*K/blocksize / 256)] f32 and offset [1] f32 on the device, in the
// flat block order; dec on the host.  The plan as bnb_gemm_4bit_fused's.
BNB_EXPORT int bnb_gemm_4bit_fused_dq(const void* A, const uint8_t* B, const uint8_t* codes, const float* s2,
                                      const float* offset, float* part, void* out, int M, int N, int K,
                                      int blocksize, int k_per_split, int splits, int tc, const float* code,
                                      const DynDecode* dec, int a_kind, int out_f32, cudaStream_t stream) {
    if (!gemm_args_ok(M, N, K, blocksize, k_per_split, splits, tc, part, a_kind, out_f32) || !nested_ok(dec))
        return (int)cudaErrorInvalidValue;
    return launch_gemm(A, B, FlatNestedScales{codes, s2, offset, *dec}, part, out, M, N, K, blocksize, k_per_split,
                       splits, tc, code, a_kind, out_f32, stream);
}

// B: the packed bytes of n elements in the flat order; absmax [ceil(n/blocksize)]
// f32; W [n] (out_kind: 0 f32, 1 bf16, 2 f16).  code on the host.
BNB_EXPORT int bnb_dequantize_4bit_2d(const uint8_t* B, const float* absmax, void* W, long long n,
                                      int blocksize, const float* code, int out_kind, cudaStream_t stream) {
    return launch_dequant(B, FlatScales{absmax}, W, n, blocksize, code, out_kind, stream);
}

// codes [ceil(n/blocksize)] uint8, s2 [ceil(codes / 256)] f32 and offset [1]
// f32 on the device; dec on the host.
BNB_EXPORT int bnb_dequantize_4bit_2d_dq(const uint8_t* B, const uint8_t* codes, const float* s2,
                                         const float* offset, void* W, long long n, int blocksize,
                                         const float* code, const DynDecode* dec, int out_kind,
                                         cudaStream_t stream) {
    if (!nested_ok(dec)) return (int)cudaErrorInvalidValue;
    return launch_dequant(B, FlatNestedScales{codes, s2, offset, *dec}, W, n, blocksize, code, out_kind, stream);
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
