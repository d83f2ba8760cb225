"""N-paired 4-bit payload: layout helpers, the decode GEMM and the dequantize.

Counterpart of the JAX package's ``ops/pallas/gemm4bit_paired.py``.  The
byte at ``[n2, k]`` holds weight rows ``2*n2`` (high nibble) and ``2*n2+1``
(low nibble) at column ``k``; quantization blocks still run along K per row,
and the absmax is stored transposed ``[K/blocksize, N]``.

The kernels, all in ``csrc/gemm4bit_paired.cu``:

* :func:`gemm_4bit_paired` replaces ``gemm_4bit_paired`` (``_paired_kernel``):
  ``out[M, N] = A[M, K] @ dequant(P)^T`` with bf16-rounded unit codes, an f32
  partial dot per quant block scaled by the f32 absmax and summed in f32; A
  in bf16, f16 or f32, read exactly (the TPU kernel splits an f32 A into
  bf16 hi + lo).
  Bound by bytes at decode M (the payload is N*K/2 bytes).  bf16 and f16 A
  run on the tensor cores (``mma.sync``, the weight's unit codes as A, the
  activations as B), each payload byte read and decoded once per 32 rows of
  A; K is cut into at most 8 splits (:func:`gemm_plan`) whose f32 partials
  a second pass adds in split order.  f32 A keeps exact f32 products on the
  CUDA cores, one warp streaming one row pair along K.
* :func:`dequantize_paired_fast` replaces ``dequantize_paired_fast``
  (``_paired_dequant_kernel``): ``W[N, K] = dtype(unit(code) * absmax)`` (bf16,
  f16 or f32) for the large-M route.  Bound by bytes, most of them written.
  One block a tile of 8 row pairs x 1024 columns: each lane's payload loads
  issued at once, the tile's scales staged once in shared memory, each
  warp's 16-byte stores one contiguous run of a row of W; every shape the
  wrapper takes runs it.
* :func:`gemm_4bit_paired_dq` and :func:`dequantize_paired_fast_dq` replace
  ``gemm_4bit_paired_dq`` and ``dequantize_paired_fast_dq``: the same two
  kernels on a double-quantized absmax, uint8 codes ``[K/blocksize, N]``
  over the canonical dynamic map, one f32 ``s2`` per 256 first-level blocks
  in flat order and an f32 offset, decoded where each scale is loaded as
  ``fma(code2(u8), s2[(n*KB + kb) >> 8], offset)`` (see
  ``functional/dynamic_segments.py``).  Bit-identical to the plain kernels
  on the resolved f32 absmax, and 3 B lighter per 64 weights.
* :func:`gemm_4bit_paired_nt` and :func:`gemm_4bit_paired_nt_dq` replace
  ``gemm_4bit_paired_nt`` and ``gemm_4bit_paired_nt_dq``: the 4-bit matmul
  backward ``grad_A[M, K] = g[M, N] @ dequant(P)[N, K]``.  Per K quant block,
  ``g`` (bf16, f16 or f32) times that block's scale of each row, rounded to
  bf16 unless ``g`` is float32, dotted with the bf16-rounded unit codes over N in f32, cast to
  ``g``'s type.  Bound by bytes at small M.  bf16 and f16 ``g`` run on the
  tensor cores (``mma.sync``, ``bf16(g * scale)`` as A, the unit codes as
  B), each payload byte read and decoded once per 32 rows of ``g``; N is cut
  into at most 8 splits (:func:`nt_plan`) whose f32 partials a second pass
  adds in split order.  f32 ``g`` keeps exact f32 products on the CUDA
  cores.

A CPU tensor goes to the plain version of each, written to the same
numerics; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..functional.dynamic_segments import dequant_nested_dynamic, dynamic_sym_table, kernel_table
from . import _lib
from .dispatch import use_kernel

__all__ = [
    "pack_npaired",
    "unpack_npaired",
    "repack_2d_to_npaired",
    "repack_npaired_to_2d",
    "decode_units",
    "gemm_4bit_paired",
    "gemm_4bit_paired_plain",
    "dequantize_paired_fast",
    "dequantize_paired_fast_plain",
    "nested_absmax_t",
    "gemm_4bit_paired_dq",
    "gemm_4bit_paired_dq_plain",
    "dequantize_paired_fast_dq",
    "dequantize_paired_fast_dq_plain",
    "gemm_4bit_paired_nt",
    "gemm_4bit_paired_nt_plain",
    "gemm_4bit_paired_nt_dq",
    "gemm_4bit_paired_nt_dq_plain",
    "nt_plan",
    "gemm_plan",
]

# Quant blocks per batched product in the plain GEMM: bounds its
# [blocks, M, N] f32 intermediate.
_PLAIN_BLOCK_CHUNK = 16

# the CUDA kernels' operand types (the C entry points' a_kind / out_kind / g_kind)
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pack_npaired(q: torch.Tensor) -> torch.Tensor:
    """Pack codes ``q [N, K]`` along N: ``byte[n2, k] = q[2n2, k] << 4 | q[2n2+1, k]``."""
    q = q.to(torch.uint8)
    return (q[0::2, :] << 4) | q[1::2, :]


def unpack_npaired(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_npaired`: ``[N/2, K] -> [N, K]`` codes."""
    n2, K = packed.shape
    return torch.stack([packed >> 4, packed & 0xF], dim=1).reshape(2 * n2, K)


def repack_2d_to_npaired(packed_2d: torch.Tensor, shape) -> torch.Tensor:
    """K-adjacent pair layout ``[N, K/2]`` (interop order) -> ``[N/2, K]``."""
    N, K = shape
    flat = packed_2d.reshape(N, K // 2)
    q = torch.stack([flat >> 4, flat & 0xF], dim=-1).reshape(N, K)
    return pack_npaired(q)


def repack_npaired_to_2d(packed_p: torch.Tensor) -> torch.Tensor:
    """Inverse relayout: ``[N/2, K] -> [N, K/2]`` interop byte order."""
    q = unpack_npaired(packed_p)
    N, K = q.shape
    pairs = q.reshape(N, K // 2, 2)
    return (pairs[..., 0] << 4) | pairs[..., 1]


@functools.lru_cache(maxsize=None)
def _units(code_t: tuple) -> tuple:
    """bf16-rounded (nearest even) codebook entries as f32 floats."""
    t = torch.tensor(code_t, dtype=torch.float32).to(torch.bfloat16).to(torch.float32)
    return tuple(float(x) for x in t)


def _code_tuple(code) -> tuple:
    return tuple(float(x) for x in np.asarray(code, dtype=np.float32).reshape(-1)[:16])


def decode_units(P: torch.Tensor, units: tuple) -> torch.Tensor:
    """Paired bytes ``[N/2, K]`` -> f32 unit values ``[N, K]`` in row order."""
    table = torch.tensor(units, dtype=torch.float32, device=P.device)
    n2, K = P.shape
    hi = table[(P >> 4).long()]
    lo = table[(P & 0xF).long()]
    return torch.stack([hi, lo], dim=1).reshape(2 * n2, K)


def gemm_4bit_paired_plain(A2, P, absmax_t, units, blocksize: int) -> torch.Tensor:
    """``A2 [M, K]`` -> f32 ``[M, N]``: one f32 sub-dot per quant block times
    its f32 absmax, summed in f32."""
    M, K = A2.shape
    U = decode_units(P, units)
    N = U.shape[0]
    nb = K // blocksize
    A3 = A2.to(torch.float32).reshape(M, nb, blocksize).transpose(0, 1)  # [nb, M, bs]
    U3 = U.reshape(N, nb, blocksize).permute(1, 2, 0)  # [nb, bs, N]
    out = torch.zeros(M, N, dtype=torch.float32, device=A2.device)
    for c in range(0, nb, _PLAIN_BLOCK_CHUNK):
        sub = torch.bmm(A3[c : c + _PLAIN_BLOCK_CHUNK], U3[c : c + _PLAIN_BLOCK_CHUNK])
        out += (sub * absmax_t[c : c + _PLAIN_BLOCK_CHUNK, None, :]).sum(0)
    return out


def _check_payload(P, absmax_t, N: int, K: int, blocksize: int) -> None:
    if P.dtype != torch.uint8 or tuple(P.shape) != (N // 2, K) or not P.is_contiguous():
        raise ValueError(f"P must be a contiguous uint8 [{N // 2}, {K}] tensor")
    if (
        absmax_t.dtype != torch.float32
        or tuple(absmax_t.shape) != (K // blocksize, N)
        or not absmax_t.is_contiguous()
    ):
        raise ValueError(f"absmax_t must be a contiguous float32 [{K // blocksize}, {N}] tensor")


def _check_aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernels need 16-byte aligned tensors")


def _check_cuda_A(A, out_dtype) -> None:
    if A.dtype not in _KIND or not A.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous bf16, f16 or float32 A")
    if out_dtype not in (A.dtype, torch.float32):
        raise ValueError(f"the CUDA kernel writes A's type or float32, not {out_dtype}")


# the tensor-core forward kernel's tiles (kernels 2 and 5, bf16 and f16 A):
# 128 rows of N a block, 128 columns of K a stage, 32 rows of A a block, two
# blocks resident on an SM; splits of K of whole quantization blocks and whole
# stages, at most 8
_FW_TN, _FW_TK, _FW_MT, _FW_RESIDENT, _FW_MAX_SPLITS = 128, 128, 32, 2, 8


def gemm_plan(M: int, N: int, K: int, blocksize: int, sms: int, stage: int = _FW_TK):
    """The tensor-core forward kernels' columns of K per split and number of
    splits S <= 8, for blocks of 128 rows of N and 32 rows of A.  A split
    holds whole quantization blocks and whole ``stage``-column units (128
    for kernels 2 and 5, 256 for kernel 9).  S is the most splits whose grid
    of ``tiles * S`` blocks stays resident in one wave (two blocks on each of
    ``sms`` SMs), so the most payload bytes are in flight; a grid of a wave or
    more keeps S = 1.  A pure function of the shapes and the SM count, so a
    call's bits do not depend on the run."""
    unit = math.lcm(blocksize, stage)
    units = -(-K // unit)
    tiles = -(-N // _FW_TN) * -(-M // _FW_MT)
    s = max(1, min(_FW_MAX_SPLITS, units, _FW_RESIDENT * sms // tiles))
    per_split = -(-units // s) * unit
    return per_split, -(-K // per_split)


def _gemm_uses_tc(dtype, blocksize: int) -> bool:
    """Whether kernels 2 and 5 run on the tensor cores: the one place this
    is decided; the C entry points take the answer and refuse a plan the
    chosen kernel cannot take.  f32 A has no exact tensor-core product (TF32
    keeps 10 bits), and a stage's scale slots, one per 32 columns, need
    blocksize % 32 == 0 (every quantization blocksize; the ops-level
    wrappers also take others, with scales made by hand)."""
    return dtype != torch.float32 and blocksize % 32 == 0


def _launch_gemm(entry: str, A2, P, scale_ptrs, extra, M: int, N: int, K: int, blocksize: int, units, out_dtype):
    tc = _gemm_uses_tc(A2.dtype, blocksize)
    k_per_split, splits = gemm_plan(M, N, K, blocksize, _sm_count(A2.device.index or 0)) if tc else (K, 1)
    # the tensor-core kernel writes out directly where there is one split
    part = torch.empty(splits * M * N, dtype=torch.float32, device=A2.device) if splits > 1 else None
    out = torch.empty(M, N, dtype=out_dtype, device=A2.device)
    err = getattr(_lib.lib(), "bnb_" + entry)(
        A2.data_ptr(), P.data_ptr(), *scale_ptrs, None if part is None else part.data_ptr(), out.data_ptr(),
        M, N, K, blocksize, k_per_split, splits, int(tc), _lib.host_f32(units), *extra, _KIND[A2.dtype],
        int(out_dtype == torch.float32), _lib.stream(A2),
    )
    _lib.check(err, entry)
    _lib.LAUNCHES[entry] += 1
    return out


def gemm_4bit_paired(
    A: torch.Tensor,
    P: torch.Tensor,
    absmax_t: torch.Tensor,
    code,
    blocksize: int,
    shapeB: tuple,
    out_dtype=None,
) -> torch.Tensor:
    """Fused ``A @ dequant(B)^T`` over the N-paired layout.

    ``A [..., K]``; ``P [N/2, K]`` uint8; ``absmax_t [K/blocksize, N]`` f32;
    ``code`` the 16-entry codebook; ``shapeB = (N, K)``.  Returns
    ``[..., N]`` in ``out_dtype`` (default ``A.dtype``).  On CUDA, A must be
    contiguous bf16, f16 or f32 and the output A's type or f32."""
    N, K = (int(s) for s in shapeB)
    if N % 2 or blocksize < 32 or K % blocksize or A.shape[-1] != K:
        raise ValueError(f"unsupported shape: A {tuple(A.shape)}, B {(N, K)}, blocksize {blocksize}")
    _check_payload(P, absmax_t, N, K, blocksize)
    lead = tuple(A.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    out_dtype = out_dtype or A.dtype
    units = _units(_code_tuple(code))
    if not use_kernel(A, P, absmax_t):
        out = gemm_4bit_paired_plain(A.reshape(M, K), P, absmax_t, units, blocksize)
        return out.to(out_dtype).reshape(*lead, N)
    _check_cuda_A(A, out_dtype)
    if M == 0:
        return torch.empty(*lead, N, dtype=out_dtype, device=A.device)
    _check_aligned(A, P, absmax_t)
    out = _launch_gemm("gemm_4bit_paired", A.reshape(M, K), P, (absmax_t.data_ptr(),), (), M, N, K, blocksize,
                       units, out_dtype)
    return out.reshape(*lead, N)


def dequantize_paired_fast_plain(P, absmax_t, units, blocksize: int, dtype) -> torch.Tensor:
    U = decode_units(P, units)
    scale = absmax_t.t().repeat_interleave(blocksize, dim=1)
    return (U * scale).to(dtype)


def dequantize_paired_fast(P, absmax_t, code, blocksize: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Paired payload ``[N/2, K]`` -> weight ``[N, K]`` in ``dtype`` (bf16,
    f16 or f32 on CUDA): ``dtype(unit(code) * absmax)`` with the product in
    exact f32."""
    N2, K = P.shape
    N = 2 * N2
    if blocksize < 8 or K % blocksize:
        raise ValueError(f"unsupported shape: B {(N, K)}, blocksize {blocksize}")
    _check_payload(P, absmax_t, N, K, blocksize)
    units = _units(_code_tuple(code))
    if not use_kernel(P, absmax_t):
        return dequantize_paired_fast_plain(P, absmax_t, units, blocksize, dtype)
    if dtype not in _KIND:
        raise ValueError(f"the CUDA kernel writes bf16, f16 or float32, not {dtype}")
    _check_aligned(P, absmax_t)
    W = torch.empty(N, K, dtype=dtype, device=P.device)
    err = _lib.lib().bnb_dequantize_paired(
        P.data_ptr(), absmax_t.data_ptr(), W.data_ptr(), N, K, blocksize,
        _lib.host_f32(units), _KIND[dtype], _lib.stream(P),
    )
    _lib.check(err, "dequantize_paired_fast")
    _lib.LAUNCHES["dequantize_paired_fast"] += 1
    return W


# -- double-quantized absmax, decoded in the kernels -------------------------


class _DynDecode(ctypes.Structure):
    """``DynDecode`` of ``csrc/common.cuh``."""

    _MAX = 40
    _fields_ = [
        ("zero_idx", ctypes.c_int),
        ("nseg", ctypes.c_int),
        ("start", ctypes.c_int * _MAX),
        ("sub", ctypes.c_int * _MAX),
        ("step", ctypes.c_float * _MAX),
        ("add", ctypes.c_float * _MAX),
    ]


@functools.lru_cache(maxsize=None)
def _dyn_decode() -> _DynDecode:
    z, starts, subs, steps, adds = kernel_table(dynamic_sym_table())
    d = _DynDecode()
    d.zero_idx, d.nseg = z, len(starts)
    for i, (st, sb, sp, ad) in enumerate(zip(starts, subs, steps, adds)):
        d.start[i], d.sub[i], d.step[i], d.add[i] = st, sb, sp, ad
    return d


def nested_absmax_t(codes_t: torch.Tensor, s2: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """f32 scales ``[K/blocksize, N]`` of a double-quantized paired state, as
    the ``_dq`` kernels decode them (the plain versions' first step)."""
    KB, N = codes_t.shape
    dev = codes_t.device
    flat = torch.arange(N, device=dev)[None, :] * KB + torch.arange(KB, device=dev)[:, None]
    return dequant_nested_dynamic(codes_t, s2, offset, flat)


def _check_nested(codes_t, s2, offset, N: int, K: int, blocksize: int) -> None:
    KB = K // blocksize
    if codes_t.dtype != torch.uint8 or tuple(codes_t.shape) != (KB, N) or not codes_t.is_contiguous():
        raise ValueError(f"codes_t must be a contiguous uint8 [{KB}, {N}] tensor")
    nb2 = -(-N * KB // 256)
    if s2.dtype != torch.float32 or s2.numel() != nb2 or not s2.is_contiguous():
        raise ValueError(f"s2 must be a contiguous float32 tensor of {nb2} scales")
    if offset.dtype != torch.float32 or offset.numel() != 1:
        raise ValueError("offset must be one float32 value")


def gemm_4bit_paired_dq_plain(A2, P, codes_t, s2, offset, units, blocksize: int) -> torch.Tensor:
    return gemm_4bit_paired_plain(A2, P, nested_absmax_t(codes_t, s2, offset), units, blocksize)


def gemm_4bit_paired_dq(
    A: torch.Tensor,
    P: torch.Tensor,
    codes_t: torch.Tensor,
    s2: torch.Tensor,
    offset: torch.Tensor,
    code,
    blocksize: int,
    shapeB: tuple,
    out_dtype=None,
) -> torch.Tensor:
    """:func:`gemm_4bit_paired` with the absmax double-quantized: ``codes_t
    [K/blocksize, N]`` uint8 over the canonical dynamic map, ``s2`` one f32
    per 256 flat first-level blocks, ``offset`` one f32 (a device tensor:
    the kernel reads it, the host never does)."""
    N, K = (int(s) for s in shapeB)
    if N % 2 or blocksize < 32 or K % blocksize or A.shape[-1] != K:
        raise ValueError(f"unsupported shape: A {tuple(A.shape)}, B {(N, K)}, blocksize {blocksize}")
    if P.dtype != torch.uint8 or tuple(P.shape) != (N // 2, K) or not P.is_contiguous():
        raise ValueError(f"P must be a contiguous uint8 [{N // 2}, {K}] tensor")
    _check_nested(codes_t, s2, offset, N, K, blocksize)
    lead = tuple(A.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    out_dtype = out_dtype or A.dtype
    units = _units(_code_tuple(code))
    if not use_kernel(A, P, codes_t, s2, offset):
        out = gemm_4bit_paired_dq_plain(A.reshape(M, K), P, codes_t, s2, offset, units, blocksize)
        return out.to(out_dtype).reshape(*lead, N)
    _check_cuda_A(A, out_dtype)
    if M == 0:
        return torch.empty(*lead, N, dtype=out_dtype, device=A.device)
    _check_aligned(A, P, codes_t)
    dec = _dyn_decode()
    out = _launch_gemm("gemm_4bit_paired_dq", A.reshape(M, K), P,
                       (codes_t.data_ptr(), s2.data_ptr(), offset.data_ptr()), (ctypes.addressof(dec),),
                       M, N, K, blocksize, units, out_dtype)
    return out.reshape(*lead, N)


def dequantize_paired_fast_dq_plain(P, codes_t, s2, offset, units, blocksize: int, dtype) -> torch.Tensor:
    return dequantize_paired_fast_plain(P, nested_absmax_t(codes_t, s2, offset), units, blocksize, dtype)


def dequantize_paired_fast_dq(P, codes_t, s2, offset, code, blocksize: int,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`dequantize_paired_fast` with the absmax double-quantized (the
    arguments of :func:`gemm_4bit_paired_dq`)."""
    N2, K = P.shape
    N = 2 * N2
    if blocksize < 8 or K % blocksize:
        raise ValueError(f"unsupported shape: B {(N, K)}, blocksize {blocksize}")
    if P.dtype != torch.uint8 or not P.is_contiguous():
        raise ValueError("P must be a contiguous uint8 tensor")
    _check_nested(codes_t, s2, offset, N, K, blocksize)
    units = _units(_code_tuple(code))
    if not use_kernel(P, codes_t, s2, offset):
        return dequantize_paired_fast_dq_plain(P, codes_t, s2, offset, units, blocksize, dtype)
    if dtype not in _KIND:
        raise ValueError(f"the CUDA kernel writes bf16, f16 or float32, not {dtype}")
    _check_aligned(P, codes_t)
    W = torch.empty(N, K, dtype=dtype, device=P.device)
    dec = _dyn_decode()
    err = _lib.lib().bnb_dequantize_paired_dq(
        P.data_ptr(), codes_t.data_ptr(), s2.data_ptr(), offset.data_ptr(), W.data_ptr(),
        N, K, blocksize, _lib.host_f32(units), ctypes.addressof(dec), _KIND[dtype], _lib.stream(P),
    )
    _lib.check(err, "dequantize_paired_fast_dq")
    _lib.LAUNCHES["dequantize_paired_fast_dq"] += 1
    return W


# -- the backward: grad_A = g @ dequant(B), contracted over N -----------------

# the CUDA-core kernel's tiles (csrc/gemm4bit_paired.cu; f32 g): 2048 columns
# of K and 8 rows of g per block; each split of N keeps at least 64 row pairs
_NT_KT, _NT_MT, _NT_MIN_PAIRS = 2048, 8, 64
# the tensor-core backward kernels' tiles (bf16 and f16 g; kernel 11 in
# csrc/gemm4bit.cu, kernels 7 and 8 here): 128 columns of K and 32 rows of g
# per block, splits of N in multiples of 64 rows, at most 8
_TC_TK, _TC_MT, _TC_ROWS, _TC_MAX_SPLITS = 128, 32, 64, 8


def gemm_4bit_paired_nt_plain(G2, P, absmax_t, units, blocksize: int) -> torch.Tensor:
    """``G2 [M, N]`` -> f32 ``[M, K]``: per K quant block, ``g * scale``
    (rounded to bf16 unless ``G2`` is float32) dotted with the unit codes."""
    M, N = G2.shape
    U = decode_units(P, units)
    K = U.shape[1]
    nb = K // blocksize
    g32 = G2.to(torch.float32)
    U3 = U.reshape(N, nb, blocksize).permute(1, 0, 2)  # [nb, N, bs]
    out = torch.empty(M, K, dtype=torch.float32, device=G2.device)
    for c in range(0, nb, _PLAIN_BLOCK_CHUNK):
        gs = g32[None] * absmax_t[c : c + _PLAIN_BLOCK_CHUNK, None, :]  # [cb, M, N]
        if G2.dtype != torch.float32:
            gs = gs.to(torch.bfloat16).to(torch.float32)
        sub = torch.bmm(gs, U3[c : c + _PLAIN_BLOCK_CHUNK])  # [cb, M, bs]
        out[:, c * blocksize : c * blocksize + sub.shape[0] * blocksize] = sub.permute(1, 0, 2).reshape(M, -1)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nt_splits(M: int, N: int, K: int, sms: int):
    """The CUDA-core kernel's rows of N per split and number of splits:
    about two blocks per SM, each split at least ``_NT_MIN_PAIRS`` row
    pairs."""
    pairs = N // 2
    tiles = -(-K // _NT_KT) * -(-M // _NT_MT)
    splits = max(1, min(-(-2 * sms // tiles), pairs // _NT_MIN_PAIRS))
    rows = 2 * -(-pairs // splits)
    return rows, -(-N // rows)


def nt_plan(M: int, N: int, K: int, sms: int):
    """The tensor-core backward kernels' rows of N per split (a multiple of
    64, so each split's g starts 16-byte aligned) and number of splits S <= 8,
    for blocks of 128 columns of K and 32 rows of g.  Among the S whose
    grid of ``tiles * S`` blocks stays within two waves of ``sms`` SMs, the
    one that fills the largest share of its waves, the fewest splits among
    equals (fewer f32 partials); a grid of one wave or more without splitting
    keeps S = 1.  A pure function of the shapes and the SM count, so a call's
    bits do not depend on the run."""
    tiles = -(-K // _TC_TK) * -(-M // _TC_MT)
    best, best_slots = 1, None
    for s in range(1, min(_TC_MAX_SPLITS, -(-N // _TC_ROWS)) + 1):
        if s > 1 and tiles * s > 2 * sms:
            break
        slots = sms * -(-tiles * s // sms)  # SM slots of the waves this grid takes
        # tiles*s / slots beats tiles*best / best_slots, compared exactly
        if best_slots is None or s * best_slots > best * slots:
            best, best_slots = s, slots
    per_split = -(-N // best)
    rows = -(-per_split // _TC_ROWS) * _TC_ROWS
    return rows, -(-N // rows)


def _nt_uses_tc(dtype, blocksize: int) -> bool:
    """Whether kernels 7 and 8 run on the tensor cores: the one place this
    is decided; the C entry points take the answer and refuse a plan the
    chosen kernel cannot take."""
    return dtype != torch.float32 and blocksize % 32 == 0


def _nt_args(G, N: int, K: int, blocksize: int, out_dtype):
    if N % 2 or blocksize < 32 or K % blocksize or G.shape[-1] != N:
        raise ValueError(f"unsupported shape: g {tuple(G.shape)}, B {(N, K)}, blocksize {blocksize}")
    lead = tuple(G.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    return lead, M, out_dtype or G.dtype


def _launch_nt(entry: str, G2, P, scale_ptrs, extra, M: int, N: int, K: int, blocksize: int, units):
    if G2.dtype not in _KIND or not G2.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous bf16, f16 or float32 g")
    _check_aligned(G2, P)
    sms = _sm_count(G2.device.index or 0)
    tc = _nt_uses_tc(G2.dtype, blocksize)
    rows, splits = nt_plan(M, N, K, sms) if tc else _nt_splits(M, N, K, sms)
    # the tensor-core kernel writes out directly where there is one split
    part = torch.empty(splits * M * K, dtype=torch.float32, device=G2.device) if splits > 1 or not tc else None
    out = torch.empty(M, K, dtype=G2.dtype, device=G2.device)
    err = getattr(_lib.lib(), "bnb_" + entry)(
        G2.data_ptr(), P.data_ptr(), *scale_ptrs, None if part is None else part.data_ptr(), out.data_ptr(),
        M, N, K, blocksize, rows, splits, int(tc), _lib.host_f32(units), *extra, _KIND[G2.dtype],
        _lib.stream(G2),
    )
    _lib.check(err, entry)
    _lib.LAUNCHES[entry] += 1
    return out


def gemm_4bit_paired_nt(G, P, absmax_t, code, blocksize: int, shapeB: tuple, out_dtype=None) -> torch.Tensor:
    """Fused ``G @ dequant(B)`` over the N-paired layout (contract over N):
    ``G [..., N]`` -> ``[..., K]`` in ``out_dtype`` (default ``G.dtype``; on
    CUDA, G is contiguous bf16, f16 or float32 and the output takes its type)."""
    N, K = (int(s) for s in shapeB)
    lead, M, out_dtype = _nt_args(G, N, K, blocksize, out_dtype)
    _check_payload(P, absmax_t, N, K, blocksize)
    units = _units(_code_tuple(code))
    if not use_kernel(G, P, absmax_t):
        return gemm_4bit_paired_nt_plain(G.reshape(M, N), P, absmax_t, units, blocksize).to(out_dtype).reshape(*lead, K)
    if out_dtype != G.dtype:
        raise ValueError("the CUDA kernel writes g's type")
    if M == 0:
        return torch.empty(*lead, K, dtype=out_dtype, device=G.device)
    _check_aligned(absmax_t)
    out = _launch_nt("gemm_4bit_paired_nt", G.reshape(M, N), P, (absmax_t.data_ptr(),), (), M, N, K,
                     blocksize, units)
    return out.reshape(*lead, K)


def gemm_4bit_paired_nt_dq_plain(G2, P, codes_t, s2, offset, units, blocksize: int) -> torch.Tensor:
    return gemm_4bit_paired_nt_plain(G2, P, nested_absmax_t(codes_t, s2, offset), units, blocksize)


def gemm_4bit_paired_nt_dq(G, P, codes_t, s2, offset, code, blocksize: int, shapeB: tuple,
                           out_dtype=None) -> torch.Tensor:
    """:func:`gemm_4bit_paired_nt` with the absmax double-quantized (the
    scale arguments of :func:`gemm_4bit_paired_dq`)."""
    N, K = (int(s) for s in shapeB)
    lead, M, out_dtype = _nt_args(G, N, K, blocksize, out_dtype)
    if P.dtype != torch.uint8 or tuple(P.shape) != (N // 2, K) or not P.is_contiguous():
        raise ValueError(f"P must be a contiguous uint8 [{N // 2}, {K}] tensor")
    _check_nested(codes_t, s2, offset, N, K, blocksize)
    units = _units(_code_tuple(code))
    if not use_kernel(G, P, codes_t, s2, offset):
        out = gemm_4bit_paired_nt_dq_plain(G.reshape(M, N), P, codes_t, s2, offset, units, blocksize)
        return out.to(out_dtype).reshape(*lead, K)
    if out_dtype != G.dtype:
        raise ValueError("the CUDA kernel writes g's type")
    if M == 0:
        return torch.empty(*lead, K, dtype=out_dtype, device=G.device)
    _check_aligned(codes_t)
    dec = _dyn_decode()
    out = _launch_nt("gemm_4bit_paired_nt_dq", G.reshape(M, N), P,
                     (codes_t.data_ptr(), s2.data_ptr(), offset.data_ptr()), (ctypes.addressof(dec),),
                     M, N, K, blocksize, units)
    return out.reshape(*lead, K)
