"""K-adjacent 4-bit payload: the GEMM, the dequantize and the backward GEMM.

Counterpart of the JAX package's ``ops/pallas/gemm4bit.py``.  Byte ``j`` of
row ``n`` holds column ``k = 2j`` in its high nibble and ``k = 2j+1`` in its
low nibble (the checkpoint interop order, the ``"flat"`` and ``"2d"``
layouts); the absmax is ``[N, K/blocksize]`` row-major, the flat block
order.  Every weight is the exact f32 product ``code[q] * absmax`` rounded
to the operand's type, as the reference library and the JAX package's
default tier compute it.

The kernels, all in ``csrc/gemm4bit.cu``:

* :func:`gemm_4bit_fused` replaces ``gemm_4bit_fused`` (``_gemm4bit_kernel``):
  ``out[M, N] = A[M, K] @ dequant(B)^T``, A in bf16, f16 or f32, sums in f32.
  Bound by bytes at decode M.  bf16 and f16 A run on the tensor cores
  (``mma.sync``, the weight as the m16 operand: one payload byte is one
  fragment register), the payload read once per 32 rows of A; K is cut into
  at most 8 splits (``_gemm2d_plan``, kernels 2 and 5's ``gemm_plan`` over
  256-column stages) whose f32 partials a second pass adds in split order.  f32 A keeps exact f32
  products on the CUDA cores, the weight read once per 8 rows of A.
* :func:`dequantize_4bit_2d` replaces ``dequantize_4bit_pallas``
  (``_dequant4_kernel``): ``W = dtype(code[q] * absmax)`` over the flat
  element order, for the large-M route and ``dequantize_4bit``.  Bound by
  bytes; one pass.
* :func:`gemm_4bit_fused_dq` and :func:`dequantize_4bit_2d_dq`: the same two
  kernels on a double-quantized absmax in the flat block order, uint8 codes
  over the canonical dynamic map, one f32 ``s2`` per 256 codes and an f32
  offset, decoded where each scale is loaded as ``fma(code2(u8), s2[f >>
  8], offset)`` (``functional/dynamic_segments.py``): the bits of the
  resolved f32 absmax, without a decode before the call.
* :func:`gemm_4bit_nt_fused` replaces ``gemm_4bit_nt_fused``
  (``_gemm4bit_nt_kernel``): the 4-bit matmul backward ``grad_A[M, K] =
  g[M, N] @ dequant(B)[N, K]``, the weight rounded to g's type, sums in f32.
  Bound by bytes at M <= 32.  bf16 and f16 g run on the tensor cores
  (``mma.sync``), each payload byte read and decoded once per 32 rows of g;
  f32 g keeps exact f32 products on the CUDA cores.  N is split into at
  most 8 splits (:func:`nt_plan`, shared with kernels 7 and 8 in
  ``ops/gemm4bit_paired``) whose f32 partials a second pass adds in
  split order.  It takes an f32 absmax only.

The GEMMs take every shape whose K holds whole quantization blocks (so K is
even), with any N and M: the JAX package's tile predicates exist for the
TPU's (8, 128) tiles.  A CPU tensor goes to the plain version of each, a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..functional.dynamic_segments import dequant_nested_dynamic
from . import _lib
from .dispatch import use_kernel
from .gemm4bit_paired import _KIND, _code_tuple, _dyn_decode, _sm_count, gemm_plan, nt_plan

__all__ = [
    "gemm_2d_supported",
    "gemm_4bit_fused",
    "gemm_4bit_fused_plain",
    "gemm_4bit_fused_dq",
    "gemm_4bit_fused_dq_plain",
    "dequantize_4bit_2d",
    "dequantize_4bit_2d_plain",
    "dequantize_4bit_2d_dq",
    "dequantize_4bit_2d_dq_plain",
    "nested_absmax",
    "gemm_4bit_nt_fused",
    "gemm_4bit_nt_fused_plain",
    "nt_plan",
]

def gemm_2d_supported(N: int, K: int, blocksize: int) -> bool:
    """The shapes the GEMM kernels take: rows of whole quantization blocks
    (``K % blocksize == 0``, a blocksize that is a multiple of 32)."""
    return N > 0 and K > 0 and blocksize >= 32 and blocksize % 32 == 0 and K % blocksize == 0


# kernel 9's tensor-core stage: 256 columns of K
_KF_TK = 256


def _gemm2d_plan(M: int, N: int, K: int, blocksize: int, sms: int):
    """Kernel 9's columns of K per split and number of splits: ``gemm_plan``
    over its 256-column stages, one plan for both instances, so the nested
    one gives the plain one's bits."""
    return gemm_plan(M, N, K, blocksize, sms, stage=_KF_TK)


def _gemm2d_uses_tc(dtype) -> bool:
    """Whether kernel 9 runs on the tensor cores: the one place this is
    decided; the C entry points take the answer and refuse a plan the chosen
    kernel cannot take.  f32 A has no exact tensor-core product (TF32 keeps
    10 bits); every blocksize the GEMM takes is a multiple of 32."""
    return dtype != torch.float32


def _weight(B, absmax, code_t: tuple, blocksize: int, n: int, dtype) -> torch.Tensor:
    """The flat weight of ``n`` elements: ``dtype(code[q] * absmax)``."""
    table = torch.tensor(code_t, dtype=torch.float32, device=B.device)
    flat = B.reshape(-1)
    q = torch.stack([flat >> 4, flat & 0xF], dim=-1).reshape(-1)[:n].long()
    vals = table[q]
    pad = (-n) % blocksize
    if pad:
        vals = torch.nn.functional.pad(vals, (0, pad))
    return (vals.reshape(-1, blocksize) * absmax.reshape(-1, 1).to(torch.float32)).reshape(-1)[:n].to(dtype)


def nested_absmax(codes: torch.Tensor, s2: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """The f32 absmax of a double-quantized flat/2d state, as the ``_dq``
    kernels decode it (the plain versions' first step)."""
    flat = torch.arange(codes.numel(), device=codes.device)
    return dequant_nested_dynamic(codes.reshape(-1), s2, offset, flat)


def dequantize_4bit_2d_plain(B, absmax, code_t: tuple, blocksize: int, shape, dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    return _weight(B, absmax, code_t, blocksize, n, dtype).reshape(tuple(int(s) for s in shape))


def dequantize_4bit_2d_dq_plain(B, codes, s2, offset, code_t: tuple, blocksize: int, shape, dtype) -> torch.Tensor:
    return dequantize_4bit_2d_plain(B, nested_absmax(codes, s2, offset), code_t, blocksize, shape, dtype)


def gemm_4bit_fused_plain(A2, B, absmax, code_t: tuple, blocksize: int, N: int) -> torch.Tensor:
    """``A2 [M, K]`` -> f32 ``[M, N]``: the weight rounded to A's type, the
    product summed in f32."""
    K = A2.shape[1]
    W = _weight(B, absmax, code_t, blocksize, N * K, A2.dtype).reshape(N, K)
    return torch.matmul(A2.to(torch.float32), W.to(torch.float32).t())


def gemm_4bit_fused_dq_plain(A2, B, codes, s2, offset, code_t: tuple, blocksize: int, N: int) -> torch.Tensor:
    return gemm_4bit_fused_plain(A2, B, nested_absmax(codes, s2, offset), code_t, blocksize, N)


def gemm_4bit_nt_fused_plain(G2, B, absmax, code_t: tuple, blocksize: int, K: int) -> torch.Tensor:
    """``G2 [M, N]`` -> f32 ``[M, K]``: the weight rounded to g's type, the
    product summed in f32."""
    N = G2.shape[1]
    W = _weight(B, absmax, code_t, blocksize, N * K, G2.dtype).reshape(N, K)
    return torch.matmul(G2.to(torch.float32), W.to(torch.float32))


def _check_payload(B, n: int) -> None:
    if B.dtype != torch.uint8 or B.numel() != (n + 1) // 2 or not B.is_contiguous():
        raise ValueError(f"B must be {(n + 1) // 2} contiguous uint8 bytes, got {B.dtype} {tuple(B.shape)}")


def _check(B, absmax, n: int, blocksize: int) -> None:
    _check_payload(B, n)
    nb = -(-n // blocksize)
    if absmax.dtype != torch.float32 or absmax.numel() != nb or not absmax.is_contiguous():
        raise ValueError(f"absmax must be {nb} contiguous float32 scales (the _dq wrappers take a nested state)")


def _check_nested(B, codes, s2, offset, n: int, blocksize: int) -> None:
    _check_payload(B, n)
    nb = -(-n // blocksize)
    if codes.dtype != torch.uint8 or codes.numel() != nb or not codes.is_contiguous():
        raise ValueError(f"codes must be {nb} contiguous uint8 codes")
    nb2 = -(-nb // 256)
    if s2.dtype != torch.float32 or s2.numel() != nb2 or not s2.is_contiguous():
        raise ValueError(f"s2 must be {nb2} contiguous float32 scales")
    if offset.dtype != torch.float32 or offset.numel() != 1:
        raise ValueError("offset must be one float32 value")


def _lead(X, last: int):
    if X.shape[-1] != last:
        raise ValueError(f"the operand's last dimension must be {last}, got {tuple(X.shape)}")
    lead = tuple(X.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    return lead, M


def _check_cuda_operand(X, what: str, out_dtype) -> None:
    if X.dtype not in _KIND or not X.is_contiguous() or X.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel takes a contiguous, 16-byte aligned bf16, f16 or f32 {what}")
    if out_dtype not in (X.dtype, torch.float32):
        raise ValueError(f"the CUDA kernel writes the {what}'s type or float32, not {out_dtype}")


def _gemm_args(A, N: int, K: int, blocksize: int, out_dtype):
    if not gemm_2d_supported(N, K, blocksize):
        raise ValueError(f"unsupported shape: B {(N, K)}, blocksize {blocksize}")
    lead, M = _lead(A, K)
    return lead, M, out_dtype or A.dtype


def _launch_gemm(entry: str, A, B, scale_ptrs, extra, M: int, N: int, K: int, blocksize: int, code_t, out_dtype):
    _check_cuda_operand(A, "A", out_dtype)
    if B.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a 16-byte aligned payload")
    tc = _gemm2d_uses_tc(A.dtype)
    k_per_split, splits = _gemm2d_plan(M, N, K, blocksize, _sm_count(A.device.index or 0)) if tc else (K, 1)
    # f32 partials only where there is more than one split
    part = torch.empty(splits * M * N, dtype=torch.float32, device=A.device) if splits > 1 else None
    out = torch.empty(M, N, dtype=out_dtype, device=A.device)
    err = getattr(_lib.lib(), "bnb_" + entry)(
        A.data_ptr(), B.data_ptr(), *scale_ptrs, None if part is None else part.data_ptr(), out.data_ptr(),
        M, N, K, blocksize, k_per_split, splits, int(tc), _lib.host_f32(code_t), *extra, _KIND[A.dtype],
        int(out_dtype == torch.float32), _lib.stream(A),
    )
    _lib.check(err, entry)
    _lib.LAUNCHES[entry] += 1
    return out


def gemm_4bit_fused(A: torch.Tensor, B: torch.Tensor, absmax: torch.Tensor, code, blocksize: int,
                    shapeB: tuple, out_dtype=None) -> torch.Tensor:
    """Fused ``A @ dequant(B)^T`` over the K-adjacent layout.

    ``A [..., K]``; ``B`` the ``N*K/2`` payload bytes (uint8, any shape);
    ``absmax`` float32 ``[N*K/blocksize]``; ``code`` the 16-entry codebook;
    ``shapeB = (N, K)``.  Returns ``[..., N]`` in ``out_dtype`` (default
    ``A.dtype``; on CUDA A's type or float32)."""
    N, K = (int(s) for s in shapeB)
    lead, M, out_dtype = _gemm_args(A, N, K, blocksize, out_dtype)
    _check(B, absmax, N * K, blocksize)
    code_t = _code_tuple(code)
    if not use_kernel(A, B, absmax):
        return gemm_4bit_fused_plain(A.reshape(M, K), B, absmax, code_t, blocksize, N).to(out_dtype).reshape(*lead, N)
    if M == 0:
        return torch.empty(*lead, N, dtype=out_dtype, device=A.device)
    out = _launch_gemm("gemm_4bit_fused", A, B, (absmax.data_ptr(),), (), M, N, K, blocksize, code_t, out_dtype)
    return out.reshape(*lead, N)


def gemm_4bit_fused_dq(A: torch.Tensor, B: torch.Tensor, codes: torch.Tensor, s2: torch.Tensor,
                       offset: torch.Tensor, code, blocksize: int, shapeB: tuple, out_dtype=None) -> torch.Tensor:
    """:func:`gemm_4bit_fused` with the absmax double-quantized: ``codes
    [N*K/blocksize]`` uint8 over the canonical dynamic map in the flat block
    order, ``s2`` one f32 per 256 codes, ``offset`` one f32 (a device tensor:
    the kernel reads it, the host never does)."""
    N, K = (int(s) for s in shapeB)
    lead, M, out_dtype = _gemm_args(A, N, K, blocksize, out_dtype)
    _check_nested(B, codes, s2, offset, N * K, blocksize)
    code_t = _code_tuple(code)
    if not use_kernel(A, B, codes, s2, offset):
        out = gemm_4bit_fused_dq_plain(A.reshape(M, K), B, codes, s2, offset, code_t, blocksize, N)
        return out.to(out_dtype).reshape(*lead, N)
    if M == 0:
        return torch.empty(*lead, N, dtype=out_dtype, device=A.device)
    if codes.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes 16-byte aligned codes")
    out = _launch_gemm("gemm_4bit_fused_dq", A, B, (codes.data_ptr(), s2.data_ptr(), offset.data_ptr()),
                       (ctypes.addressof(_dyn_decode()),), M, N, K, blocksize, code_t, out_dtype)
    return out.reshape(*lead, N)


def _dequant_args(blocksize: int, shape: tuple):
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if blocksize < 16 or blocksize % 16:
        raise ValueError(f"unsupported blocksize {blocksize}")
    return shape, n


def _launch_dequant(entry: str, B, ptrs, extra, n: int, blocksize: int, code_t, shape, dtype):
    if dtype not in _KIND:
        raise ValueError(f"the CUDA kernel writes bf16, f16 or float32, not {dtype}")
    if B.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a 16-byte aligned payload")
    W = torch.empty(shape, dtype=dtype, device=B.device)
    if n == 0:
        return W
    err = getattr(_lib.lib(), "bnb_" + entry)(
        B.data_ptr(), *ptrs, W.data_ptr(), n, blocksize, _lib.host_f32(code_t), *extra, _KIND[dtype], _lib.stream(B),
    )
    _lib.check(err, entry)
    _lib.LAUNCHES[entry] += 1
    return W


def dequantize_4bit_2d(B: torch.Tensor, absmax: torch.Tensor, code, blocksize: int, shape: tuple,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Payload bytes in the flat (K-adjacent) order -> the weight of
    ``shape`` in ``dtype`` (bf16, f16 or f32): ``dtype(code[q] * absmax)``
    with the product in exact f32."""
    shape, n = _dequant_args(blocksize, shape)
    _check(B, absmax, n, blocksize)
    code_t = _code_tuple(code)
    if not use_kernel(B, absmax):
        return dequantize_4bit_2d_plain(B, absmax, code_t, blocksize, shape, dtype)
    return _launch_dequant("dequantize_4bit_2d", B, (absmax.data_ptr(),), (), n, blocksize, code_t, shape, dtype)


def dequantize_4bit_2d_dq(B: torch.Tensor, codes: torch.Tensor, s2: torch.Tensor, offset: torch.Tensor, code,
                          blocksize: int, shape: tuple, dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`dequantize_4bit_2d` with the absmax double-quantized (the scale
    arguments of :func:`gemm_4bit_fused_dq`, ``ceil(n/blocksize)`` codes)."""
    shape, n = _dequant_args(blocksize, shape)
    _check_nested(B, codes, s2, offset, n, blocksize)
    code_t = _code_tuple(code)
    if not use_kernel(B, codes, s2, offset):
        return dequantize_4bit_2d_dq_plain(B, codes, s2, offset, code_t, blocksize, shape, dtype)
    return _launch_dequant("dequantize_4bit_2d_dq", B, (codes.data_ptr(), s2.data_ptr(), offset.data_ptr()),
                           (ctypes.addressof(_dyn_decode()),), n, blocksize, code_t, shape, dtype)


# the f32 backward kernel's tiles (csrc/gemm4bit.cu): 2048 columns of K and 8
# rows of g per block; each split of N keeps at least 64 rows
_NT_KT, _NT_MT, _NT_MIN_ROWS = 2048, 8, 64


def _nt_splits(M: int, N: int, K: int, sms: int):
    """The f32 kernel's rows of N per split and number of splits: about two
    blocks per SM, each split at least ``_NT_MIN_ROWS`` rows."""
    tiles = -(-K // _NT_KT) * -(-M // _NT_MT)
    splits = max(1, min(-(-2 * sms // tiles), N // _NT_MIN_ROWS))
    rows = -(-N // splits)
    return rows, -(-N // rows)


def gemm_4bit_nt_fused(G: torch.Tensor, B: torch.Tensor, absmax: torch.Tensor, code, blocksize: int,
                       shapeB: tuple, out_dtype=None) -> torch.Tensor:
    """Fused ``G @ dequant(B)`` over the K-adjacent layout (contract over
    N): ``G [..., N]`` -> ``[..., K]`` in ``out_dtype`` (default ``G.dtype``;
    on CUDA the output takes G's type)."""
    N, K = (int(s) for s in shapeB)
    if not gemm_2d_supported(N, K, blocksize):
        raise ValueError(f"unsupported shape: B {(N, K)}, blocksize {blocksize}")
    lead, M = _lead(G, N)
    _check(B, absmax, N * K, blocksize)
    out_dtype = out_dtype or G.dtype
    code_t = _code_tuple(code)
    if not use_kernel(G, B, absmax):
        return gemm_4bit_nt_fused_plain(G.reshape(M, N), B, absmax, code_t, blocksize, K).to(out_dtype).reshape(
            *lead, K)
    _check_cuda_operand(G, "g", out_dtype)
    if out_dtype != G.dtype:
        raise ValueError("the CUDA kernel writes g's type")
    if B.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a 16-byte aligned payload")
    out = torch.empty(*lead, K, dtype=out_dtype, device=G.device)
    if M == 0:
        return out
    plan = _nt_splits if G.dtype == torch.float32 else nt_plan
    rows, splits = plan(M, N, K, _sm_count(G.device.index or 0))
    # f32 partials only where there is more than one split; the tensor stays
    # bound until the launch is queued, so the allocator cannot hand it out
    part = torch.empty(splits * M * K, dtype=torch.float32, device=G.device) if splits > 1 else None
    err = _lib.lib().bnb_gemm_4bit_nt_fused(
        G.data_ptr(), B.data_ptr(), absmax.data_ptr(), None if part is None else part.data_ptr(), out.data_ptr(),
        M, N, K, blocksize, rows, splits, _lib.host_f32(code_t), _KIND[G.dtype], _lib.stream(G),
    )
    _lib.check(err, "gemm_4bit_nt_fused")
    _lib.LAUNCHES["gemm_4bit_nt_fused"] += 1
    return out
