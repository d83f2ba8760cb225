"""K-adjacent 4-bit payload: the GEMM, the dequantize and the backward GEMM.

Counterpart of the JAX package's ``ops/pallas/gemm4bit.py``.  Byte ``j`` of
row ``n`` holds column ``k = 2j`` in its high nibble and ``k = 2j+1`` in its
low nibble (the checkpoint interop order, the ``"flat"`` and ``"2d"``
layouts); the absmax is ``[N, K/blocksize]`` row-major, already decoded to
float32 when the state is double-quantized.  Every weight is the exact f32
product ``code[q] * absmax`` rounded to the operand's type, as the reference
library and the JAX package's default tier compute it.

The kernels, all in ``csrc/gemm4bit.cu``:

* :func:`gemm_4bit_fused` replaces ``gemm_4bit_fused`` (``_gemm4bit_kernel``):
  ``out[M, N] = A[M, K] @ dequant(B)^T``, A in bf16, f16 or f32, sums in f32.
  Bound by bytes at decode M; one warp streams two rows of the payload with
  16-byte loads against A staged in shared memory.
* :func:`dequantize_4bit_2d` replaces ``dequantize_4bit_pallas``
  (``_dequant4_kernel``): ``W = dtype(code[q] * absmax)`` over the flat
  element order, for the large-M route and ``dequantize_4bit``.  Bound by
  bytes; one pass.
* :func:`gemm_4bit_nt_fused` replaces ``gemm_4bit_nt_fused``
  (``_gemm4bit_nt_kernel``): the 4-bit matmul backward ``grad_A[M, K] =
  g[M, N] @ dequant(B)[N, K]``, the weight rounded to g's type, sums in f32.
  N is split across blocks into f32 partials that a second pass adds in a
  fixed order.

The GEMMs take every shape whose K holds whole quantization blocks (so K is
even), with any N and M: the JAX package's tile predicates exist for the
TPU's (8, 128) tiles.  A CPU tensor goes to the plain version of each, a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _lib
from .dispatch import use_kernel
from .gemm4bit_paired import _KIND, _code_tuple, _sm_count

__all__ = [
    "gemm_2d_supported",
    "gemm_4bit_fused",
    "gemm_4bit_fused_plain",
    "dequantize_4bit_2d",
    "dequantize_4bit_2d_plain",
    "gemm_4bit_nt_fused",
    "gemm_4bit_nt_fused_plain",
]

def gemm_2d_supported(N: int, K: int, blocksize: int) -> bool:
    """The shapes the GEMM kernels take: rows of whole quantization blocks
    (``K % blocksize == 0``, a blocksize that is a multiple of 32)."""
    return N > 0 and K > 0 and blocksize >= 32 and blocksize % 32 == 0 and K % blocksize == 0


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


def dequantize_4bit_2d_plain(B, absmax, code_t: tuple, blocksize: int, shape, dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    return _weight(B, absmax, code_t, blocksize, n, dtype).reshape(tuple(int(s) for s in shape))


def gemm_4bit_fused_plain(A2, B, absmax, code_t: tuple, blocksize: int, N: int) -> torch.Tensor:
    """``A2 [M, K]`` -> f32 ``[M, N]``: the weight rounded to A's type, the
    product summed in f32."""
    K = A2.shape[1]
    W = _weight(B, absmax, code_t, blocksize, N * K, A2.dtype).reshape(N, K)
    return torch.matmul(A2.to(torch.float32), W.to(torch.float32).t())


def gemm_4bit_nt_fused_plain(G2, B, absmax, code_t: tuple, blocksize: int, K: int) -> torch.Tensor:
    """``G2 [M, N]`` -> f32 ``[M, K]``: the weight rounded to g's type, the
    product summed in f32."""
    N = G2.shape[1]
    W = _weight(B, absmax, code_t, blocksize, N * K, G2.dtype).reshape(N, K)
    return torch.matmul(G2.to(torch.float32), W.to(torch.float32))


def _check(B, absmax, n: int, blocksize: int) -> None:
    if B.dtype != torch.uint8 or B.numel() != (n + 1) // 2 or not B.is_contiguous():
        raise ValueError(f"B must be {(n + 1) // 2} contiguous uint8 bytes, got {B.dtype} {tuple(B.shape)}")
    nb = -(-n // blocksize)
    if absmax.dtype != torch.float32 or absmax.numel() != nb or not absmax.is_contiguous():
        raise ValueError(f"absmax must be {nb} contiguous float32 scales (decode a nested state first)")


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


def gemm_4bit_fused(A: torch.Tensor, B: torch.Tensor, absmax: torch.Tensor, code, blocksize: int,
                    shapeB: tuple, out_dtype=None) -> torch.Tensor:
    """Fused ``A @ dequant(B)^T`` over the K-adjacent layout.

    ``A [..., K]``; ``B`` the ``N*K/2`` payload bytes (uint8, any shape);
    ``absmax`` float32 ``[N*K/blocksize]``; ``code`` the 16-entry codebook;
    ``shapeB = (N, K)``.  Returns ``[..., N]`` in ``out_dtype`` (default
    ``A.dtype``; on CUDA A's type or float32)."""
    N, K = (int(s) for s in shapeB)
    if not gemm_2d_supported(N, K, blocksize):
        raise ValueError(f"unsupported shape: B {(N, K)}, blocksize {blocksize}")
    lead, M = _lead(A, K)
    _check(B, absmax, N * K, blocksize)
    out_dtype = out_dtype or A.dtype
    code_t = _code_tuple(code)
    if not use_kernel(A, B, absmax):
        return gemm_4bit_fused_plain(A.reshape(M, K), B, absmax, code_t, blocksize, N).to(out_dtype).reshape(*lead, N)
    _check_cuda_operand(A, "A", out_dtype)
    if B.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a 16-byte aligned payload")
    out = torch.empty(*lead, N, dtype=out_dtype, device=A.device)
    if M == 0:
        return out
    err = _lib.lib().bnb_gemm_4bit_fused(
        A.data_ptr(), B.data_ptr(), absmax.data_ptr(), out.data_ptr(), M, N, K, blocksize,
        _lib.host_f32(code_t), _KIND[A.dtype], int(out_dtype == torch.float32), _lib.stream(A),
    )
    _lib.check(err, "gemm_4bit_fused")
    _lib.LAUNCHES["gemm_4bit_fused"] += 1
    return out


def dequantize_4bit_2d(B: torch.Tensor, absmax: torch.Tensor, code, blocksize: int, shape: tuple,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Payload bytes in the flat (K-adjacent) order -> the weight of
    ``shape`` in ``dtype`` (bf16, f16 or f32): ``dtype(code[q] * absmax)``
    with the product in exact f32."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if blocksize < 16 or blocksize % 16:
        raise ValueError(f"unsupported blocksize {blocksize}")
    _check(B, absmax, n, blocksize)
    code_t = _code_tuple(code)
    if not use_kernel(B, absmax):
        return dequantize_4bit_2d_plain(B, absmax, code_t, blocksize, shape, dtype)
    if dtype not in _KIND:
        raise ValueError(f"the CUDA kernel writes bf16, f16 or float32, not {dtype}")
    if B.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a 16-byte aligned payload")
    W = torch.empty(shape, dtype=dtype, device=B.device)
    if n == 0:
        return W
    err = _lib.lib().bnb_dequantize_4bit_2d(
        B.data_ptr(), absmax.data_ptr(), W.data_ptr(), n, blocksize, _lib.host_f32(code_t), _KIND[dtype],
        _lib.stream(B),
    )
    _lib.check(err, "dequantize_4bit_2d")
    _lib.LAUNCHES["dequantize_4bit_2d"] += 1
    return W


# the backward kernel's tiles (csrc/gemm4bit.cu): 2048 columns of K and 8 rows
# of g per block; each split of N keeps at least 64 rows
_NT_KT, _NT_MT, _NT_MIN_ROWS = 2048, 8, 64


def _nt_splits(M: int, N: int, K: int, sms: int):
    """Rows of N per split and the number of splits: about two blocks per
    SM, each split at least ``_NT_MIN_ROWS`` rows."""
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
    rows, splits = _nt_splits(M, N, K, _sm_count(G.device.index or 0))
    part = torch.empty(splits * M * K, dtype=torch.float32, device=G.device)
    err = _lib.lib().bnb_gemm_4bit_nt_fused(
        G.data_ptr(), B.data_ptr(), absmax.data_ptr(), part.data_ptr(), out.data_ptr(), M, N, K, blocksize,
        rows, splits, _lib.host_f32(code_t), _KIND[G.dtype], _lib.stream(G),
    )
    _lib.check(err, "gemm_4bit_nt_fused")
    _lib.LAUNCHES["gemm_4bit_nt_fused"] += 1
    return out
