"""LLM.int8() functional ops.

Counterpart of the JAX package's ``functional/int8.py``.  No TPU kernel
stands behind these: the JAX package computes the int8 product with
``lax.dot_general`` (int32 accumulation) and the epilogues with plain
elementwise ops.  Here the product is ``torch._int_mm`` (cuBLASLt's int8
GEMM on CUDA) and the epilogues are stock torch ops, written in the JAX
package's float32 operation order so that CB, SCB, the outlier mask, the
int32 product and the quantized operands agree with it bit for bit:

  quant   = clip(round(x * (127 / clip(absmax, 1e-38))), -127, 127)  (half to even)
  dequant = A.f32 * (row_stats[:, None] * col_stats) * (1 / 127^2)

An all-zero row scales by inf, so its values are NaN before the cast; they
become code 0, as XLA's conversion gives.

``torch._int_mm`` on CUDA takes more than 16 rows in its first operand, K
and N multiples of 8, the first operand row-major and the second
column-major.  :func:`int8_linear_matmul` pads the rows of A and, where
needed, K and N with zeros (exact for an integer product) and slices the
result, on every device, so that the CPU runs the card's path; it never
falls back to a float matmul.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "int8_vectorwise_quant",
    "int8_vectorwise_dequant",
    "int8_double_quant",
    "int8_linear_matmul",
    "int8_mm_dequant",
    "int8_scaled_mm",
    "int8_mixed_scaled_mm",
    "int_mm_padded",
    "INT_MM_MIN_M",
]

# Exact 1/127 and 1/(127*127), as the JAX package carries them.
INV_127 = 1.0 / 127.0
INV_127_SQ = 1.0 / (127.0 * 127.0)

# The fewest rows torch._int_mm takes on CUDA (it wants more than 16).
INT_MM_MIN_M = 17


def quantize_int8(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 codes of f32 ``x`` against ``stats`` (broadcast).
    ``127 / stats`` is one rounded division: ``127.0 / tensor`` in PyTorch
    is a reciprocal times 127, two roundings, which moves codes of values
    on a rounding tie (common in bf16 weights)."""
    s = stats.clamp(min=1e-38)
    q = torch.round(x * (torch.full_like(s, 127.0) / s)).clamp(-127.0, 127.0)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8)


def int8_vectorwise_quant(
    A: torch.Tensor, threshold: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Row-wise symmetric int8 quantization: ``(int8 [..., K], row_stats f32
    [...], outlier_cols bool [K] or None)``.

    With ``threshold > 0`` the elements with ``|x| >= threshold`` are left
    out of the row absmax, and their columns are zeroed in every row of the
    int8 output and reported as a mask over the last axis."""
    A_f = A.to(torch.float32)
    K = A.shape[-1]
    if threshold > 0.0:
        outliers = A_f.abs() >= threshold
        inliers = torch.where(outliers, 0.0, A_f)
        row_stats = inliers.abs().amax(dim=-1)
        outlier_cols = outliers.reshape(-1, K).any(dim=0)
        quant = quantize_int8(inliers, row_stats[..., None])
        return torch.where(outlier_cols, 0, quant).to(torch.int8), row_stats, outlier_cols
    row_stats = A_f.abs().amax(dim=-1)
    return quantize_int8(A_f, row_stats[..., None]), row_stats, None


def int8_vectorwise_dequant(A: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """``A * stats / 127`` in float32."""
    return A.to(torch.float32) * stats[..., None] * INV_127


def int8_double_quant(A: torch.Tensor, threshold: float = 0.0):
    """Row-wise and column-wise int8 quantization: ``(out_row, out_col,
    row_stats, col_stats, outlier_mask)``; the outliers (``threshold > 0``)
    are left out of the column statistics too."""
    out_row, row_stats, outlier_mask = int8_vectorwise_quant(A, threshold=threshold)
    A_f = A.to(torch.float32)
    if threshold > 0.0:
        A_f = torch.where(A_f.abs() >= threshold, 0.0, A_f)
    A2d = A_f.reshape(-1, A.shape[-1])
    col_stats = A2d.abs().amax(dim=0)
    out_col = quantize_int8(A2d, col_stats[None, :]).reshape(A.shape)
    return out_row, out_col, row_stats, col_stats, outlier_mask


def int_mm_padded(A2: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A2 [M, K] @ B [N, K]^T`` in int32 by ``torch._int_mm``, the rows of
    ``A2`` padded with zeros to at least ``INT_MM_MIN_M``, K and N to
    multiples of 8, the result sliced back to ``[M, N]``.  The first operand
    goes row-major, the second column-major (``B``'s rows contiguous, then
    transposed)."""
    M, K = A2.shape
    N = B.shape[0]
    pm, pk, pn = max(INT_MM_MIN_M - M, 0), (-K) % 8, (-N) % 8
    if pm or pk:
        A2 = torch.nn.functional.pad(A2, (0, pk, 0, pm))
    if pk or pn:
        B = torch.nn.functional.pad(B, (0, pk, 0, pn))
    out = torch._int_mm(A2.contiguous(), B.contiguous().t())
    return out[:M, :N] if pm or pn else out


def int8_linear_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32: ``A [..., K] @ B [N, K]^T -> [..., N]``, the
    operands padded to the shapes ``torch._int_mm`` takes on CUDA
    (:func:`int_mm_padded`)."""
    if A.dtype != torch.int8 or B.dtype != torch.int8:
        raise ValueError(f"int8_linear_matmul takes int8 operands, got {A.dtype} and {B.dtype}")
    lead, K = A.shape[:-1], A.shape[-1]
    if B.dim() != 2 or B.shape[1] != K:
        raise ValueError(f"B must be [N, {K}], got {tuple(B.shape)}")
    return int_mm_padded(A.reshape(-1, K), B).reshape(*lead, B.shape[0])


def int8_mm_dequant(
    A: torch.Tensor,
    row_stats: torch.Tensor,
    col_stats: torch.Tensor,
    dtype=torch.float16,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """An int32 product back to floats: ``A * row_stats[:, None] *
    col_stats / 127^2 (+ bias)`` in float32, then cast to ``dtype``."""
    out = A.to(torch.float32) * (row_stats[..., None] * col_stats) * INV_127_SQ
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dtype)


def int8_scaled_mm(
    A: torch.Tensor,
    B: torch.Tensor,
    row_stats: torch.Tensor,
    col_stats: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dtype=torch.float16,
) -> torch.Tensor:
    """The int8 product with its dequantize epilogue."""
    return int8_mm_dequant(int8_linear_matmul(A, B), row_stats, col_stats, dtype=dtype, bias=bias)


def int8_mixed_scaled_mm(
    A_quant: torch.Tensor,
    A_full: torch.Tensor,
    B: torch.Tensor,
    row_stats: torch.Tensor,
    col_stats: torch.Tensor,
    outlier_cols: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    dtype=torch.float16,
) -> torch.Tensor:
    """LLM.int8()'s mixed-precision product: ``int8_scaled_mm(A_quant, B)``
    plus ``A_full[:, outliers] @ dequant(B)[:, outliers]^T``.  As in the JAX
    package, the outlier part is a masked full-width product of operands
    rounded to ``dtype``, accumulated in float32 (the int8 operand saw zeros
    in those columns, so the sum is whole)."""
    out = int8_scaled_mm(A_quant, B, row_stats, col_stats, bias=bias, dtype=dtype)
    if outlier_cols is None:
        return out
    mask = outlier_cols.to(torch.float32)
    B_dq = B.to(torch.float32) * (col_stats[:, None] * INV_127) * mask[None, :]
    A_masked = A_full.to(torch.float32) * mask
    corr = torch.matmul(A_masked.to(dtype).to(torch.float32), B_dq.to(dtype).to(torch.float32).t())
    return (out.to(torch.float32) + corr).to(dtype)
