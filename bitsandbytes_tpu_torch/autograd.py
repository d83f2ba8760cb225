"""Quantized matmuls as users call them.

Counterpart of the JAX package's ``autograd.py``.  :func:`matmul_4bit` is a
``torch.autograd.Function``: its forward is ``gemm_4bit``, its backward
``grad_A = g @ dequant(B)`` (``gemm_4bit_grad_A``) plus the bias gradient.
The 4-bit weight is frozen: neither the packed payload nor any tensor of its
state gets a gradient, so QLoRA trains adapters beside it.

:func:`matmul` is LLM.int8(): the activations quantized row-wise to int8
against an int8 weight (CB, with its row absmax SCB), the columns holding an
outlier (``threshold > 0``) computed apart in floats.  A frozen int8 weight
gives ``grad_A`` against ``CB * SCB / 127`` and no weight gradient; a
trainable float weight (``has_fp16_weights``) is quantized on the fly and
also gets ``grad_B``, an int8 product of the column-quantized gradient and
activations plus the exact float product on the captured outlier columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .functional.gemm import gemm_4bit, gemm_4bit_grad_A
from .functional.int8 import (
    int8_mixed_scaled_mm,
    int8_scaled_mm,
    int8_vectorwise_quant,
    quantize_int8,
)
from .functional.quant_state import QuantState

__all__ = ["matmul_4bit", "matmul", "MatmulLtState"]


class _MatMul4Bit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B_packed, quant_state, bias):
        # the frozen weight is kept by reference: no gradient reaches it
        ctx.weight = (B_packed, quant_state)
        ctx.bias_dtype = None if bias is None else bias.dtype
        out = gemm_4bit(A, B_packed, quant_state)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        B_packed, quant_state = ctx.weight
        grad_A = grad_bias = None
        if ctx.needs_input_grad[0]:
            grad_A = gemm_4bit_grad_A(g, B_packed, quant_state).to(g.dtype)
        if ctx.needs_input_grad[3]:
            grad_bias = g.reshape(-1, g.shape[-1]).sum(0).to(ctx.bias_dtype)
        return grad_A, None, None, grad_bias


def matmul_4bit(
    A: torch.Tensor,
    B_packed: torch.Tensor,
    quant_state: QuantState,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``A @ dequant(B)^T + bias``, with gradients for ``A`` and ``bias``
    only."""
    return _MatMul4Bit.apply(A, B_packed, quant_state, bias)


# -- LLM.int8() ----------------------------------------------------------------


@dataclasses.dataclass
class MatmulLtState:
    """The weight side of LLM.int8()'s matmul: ``CB`` the int8 weight [N, K]
    and ``SCB`` its row absmax [N] (frozen), or ``has_fp16_weights`` for a
    float weight quantized at every call (trained).  ``threshold > 0`` turns
    on the outlier decomposition; ``outlier_budget`` is how many columns the
    training forward keeps in floats for ``grad_B`` (default
    ``_outlier_budget(K)``)."""

    CB: Optional[torch.Tensor] = None
    SCB: Optional[torch.Tensor] = None
    threshold: float = 0.0
    has_fp16_weights: bool = False
    outlier_budget: Optional[int] = None


def _int8_forward(A, CB, SCB, threshold, out_dtype):
    lead = A.shape[:-1]
    A2 = A.reshape(-1, A.shape[-1])
    if threshold > 0.0:
        Aq, row_stats, outlier_cols = int8_vectorwise_quant(A2, threshold=threshold)
        out = int8_mixed_scaled_mm(Aq, A2, CB, row_stats, SCB, outlier_cols=outlier_cols, dtype=out_dtype)
    else:
        Aq, row_stats, _ = int8_vectorwise_quant(A2)
        out = int8_scaled_mm(Aq, CB, row_stats, SCB, dtype=out_dtype)
    return out.reshape(*lead, CB.shape[0])


def _colwise_quant(x2d):
    """Column-wise symmetric int8 quantization: ``(codes, column absmax)``."""
    x_f = x2d.to(torch.float32)
    col_stats = x_f.abs().amax(dim=0)
    return quantize_int8(x_f, col_stats[None, :]), col_stats


def _outlier_budget(K: int) -> int:
    """Outlier columns kept in floats for ``grad_B``: K/64 (at least 32, at
    most K), about 16 times the 0.1% of columns LLM.int8() finds at
    threshold 6."""
    return min(K, max(32, K // 64))


def _grad_A(g, CB, SCB):
    """``g @ (CB * SCB / 127)`` in float32, back in ``g``'s type."""
    W_dq = CB.to(torch.float32) * (SCB[:, None] / 127.0)
    return torch.matmul(g.to(torch.float32), W_dq).to(g.dtype)


class _MatMul8bitFrozen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, CB, SCB, threshold):
        ctx.weight = (CB, SCB)  # by reference: no gradient reaches it
        return _int8_forward(A, CB, SCB, threshold, A.dtype)

    @staticmethod
    def backward(ctx, g):
        CB, SCB = ctx.weight
        grad_A = _grad_A(g, CB, SCB) if ctx.needs_input_grad[0] else None
        return grad_A, None, None, None


class _MatMul8bitTrain(torch.autograd.Function):
    """The float weight is quantized row-wise for the forward.  Saved for the
    backward: CB/SCB, the activations quantized column-wise (``CAt``,
    ``SCAt``) and, under a threshold, the ``budget`` columns of largest absmax
    that hold an outlier, in the activations' type (``subA``; the ties of
    the ranking go to the lower column, as ``lax.top_k`` breaks them).
    Captured columns are zeroed in ``CAt``; outlier columns past the budget
    stay int8-quantized there."""

    @staticmethod
    def forward(ctx, A, B_fp, threshold, budget):
        CB, SCB, _ = int8_vectorwise_quant(B_fp)
        out = _int8_forward(A, CB, SCB, threshold, A.dtype)
        A2 = A.reshape(-1, A.shape[-1])
        idx = subA = None
        if threshold > 0.0:
            A2f = A2.to(torch.float32)
            K = A2.shape[-1]
            colmax = A2f.abs().amax(dim=0)
            idx = torch.sort(colmax, descending=True, stable=True).indices[: min(budget, K)]
            captured = colmax[idx] >= threshold
            subA = (A2f[:, idx] * captured[None, :]).to(A2.dtype)
            capture_mask = torch.zeros(K, dtype=torch.bool, device=A.device)
            capture_mask[idx] = captured
            CAt, SCAt = _colwise_quant(torch.where(capture_mask[None, :], 0.0, A2f))
        else:
            CAt, SCAt = _colwise_quant(A2)
        ctx.saved = (CB, SCB, CAt, SCAt, subA, idx)
        ctx.threshold = threshold
        ctx.b_dtype = B_fp.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        CB, SCB, CAt, SCAt, subA, idx = ctx.saved
        grad_A = grad_B = None
        if ctx.needs_input_grad[0]:
            grad_A = _grad_A(g, CB, SCB)
        if ctx.needs_input_grad[1]:
            g2 = g.reshape(-1, g.shape[-1])
            Cgt, SCgt = _colwise_quant(g2)
            # grad_B[n, k] = sum over tokens of g[m, n] A[m, k]: an int8
            # product contracting the tokens (int8_linear_matmul makes the
            # transposed operands contiguous)
            grad_B = int8_scaled_mm(Cgt.t(), CAt.t(), SCgt, SCAt, dtype=torch.float32)
            if ctx.threshold > 0.0:
                grad_B[:, idx] += torch.matmul(g2.t().to(torch.float32), subA.to(torch.float32))
            grad_B = grad_B.to(ctx.b_dtype)
        return grad_A, grad_B, None, None


def matmul(
    A: torch.Tensor,
    B: Optional[torch.Tensor],
    state: MatmulLtState,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LLM.int8() ``A @ B^T + bias``.  ``B`` is the float weight [N, K] when
    ``state.has_fp16_weights`` (it gets a gradient); otherwise
    ``state.CB``/``state.SCB`` hold the frozen int8 weight and ``B`` is not
    read."""
    if state.has_fp16_weights:
        budget = state.outlier_budget
        if budget is None:
            budget = _outlier_budget(A.shape[-1])
        out = _MatMul8bitTrain.apply(A, B, float(state.threshold), int(budget))
    else:
        out = _MatMul8bitFrozen.apply(A, state.CB, state.SCB, float(state.threshold))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
