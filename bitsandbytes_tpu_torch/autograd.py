"""Quantized matmuls as users call them.

Counterpart of the JAX package's ``autograd.py``.  :func:`matmul_4bit` is a
``torch.autograd.Function``: its forward is ``gemm_4bit``, its backward
``grad_A = g @ dequant(B)`` (``gemm_4bit_grad_A``) plus the bias gradient.
The 4-bit weight is frozen: neither the packed payload nor any tensor of its
state gets a gradient, so QLoRA trains adapters beside it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .functional.gemm import gemm_4bit, gemm_4bit_grad_A
from .functional.quant_state import QuantState

__all__ = ["matmul_4bit"]


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
