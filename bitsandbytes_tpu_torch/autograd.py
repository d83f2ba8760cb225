"""Quantized matmuls as users call them.

Counterpart of the JAX package's ``autograd.py``.  :func:`matmul_4bit` is
forward-only here: the 4-bit backward (``grad_A = g @ dequant(B)``) comes
with the training slice, so a call that would need a gradient raises rather
than return a wrong one.
"""

from __future__ import annotations

from typing import Optional

import torch

from .functional.gemm import gemm_4bit
from .functional.quant_state import QuantState

__all__ = ["matmul_4bit"]


def matmul_4bit(
    A: torch.Tensor,
    B_packed: torch.Tensor,
    quant_state: QuantState,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``A @ dequant(B)^T + bias``, forward only."""
    if torch.is_grad_enabled() and (A.requires_grad or (bias is not None and bias.requires_grad)):
        raise NotImplementedError("matmul_4bit has no backward in this port yet")
    out = gemm_4bit(A, B_packed, quant_state)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
