"""4-bit matmul entry points: gemm_4bit / gemv_4bit, and the backward
gemm_4bit_grad_A.

Counterpart of the JAX package's ``functional/gemm.py`` for the paired
layout.  Below :data:`LARGE_M_THRESHOLD` rows of A the decode GEMM kernel
reads the packed weight directly; at or above it the dequantize kernel
writes the bf16 weight once and ``torch.matmul`` runs the product, as the
JAX package leaves the large product to XLA.

A double-quantized paired state over the canonical dynamic map (nested
blocksize 256, with an offset) runs the ``_dq`` kernels, which decode the
uint8 absmax where they load it.  Any other nested state is decoded to an
f32 absmax first (``QuantState.dequant_absmax_t``) and runs the plain ones.

The backward ``grad_A = g @ dequant(B)`` routes the same way: below
:data:`BACKWARD_LARGE_M_THRESHOLD` rows of ``g`` the ``_nt`` kernels read the
packed weight, at or above it (bf16 ``g``) the dequantize kernel and
``torch.matmul``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.dispatch import use_kernel
from ..ops.gemm4bit_paired import (
    dequantize_paired_fast,
    dequantize_paired_fast_dq,
    gemm_4bit_paired,
    gemm_4bit_paired_dq,
    gemm_4bit_paired_nt,
    gemm_4bit_paired_nt_dq,
)
from .codebooks import get_4bit_code
from .fourbit import dequantize_4bit
from .quant_state import QuantState

__all__ = ["LARGE_M_THRESHOLD", "BACKWARD_LARGE_M_THRESHOLD", "gemm_4bit", "gemv_4bit", "gemm_4bit_grad_A"]

# Rows of A from which the dequantize + torch.matmul route runs instead of
# the decode GEMM kernel.  Chosen from chip_smoke.py's sweep of both routes
# on the gate_up [28672, 4096] and down [4096, 14336] weights (NVIDIA H100
# 80GB HBM3, 700 W): the kernel wins at M = 16 and loses from M = 32 on,
# since it re-reads the weight once per 8 rows of A (PERF.md).
LARGE_M_THRESHOLD = 32

# Rows of g from which the backward runs the dequantize kernel +
# torch.matmul instead of the _nt kernels.  Chosen from chip_smoke.py's
# phase 3j sweep of both routes on gate_up^T and down^T (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md): the kernel wins on gate_up^T up to M = 16 and loses
# from M = 32 on; on down^T it wins at M = 8 and ties at 16.
BACKWARD_LARGE_M_THRESHOLD = 32


def _paired_routes(quant_state: QuantState):
    """(scales, dequantize, small-M kernels) of a paired state: the ``_dq``
    kernels for a state they decode in place, else the f32 absmax."""
    if quant_state.inline_nested:  # a static property of the state: no device read per call
        scales = (quant_state.absmax, quant_state.state2.absmax, quant_state.offset)
        return scales, dequantize_paired_fast_dq, gemm_4bit_paired_dq, gemm_4bit_paired_nt_dq
    return (quant_state.dequant_absmax_t(),), dequantize_paired_fast, gemm_4bit_paired, gemm_4bit_paired_nt


def gemm_4bit(
    A: torch.Tensor,
    B_packed: torch.Tensor,
    quant_state: QuantState,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out = A @ dequant(B)^T (+ bias)`` with B 4-bit blockwise quantized."""
    N, K = (int(s) for s in quant_state.shape[-2:])
    lead = tuple(A.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    if quant_state.layout != "paired":
        if use_kernel(A, B_packed):
            raise NotImplementedError(
                "only the paired layout has CUDA kernels in this port; "
                "convert with QuantizedTensor.to_layout('paired')"
            )
        W = dequantize_4bit(B_packed, quant_state=quant_state).to(A.dtype)
        out = torch.matmul(A, W.t())
    else:
        bs = quant_state.blocksize
        # the static quant_type, not the code tensor: no device read per call
        code = get_4bit_code(quant_state.quant_type, bs)
        P = B_packed.reshape(N // 2, K)
        A2 = A.reshape(M, K).contiguous()
        scales, dequant, gemm, _ = _paired_routes(quant_state)
        if M >= LARGE_M_THRESHOLD and A.dtype == torch.bfloat16:
            W = dequant(P, *scales, code, bs, torch.bfloat16)
            out = torch.matmul(A2, W.t())
        else:
            out = gemm(A2, P, *scales, code, bs, (N, K))
        out = out.reshape(*lead, N)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def gemv_4bit(A, B_packed, quant_state: QuantState, bias=None) -> torch.Tensor:
    """Decode-path (small M) name for :func:`gemm_4bit`; one routing serves both."""
    return gemm_4bit(A, B_packed, quant_state, bias)


def gemm_4bit_grad_A(g: torch.Tensor, B_packed: torch.Tensor, quant_state: QuantState) -> torch.Tensor:
    """``grad_A = g @ dequant(B)`` (contract over N), the 4-bit matmul's
    backward: ``g [..., N]`` -> ``[..., K]`` in ``g``'s type."""
    N, K = (int(s) for s in quant_state.shape[-2:])
    lead = tuple(g.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    if quant_state.layout != "paired":
        if use_kernel(g, B_packed):
            raise NotImplementedError(
                "only the paired layout has CUDA kernels in this port; "
                "convert with QuantizedTensor.to_layout('paired')"
            )
        W = dequantize_4bit(B_packed, quant_state=quant_state).to(g.dtype)
        return torch.matmul(g, W)
    bs = quant_state.blocksize
    code = get_4bit_code(quant_state.quant_type, bs)
    P = B_packed.reshape(N // 2, K)
    g2 = g.reshape(M, N).contiguous()
    scales, dequant, _, nt = _paired_routes(quant_state)
    if M >= BACKWARD_LARGE_M_THRESHOLD and g.dtype == torch.bfloat16:
        out = torch.matmul(g2, dequant(P, *scales, code, bs, torch.bfloat16))
    else:
        out = nt(g2, P, *scales, code, bs, (N, K))
    return out.reshape(*lead, K)
