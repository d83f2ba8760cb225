"""4-bit matmul entry points: gemm_4bit / gemv_4bit, and the backward
gemm_4bit_grad_A.

Counterpart of the JAX package's ``functional/gemm.py``, over both payload
orders:

* **paired** (``ops/gemm4bit_paired.py``).  Below :data:`LARGE_M_THRESHOLD`
  rows of A the decode GEMM kernel reads the packed weight directly; at or
  above it the dequantize kernel writes the weight once in A's type (bf16,
  f16 or f32) and ``torch.matmul`` runs the product, as the JAX package
  leaves the large product to XLA.  A double-quantized paired state over
  the canonical dynamic map (nested blocksize 256, with an offset) runs the
  ``_dq`` kernels, which decode the uint8 absmax where they load it; any
  other nested state is decoded to an f32 absmax first
  (``QuantState.dequant_absmax_t``) and runs the plain ones.
* **K-adjacent**, the ``"flat"`` and ``"2d"`` layouts that a ``quant_storage``
  wider than a byte gives (``ops/gemm4bit.py``).  A payload of a wider
  storage type is read as its bytes; a nested absmax is decoded on the
  device before each call (``QuantState.dequant_absmax``), as the JAX package
  does on this layout.  Below :data:`LARGE_M_THRESHOLD` rows of A kernel 9
  (``gemm_4bit_fused``) reads the packed weight; at or above it, with bf16
  A, kernel 10 (``dequantize_4bit_2d``) and ``torch.matmul``.  (The JAX
  package runs its fused kernel at every M on this layout.)  A weight whose
  rows do not hold whole quantization blocks takes kernel 10 and the matmul
  at any M.

The backward ``grad_A = g @ dequant(B)`` routes the same way around
:data:`BACKWARD_LARGE_M_THRESHOLD` rows of ``g``: the ``_nt`` kernels (kernel
11 on the K-adjacent layout) below it, the dequantize kernel and
``torch.matmul`` at or above it with bf16 ``g``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.gemm4bit import dequantize_4bit_2d, gemm_2d_supported, gemm_4bit_fused, gemm_4bit_nt_fused
from ..ops.gemm4bit_paired import (
    dequantize_paired_fast,
    dequantize_paired_fast_dq,
    gemm_4bit_paired,
    gemm_4bit_paired_dq,
    gemm_4bit_paired_nt,
    gemm_4bit_paired_nt_dq,
)
from .codebooks import get_4bit_code
from .fourbit import payload_bytes
from .quant_state import QuantState

__all__ = ["LARGE_M_THRESHOLD", "BACKWARD_LARGE_M_THRESHOLD", "gemm_4bit", "gemv_4bit", "gemm_4bit_grad_A"]

# Rows of A from which the dequantize + torch.matmul route runs instead of
# the decode GEMM kernel.  Chosen from chip_smoke.py's sweep of both routes
# on the gate_up [28672, 4096] and down [4096, 14336] weights (NVIDIA H100
# 80GB HBM3, 700 W): the kernel wins at M = 16 and loses from M = 32 on,
# since it re-reads the weight once per 8 rows of A (PERF.md).  The
# K-adjacent layout's kernel 9 crosses over at the same place (phase 3l:
# gate_up 0.320 against 0.342 ms at M = 16, 0.636 against 0.342 at M = 32),
# so both layouts share the constant.
LARGE_M_THRESHOLD = 32

# Rows of g from which the backward runs the dequantize kernel +
# torch.matmul instead of the _nt kernels.  Chosen from chip_smoke.py's
# phase 3j sweep of both routes on gate_up^T and down^T (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md): the kernel wins on gate_up^T up to M = 16 and loses
# from M = 32 on; on down^T it wins at M = 8 and ties at 16.  Kernel 11 on
# the K-adjacent layout (phase 3l) wins on gate_up^T up to M = 16 (0.276
# against 0.329 ms), loses on down^T at 16 (0.274 against 0.188) and on
# both at 32: the larger weight's crossover is the paired one, so both
# layouts share the constant.
BACKWARD_LARGE_M_THRESHOLD = 32


def _paired_routes(quant_state: QuantState):
    """(scales, dequantize, small-M kernels) of a paired state: the ``_dq``
    kernels for a state they decode in place, else the f32 absmax."""
    if quant_state.inline_nested:  # a static property of the state: no device read per call
        scales = (quant_state.absmax, quant_state.state2.absmax, quant_state.offset)
        return scales, dequantize_paired_fast_dq, gemm_4bit_paired_dq, gemm_4bit_paired_nt_dq
    return (quant_state.dequant_absmax_t(),), dequantize_paired_fast, gemm_4bit_paired, gemm_4bit_paired_nt


def _kadjacent_args(B_packed: torch.Tensor, quant_state: QuantState):
    """(payload bytes, f32 absmax in the flat block order, codebook,
    blocksize) of a flat or 2d state; a nested absmax decoded on the device."""
    bs = quant_state.blocksize
    # the static quant_type, not the code tensor: no device read per call
    return (payload_bytes(B_packed.contiguous()).reshape(-1), quant_state.dequant_absmax().contiguous(),
            get_4bit_code(quant_state.quant_type, bs), bs)


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
        B, absmax, code, bs = _kadjacent_args(B_packed, quant_state)
        if (M >= LARGE_M_THRESHOLD and A.dtype == torch.bfloat16) or not gemm_2d_supported(N, K, bs):
            W = dequantize_4bit_2d(B, absmax, code, bs, (N, K), A.dtype)
            out = torch.matmul(A, W.t())
        else:
            out = gemm_4bit_fused(A.contiguous(), B, absmax, code, bs, (N, K))
    else:
        bs = quant_state.blocksize
        # the static quant_type, not the code tensor: no device read per call
        code = get_4bit_code(quant_state.quant_type, bs)
        P = B_packed.reshape(N // 2, K)
        A2 = A.reshape(M, K).contiguous()
        scales, dequant, gemm, _ = _paired_routes(quant_state)
        if M >= LARGE_M_THRESHOLD:
            W = dequant(P, *scales, code, bs, A.dtype)
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
        B, absmax, code, bs = _kadjacent_args(B_packed, quant_state)
        if (M >= BACKWARD_LARGE_M_THRESHOLD and g.dtype == torch.bfloat16) or not gemm_2d_supported(N, K, bs):
            return torch.matmul(g, dequantize_4bit_2d(B, absmax, code, bs, (N, K), g.dtype))
        return gemm_4bit_nt_fused(g.contiguous(), B, absmax, code, bs, (N, K))
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
