"""4-bit matmul entry points: gemm_4bit / gemv_4bit, and the backward
gemm_4bit_grad_A.

Counterpart of the JAX package's ``functional/gemm.py``, over both payload
orders:

* **paired** (``ops/gemm4bit_paired.py``).  Below :data:`LARGE_M_THRESHOLD`
  rows of A the decode GEMM kernels (2, and 5 on a nested state) read the
  packed weight directly; at or above it the dequantize kernel writes the
  weight once in A's type (bf16, f16 or f32) and ``torch.matmul`` runs the
  product, as the JAX package leaves the large product to XLA.  A double-quantized paired state over
  the canonical dynamic map (nested blocksize 256, with an offset) runs the
  ``_dq`` kernels, which decode the uint8 absmax where they load it; any
  other nested state is decoded to an f32 absmax first
  (``QuantState.dequant_absmax_t``) and runs the plain ones.
* **K-adjacent**, the ``"flat"`` and ``"2d"`` layouts that a ``quant_storage``
  wider than a byte gives (``ops/gemm4bit.py``).  A payload of a wider
  storage type is read as its bytes.  Below :data:`KADJACENT_LARGE_M_THRESHOLD`
  rows of bf16 or f16 A (:data:`KADJACENT_F32_LARGE_M_THRESHOLD` of f32 A)
  kernel 9 (``gemm_4bit_fused``) reads the packed weight; at or above it
  kernel 10 (``dequantize_4bit_2d``) writes the weight in A's type and
  ``torch.matmul`` runs the product.  (The JAX package runs its fused kernel
  at every M on this layout.)  A weight whose rows do not hold whole
  quantization blocks takes kernel 10 and the matmul at any M.  A
  double-quantized state over the canonical dynamic map
  (``QuantState.inline_nested``) runs the ``_dq`` kernels, which decode the
  uint8 absmax where they load it; any other nested state is decoded to an
  f32 absmax first (``QuantState.dequant_absmax``).

The backward ``grad_A = g @ dequant(B)`` routes the same way around a
threshold of rows of ``g`` for its type and layout
(:func:`backward_threshold`): the ``_nt`` kernels (kernel 11 on the
K-adjacent layout) below it, the dequantize kernel in g's type (``_dq`` on
an ``inline_nested`` state) and ``torch.matmul`` at or above it.  Kernel 11
takes an f32 absmax only, so on a nested K-adjacent state it still runs
after a decode on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.gemm4bit import (
    dequantize_4bit_2d,
    dequantize_4bit_2d_dq,
    gemm_2d_supported,
    gemm_4bit_fused,
    gemm_4bit_fused_dq,
    gemm_4bit_nt_fused,
)
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

__all__ = ["LARGE_M_THRESHOLD", "KADJACENT_LARGE_M_THRESHOLD", "KADJACENT_F32_LARGE_M_THRESHOLD",
           "BACKWARD_LARGE_M_THRESHOLD", "BACKWARD_F16_LARGE_M_THRESHOLD", "BACKWARD_F32_LARGE_M_THRESHOLD",
           "KADJACENT_BACKWARD_F32_LARGE_M_THRESHOLD", "backward_threshold", "gemm_4bit", "gemv_4bit",
           "gemm_4bit_grad_A"]

# Rows of A from which the paired layout's dequantize + torch.matmul route
# runs instead of kernels 2 and 5.  Chosen from chip_smoke.py's sweep of both
# routes (phase 3d) on the gate_up [28672, 4096] and down [4096, 14336]
# weights at M 8-256, device time with the host held out, bf16 A (NVIDIA H100
# 80GB HBM3, 700.00 W).  The tensor-core kernels read the payload once per 32
# rows of A, so their time steps every 32 rows.  Up to M 128 (four steps)
# both kernels lead on both weights (down at 128: kernel 2 0.1134 against
# 0.1692 ms, kernel 5 0.1235 against 0.1677; gate_up 0.2134 / 0.2353 against
# 0.3064 / 0.3027); from M 129 the fifth step makes both trail on down (M
# 160: 0.2052 / 0.2231 against 0.1686 / 0.1669), and on gate_up from M 192.
LARGE_M_THRESHOLD = 129

# The same for the K-adjacent layout's kernel 9: chip_smoke.py's sweep (phase
# 3l) of kernel 9, plain and nested, against kernel 10 (plain and _dq) +
# matmul in A's type, on gate_up and down at M 8-256, device time with the
# host held out, NVIDIA H100 80GB HBM3 at 700.00 W.  bf16 and f16 A run on
# the tensor cores, which read the payload once per 32 rows of A: kernel 9
# leads through M 64 on both linears (gate_up 0.1301 against 0.1982 ms,
# nested 0.1589 against 0.1976; down 0.0651 against 0.1104, nested 0.0759
# against 0.1101), and from M 65 the nested instance trails on both (gate_up
# 0.2307 against 0.1994, down 0.1362 against 0.1105), as the plain one does
# on down (0.1153 against 0.1104); plain gate_up still leads at 65 and 96
# (0.1875 against 0.2004) and trails from M 128 (0.2202 against 0.2023).  f16
# within 2% of bf16.  So the dequantize route takes M 65 and above.  f32 A
# keeps the CUDA-core body, which reads the weight once per 8 rows of A: at M
# 8 the layer is even (gate_up 0.5104 against 0.4707 ms, down 0.2604 against
# 0.2951), and both trail from M 16 (1.0165 against 0.4646, 0.5217 against
# 0.2370).
KADJACENT_LARGE_M_THRESHOLD = 65
KADJACENT_F32_LARGE_M_THRESHOLD = 9

# Rows of g from which the backward runs the dequantize kernel (in g's
# type) + torch.matmul instead of the _nt kernels.  Chosen from
# chip_smoke.py's sweeps of both routes on gate_up^T and down^T, device time
# with the host held out (phase 3j: kernel 7 against dequantize_paired_fast
# + matmul and kernel 8 against dequantize_paired_fast_dq + matmul; phase
# 3l: kernel 11 against dequantize_4bit_2d + matmul), NVIDIA H100 80GB HBM3
# at 700.00 W.
#
# bf16 and f16 g run the tensor-core kernels, which read the payload once
# per 32 rows of g, and both layouts change sides at the same row.  bf16:
# every _nt kernel leads through M 64 (gate_up^T: kernel 7 0.1197 against
# 0.2027 ms, kernel 8 0.1425 against 0.2005, kernel 11 0.1520 against
# 0.2023) and trails from M 65 (0.2264 against 0.2034, 0.2649 against
# 0.2017, 0.2810 against 0.2027; down^T: kernel 8 0.1257 against 0.1075,
# kernel 11 0.1158 against 0.1078, kernel 7 even at 0.1083 against 0.1085,
# behind from M 128).  f16 the same (M 64 / 65 on gate_up^T: kernel 7 0.1148
# / 0.2101 against 0.2031 / 0.2037, kernel 8 0.1389 / 0.2633 against 0.2008
# / 0.2014, kernel 11 0.1509 / 0.2813 against 0.2029 / 0.2028; down^T at 65:
# kernel 8 0.1240 against 0.1069, kernel 11 0.1157 against 0.1084, kernel 7
# 0.1015 against 0.1076, behind from 128); at M 2048 kernel 7 takes 3.241 ms
# against 0.7174.
#
# f32 g runs the CUDA-core bodies, which read the weight once per 8 rows of
# g, against an f32 dequantize and a full-f32 matmul (TF32 off), and the
# layouts part.  Kernels 7 and 8 lead through M 32 (gate_up^T 0.3213 /
# 0.3151 against 0.3998 / 0.3986 ms, down^T 0.2693 / 0.2658 against 0.2888 /
# 0.2878) and trail at M 40 (0.6815 against 0.5159, 0.3345 against 0.2764).
# Kernel 11 leads through M 24 on gate_up^T (0.3206 against 0.3955) and
# trails there on down^T by 1.6% (0.2928 against 0.2881); both trail at 32
# (0.4272 against 0.3969, 0.3773 against 0.2874).  At M 2048 the CUDA-core
# kernels take 20.14 (kernel 7) and 25.16 ms (kernel 11) on gate_up^T
# against 9.48.
BACKWARD_LARGE_M_THRESHOLD = 65
BACKWARD_F16_LARGE_M_THRESHOLD = 65
BACKWARD_F32_LARGE_M_THRESHOLD = 33
KADJACENT_BACKWARD_F32_LARGE_M_THRESHOLD = 25


def backward_threshold(dtype, layout: str) -> int:
    """The rows of g from which the backward of a ``layout`` state takes the
    dequantize route."""
    if dtype == torch.float16:
        return BACKWARD_F16_LARGE_M_THRESHOLD
    if dtype == torch.float32:
        return BACKWARD_F32_LARGE_M_THRESHOLD if layout == "paired" else KADJACENT_BACKWARD_F32_LARGE_M_THRESHOLD
    return BACKWARD_LARGE_M_THRESHOLD


def _paired_routes(quant_state: QuantState):
    """(scales, dequantize, small-M kernels) of a paired state: the ``_dq``
    kernels for a state they decode in place, else the f32 absmax."""
    if quant_state.inline_nested:  # a static property of the state: no device read per call
        scales = (quant_state.absmax, quant_state.state2.absmax, quant_state.offset)
        return scales, dequantize_paired_fast_dq, gemm_4bit_paired_dq, gemm_4bit_paired_nt_dq
    return (quant_state.dequant_absmax_t(),), dequantize_paired_fast, gemm_4bit_paired, gemm_4bit_paired_nt


def _kadjacent_routes(B_packed: torch.Tensor, quant_state: QuantState):
    """(payload bytes, scales, codebook, blocksize, dequantize, small-M
    GEMM) of a flat or 2d state: the ``_dq`` kernels for a state they decode
    in place, else the f32 absmax in the flat block order."""
    bs = quant_state.blocksize
    B = payload_bytes(B_packed.contiguous()).reshape(-1)
    # the static quant_type, not the code tensor: no device read per call
    code = get_4bit_code(quant_state.quant_type, bs)
    if quant_state.inline_nested:  # a static property of the state: no device read per call
        scales = (quant_state.absmax.reshape(-1), quant_state.state2.absmax, quant_state.offset)
        return B, scales, code, bs, dequantize_4bit_2d_dq, gemm_4bit_fused_dq
    return B, (quant_state.dequant_absmax().contiguous(),), code, bs, dequantize_4bit_2d, gemm_4bit_fused


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
        B, scales, code, bs, dequant, gemm = _kadjacent_routes(B_packed, quant_state)
        threshold = KADJACENT_F32_LARGE_M_THRESHOLD if A.dtype == torch.float32 else KADJACENT_LARGE_M_THRESHOLD
        if M >= threshold or not gemm_2d_supported(N, K, bs):
            out = torch.matmul(A, dequant(B, *scales, code, bs, (N, K), A.dtype).t())
        else:
            out = gemm(A.contiguous(), B, *scales, code, bs, (N, K))
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
    large = M >= backward_threshold(g.dtype, quant_state.layout)
    if quant_state.layout != "paired":
        B, scales, code, bs, dequant, _ = _kadjacent_routes(B_packed, quant_state)
        if large or not gemm_2d_supported(N, K, bs):
            return torch.matmul(g, dequant(B, *scales, code, bs, (N, K), g.dtype))
        # kernel 11 takes an f32 absmax only: a state the _dq kernels read is decoded first
        absmax = quant_state.dequant_absmax().contiguous() if quant_state.inline_nested else scales[0]
        return gemm_4bit_nt_fused(g.contiguous(), B, absmax, code, bs, (N, K))
    bs = quant_state.blocksize
    code = get_4bit_code(quant_state.quant_type, bs)
    P = B_packed.reshape(N // 2, K)
    g2 = g.reshape(M, N).contiguous()
    scales, dequant, _, nt = _paired_routes(quant_state)
    if large:
        out = torch.matmul(g2, dequant(P, *scales, code, bs, g.dtype))
    else:
        out = nt(g2, P, *scales, code, bs, (N, K))
    return out.reshape(*lead, K)
