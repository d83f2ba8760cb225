"""Quantized tensors and linear layers as ``torch.nn.Module``s.

Counterpart of the JAX package's ``nn/modules.py`` for the 4-bit and int8
paths:

* :class:`QuantizedTensor`: a packed 4-bit payload with its QuantState;
* :class:`Linear4bit` with :class:`LinearNF4` / :class:`LinearFP4`: a linear
  layer over a frozen 4-bit weight, quantized when it is built;
* :class:`Int8TensorState`: an int8 weight (CB) with its row absmax (SCB);
* :class:`Linear8bitLt`: LLM.int8()'s linear layer, over a frozen int8
  weight or a trained float one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import autograd
from ..functional.fourbit import dequantize_4bit, payload_bytes, quantize_4bit
from ..functional.int8 import int8_vectorwise_quant
from ..functional.quant_state import QuantState
from ..ops.dispatch import resolve_device
from ..ops.gemm4bit_paired import repack_2d_to_npaired, repack_npaired_to_2d

__all__ = ["QuantizedTensor", "Linear4bit", "LinearNF4", "LinearFP4", "Int8TensorState", "Linear8bitLt"]


@dataclasses.dataclass
class QuantizedTensor:
    """A packed 4-bit tensor and its QuantState."""

    data: torch.Tensor
    state: QuantState

    @classmethod
    def quantize(
        cls,
        W: torch.Tensor,
        blocksize: int = 64,
        quant_type: str = "nf4",
        compress_statistics: bool = False,
        layout: str = "auto",
        quant_storage: torch.dtype = torch.uint8,
    ) -> "QuantizedTensor":
        """``layout="auto"`` picks the paired decode layout when the shape
        allows it (2-D, K % blocksize == 0, even N) and the storage is uint8,
        then ``"2d"``, then ``"flat"``, as the JAX package picks: a wider
        ``quant_storage`` (bf16 for FSDP-QLoRA) keeps the K-adjacent order."""
        if layout == "auto":
            if (W.dim() == 2 and W.shape[-1] % blocksize == 0 and W.shape[0] % 2 == 0
                    and quant_storage == torch.uint8):
                layout = "paired"
            elif W.dim() == 2 and W.shape[-1] % blocksize == 0 and W.shape[-1] % 2 == 0:
                layout = "2d"
            else:
                layout = "flat"
        packed, state = quantize_4bit(
            W,
            blocksize=blocksize,
            quant_type=quant_type,
            compress_statistics=compress_statistics,
            layout=layout,
            quant_storage=quant_storage,
        )
        return cls(data=packed, state=state)

    def dequantize(self) -> torch.Tensor:
        return dequantize_4bit(self.data, quant_state=self.state)

    def resolve_nested(self) -> "QuantizedTensor":
        """Decode a double-quantized absmax to float32 once
        (``QuantState.resolve_nested``); bit-identical outputs.  No-op when
        the state is not nested."""
        if not self.state.nested:
            return self
        return QuantizedTensor(data=self.data, state=self.state.resolve_nested())

    def to_layout(self, layout: str) -> "QuantizedTensor":
        """Relayout the payload between ``flat``/``2d`` (interop K-adjacent
        order) and ``paired``; a byte-exact round trip.  The absmax (f32
        values or uint8 nested codes alike) transposes with the payload.  A
        payload of a wider storage type is read as its bytes, and the result
        is uint8."""
        state = self.state
        cur = state.layout
        if cur == layout:
            return self
        N, K = (int(s) for s in state.shape)
        bs = state.blocksize
        raw = payload_bytes(self.data.contiguous())  # never reshaped along K before this bitcast
        if layout == "paired":
            if N % 2 or K % bs:
                raise ValueError(f"paired layout needs even N and K % {bs} == 0")
            data = repack_2d_to_npaired(raw.reshape(N, K // 2), (N, K))
            absmax = state.absmax.reshape(N, K // bs).t().contiguous()
        elif cur == "paired":
            data = repack_npaired_to_2d(raw.reshape(N // 2, K))
            if layout == "flat":
                data = data.reshape(-1, 1)
            absmax = state.absmax.t().reshape(-1)
        else:  # flat <-> 2d: the same bytes
            data = raw.reshape(N, K // 2) if layout == "2d" else raw.reshape(-1, 1)
            absmax = state.absmax
        return QuantizedTensor(data=data, state=dataclasses.replace(state, absmax=absmax, layout=layout))

    @property
    def shape(self):
        return self.state.shape

    @property
    def dtype(self):
        return self.state.dtype


class Linear4bit(torch.nn.Module):
    """Linear layer over a frozen 4-bit blockwise-quantized weight ``[N, K]``.

    The weight is drawn like ``torch.nn.Linear``'s (uniform, bound
    ``1/sqrt(K)``) from ``generator`` and quantized at once, its absmax
    double-quantized when ``compress_statistics``, its payload stored as
    ``quant_storage`` (a type wider than uint8 keeps the K-adjacent layout);
    assign a :class:`QuantizedTensor` to ``weight`` to load another.  The
    input is cast to ``compute_dtype``."""

    quant_type_default = "nf4"

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        quant_type: Optional[str] = None,
        blocksize: int = 64,
        compress_statistics: bool = False,
        quant_storage: torch.dtype = torch.uint8,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        bound = 1.0 / math.sqrt(in_features)
        W = torch.rand(out_features, in_features, generator=generator, device=device) * (2 * bound) - bound
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.weight = QuantizedTensor.quantize(
            W, blocksize=blocksize, quant_type=quant_type or self.quant_type_default,
            compress_statistics=compress_statistics, quant_storage=quant_storage,
        )
        self.bias = (
            torch.nn.Parameter(torch.zeros(out_features, dtype=compute_dtype, device=device), requires_grad=False)
            if bias
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.matmul_4bit(
            x.to(self.compute_dtype), self.weight.data, self.weight.state, bias=self.bias
        )

    def extra_repr(self) -> str:
        st = self.weight.state
        return (
            f"in_features={self.in_features}, out_features={self.out_features}, "
            f"quant_type={st.quant_type}, blocksize={st.blocksize}, layout={st.layout}, "
            f"compress_statistics={st.nested}"
        )


class LinearNF4(Linear4bit):
    quant_type_default = "nf4"


class LinearFP4(Linear4bit):
    quant_type_default = "fp4"


@dataclasses.dataclass
class Int8TensorState:
    """An int8 weight ``CB [N, K]`` and its per-row absmax ``SCB [N]``
    (float32): LLM.int8()'s row-wise quantization of a float weight."""

    CB: torch.Tensor
    SCB: torch.Tensor

    @classmethod
    def quantize(cls, W: torch.Tensor) -> "Int8TensorState":
        CB, SCB, _ = int8_vectorwise_quant(W)
        return cls(CB=CB, SCB=SCB)

    def dequantize(self) -> torch.Tensor:
        return self.CB.to(torch.float32) * (self.SCB[:, None] / 127.0)

    @property
    def shape(self):
        return self.CB.shape


class Linear8bitLt(torch.nn.Module):
    """LLM.int8()'s linear layer ``[N, K]``.

    With ``has_fp16_weights`` the weight is a trainable
    ``torch.nn.Parameter`` in ``compute_dtype``, quantized to int8 at every
    call (its gradient comes from :func:`autograd.matmul`'s int8 backward);
    otherwise it is quantized once to a frozen :class:`Int8TensorState`.
    ``threshold > 0`` computes the activation columns that hold an outlier
    in floats.  The weight is drawn like ``torch.nn.Linear``'s (uniform,
    bound ``1/sqrt(K)``) from ``generator``; assign a tensor or an
    :class:`Int8TensorState` to ``weight`` to load another.  The bias is a
    trainable parameter, zero at first."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        has_fp16_weights: bool = False,
        threshold: float = 0.0,
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        bound = 1.0 / math.sqrt(in_features)
        W = torch.rand(out_features, in_features, generator=generator, device=device) * (2 * bound) - bound
        self.in_features = in_features
        self.out_features = out_features
        self.has_fp16_weights = has_fp16_weights
        self.threshold = threshold
        self.compute_dtype = compute_dtype
        if has_fp16_weights:
            self.weight = torch.nn.Parameter(W.to(compute_dtype))
        else:
            self.weight = Int8TensorState.quantize(W)
        self.bias = (
            torch.nn.Parameter(torch.zeros(out_features, dtype=compute_dtype, device=device)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.has_fp16_weights:
            state = autograd.MatmulLtState(threshold=self.threshold, has_fp16_weights=True)
            return autograd.matmul(x, self.weight, state, bias=self.bias)
        state = autograd.MatmulLtState(CB=self.weight.CB, SCB=self.weight.SCB, threshold=self.threshold)
        return autograd.matmul(x, None, state, bias=self.bias)

    def extra_repr(self) -> str:
        return (
            f"in_features={self.in_features}, out_features={self.out_features}, "
            f"has_fp16_weights={self.has_fp16_weights}, threshold={self.threshold}"
        )
