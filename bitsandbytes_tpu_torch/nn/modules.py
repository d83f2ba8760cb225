"""Quantized tensors and linear layers as ``torch.nn.Module``s.

Counterpart of the JAX package's ``nn/modules.py`` for the 4-bit and int8
paths:

* :class:`QuantizedTensor`: a packed 4-bit payload with its QuantState;
* :class:`Linear4bit` with :class:`LinearNF4` / :class:`LinearFP4`: a linear
  layer over a frozen 4-bit weight, quantized when it is built;
* :class:`Int8TensorState`: an int8 weight (CB) with its row absmax (SCB);
* :class:`Linear8bitLt`: LLM.int8()'s linear layer, over a frozen int8
  weight or a trained float one;
* :class:`Embedding4bit` with :class:`EmbeddingNF4` / :class:`EmbeddingFP4`,
  and :class:`Embedding8bit`: lookups into a frozen quantized table that
  dequantize only the rows they gather;
* :class:`Embedding` and :class:`StableEmbedding` (with a LayerNorm): float
  tables whose optimizer states the override rules keep at 32 bits;
* :class:`OutlierAwareLinear`: an int8 weight whose outlier input columns
  stay in floats.

The embeddings take ``padding_idx``, ``max_norm`` and ``norm_type`` as
``torch.nn.Embedding`` does, with one difference kept from the JAX
package: ``max_norm`` rescales the gathered rows, and the stored table is
never renormed in place.
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

__all__ = [
    "QuantizedTensor",
    "Linear4bit",
    "LinearNF4",
    "LinearFP4",
    "Int8TensorState",
    "Linear8bitLt",
    "Embedding4bit",
    "EmbeddingNF4",
    "EmbeddingFP4",
    "Embedding8bit",
    "Embedding",
    "StableEmbedding",
    "OutlierAwareLinear",
]


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


def _partial_dequant_rows(qweight: QuantizedTensor, ids: torch.Tensor, dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Gather rows of a packed 4-bit table ``[V, D]`` with their absmax rows
    and dequantize only those rows (kernel 10 on CUDA): ``[*ids.shape, D]``
    in ``dtype`` (default the state's), each value the exact f32 product
    rounded once, as a dequantize to the state's type and a cast give it.  A
    paired table is relaid to 2d first, at every lookup (tables should be
    quantized with layout "2d"), and rows that do not own whole quantization
    blocks take a dequantize of the whole table, as in the JAX package."""
    if qweight.state.layout == "paired":
        qweight = qweight.to_layout("2d")
    state = qweight.state
    dtype = dtype or state.dtype
    V, D = (int(s) for s in state.shape)
    bs = state.blocksize
    if D % 2 or D % bs:
        return qweight.dequantize()[ids].to(dtype)
    flat = ids.reshape(-1)
    rows = payload_bytes(qweight.data.contiguous()).reshape(V, D // 2)[flat]
    absmax = state.dequant_absmax().reshape(V, D // bs)[flat]
    out = dequantize_4bit(rows.reshape(-1, 1), absmax=absmax.reshape(-1), blocksize=bs,
                          quant_type=state.quant_type, shape=(flat.numel(), D), dtype=dtype)
    return out.reshape(*ids.shape, D)


def _apply_lookup_opts(out: torch.Tensor, ids: torch.Tensor, padding_idx, max_norm, norm_type) -> torch.Tensor:
    """``padding_idx`` and ``max_norm`` on gathered rows ``out [n, D]``: the
    padding rows come out zero, and each row whose ``norm_type``-norm (in
    f32) exceeds ``max_norm`` is scaled down to it.  ``torch.nn.Embedding``
    renorms the stored rows in place instead; the values looked up are the
    same, and the table here is left as it is."""
    if padding_idx is not None:
        pad = (ids.reshape(-1) == padding_idx)[:, None]
        out = torch.where(pad, torch.zeros((), dtype=out.dtype, device=out.device), out)
    if max_norm is not None:
        norms = torch.linalg.vector_norm(out.to(torch.float32), ord=norm_type, dim=-1, keepdim=True)
        out = out * torch.clamp(max_norm / torch.clamp(norms, min=1e-30), max=1.0).to(out.dtype)
    return out


class _LookupOpts(torch.nn.Module):
    """The lookup options and output type the embeddings share."""

    def __init__(self, num_embeddings, embedding_dim, dtype, padding_idx, max_norm, norm_type):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.dtype = dtype
        self.padding_idx = padding_idx
        self.max_norm = max_norm
        self.norm_type = norm_type

    def _opts(self, rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return _apply_lookup_opts(rows, ids, self.padding_idx, self.max_norm, self.norm_type)

    def extra_repr(self) -> str:
        return (f"{self.num_embeddings}, {self.embedding_dim}, dtype={self.dtype}, padding_idx={self.padding_idx}, "
                f"max_norm={self.max_norm}, norm_type={self.norm_type}")


class Embedding4bit(_LookupOpts):
    """An embedding over a frozen 4-bit table ``[num_embeddings,
    embedding_dim]``, drawn from a unit normal with ``generator`` and
    quantized at once (kernel 1 on CUDA): layout "2d" when the rows own
    whole blocks and ``embedding_dim`` is even, else "flat".  A lookup
    dequantizes only the rows it gathers (kernel 10 on CUDA).  Assign a
    :class:`QuantizedTensor` to ``weight`` to load another table."""

    quant_type_default = "nf4"

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        quant_type: Optional[str] = None,
        blocksize: int = 64,
        dtype: torch.dtype = torch.float32,
        padding_idx: Optional[int] = None,
        max_norm: Optional[float] = None,
        norm_type: float = 2.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_embeddings, embedding_dim, dtype, padding_idx, max_norm, norm_type)
        device = resolve_device(device)
        W = torch.randn(num_embeddings, embedding_dim, generator=generator, device=device)
        layout = "2d" if embedding_dim % blocksize == 0 and embedding_dim % 2 == 0 else "flat"
        self.weight = QuantizedTensor.quantize(
            W, blocksize=blocksize, quant_type=quant_type or self.quant_type_default, layout=layout)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = _partial_dequant_rows(self.weight, ids, self.dtype)
        return self._opts(out.reshape(-1, self.embedding_dim), ids).reshape(out.shape)


class EmbeddingNF4(Embedding4bit):
    quant_type_default = "nf4"


class EmbeddingFP4(Embedding4bit):
    quant_type_default = "fp4"


class Embedding8bit(_LookupOpts):
    """An embedding over a frozen int8 table with per-row absmax (an
    :class:`Int8TensorState`), drawn from a unit normal with ``generator``:
    a lookup gathers ``CB`` and ``SCB`` rows and computes ``rows * (SCB /
    127)``."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        dtype: torch.dtype = torch.float32,
        padding_idx: Optional[int] = None,
        max_norm: Optional[float] = None,
        norm_type: float = 2.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_embeddings, embedding_dim, dtype, padding_idx, max_norm, norm_type)
        device = resolve_device(device)
        self.weight = Int8TensorState.quantize(
            torch.randn(num_embeddings, embedding_dim, generator=generator, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1)
        rows = self.weight.CB[flat].to(torch.float32)
        out = self._opts(rows * (self.weight.SCB[flat][:, None] / 127.0), ids)
        return out.reshape(*ids.shape, self.embedding_dim).to(self.dtype)


def _xavier_uniform(n: int, m: int, generator, device) -> torch.Tensor:
    bound = math.sqrt(6.0 / (n + m))
    return torch.rand(n, m, generator=generator, device=device) * (2 * bound) - bound


class Embedding(_LookupOpts):
    """A float32 embedding table ``weight``, xavier-uniform from
    ``generator``, whose optimizer states stay 32-bit: its parameter path
    (``...embedding.weight`` when the module is held as ``embedding``)
    matches :data:`optim.STABLE_EMBEDDING_RULE`."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        padding_idx: Optional[int] = None,
        max_norm: Optional[float] = None,
        norm_type: float = 2.0,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_embeddings, embedding_dim, dtype, padding_idx, max_norm, norm_type)
        device = resolve_device(device)
        self.weight = torch.nn.Parameter(_xavier_uniform(num_embeddings, embedding_dim, generator, device))

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self._opts(self.weight[ids.reshape(-1)], ids)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._lookup(ids).reshape(*ids.shape, self.embedding_dim).to(self.dtype)


class StableEmbedding(Embedding):
    """:class:`Embedding` followed by a LayerNorm in float32 (``norm``, eps
    1e-6 as the JAX package's LayerNorm takes it; ``torch.nn.LayerNorm``'s
    default is 1e-5), after the lookup options."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        padding_idx: Optional[int] = None,
        max_norm: Optional[float] = None,
        norm_type: float = 2.0,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(num_embeddings, embedding_dim, padding_idx, max_norm, norm_type, dtype, device, generator)
        self.norm = torch.nn.LayerNorm(embedding_dim, eps=1e-6, device=self.weight.device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = self.norm(self._lookup(ids).to(torch.float32))
        return out.reshape(*ids.shape, self.embedding_dim).to(self.dtype)


class OutlierAwareLinear(torch.nn.Module):
    """A linear layer ``[out_features, in_features]`` whose weight is int8
    except for ``outlier_topk`` input columns, kept in float32.

    The columns are chosen once, when the layer is built, as the largest
    column norms of the weight (``utils.outliers.find_outlier_dims``); they
    are zeroed in the int8 part.  ``weight`` (float ``[out_features,
    in_features]``) gives the weight; otherwise it is drawn as the JAX
    package draws it (lecun-normal, truncated at two deviations, over its
    fan-in ``out_features``) from ``generator``.  The forward is LLM.int8()'s
    product (:func:`autograd.matmul`) plus ``x[..., outlier_idx] @
    outlier_w^T`` in ``compute_dtype``, plus the bias."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        outlier_topk: int = 16,
        compute_dtype: torch.dtype = torch.bfloat16,
        bias: bool = True,
        device=None,
        generator: Optional[torch.Generator] = None,
        weight: Optional[torch.Tensor] = None,
    ):
        from ..utils.outliers import find_outlier_dims

        super().__init__()
        device = resolve_device(device)
        if weight is not None:
            if tuple(weight.shape) != (out_features, in_features):
                raise ValueError(f"weight must be [{out_features}, {in_features}], got {list(weight.shape)}")
            W = weight.detach().to(device=device, dtype=torch.float32, copy=True)
        else:
            std = math.sqrt(1.0 / out_features) / 0.87962566103423978
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # the normal CDF at -2
            u = torch.rand(out_features, in_features, generator=generator, device=device) * (1.0 - 2 * lo) + lo
            W = torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)
        idx = find_outlier_dims(W, reduction_dim=0, topk=outlier_topk)
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.outlier_idx = idx
        self.outlier_w = W[:, idx].contiguous()
        W[:, idx] = 0.0
        self.weight = Int8TensorState.quantize(W)
        self.bias = (
            torch.nn.Parameter(torch.zeros(out_features, dtype=compute_dtype, device=device)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        out = autograd.matmul(x, None, autograd.MatmulLtState(CB=self.weight.CB, SCB=self.weight.SCB))
        out = out + torch.matmul(x[..., self.outlier_idx], self.outlier_w.t().to(self.compute_dtype))
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"outlier_topk={self.outlier_idx.numel()}")
