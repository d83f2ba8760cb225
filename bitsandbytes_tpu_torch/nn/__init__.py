"""``torch.nn`` modules over quantized weights (linears and embeddings),
and the quantization of parameter trees (``parametrize``)."""

from .modules import (
    Embedding,
    Embedding4bit,
    Embedding8bit,
    EmbeddingFP4,
    EmbeddingNF4,
    Int8TensorState,
    Linear4bit,
    Linear8bitLt,
    LinearFP4,
    LinearNF4,
    OutlierAwareLinear,
    QuantizedTensor,
    StableEmbedding,
)
from .parametrize import dequantize_tree, mask_quantized, quantize_tree

# the reference's tensor-subclass names, as the JAX package publishes them
Params4bit = QuantizedTensor
Int8Params = Int8TensorState

__all__ = [
    "Embedding",
    "Embedding4bit",
    "Embedding8bit",
    "EmbeddingFP4",
    "EmbeddingNF4",
    "Int8Params",
    "Int8TensorState",
    "Linear4bit",
    "Linear8bitLt",
    "LinearFP4",
    "LinearNF4",
    "OutlierAwareLinear",
    "Params4bit",
    "QuantizedTensor",
    "StableEmbedding",
    "dequantize_tree",
    "mask_quantized",
    "quantize_tree",
]
