"""``torch.nn`` modules over quantized weights, and the quantization of
parameter trees (``parametrize``)."""

from .modules import Int8TensorState, Linear4bit, Linear8bitLt, LinearFP4, LinearNF4, QuantizedTensor
from .parametrize import dequantize_tree, mask_quantized, quantize_tree

# the reference's tensor-subclass names, as the JAX package publishes them
Params4bit = QuantizedTensor
Int8Params = Int8TensorState

__all__ = [
    "Int8Params",
    "Int8TensorState",
    "Linear4bit",
    "Linear8bitLt",
    "LinearFP4",
    "LinearNF4",
    "Params4bit",
    "QuantizedTensor",
    "dequantize_tree",
    "mask_quantized",
    "quantize_tree",
]
