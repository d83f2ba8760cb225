"""``torch.nn`` modules over quantized weights."""

from .modules import Linear4bit, LinearFP4, LinearNF4, QuantizedTensor

__all__ = ["Linear4bit", "LinearFP4", "LinearNF4", "QuantizedTensor"]
