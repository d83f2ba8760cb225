"""Functional API: codebooks and the functions that make them, QuantState,
4-bit and blockwise 8-bit quantize/dequantize, GEMM, LLM.int8()'s int8 ops
and the optimizer updates."""

from .blockwise import (
    blockwise_absmax,
    dequantize_blockwise,
    dequantize_blockwise_with_code,
    quantize_blockwise,
    quantize_blockwise_with_code,
)
from .codebooks import (
    CODE_DTYPE,
    create_dynamic_map,
    create_fp8_map,
    create_linear_map,
    create_normal_map,
    get_4bit_code,
)
from .fourbit import (
    dequantize_4bit,
    dequantize_fp4,
    dequantize_nf4,
    pack_4bit,
    quantize_4bit,
    quantize_fp4,
    quantize_nf4,
    unpack_4bit,
)
from .gemm import gemm_4bit, gemv_4bit
from .int8 import (
    int8_double_quant,
    int8_linear_matmul,
    int8_mixed_scaled_mm,
    int8_mm_dequant,
    int8_scaled_mm,
    int8_vectorwise_dequant,
    int8_vectorwise_quant,
)
from .optim_update import optimizer_update_8bit_blockwise, optimizer_update_32bit
from .quant_state import QuantState

# the reference's name for the codebook lookup
get_4bit_type = get_4bit_code

__all__ = [
    "CODE_DTYPE",
    "QuantState",
    "blockwise_absmax",
    "create_dynamic_map",
    "create_fp8_map",
    "create_linear_map",
    "create_normal_map",
    "dequantize_4bit",
    "dequantize_blockwise",
    "dequantize_blockwise_with_code",
    "dequantize_fp4",
    "dequantize_nf4",
    "gemm_4bit",
    "gemv_4bit",
    "get_4bit_code",
    "get_4bit_type",
    "int8_double_quant",
    "int8_linear_matmul",
    "int8_mixed_scaled_mm",
    "int8_mm_dequant",
    "int8_scaled_mm",
    "int8_vectorwise_dequant",
    "int8_vectorwise_quant",
    "optimizer_update_32bit",
    "optimizer_update_8bit_blockwise",
    "pack_4bit",
    "quantize_4bit",
    "quantize_blockwise",
    "quantize_blockwise_with_code",
    "quantize_fp4",
    "quantize_nf4",
    "unpack_4bit",
]
