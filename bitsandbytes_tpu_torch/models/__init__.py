"""Models served on the quantized path."""

from .llama import (
    KVCache,
    LlamaConfig,
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    prefill,
    quantize_params_4bit,
)

__all__ = [
    "KVCache",
    "LlamaConfig",
    "decode_step",
    "forward",
    "init_kv_cache",
    "init_params",
    "prefill",
    "quantize_params_4bit",
]
