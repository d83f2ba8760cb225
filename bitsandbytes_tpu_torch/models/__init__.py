"""Models served and fine-tuned on the quantized path."""

from .llama import (
    Int8KVCache,
    KVCache,
    LlamaConfig,
    PagedKVCache,
    add_lora,
    decode_step,
    forward,
    init_kv_cache,
    init_paged_kv_cache,
    init_params,
    lm_loss,
    lora_parameters,
    lora_train_step,
    prefill,
    quantize_params_4bit,
)

__all__ = [
    "Int8KVCache",
    "KVCache",
    "LlamaConfig",
    "PagedKVCache",
    "add_lora",
    "decode_step",
    "forward",
    "init_kv_cache",
    "init_paged_kv_cache",
    "init_params",
    "lm_loss",
    "lora_parameters",
    "lora_train_step",
    "prefill",
    "quantize_params_4bit",
]
