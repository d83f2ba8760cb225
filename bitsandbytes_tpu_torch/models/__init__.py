"""Models served and fine-tuned on the quantized path: the Llama family
(``llama``) and the GPT-2/OPT family (``gpt2``)."""

from . import gpt2
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
    "gpt2",
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
