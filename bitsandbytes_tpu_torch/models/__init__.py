"""Models served and fine-tuned on the quantized path: the Llama family
(``llama``), the GPT-2/OPT family (``gpt2``) and the MoE FFN on 4-bit
experts (``moe``)."""

from . import gpt2, moe
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
    "moe",
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
