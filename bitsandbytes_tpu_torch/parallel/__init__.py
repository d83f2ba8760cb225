"""Distribution layer: quantized trees and KV caches placed over a mesh of
``torch.distributed`` ranks, collectives over packed 4-bit payloads, and
training over the mesh.

Counterpart of the JAX package's ``parallel`` package: where the JAX
package lets GSPMD place its arrays and transpose its collectives, the port
places them explicitly (``sharding.py``), gathers packed payloads rather
than dequantized ones (``collectives.py``), runs its linears, embedding and
attention over the mesh's process groups (``models/llama.forward(mesh=)``,
``ops/flash_cached.flash_attention_*_tp``), and writes out the adjoint of
every collective a training path runs (``collectives.py``): the split
linears, ring attention over a sequence axis (``ring_attention.py``) and
the GPipe schedule over a pipe axis (``pipeline.py``), under
``models/llama.lm_loss(mesh=)`` and ``lora_train_step(mesh=)``.
"""

from .collectives import all_gather_packed, ppermute, tp_gemm_4bit_allgather, tp_gemm_4bit_ring
from .mesh import Mesh, make_mesh
from .pipeline import gpipe, stack_stage_params
from .ring_attention import ring_attention, ring_attention_local
from .sharding import (
    Sharded,
    kv_cache_specs,
    leaf_sharding,
    llama_param_specs,
    llama_tp_rules,
    shard_kv_cache,
    shard_quantized_tree,
)

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "leaf_sharding",
    "shard_quantized_tree",
    "llama_param_specs",
    "llama_tp_rules",
    "kv_cache_specs",
    "shard_kv_cache",
    "all_gather_packed",
    "tp_gemm_4bit_allgather",
    "tp_gemm_4bit_ring",
    "ppermute",
    "gpipe",
    "stack_stage_params",
    "ring_attention",
    "ring_attention_local",
]
