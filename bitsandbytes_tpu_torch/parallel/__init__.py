"""Distribution layer: quantized trees and KV caches placed over a mesh of
``torch.distributed`` ranks, and collectives over packed 4-bit payloads.

Counterpart of the JAX package's ``parallel`` package for serving: where
the JAX package lets GSPMD place its arrays, the port places them
explicitly (``sharding.py``), gathers packed payloads rather than
dequantized ones (``collectives.py``), and runs its linears, embedding and
attention over the mesh's process groups (``models/llama.forward(mesh=)``,
``ops/flash_cached.flash_attention_*_tp``).  Ring attention and the GPipe
pipeline are not ported yet.
"""

from .collectives import all_gather_packed, tp_gemm_4bit_allgather, tp_gemm_4bit_ring
from .mesh import Mesh, make_mesh
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
]
