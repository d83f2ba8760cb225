"""Quantize and dequantize the leaves of a parameter tree.

Counterpart of the JAX package's ``nn/parametrize.py`` (the reference's
``nn/parametrize.py``, which stores module parameters such as MoE expert
weights in 4-bit and dequantizes them on access).  Here a parameter tree is
nested dicts and lists of tensors, as ``models/llama.py`` builds it: selected
float leaves become :class:`QuantizedTensor`, and are dequantized where
they are used.  A leaf's path is the tuple of dict keys and list indices that
leads to it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .modules import QuantizedTensor

__all__ = ["quantize_tree", "dequantize_tree", "mask_quantized", "map_tree"]


def map_tree(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over every leaf of nested dicts, lists and tuples;
    a :class:`QuantizedTensor` is a leaf, and ``None`` is kept as it is."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _is_quantizable(x, min_size: int) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 2 and x.numel() >= min_size


def quantize_tree(
    params,
    predicate: Optional[Callable[[tuple, torch.Tensor], bool]] = None,
    blocksize: int = 64,
    quant_type: str = "nf4",
    compress_statistics: bool = False,
    min_size: int = 4096,
):
    """Replace float tensor leaves with 4-bit :class:`QuantizedTensor`s, on
    each leaf's own device (``layout="auto"``).  ``predicate(path, leaf)``
    selects the leaves; by default every float tensor with two or more
    dimensions and at least ``min_size`` elements."""

    def maybe_quantize(path, leaf):
        if isinstance(leaf, QuantizedTensor):
            return leaf
        selected = predicate(path, leaf) if predicate is not None else _is_quantizable(leaf, min_size)
        if not selected:
            return leaf
        return QuantizedTensor.quantize(
            leaf, blocksize=blocksize, quant_type=quant_type, compress_statistics=compress_statistics
        )

    return map_tree(maybe_quantize, params)


def dequantize_tree(params):
    """Every :class:`QuantizedTensor` leaf dequantized to a dense tensor in
    its state's dtype (kernel 10 on CUDA, a paired payload repacked first)."""
    return map_tree(lambda _, x: x.dequantize() if isinstance(x, QuantizedTensor) else x, params)


def mask_quantized(params, trainable: bool = False):
    """A tree of bools: ``trainable`` at quantized leaves, the opposite
    elsewhere; picks the tensors an optimizer should leave alone."""
    return map_tree(lambda _, x: trainable if isinstance(x, QuantizedTensor) else not trainable, params)
