"""Utilities under the names a bitsandbytes user knows.

Counterpart of the JAX package's ``utils/compat.py`` (the reference's
``bitsandbytes/utils.py``): packing a metadata dict into a uint8 tensor and
back, quantizing the linear weights of a parameter tree, and the weight
outlier tracer.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from .outliers import find_outlier_dims

__all__ = [
    "OutlierTracer",
    "pack_dict_to_tensor",
    "unpack_tensor_to_dict",
    "replace_linear",
]


def pack_dict_to_tensor(source_dict: dict) -> torch.Tensor:
    """``json.dumps(source_dict)`` as a uint8 tensor on the CPU, the way
    quant-state metadata rides in tensor-only containers."""
    return torch.frombuffer(bytearray(json.dumps(source_dict).encode("utf-8")), dtype=torch.uint8)


def unpack_tensor_to_dict(tensor_data) -> dict:
    """Inverse of :func:`pack_dict_to_tensor`; takes a tensor on any device
    or a numpy array."""
    if isinstance(tensor_data, torch.Tensor):
        tensor_data = tensor_data.detach().cpu().numpy()
    return json.loads(np.asarray(tensor_data, np.uint8).tobytes().decode("utf-8"))


def replace_linear(
    params,
    quant_type: str = "nf4",
    blocksize: int = 64,
    skip: Optional[list] = None,
    compress_statistics: bool = False,
):
    """Quantize the linear weights of a parameter tree to 4-bit (the
    reference's ``replace_linear(model, Linear4bit, ...)``, over a tree of
    tensors instead of modules): every float leaf with two or more
    dimensions and at least 4096 elements whose path, joined with ``/``,
    contains none of the substrings in ``skip`` (default ``["lm_head"]``,
    the reference's ``modules_to_not_convert``)."""
    from ..nn.parametrize import quantize_tree

    skip = ["lm_head"] if skip is None else skip

    def predicate(path, leaf):
        name = "/".join(str(p) for p in path)
        if any(s in name for s in skip):
            return False
        return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 and leaf.numel() >= 4096 and leaf.is_floating_point()

    return quantize_tree(
        params, predicate=predicate, blocksize=blocksize, quant_type=quant_type,
        compress_statistics=compress_statistics,
    )


class OutlierTracer:
    """A weight's outlier features, memoized by the weight's identity (the
    reference's forward-hook tracer; with plain functions there is no hook,
    so call :meth:`get_outliers` on the weight)."""

    _instance = None

    def __init__(self):
        self._cache: dict = {}

    @classmethod
    def get_instance(cls) -> "OutlierTracer":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def initialize(self, *_args, **_kwargs) -> None:  # the hook API's, nothing to do
        return None

    def is_initialized(self) -> bool:
        return True

    def get_hvalue(self, weight) -> int:
        return id(weight)

    def get_outliers(self, weight, reduction_dim: int = 0, zscore: float = 4.0) -> torch.Tensor:
        """A boolean mask over the features (:func:`find_outlier_dims`);
        ``mask.nonzero()`` gives the indices."""
        h = self.get_hvalue(weight)
        if h not in self._cache:
            self._cache[h] = find_outlier_dims(weight, reduction_dim=reduction_dim, zscore=zscore)
        return self._cache[h]
