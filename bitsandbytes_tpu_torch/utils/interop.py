"""Carry a parameter tree from the JAX package into this port.

The tree comes as nested dicts and lists of numpy arrays (the caller
flattens the JAX arrays to numpy; this package never imports JAX).  A
quantized weight comes as a dict with the keys ``data``, ``absmax``,
``shape``, ``blocksize``, ``quant_type``, ``layout`` and ``code`` (and
optionally ``dtype``), and becomes a :class:`QuantizedTensor`.  Float and
already-quantized trees are both accepted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..functional.quant_state import QuantState
from ..nn.modules import QuantizedTensor
from ..ops.dispatch import resolve_device

__all__ = ["params_from_numpy", "tensor_from_numpy", "QUANTIZED_KEYS"]

QUANTIZED_KEYS = frozenset({"data", "absmax", "shape", "blocksize", "quant_type", "layout", "code"})

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def _quantized(d: dict, device) -> QuantizedTensor:
    absmax = tensor_from_numpy(d["absmax"], device).to(torch.float32).contiguous()
    state = QuantState(
        absmax=absmax,
        code=tensor_from_numpy(d["code"], device).to(torch.float32),
        blocksize=int(d["blocksize"]),
        quant_type=str(d["quant_type"]),
        dtype=_DTYPES[str(d.get("dtype", "float32"))],
        shape=tuple(int(s) for s in d["shape"]),
        layout=str(d["layout"]),
    )
    return QuantizedTensor(data=tensor_from_numpy(d["data"], device).contiguous(), state=state)


def params_from_numpy(tree, device=None):
    """Turn a JAX-package parameter tree, given as nested dicts/lists of numpy
    arrays, into this port's tree on ``device`` (CUDA unless named)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if QUANTIZED_KEYS <= set(node):
                return _quantized(node, device)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if node is None:
            return None
        return tensor_from_numpy(node, device)

    return walk(tree)
