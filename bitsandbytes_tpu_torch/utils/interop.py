"""Carry a parameter tree from the JAX package into this port.

The tree comes as nested dicts and lists of numpy arrays (the caller
flattens the JAX arrays to numpy; this package never imports JAX).  A
quantized weight comes as a dict with the keys ``data``, ``absmax``,
``shape``, ``blocksize``, ``quant_type``, ``layout`` and ``code`` (and
optionally ``dtype``), and becomes a :class:`QuantizedTensor`.  A
double-quantized one adds ``offset``, ``nested_absmax``, ``nested_blocksize``
and ``nested_code``, and its ``absmax`` holds the uint8 codes, which stay
uint8.  A key outside these raises rather than be dropped.  Float and
already-quantized trees are both accepted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..functional.codebooks import is_dynamic_map
from ..functional.quant_state import QuantState
from ..nn.modules import QuantizedTensor
from ..ops.dispatch import resolve_device

__all__ = ["params_from_numpy", "tensor_from_numpy", "QUANTIZED_KEYS", "NESTED_KEYS"]

QUANTIZED_KEYS = frozenset({"data", "absmax", "shape", "blocksize", "quant_type", "layout", "code"})
NESTED_KEYS = frozenset({"offset", "nested_absmax", "nested_blocksize", "nested_code"})
_OPTIONAL_KEYS = frozenset({"dtype"})

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
    unknown = set(d) - QUANTIZED_KEYS - NESTED_KEYS - _OPTIONAL_KEYS
    if unknown:
        raise ValueError(f"unknown keys in a quantized weight: {sorted(unknown)}")
    nested = NESTED_KEYS & set(d)
    if nested and nested != NESTED_KEYS:
        raise ValueError(f"a nested state needs all of {sorted(NESTED_KEYS)}, got {sorted(nested)}")
    absmax = tensor_from_numpy(d["absmax"], device).contiguous()
    offset = state2 = None
    if nested:
        if absmax.dtype != torch.uint8:
            raise ValueError("a nested state's absmax holds uint8 codes")
        nested_code = np.asarray(d["nested_code"], dtype=np.float32)
        offset = tensor_from_numpy(np.asarray(d["offset"], dtype=np.float32).reshape(()), device)
        state2 = QuantState(
            absmax=tensor_from_numpy(d["nested_absmax"], device).to(torch.float32).contiguous(),
            code=tensor_from_numpy(nested_code, device),
            blocksize=int(d["nested_blocksize"]),
            quant_type="8bit",
            dtype=torch.float32,
            shape=(absmax.numel(),),
            dynamic_code=is_dynamic_map(nested_code),  # decided once, on the host
        )
    else:
        absmax = absmax.to(torch.float32)
    state = QuantState(
        absmax=absmax,
        code=tensor_from_numpy(d["code"], device).to(torch.float32),
        blocksize=int(d["blocksize"]),
        quant_type=str(d["quant_type"]),
        dtype=_DTYPES[str(d.get("dtype", "float32"))],
        shape=tuple(int(s) for s in d["shape"]),
        offset=offset,
        state2=state2,
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
