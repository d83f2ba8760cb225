"""Carry a parameter tree from the JAX package into this port.

The tree comes as nested dicts and lists of numpy arrays (the caller
flattens the JAX arrays to numpy; this package never imports JAX).  A
quantized weight comes as a dict with the keys ``data``, ``absmax``,
``shape``, ``blocksize``, ``quant_type``, ``layout`` and ``code`` (and
optionally ``dtype``), and becomes a :class:`QuantizedTensor`.  A
double-quantized one adds ``offset``, ``nested_absmax``, ``nested_blocksize``
and ``nested_code``, and its ``absmax`` holds the uint8 codes, which stay
uint8.  A key outside these raises rather than be dropped.  An LLM.int8()
weight comes as a dict of exactly ``CB`` (int8) and ``SCB`` (float32) and
becomes an :class:`Int8TensorState`.  Float and already-quantized trees are
both accepted.

:func:`lora_from_numpy` carries a LoRA adapter tree (``{"layers": [{target:
{"a", "b", "scale"}}]}``) and :func:`optim_state_from_numpy` an optimizer
state (``{"step", "leaves"}``, the leaves shaped like the adapter tree, each
a dict of ``state1``/``state2``/``absmax1``/``absmax2``) into the port, so
that both packages take the same next step from the same state (AdEMAMix's
leaves hold its two momenta as ``state1 [2, ...]`` and ``absmax1 [2, nb]``,
which load as they are).  Payloads of a wider ``quant_storage`` (uint16,
uint32, int8) load as tensors of that type.

:func:`kv_cache_from_numpy` carries a KV cache (dense bf16, dense int8 with
its scales, or a paged pool with its tables) across, so that both packages
decode from the same cache.

:func:`module_from_numpy` loads a JAX-package module's params, as numpy
(with or without the outer ``"params"``), into the port's module of the
same kind, under the port's names: an embedding's ``embedding`` table is
its ``weight``, StableEmbedding's ``LayerNorm_0`` ``scale``/``bias`` its
``norm.weight``/``norm.bias``, and OutlierAwareLinear's ``kernel`` (``q``,
``outlier_idx``, ``outlier_w``) its ``weight``, ``outlier_idx`` and
``outlier_w``.  A GPT-2/OPT tree is a plain tree: :func:`params_from_numpy`.

:func:`moe_params_from_numpy` carries a MoE layer's stacked tree and its
``meta`` (``models/moe.py``), recording each weight's layout from its
payload's shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..functional.codebooks import is_dynamic_map
from ..functional.quant_state import QuantState, dtype_from_name
from ..nn import modules as M
from ..nn.modules import Int8TensorState, QuantizedTensor
from ..ops.dispatch import resolve_device

__all__ = [
    "params_from_numpy",
    "tensor_from_numpy",
    "as_device_tensor",
    "lora_from_numpy",
    "optim_state_from_numpy",
    "kv_cache_from_numpy",
    "module_from_numpy",
    "moe_params_from_numpy",
    "QUANTIZED_KEYS",
    "NESTED_KEYS",
    "INT8_KEYS",
    "LORA_KEYS",
    "STATE_KEYS",
]

QUANTIZED_KEYS = frozenset({"data", "absmax", "shape", "blocksize", "quant_type", "layout", "code"})
NESTED_KEYS = frozenset({"offset", "nested_absmax", "nested_blocksize", "nested_code"})
_OPTIONAL_KEYS = frozenset({"dtype"})
INT8_KEYS = frozenset({"CB", "SCB"})
LORA_KEYS = frozenset({"a", "b", "scale"})
LORA_TARGETS = frozenset({"wq", "wk", "wv", "wo", "gate", "up", "down"})
STATE_KEYS = frozenset({"state1", "state2", "absmax1", "absmax2"})

def tensor_from_numpy(arr, device) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> tensor on ``device``,
    of the same shape (a 0-d array stays 0-d; ``np.ascontiguousarray`` would
    make it 1-d)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.reshape(arr.shape).to(device)


def as_device_tensor(a, device) -> torch.Tensor:
    """A tensor or a numpy array as a contiguous tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device).contiguous()
    return tensor_from_numpy(a, device).contiguous()


def _quantized(d: dict, device) -> QuantizedTensor:
    _check_keys(d, QUANTIZED_KEYS | NESTED_KEYS | _OPTIONAL_KEYS, "a quantized weight")
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
        dtype=dtype_from_name(d.get("dtype", "float32")),
        shape=tuple(int(s) for s in d["shape"]),
        offset=offset,
        state2=state2,
        layout=str(d["layout"]),
    )
    return QuantizedTensor(data=tensor_from_numpy(d["data"], device).contiguous(), state=state)


def _int8(d: dict, device) -> Int8TensorState:
    _check_keys(d, INT8_KEYS, "an int8 weight")
    if set(d) != INT8_KEYS:
        raise ValueError(f"an int8 weight needs all of {sorted(INT8_KEYS)}, got {sorted(d)}")
    CB = tensor_from_numpy(d["CB"], device).contiguous()
    if CB.dtype != torch.int8:
        raise ValueError(f"an int8 weight's CB holds int8 codes, got {CB.dtype}")
    SCB = tensor_from_numpy(np.asarray(d["SCB"], dtype=np.float32), device).contiguous()
    return Int8TensorState(CB=CB, SCB=SCB)


def params_from_numpy(tree, device=None):
    """Turn a JAX-package parameter tree, given as nested dicts/lists of numpy
    arrays, into this port's tree on ``device`` (CUDA unless named)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if QUANTIZED_KEYS <= set(node):
                return _quantized(node, device)
            if INT8_KEYS & set(node):
                return _int8(node, device)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if node is None:
            return None
        return tensor_from_numpy(node, device)

    return walk(tree)


def _check_keys(found, allowed, what: str) -> None:
    unknown = set(found) - set(allowed)
    if unknown:
        raise ValueError(f"unknown keys in {what}: {sorted(unknown)}")


def lora_from_numpy(tree, device=None, requires_grad: bool = True) -> dict:
    """A JAX-package adapter tree, as numpy, -> the port's (float32 tensors
    on ``device``, CUDA unless named, trainable unless ``requires_grad`` is
    False)."""
    device = resolve_device(device)
    _check_keys(tree, {"layers"}, "an adapter tree")
    layers = []
    for layer in tree["layers"]:
        _check_keys(layer, LORA_TARGETS, "an adapter layer")
        out = {}
        for name, ad in layer.items():
            _check_keys(ad, LORA_KEYS, f"adapter {name!r}")
            if set(ad) != LORA_KEYS:
                raise ValueError(f"adapter {name!r} needs all of {sorted(LORA_KEYS)}")
            out[name] = {
                k: tensor_from_numpy(np.asarray(ad[k], dtype=np.float32), device).requires_grad_(requires_grad)
                for k in ("a", "b", "scale")
            }
        layers.append(out)
    return {"layers": layers}


def optim_state_from_numpy(optimizer: torch.optim.Optimizer, lora: dict, state) -> None:
    """Load a JAX-package optimizer state, as numpy ``{"step", "leaves"}``,
    into ``optimizer`` for the tensors of ``lora`` (the same tree, built
    with :func:`lora_from_numpy`); each tensor's state takes the global
    step and its leaf's arrays, uint8 codes staying uint8."""
    _check_keys(state, {"step", "leaves"}, "an optimizer state")
    step = int(np.asarray(state["step"]))
    leaves = state["leaves"]
    _check_keys(leaves, {"layers"}, "the optimizer state's leaves")
    if len(leaves["layers"]) != len(lora["layers"]):
        raise ValueError("the optimizer state and the adapters have different numbers of layers")
    for layer_t, layer_s in zip(lora["layers"], leaves["layers"]):
        if set(layer_s) != set(layer_t):
            raise ValueError(f"targets differ: {sorted(layer_s)} against {sorted(layer_t)}")
        for name, ad in layer_t.items():
            _check_keys(layer_s[name], LORA_KEYS, f"the state of adapter {name!r}")
            for k, p in ad.items():
                leaf = layer_s[name][k]
                _check_keys(leaf, STATE_KEYS, f"the state of {name}.{k}")
                st = optimizer.state[p]
                st.clear()
                st["step"] = step
                for key, arr in leaf.items():
                    st[key] = tensor_from_numpy(arr, p.device).contiguous()


_KV_KEYS = ("k", "v", "k_scale", "v_scale", "tables")


def kv_cache_from_numpy(cache, device=None):
    """A JAX-package KV cache as a dict of numpy arrays -> the port's, on
    ``device`` (CUDA unless named): ``k``/``v`` alone make a ``KVCache``,
    with ``k_scale``/``v_scale`` an ``Int8KVCache``, and with ``tables`` a
    ``PagedKVCache`` (bf16 pools without scales)."""
    from ..models import llama

    device = resolve_device(device)
    _check_keys(cache, _KV_KEYS, "a KV cache")
    t = {k: None if cache.get(k) is None else tensor_from_numpy(cache[k], device).contiguous() for k in _KV_KEYS}
    if (t["k_scale"] is None) != (t["v_scale"] is None):
        raise ValueError("a KV cache takes both scales or neither")
    if t["tables"] is not None:
        return llama.PagedKVCache(t["k"], t["v"], t["k_scale"], t["v_scale"], t["tables"].to(torch.int32))
    if t["k_scale"] is not None:
        return llama.Int8KVCache(t["k"], t["v"], t["k_scale"], t["v_scale"])
    return llama.KVCache(t["k"], t["v"])


def _expect(tree: dict, keys, what: str) -> None:
    if set(tree) != set(keys):
        raise ValueError(f"{what} takes the params {sorted(keys)}, got {sorted(tree)}")


def module_from_numpy(module: torch.nn.Module, tree: dict, device=None) -> torch.nn.Module:
    """Load a JAX-package module's params (numpy) into ``module``, a port
    module of the same kind, on ``device`` (CUDA unless named); returns the
    module.  The shapes must be the module's."""
    device = resolve_device(device)
    if set(tree) == {"params"}:
        tree = tree["params"]
    t = params_from_numpy(tree, device)
    if isinstance(module, M.OutlierAwareLinear):
        _expect(t, {"kernel", "bias"} if module.bias is not None else {"kernel"}, "OutlierAwareLinear")
        _expect(t["kernel"], {"q", "outlier_idx", "outlier_w"}, "OutlierAwareLinear's kernel")
        q, idx, w = t["kernel"]["q"], t["kernel"]["outlier_idx"], t["kernel"]["outlier_w"]
        if not isinstance(q, Int8TensorState) or tuple(q.shape) != (module.out_features, module.in_features):
            raise ValueError("OutlierAwareLinear's q must be an int8 weight of the module's shape")
        module.weight, module.outlier_idx, module.outlier_w = q, idx.to(torch.int64), w.to(torch.float32)
        if module.bias is not None:
            module.bias = torch.nn.Parameter(t["bias"].to(module.compute_dtype))
        return module
    if not isinstance(module, M._LookupOpts):
        raise TypeError(f"no JAX-package params map onto {type(module).__name__}")
    want = (module.num_embeddings, module.embedding_dim)
    if isinstance(module, M.StableEmbedding):
        _expect(t, {"embedding", "LayerNorm_0"}, "StableEmbedding")
        _expect(t["LayerNorm_0"], {"scale", "bias"}, "StableEmbedding's LayerNorm_0")
        module.norm.weight = torch.nn.Parameter(t["LayerNorm_0"]["scale"].to(torch.float32))
        module.norm.bias = torch.nn.Parameter(t["LayerNorm_0"]["bias"].to(torch.float32))
    else:
        _expect(t, {"embedding"}, type(module).__name__)
    table = t["embedding"]
    kind = {M.Embedding4bit: QuantizedTensor, M.Embedding8bit: Int8TensorState, M.Embedding: torch.Tensor}
    cls = next(v for k, v in kind.items() if isinstance(module, k))
    if not isinstance(table, cls) or tuple(table.shape) != want:
        raise ValueError(f"{type(module).__name__}'s table must be a {cls.__name__} of shape {want}")
    module.weight = torch.nn.Parameter(table.to(torch.float32)) if cls is torch.Tensor else table
    return module


_MOE_KEYS = ("router", "gate_up_data", "gate_up_absmax", "down_data", "down_absmax")


def moe_params_from_numpy(params: dict, meta: dict, device=None):
    """A JAX-package MoE tree (``router``, ``gate_up_data``, ``gate_up_absmax``,
    ``down_data``, ``down_absmax`` as numpy) and its ``meta`` (``{name:
    (quant_type, blocksize, shape)}``) -> the port's ``(params, meta)`` on
    ``device`` (CUDA unless named).  The port's meta adds each weight's
    layout, read off its stacked payload ``[E, ...]``: ``[N/2, K]`` paired,
    ``[N, K/2]`` 2d, anything else flat."""
    device = resolve_device(device)
    _expect(params, _MOE_KEYS, "a MoE layer")
    out = {k: tensor_from_numpy(params[k], device).contiguous() for k in _MOE_KEYS}
    out["router"] = out["router"].to(torch.float32)
    tmeta = {}
    for name in ("gate_up", "down"):
        quant_type, blocksize, shape = meta[name][:3]
        N, K = (int(d) for d in shape)
        per = tuple(out[name + "_data"].shape[1:])
        layout = "paired" if per == (N // 2, K) else "2d" if per == (N, K // 2) else "flat"
        tmeta[name] = (str(quant_type), int(blocksize), (N, K), layout)
        out[name + "_absmax"] = out[name + "_absmax"].to(torch.float32)
    return out, tmeta
