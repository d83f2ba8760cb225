"""Checkpoints of (quantized) parameter trees, and HF Llama import.

Counterpart of the JAX package's ``utils/serialization.py``.  A tree is
flattened to a state dict under the reference's serialized-quant-state
names, so that checkpoints interoperate with the JAX package, with
bitsandbytes and with HF Transformers' pre-quantized bnb checkpoints:

* a 4-bit weight is ``{key}`` (the packed payload in the flat interop
  order, ``[bytes / width, 1]``) with ``{key}.absmax``, ``{key}.quant_map``,
  ``{key}.nested_absmax``, ``{key}.nested_quant_map`` and the JSON-in-uint8
  metadata ``{key}.quant_state.bitsandbytes__{nf4|fp4}``
  (``QuantState.as_dict(packed=True)``);
* an LLM.int8() weight is ``{key}`` (int8 CB) with ``{key}.SCB``;
* anything else is a tensor under its tree path.

Tree paths join dict keys and list indices with ``.`` (``layers.0.wqkv``),
the names the JAX package gives the same tree.  A state dict holds CPU
tensors; it is written as ``.npz`` (``np.savez``) or ``.safetensors``.

The port reads and writes the safetensors format itself
(:func:`write_safetensors`, :func:`read_safetensors`): an 8-byte
little-endian header length, a JSON header padded with spaces to a multiple
of 8, then the raw bytes.  The ``safetensors`` package's numpy reader cannot
take BF16 without ``ml_dtypes``, and neither is needed to run the port.
"""

from __future__ import annotations

import dataclasses
import json
import re
import struct
from typing import Any, Optional

import numpy as np
import torch

from ..functional.fourbit import payload_bytes
from ..functional.quant_state import QuantState, host_array
from ..nn.modules import Int8TensorState, QuantizedTensor
from ..nn.parametrize import map_tree
from ..ops.dispatch import resolve_device
from .interop import as_device_tensor

__all__ = [
    "state_dict_from_params",
    "params_from_state_dict",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_safetensors",
    "load_checkpoint_safetensors",
    "write_safetensors",
    "read_safetensors",
    "import_hf_llama",
]

def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


def _host(t, widen: bool) -> torch.Tensor:
    t = torch.as_tensor(t).detach().cpu()
    if widen and t.dtype == torch.bfloat16:  # npz has no bf16: widen, losslessly
        t = t.to(torch.float32)
    return t.contiguous()


def state_dict_from_params(params: Any, widen_ml_dtypes: bool = True) -> dict:
    """Flatten a (quantized) parameter tree to ``{name: CPU tensor}``.

    A paired payload is relaid to the flat interop order first.  A payload
    stored wider than uint8 keeps its unsigned type (uint16 for bf16
    ``quant_storage``).  ``widen_ml_dtypes`` widens bf16 leaves to float32,
    losslessly, for containers without bf16 (npz); False keeps them
    (safetensors stores BF16)."""
    out = {}

    def visit(path, leaf):
        key = _path_str(path)
        if isinstance(leaf, QuantizedTensor):
            canon = leaf.to_layout("flat") if leaf.state.layout == "paired" else leaf
            out[key] = _host(canon.data, widen_ml_dtypes).reshape(-1, 1)
            for comp, arr in canon.state.as_dict(packed=True).items():
                out[f"{key}.{comp}"] = torch.from_numpy(arr)
        elif isinstance(leaf, Int8TensorState):
            out[key] = _host(leaf.CB, widen_ml_dtypes)
            out[f"{key}.SCB"] = _host(leaf.SCB, widen_ml_dtypes)
        else:
            out[key] = _host(leaf, widen_ml_dtypes)
        return leaf

    map_tree(visit, params)
    return out


_QS_META = re.compile(r"\.quant_state\.bitsandbytes__(nf4|fp4|int4|af4|8bit)$")
_COMPONENTS = ("absmax", "quant_map", "nested_absmax", "nested_quant_map")


def _fold_components(sd: dict, device) -> dict:
    """Group ``{key}.absmax``-style components into QuantizedTensor and
    Int8TensorState values under their base names, on ``device``.  A 4-bit
    payload whose rows own whole quantization blocks is reshaped to
    ``[N, -1]`` (its state stays ``"flat"``), as the JAX package does."""
    sd = dict(sd)
    out = {}
    quant_bases = {}
    for k in list(sd):
        m = _QS_META.search(k)
        if m:
            quant_bases[k[: m.start()]] = k
    for base, meta_key in quant_bases.items():
        comp = {meta_key[len(base) + 1:]: sd.pop(meta_key)}
        for name in _COMPONENTS:
            k = f"{base}.{name}"
            if k in sd:
                comp[name] = sd.pop(k)
        state = QuantState.from_dict(comp, device=device)
        data = as_device_tensor(sd.pop(base), device)
        shp = state.shape
        if len(shp) == 2 and shp[1] % state.blocksize == 0 and shp[1] % 2 == 0 and data.numel() % shp[0] == 0:
            data = data.reshape(shp[0], -1)
        out[base] = QuantizedTensor(data=data, state=state)
    for k in list(sd):
        if k.endswith(".SCB"):
            base = k[: -len(".SCB")]
            if base in sd:
                out[base] = Int8TensorState(CB=as_device_tensor(sd.pop(base), device),
                                            SCB=as_device_tensor(sd.pop(k), device))
    out.update({k: as_device_tensor(v, device) for k, v in sd.items()})
    return out


def _like_template(val: QuantizedTensor, leaf: QuantizedTensor, key: str) -> QuantizedTensor:
    """``val`` in the template's layout, its payload in the template's
    storage type and shape (the JAX package hands back uint8 bytes for a
    wider storage; the port keeps the template's type)."""
    val = val.to_layout(leaf.state.layout)
    data = val.data
    if data.dtype != leaf.data.dtype or data.shape != leaf.data.shape:
        raw = payload_bytes(data.contiguous()).reshape(-1)
        if raw.numel() != leaf.data.numel() * leaf.data.element_size():
            raise ValueError(f"{key!r}: {raw.numel()} payload bytes do not fit the template's {tuple(leaf.data.shape)} "
                             f"{leaf.data.dtype}")
        data = raw.view(leaf.data.dtype).reshape(leaf.data.shape)
    return QuantizedTensor(data=data, state=val.state)


def params_from_state_dict(sd: dict, template: Optional[Any] = None, device=None) -> Any:
    """Rebuild a parameter tree from a state dict of tensors or numpy arrays,
    on ``device`` (CUDA unless named).

    With ``template`` (a tree of the same structure, such as
    ``init_params`` followed by ``quantize_params_*``), every leaf takes the
    template's form: a quantized leaf its layout (``to_layout``, on the
    device) and payload type, a float leaf its dtype and shape.  A key the
    template has and the checkpoint lacks raises ``KeyError``, a leaf of
    another kind ``TypeError``.  Without a template the result is the flat
    ``{name: tensor | QuantizedTensor | Int8TensorState}`` dict."""
    device = resolve_device(device)
    folded = _fold_components(sd, device)
    if template is None:
        return folded

    def rebuild(path, leaf):
        key = _path_str(path)
        if key not in folded:
            raise KeyError(f"checkpoint missing {key!r}")
        val = folded[key]
        if isinstance(leaf, QuantizedTensor):
            if not isinstance(val, QuantizedTensor):
                raise TypeError(f"{key!r}: expected quantized leaf in checkpoint")
            return _like_template(val, leaf, key)
        if isinstance(leaf, Int8TensorState):
            if not isinstance(val, Int8TensorState):
                raise TypeError(f"{key!r}: expected int8 leaf in checkpoint")
            return val
        if not isinstance(val, torch.Tensor):
            raise TypeError(f"{key!r}: expected a plain tensor in checkpoint")
        leaf = torch.as_tensor(leaf)
        return val.to(dtype=leaf.dtype).reshape(leaf.shape)

    return map_tree(rebuild, template)


def save_checkpoint(path: str, params: Any) -> None:
    """Write a parameter tree to an ``.npz`` file (bf16 widened to f32)."""
    np.savez(path, **{k: host_array(v) for k, v in state_dict_from_params(params).items()})


def load_checkpoint(path: str, template: Optional[Any] = None, device=None) -> Any:
    """Read an ``.npz`` checkpoint (this package's or the JAX package's) onto
    ``device``; see :func:`params_from_state_dict`."""
    with np.load(path, allow_pickle=False) as z:
        sd = {k: z[k] for k in z.files}
    return params_from_state_dict(sd, template, device)


# -- the safetensors format ---------------------------------------------------

# the types the parameter trees hold
_ST_DTYPES = {
    torch.bfloat16: "BF16",
    torch.float16: "F16",
    torch.float32: "F32",
    torch.uint8: "U8",
    torch.int8: "I8",
    torch.uint16: "U16",
    torch.int32: "I32",
    torch.uint32: "U32",
    torch.int64: "I64",
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: dict, metadata: Optional[dict] = None) -> int:
    """Write ``{name: tensor}`` as a ``.safetensors`` file; returns the
    file's size in bytes.  Tensors are stored widest type first, then by
    name; ``metadata`` (str to str) goes under ``__metadata__``."""
    items = []
    for name, t in tensors.items():
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if t.dtype not in _ST_DTYPES:
            raise ValueError(f"{name!r}: safetensors has no type for {t.dtype}")
        items.append((str(name), t))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header = {}
    if metadata is not None:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata maps str to str")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def read_safetensors(path: str):
    """Read a ``.safetensors`` file into ``({name: CPU tensor}, metadata)``;
    each tensor is read once, straight into its own buffer."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        metadata = header.pop("__metadata__", None)
        start = 8 + n
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            dtype = _ST_NAMES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{name!r}: unsupported safetensors dtype {info['dtype']!r}")
            b, e = info["data_offsets"]
            shape = [int(s) for s in info["shape"]]
            if e - b != int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size():
                raise ValueError(f"{name!r}: {e - b} bytes do not hold {shape} {info['dtype']}")
            buf = torch.empty(e - b, dtype=torch.uint8)
            if e > b:
                f.seek(start + b)
                if f.readinto(memoryview(buf.numpy())) != e - b:
                    raise ValueError(f"{name!r}: the file ends inside the tensor")
            out[name] = buf.view(dtype).reshape(shape)
    return out, metadata


def save_checkpoint_safetensors(path: str, params: Any, metadata: Optional[dict] = None) -> int:
    """Write a parameter tree to a ``.safetensors`` file, bf16 kept as BF16:
    the flat dict ``safetensors.torch.load_file`` yields from it is the one
    the reference's ``Params4bit.from_prequantized`` takes.  Returns the
    file's size in bytes."""
    return write_safetensors(path, state_dict_from_params(params, widen_ml_dtypes=False), metadata)


def load_checkpoint_safetensors(path: str, template: Optional[Any] = None, device=None) -> Any:
    """Read a ``.safetensors`` checkpoint (this package's, the JAX
    package's, or one in the same names from the reference or HF) onto
    ``device``; see :func:`params_from_state_dict`."""
    return params_from_state_dict(read_safetensors(path)[0], template, device)


# -- HF Transformers interop --------------------------------------------------

_HF_LLAMA_MAP = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "gate",
    "mlp.up_proj": "up",
    "mlp.down_proj": "down",
    "input_layernorm": "attn_norm",
    "post_attention_layernorm": "mlp_norm",
}

_STRING_MODES = ("nf4", "fp4", "int8")


def import_hf_llama(hf_state_dict: dict, cfg, quantize=None, dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Map an HF Transformers Llama state dict (tensors on any device, or
    numpy arrays; ``model.layers.N.self_attn.q_proj.weight`` names, with or
    without the ``model.`` prefix) onto the tree of ``models/llama.py``, on
    ``device`` (CUDA unless named).  Unfused: ``wq`` ... ``down``, with
    ``wq_b``/``wk_b``/``wv_b`` where the checkpoint has q/k/v biases; the
    lm_head is the embedding when ``lm_head.weight`` is absent (tied).

    ``quantize`` is a callable, given each linear weight as float32, or one
    of ``"nf4"``, ``"fp4"`` and ``"int8"`` (``load_in_4bit`` /
    ``load_in_8bit``).  The 4-bit modes quantize on ``device`` through
    ``QuantizedTensor.quantize`` at blocksize 64, ``layout="auto"`` (paired
    for Llama's linears), the weight in its own type (kernel 1 upcasts
    exactly), the state recording float32; ``"int8"`` casts to float32
    first.  Every other tensor is cast to ``dtype``."""
    device = resolve_device(device)
    mode = None
    if isinstance(quantize, str):
        if quantize not in _STRING_MODES:
            raise ValueError(f"quantize must be a callable or one of {_STRING_MODES}, got {quantize!r}")
        mode = quantize

    def tensor(t) -> torch.Tensor:
        return as_device_tensor(t.detach() if isinstance(t, torch.Tensor) else t, device)

    sd = dict(hf_state_dict)

    def find(name):
        for prefix in ("model.", ""):
            if prefix + name in sd:
                return prefix + name
        return None

    def get(name):
        k = find(name)
        if k is None:
            raise KeyError(name)
        return tensor(sd[k])

    def linear(name):
        W = get(name + ".weight")
        if mode == "int8":
            return Int8TensorState.quantize(W.to(torch.float32))
        if mode is not None:
            qt = QuantizedTensor.quantize(W, blocksize=64, quant_type=mode)
            return QuantizedTensor(data=qt.data, state=dataclasses.replace(qt.state, dtype=torch.float32))
        if quantize is not None:
            return quantize(W.to(torch.float32))
        return W.to(dtype)

    layers = []
    for i in range(cfg.num_layers):
        layer = {}
        for hf_name, ours in _HF_LLAMA_MAP.items():
            full = f"layers.{i}.{hf_name}"
            if ours.endswith("norm"):
                layer[ours] = get(full + ".weight").to(dtype)
                continue
            layer[ours] = linear(full)
            if ours in ("wq", "wk", "wv") and find(full + ".bias") is not None:
                layer[ours + "_b"] = get(full + ".bias").to(dtype)
        layers.append(layer)

    embed = get("embed_tokens.weight").to(dtype)
    lm_head = tensor(sd["lm_head.weight"]).to(dtype) if "lm_head.weight" in sd else embed
    return {"embed": embed, "layers": layers, "final_norm": get("norm.weight").to(dtype), "lm_head": lm_head}
