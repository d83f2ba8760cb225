"""The GPT-2/OPT family on the quantized path.

Counterpart of the JAX package's ``models/gpt2.py`` (OPT-125M LLM.int8()
inference is the reference library's own int8 example): pre-LayerNorm
blocks, learned positions, full multi-head attention, a tanh-GELU MLP and
an lm_head tied to the embeddings.  The linears go through the Llama
model's weight dispatch (a float tensor, a :class:`QuantizedTensor` or an
:class:`Int8TensorState`) and its dense attention.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..nn.modules import Int8TensorState, QuantizedTensor
from ..ops.dispatch import resolve_device
from ..ops.quant4bit import QUANTIZE_DTYPES
from .llama import _apply_linear, _attention

__all__ = ["GPT2Config", "init_params", "forward", "quantize_params_4bit", "quantize_params_int8"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # padded to a multiple of 64 (50257 in HF)
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 1024
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def opt125m(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "GPT2Config":
        return cls(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
                   max_positions=64)


@dataclasses.dataclass(frozen=True)
class _AttnCfg:
    """What the Llama model's attention reads of a config: full multi-head
    attention, no window."""

    num_kv_heads: int
    sliding_window: Optional[int] = None


def init_params(cfg: GPT2Config, generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Random init for benchmarks and tests: normal weights scaled by
    ``fan_in ** -0.5``, LayerNorms at one and zero, drawn from ``generator``
    (a generator on ``device``; seed 0 when omitted)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    D, F = cfg.hidden_size, cfg.intermediate_size

    def dense(n, m):
        w = torch.randn(n, m, dtype=torch.float32, generator=generator, device=device)
        return (w * m**-0.5).to(cfg.dtype)

    def ones():
        return torch.ones(D, dtype=cfg.dtype, device=device)

    def zeros():
        return torch.zeros(D, dtype=cfg.dtype, device=device)

    embed = dense(cfg.vocab_size, D)
    pos_embed = dense(cfg.max_positions, D)
    layers = [
        {
            "ln1_scale": ones(), "ln1_bias": zeros(), "wqkv": dense(3 * D, D), "wo": dense(D, D),
            "ln2_scale": ones(), "ln2_bias": zeros(), "fc_in": dense(F, D), "fc_out": dense(D, F),
        }
        for _ in range(cfg.num_layers)
    ]
    return {"embed": embed, "pos_embed": pos_embed, "layers": layers, "final_ln_scale": ones(),
            "final_ln_bias": zeros()}


_LINEARS = ("wqkv", "wo", "fc_in", "fc_out")


def quantize_params_4bit(params: dict, quant_type: str = "nf4", blocksize: int = 64,
                         compress_statistics: bool = False) -> dict:
    """Replace the four linears of every layer with packed 4-bit weights
    (layout "auto": paired where the shape allows), on the weight's own
    device; the state records float32 as its type, as the JAX package's,
    which quantizes the float32 cast (kernel 1's upcast is exact).  The
    tied embeddings stay as they are."""

    def q(W):
        qt = QuantizedTensor.quantize(W if W.dtype in QUANTIZE_DTYPES else W.to(torch.float32),
                                      blocksize=blocksize, quant_type=quant_type,
                                      compress_statistics=compress_statistics)
        return QuantizedTensor(data=qt.data, state=dataclasses.replace(qt.state, dtype=torch.float32))

    out = dict(params)
    out["layers"] = [{k: (q(v) if k in _LINEARS else v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def quantize_params_int8(params: dict) -> dict:
    """Replace the four linears of every layer with LLM.int8() weights
    (:class:`Int8TensorState`), on the weight's own device."""
    out = dict(params)
    out["layers"] = [{k: (Int8TensorState.quantize(v) if k in _LINEARS else v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def _layernorm(x, scale, bias, eps):
    """LayerNorm with the statistics and the normalization in f32, rounded
    to ``x``'s type before the scale and bias."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def forward(params: dict, ids: torch.Tensor, cfg: GPT2Config, int8_threshold: float = 0.0) -> torch.Tensor:
    """Causal forward over ``ids [B, T]``: f32 logits ``[B, T, V]`` from the
    lm_head tied to the embeddings.  ``int8_threshold`` turns on LLM.int8()'s
    outlier decomposition in every int8 linear."""
    B, T = ids.shape
    H, hd, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    x = params["embed"][ids].to(cfg.dtype)
    x = x + params["pos_embed"][None, :T]
    positions = torch.arange(T, device=ids.device)[None, :].expand(B, T)
    valid = torch.ones(B, T, dtype=torch.bool, device=ids.device)
    attn_cfg = _AttnCfg(H)

    for layer in params["layers"]:
        h = _layernorm(x, layer["ln1_scale"], layer["ln1_bias"], cfg.ln_eps)
        q, k, v = torch.split(_apply_linear(h, layer["wqkv"], None, int8_threshold), D, dim=-1)
        attn = _attention(q.reshape(B, T, H, hd), k.reshape(B, T, H, hd), v.reshape(B, T, H, hd), positions,
                          valid, attn_cfg)
        x = x + _apply_linear(attn, layer["wo"], None, int8_threshold)
        h = _layernorm(x, layer["ln2_scale"], layer["ln2_bias"], cfg.ln_eps)
        h = _apply_linear(h, layer["fc_in"], None, int8_threshold)
        h = torch.nn.functional.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
        x = x + _apply_linear(h, layer["fc_out"], None, int8_threshold)

    x = _layernorm(x, params["final_ln_scale"], params["final_ln_bias"], cfg.ln_eps)
    return _apply_linear(x, params["embed"], None, int8_threshold).to(torch.float32)
