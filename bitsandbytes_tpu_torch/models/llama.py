"""Llama-family transformer on the 4-bit and int8 serving and the QLoRA
training paths.

Counterpart of the JAX package's ``models/llama.py``: config presets, random
init, 4-bit and LLM.int8() quantization of the layer weights, the KV caches
(dense bf16, dense int8 with per-position scales, and a paged block pool in
either type), ``forward`` / ``prefill`` / ``decode_step``, and QLoRA
training (``add_lora``, ``lm_loss``, ``lora_train_step``).

Parameters are a plain dict: ``embed``, ``layers`` (a list of dicts),
``final_norm`` and ``lm_head``.  A layer's linear weights are bf16 tensors,
:class:`~bitsandbytes_tpu_torch.nn.QuantizedTensor` (NF4/FP4) or
:class:`~bitsandbytes_tpu_torch.nn.Int8TensorState` (LLM.int8()); the
forward dispatches per weight.  Every 4-bit linear goes through
``autograd.matmul_4bit``, every int8 one through ``autograd.matmul`` (at the
outlier threshold ``int8_threshold`` of ``forward`` and ``lm_loss``; serving
runs at threshold 0, as in the JAX package), and attention over the cache
through the flash kernel (``ops/flash_cached.py``).  The lm_head stays bf16
and runs as ``torch.matmul``.  A paged cache is read through the paged flash
kernel (``flash_attention_paged``); it takes per-slot decode steps only, as
in the JAX package: prefill runs through a dense cache whose blocks the
serving engine packs into the pool.

The bf16/f32 cast points are the JAX package's: RMSNorm and RoPE compute in
f32 and cast back, SiLU runs on the f32 gate, logits come out in f32.  A
LoRA delta is computed as the JAX package computes it (bf16 products times
the f32 scale) and added in f32, but the sum is rounded back to the
activations' type: the JAX package keeps it in f32, which would carry the
rest of the network in f32 and off the bf16 large-M routes of the kernels.

``forward`` runs with gradients enabled (training: no cache, causal
attention from position 0: on CUDA through the flash kernels of
``ops/flash_attention.py`` where ``_flash_ok`` holds, as the JAX package
routes its Pallas flash kernel, else the dense oracle); ``prefill`` and
``decode_step`` serve under ``torch.no_grad()``, and the cached attention
refuses to run where a gradient is needed, since its kernel has no
backward.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.utils.checkpoint

from .. import autograd
from ..nn.modules import Int8TensorState, QuantizedTensor
from ..ops.dispatch import resolve_device
from ..ops.flash_attention import flash_attention_causal
from ..ops.flash_cached import (
    GT_MAX,
    flash_attention_cached,
    flash_attention_cached_tp,
    flash_attention_paged,
    flash_attention_paged_tp,
    tp_slices,
)
from ..ops.quant4bit import QUANTIZE_DTYPES
from ..parallel.collectives import reduce_from_axis
from ..parallel.ring_attention import ring_attention
from ..parallel.sharding import Sharded

__all__ = [
    "LlamaConfig",
    "KVCache",
    "Int8KVCache",
    "PagedKVCache",
    "init_params",
    "init_kv_cache",
    "init_paged_kv_cache",
    "quantize_params_4bit",
    "quantize_params_int8",
    "forward",
    "lm_logits",
    "prefill",
    "decode_step",
    "add_lora",
    "lora_parameters",
    "lm_loss",
    "lora_train_step",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture of the decoder stack.  Mistral sets ``sliding_window``,
    Qwen2 ``attn_bias``, Gemma ``act="gelu"``, ``norm_plus_one`` and
    ``scale_embed``."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    sliding_window: Optional[int] = None
    attn_bias: bool = False
    act: str = "silu"
    norm_plus_one: bool = False
    scale_embed: bool = False

    @classmethod
    def llama3_8b(cls, num_layers: int = 32) -> "LlamaConfig":
        return cls(num_layers=num_layers)

    @classmethod
    def llama3_70b(cls, num_layers: int = 80) -> "LlamaConfig":
        return cls(
            hidden_size=8192, intermediate_size=28672, num_heads=64, num_kv_heads=8,
            num_layers=num_layers,
        )

    @classmethod
    def llama2_7b(cls, num_layers: int = 32) -> "LlamaConfig":
        return cls(intermediate_size=11008, num_kv_heads=32, rope_theta=10000.0, num_layers=num_layers)

    @classmethod
    def mistral_7b(cls, num_layers: int = 32) -> "LlamaConfig":
        return cls(
            intermediate_size=14336, num_kv_heads=8, rope_theta=10000.0, num_layers=num_layers,
            sliding_window=4096,
        )

    @classmethod
    def qwen2_7b(cls, num_layers: int = 28) -> "LlamaConfig":
        return cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_heads=28,
            num_kv_heads=4, rope_theta=1000000.0, num_layers=num_layers, attn_bias=True,
        )

    @classmethod
    def qwen25_32b(cls, num_layers: int = 64) -> "LlamaConfig":
        return cls(
            vocab_size=152064, hidden_size=5120, intermediate_size=27648, num_heads=40,
            num_kv_heads=8, rope_theta=1000000.0, num_layers=num_layers, attn_bias=True,
        )

    @classmethod
    def gemma_7b(cls, num_layers: int = 28) -> "LlamaConfig":
        return cls(
            vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_heads=16,
            num_kv_heads=16, head_dim=256, rope_theta=10000.0, num_layers=num_layers,
            act="gelu", norm_plus_one=True, scale_embed=True,
        )

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(
            vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=64,
        )


class KVCache(NamedTuple):
    """Static-shape KV cache: ``k``/``v`` are ``[L, B, KVH, S, hd]``.

    ``forward`` writes the new positions into these tensors in place and
    returns the same cache object."""

    k: torch.Tensor
    v: torch.Tensor


class Int8KVCache(NamedTuple):
    """int8 KV cache: ``k``/``v`` int8 ``[L, B, KVH, S, hd]``, ``k_scale`` /
    ``v_scale`` f32 ``[L, B, KVH, S]``, the absmax/127 of each (slot, head,
    position) row.  The flash kernel reads the codes and applies the scales
    after the dot; the cache is never dequantized as a whole.  Written in
    place, as :class:`KVCache`."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


class PagedKVCache(NamedTuple):
    """Block-table KV cache: a shared pool ``k``/``v [L, NB, KVH, BS, hd]``
    (bf16, or int8 with ``k_scale``/``v_scale [L, NB, KVH, BS]``) and
    ``tables [B, MAXB]`` int32 mapping each slot's logical block j to a pool
    block.  Memory scales with NB, not batch x max_len.  The serving engine
    owns the allocation; decode writes and attention walk the table on the
    device."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    tables: torch.Tensor


def _is_int8(kv_dtype) -> bool:
    if kv_dtype in ("int8", torch.int8):
        return True
    if kv_dtype in ("bf16", torch.bfloat16):
        return False
    raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, kv_dtype="bf16", device=None):
    """A zeroed dense cache: :class:`KVCache` in bf16, :class:`Int8KVCache`
    for ``kv_dtype="int8"``."""
    int8 = _is_int8(kv_dtype)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if int8:
        return Int8KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
    )


def init_paged_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, num_blocks: int, block_size: int = 128,
                        kv_dtype="bf16", device=None) -> PagedKVCache:
    """A zeroed pool of ``num_blocks`` blocks of ``block_size`` positions,
    with every table entry 0."""
    int8 = _is_int8(kv_dtype)
    device = resolve_device(device)
    max_blocks = -(-max_len // block_size)
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size, cfg.head_dim)
    dt = torch.int8 if int8 else cfg.dtype
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device) if int8 else None,
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device) if int8 else None,
        tables=torch.zeros(batch, max_blocks, dtype=torch.int32, device=device),
    )


def _quantize_kv(x):
    """Per-(slot, head, position) symmetric int8 over the head dim: ``x
    [B, KVH, T, hd]`` -> (int8 codes, f32 scales ``[B, KVH, T]``).  The scale
    is absmax/127; codes round half to even, as ``jnp.round`` does."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1) / 127.0
    q = torch.round(x32 / scale[..., None].clamp(min=1e-12))
    return q.to(torch.int8), scale


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Random init for benchmarks and tests: normal weights scaled by
    ``fan_in ** -0.5``, drawn from ``generator`` (a generator on ``device``;
    seed 0 when omitted)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    D = cfg.hidden_size
    H, KVH, hd, F = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size

    def dense(n, m):
        w = torch.randn(n, m, dtype=torch.float32, generator=generator, device=device)
        return (w * m**-0.5).to(cfg.dtype)

    def norm():
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        return fill(D, dtype=cfg.dtype, device=device)

    def layer():
        out = {
            "attn_norm": norm(),
            "wq": dense(H * hd, D),
            "wk": dense(KVH * hd, D),
            "wv": dense(KVH * hd, D),
            "wo": dense(D, H * hd),
            "mlp_norm": norm(),
            "gate": dense(F, D),
            "up": dense(F, D),
            "down": dense(D, F),
        }
        if cfg.attn_bias:
            for name, n in (("wq_b", H * hd), ("wk_b", KVH * hd), ("wv_b", KVH * hd)):
                out[name] = torch.zeros(n, dtype=cfg.dtype, device=device)
        return out

    embed = dense(cfg.vocab_size, D)
    layers = [layer() for _ in range(cfg.num_layers)]
    return {"embed": embed, "layers": layers, "final_norm": norm(), "lm_head": dense(cfg.vocab_size, D)}


_LINEAR_NAMES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def quantize_params_4bit(
    params: dict,
    quant_type: str = "nf4",
    blocksize: int = 64,
    compress_statistics: bool = False,
    quantize_lm_head: bool = False,
    fuse: bool = False,
) -> dict:
    """Replace every layer linear weight with a packed 4-bit QuantizedTensor,
    on the weight's own device.  A bf16, f16 or f32 weight is quantized in
    its type (the kernel's upcast is exact), any other upcast to f32 first;
    the state records f32 as its type either way, as the JAX package's does.
    ``fuse=True`` concatenates q/k/v into ``wqkv`` and gate/up into
    ``gate_up`` first; rows are independent quant blocks, so this is
    bit-identical to quantizing them apart."""

    def q(W):
        qt = QuantizedTensor.quantize(
            W if W.dtype in QUANTIZE_DTYPES else W.to(torch.float32), blocksize=blocksize,
            quant_type=quant_type, compress_statistics=compress_statistics,
        )
        return QuantizedTensor(data=qt.data, state=dataclasses.replace(qt.state, dtype=torch.float32))

    def qlayer(layer):
        if not fuse:
            return {k: (q(v) if k in _LINEAR_NAMES else v) for k, v in layer.items()}
        out = {
            "attn_norm": layer["attn_norm"],
            "mlp_norm": layer["mlp_norm"],
            "wqkv": q(torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=0)),
            "wo": q(layer["wo"]),
            "gate_up": q(torch.cat([layer["gate"], layer["up"]], dim=0)),
            "down": q(layer["down"]),
        }
        if "wq_b" in layer:
            out["wqkv_b"] = torch.cat([layer["wq_b"], layer["wk_b"], layer["wv_b"]], dim=0)
        return out

    out = dict(params)
    out["layers"] = [qlayer(layer) for layer in params["layers"]]
    if quantize_lm_head:
        out["lm_head"] = q(params["lm_head"])
    return out


def quantize_params_int8(params: dict, quantize_lm_head: bool = False) -> dict:
    """Replace every layer linear weight (``wq`` ... ``down``, unfused) with
    an LLM.int8() :class:`Int8TensorState` on the weight's own device: row
    absmax and int8 codes, as the JAX package quantizes its float32 cast
    (the upcast here is exact, inside the quantize)."""
    out = dict(params)
    out["layers"] = [
        {k: (Int8TensorState.quantize(v) if k in _LINEAR_NAMES else v) for k, v in layer.items()}
        for layer in params["layers"]
    ]
    if quantize_lm_head:
        out["lm_head"] = Int8TensorState.quantize(params["lm_head"])
    return out


def _add_lora(out, x, lora):
    """``out + (x @ A^T @ B^T) * scale``: the products in ``x``'s type, the
    delta and the sum in f32, rounded back to ``out``'s type."""
    if lora is None:
        return out
    h = torch.matmul(x, lora["a"].t().to(x.dtype))
    delta = torch.matmul(h, lora["b"].t().to(x.dtype)).to(torch.float32) * lora["scale"]
    return (out.to(torch.float32) + delta).to(out.dtype)


def _apply_linear(x, w, lora=None, threshold: float = 0.0):
    """Dispatch on the weight's type, then add the LoRA delta if any.
    ``threshold`` is LLM.int8()'s outlier threshold on an int8 weight.  A
    :class:`~bitsandbytes_tpu_torch.parallel.Sharded` weight computes this
    rank's piece through the same dispatch and puts the output together over
    its mesh."""
    if isinstance(w, Sharded):
        out = w.linear(x, lambda xl, wl: _apply_linear(xl, wl, None, threshold))
    elif isinstance(w, QuantizedTensor):
        out = autograd.matmul_4bit(x, w.data, w.state)
    elif isinstance(w, Int8TensorState):
        out = autograd.matmul(x, None, autograd.MatmulLtState(CB=w.CB, SCB=w.SCB, threshold=threshold))
    else:
        out = torch.matmul(x, w.to(x.dtype).t())
    return _add_lora(out, x, lora)


def _rmsnorm(x, w, eps, plus_one: bool = False):
    x32 = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if plus_one:
        return (x32 * rms).to(x.dtype) * (1.0 + w.to(torch.float32)).to(x.dtype)
    return (x32 * rms).to(x.dtype) * w


def _rope(x, positions, theta):
    """x: [B, T, H, hd]; positions: [B, T] integer."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32, device=x.device) / (hd // 2))
    angles = positions[..., None].to(torch.float32) * freqs  # [B, T, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(q, k, v, q_positions, kv_len_mask, cfg):
    """Dense attention oracle.  q: [B, T, H, hd]; k/v: [B, S, KVH, hd];
    kv_len_mask: [B, S] valid cache slots; q_positions: [B, T]."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    groups = H // cfg.num_kv_heads
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32), k.to(torch.float32)) * hd**-0.5
    kv_positions = torch.arange(S, device=q.device)[None, None, None, :]
    mask = kv_positions <= q_positions[:, None, :, None]
    mask = mask & kv_len_mask[:, None, None, :]
    if cfg.sliding_window is not None:
        mask = mask & (kv_positions > q_positions[:, None, :, None] - cfg.sliding_window)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v)
    return out.reshape(B, T, H * hd)


def _flash_ok(cfg, T: int, hd: int, device: torch.device) -> bool:
    """Whether the no-cache causal attention takes the flash kernels
    (``ops/flash_attention.py``): the JAX package's conditions, with the
    tensors on CUDA in place of the TPU backend.  No sliding window, T at
    least 1024 (the JAX package's line, drawn against the memory of the
    dense path's [B, H, T, T] f32 scores), T a multiple of 128 and head_dim
    a multiple of 128.  Elsewhere, and on the CPU, the dense oracle runs."""
    return (
        device.type == "cuda"
        and cfg.sliding_window is None
        and T >= 1024
        and T % 128 == 0
        and hd % 128 == 0
    )


def _flash_attention_causal(q, k, v, cfg):
    """q [B, T, H, hd], k/v [B, T, KVH, hd] -> [B, T, H*hd] through the
    causal flash kernels, both ways (``FlashAttentionCausal``); the grouped
    KV heads are read in place, not repeated."""
    B, T, H, hd = q.shape
    return flash_attention_causal(q, k, v).reshape(B, T, H * hd)


def _no_grad_check(q, k, v) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the cached attention kernel has no backward: train without a cache")


def _to_cache(k_t, v_t, dtype):
    """New K/V ``[B, KVH, T, hd]`` in the cache's type: (k, v, k_scale,
    v_scale), the scales None for a bf16 cache."""
    if dtype == torch.int8:
        (k_w, k_s), (v_w, v_s) = _quantize_kv(k_t), _quantize_kv(v_t)
        return k_w, v_w, k_s, v_s
    return k_t.to(dtype), v_t.to(dtype), None, None


def _decode_rows(cache, pos: torch.Tensor):
    """Where per-slot decode writes each slot's new K/V in one layer's cache:
    index tensors ``(i, j)`` for ``layer[i, :, j]`` (slot and position of a
    dense cache, pool block and row of a paged one), and which slots write.
    A position past the cache's end is dropped, as the JAX package's dense
    scatter drops it (its paged write clamps the table index and overwrites
    a row of the slot's last block instead): the engine's last decode chunk
    of a request may run past ``max_len``, and the host discards what those
    steps make."""
    pos = pos.to(torch.int64)
    ar = torch.arange(pos.shape[0], device=pos.device)
    if isinstance(cache, PagedKVCache):
        BS = cache.k.shape[3]
        S = cache.tables.shape[1] * BS
        keep = pos < S
        pos = pos.clamp(max=S - 1)
        return cache.tables[ar, pos // BS].to(torch.int64), pos % BS, keep
    S = cache.k.shape[3]
    return ar, pos.clamp(max=S - 1), pos < S


def _write_rows(dst, rows, new):
    """``dst[i, :, j] = new`` for the slots that write; the others keep the
    row's value."""
    i, j, keep = rows
    dst[i, :, j] = torch.where(keep.view(-1, *[1] * (new.dim() - 1)), new, dst[i, :, j])


def _cached_attention(q, k, v, cache, li, start_pos, rows, cfg, mesh=None, tp=None):
    """Write this step's K/V (quantized for an int8 cache, with their
    scales) into layer ``li`` of the dense cache in place, then run the
    flash kernel over it, chunked over T so the folded rows stay within
    ``GT_MAX``.  ``rows`` (:func:`_decode_rows`) for per-slot decode, else
    None.  Over a mesh, ``cache`` is this rank's piece and ``tp`` its
    ``(slots, heads)`` slices (``ops/flash_cached.tp_slices``): it writes
    its piece of the new K/V, and the attention runs through
    ``flash_attention_cached_tp``."""
    _no_grad_check(q, k, v)
    B, T, H, hd = q.shape
    KVH = cfg.num_kv_heads
    G = H // KVH
    int8 = isinstance(cache, Int8KVCache)
    ck, cv = cache.k[li], cache.v[li]
    cks = cache.k_scale[li] if int8 else None
    cvs = cache.v_scale[li] if int8 else None
    k_w, v_w, k_s, v_s = _to_cache(k.transpose(1, 2), v.transpose(1, 2), ck.dtype)  # [B, KVH, T, hd]
    if tp is not None:
        k_w, v_w, k_s, v_s = (None if t is None else t[tp] for t in (k_w, v_w, k_s, v_s))
    if rows is not None:
        _write_rows(ck, rows, k_w[:, :, 0])
        _write_rows(cv, rows, v_w[:, :, 0])
        if int8:
            _write_rows(cks, rows, k_s[:, :, 0])
            _write_rows(cvs, rows, v_s[:, :, 0])
        lengths = start_pos.to(torch.int32)
    else:
        ck[:, :, start_pos : start_pos + T] = k_w
        cv[:, :, start_pos : start_pos + T] = v_w
        if int8:
            cks[:, :, start_pos : start_pos + T] = k_s
            cvs[:, :, start_pos : start_pos + T] = v_s
        lengths = torch.full((B,), start_pos + T - 1, dtype=torch.int32, device=q.device)
    Tc_max = max(1, GT_MAX // G)
    chunks = []
    for off in range(0, T, Tc_max):
        Tc = min(Tc_max, T - off)
        # contiguous: with G = 1 (no grouped heads) the reshape is a strided view
        qf = q[:, off : off + Tc].permute(0, 2, 1, 3).reshape(B, KVH, G * Tc, hd).contiguous()
        lens = lengths - (T - 1) + (off + Tc - 1)
        if mesh is not None:
            out = flash_attention_cached_tp(mesh, qf, ck, cv, lens, T=Tc, k_scale=cks, v_scale=cvs,
                                            window=cfg.sliding_window)
        else:
            out = flash_attention_cached(qf, ck, cv, lens, T=Tc, k_scale=cks, v_scale=cvs, window=cfg.sliding_window)
        chunks.append(out.reshape(B, KVH, G, Tc, hd))
    attn = torch.cat(chunks, dim=3) if len(chunks) > 1 else chunks[0]
    return attn.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd)


def _paged_attention(q, k, v, cache, li, start_pos, rows, cfg, mesh=None, tp=None):
    """Per-slot decode over the block pool: write each slot's new K/V at
    ``tables[b, pos // BS]``, row ``pos % BS`` of layer ``li`` in place
    (``rows`` from :func:`_decode_rows`), then run the paged flash kernel.
    Over a mesh the pool is this rank's KV heads, every slot writes its rows
    of those heads, and the attention runs through
    ``flash_attention_paged_tp``."""
    _no_grad_check(q, k, v)
    B, T, H, hd = q.shape
    KVH = cfg.num_kv_heads
    G = H // KVH
    int8 = cache.k_scale is not None
    pk, pv = cache.k[li], cache.v[li]
    pks = cache.k_scale[li] if int8 else None
    pvs = cache.v_scale[li] if int8 else None
    k_w, v_w, k_s, v_s = _to_cache(k.transpose(1, 2), v.transpose(1, 2), pk.dtype)  # [B, KVH, 1, hd]
    if tp is not None:  # the pool holds every slot: this rank's heads only
        k_w, v_w, k_s, v_s = (None if t is None else t[:, tp[1]] for t in (k_w, v_w, k_s, v_s))
    _write_rows(pk, rows, k_w[:, :, 0])
    _write_rows(pv, rows, v_w[:, :, 0])
    if int8:
        _write_rows(pks, rows, k_s[:, :, 0])
        _write_rows(pvs, rows, v_s[:, :, 0])
    qf = q.permute(0, 2, 1, 3).reshape(B, KVH, G, hd)
    if mesh is not None:
        out = flash_attention_paged_tp(mesh, qf, pk, pv, cache.tables, start_pos, T=1, k_scale=pks, v_scale=pvs,
                                       window=cfg.sliding_window)
    else:
        out = flash_attention_paged(
            qf, pk, pv, cache.tables, start_pos, T=1, k_scale=pks, v_scale=pvs, window=cfg.sliding_window
        )
    return out.reshape(B, KVH, G, 1, hd).permute(0, 3, 1, 2, 4).reshape(B, T, H * hd)


def forward(
    params: dict,
    ids: torch.Tensor,
    cfg: LlamaConfig,
    cache=None,
    start_pos: Union[int, torch.Tensor] = 0,
    lora: Optional[dict] = None,
    return_hidden: bool = False,
    int8_threshold: float = 0.0,
    mesh=None,
):
    """Run the transformer over ``ids [B, T]``.

    Without a cache this is a plain causal forward from position 0 (training).
    With a cache, K/V for these positions are written at ``start_pos`` (an
    int, or a per-slot ``[B]`` tensor for decode with T == 1) and attention
    runs over the cache: a :class:`KVCache`, an :class:`Int8KVCache`, or a
    :class:`PagedKVCache` (per-slot decode only).  ``lora`` (from :func:`add_lora`) adds adapter
    deltas; on the fused ``wqkv``/``gate_up`` weights they apply after the
    split.  Returns ``(logits [B, T, V] f32, cache)``, or the final-norm
    hidden states ``[B, T, D]`` in place of the logits when
    ``return_hidden`` (the chunked loss applies the lm_head itself).
    ``int8_threshold`` turns on LLM.int8()'s outlier decomposition in every
    int8 linear, the lm_head's included.

    ``mesh`` (a ``parallel.Mesh``) serves over several ranks: ``params`` is
    this rank's tree from ``parallel.llama_param_specs`` and ``cache`` its
    piece from ``parallel.shard_kv_cache``, as the JAX package's engine
    places them.  Replicated weights compute whole on every rank; a split
    linear computes its rows through the kernels and gathers its output
    (``parallel.Sharded.linear``), the vocab-split embedding is a masked
    lookup plus a sum over the axis, and the cached attention runs on this
    rank's KV heads (and slots) through ``flash_attention_*_tp``.  Every rank
    ends with the same logits, bit for bit.

    Without a cache the mesh forward trains: ``ids`` are this rank's rows
    and, on a mesh with a ``"seq"`` axis, its shard of the tokens, whose
    positions start at ``index("seq") * T``; the attention is then
    ``parallel.ring_attention`` over that axis (at one rank too), the
    grouped KV heads repeated first, masked by ``cfg.sliding_window`` as the
    dense oracle is.  Gradients flow through the split linears
    (``Sharded.linear``) and the ring.  A cached forward ignores ``"seq"``,
    as the JAX package's ``kv_cache_specs`` does: the cache replicates over
    it and every ``seq`` rank computes the whole token axis, with no
    collective over it."""
    B, T = ids.shape
    ring = mesh is not None and "seq" in mesh.shape and cache is None
    if ring:
        start_pos = start_pos + mesh.index("seq") * T
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    emb = params["embed"]
    x = (emb.embedding(ids) if isinstance(emb, Sharded) else emb[ids]).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=cfg.dtype)
    vector_pos = isinstance(start_pos, torch.Tensor) and start_pos.dim() == 1
    if vector_pos and T != 1:
        raise ValueError("per-slot start_pos requires T == 1 (decode)")
    if isinstance(cache, PagedKVCache) and not vector_pos:
        raise ValueError(
            "PagedKVCache supports per-slot decode (T == 1) only; prefill through a dense cache "
            "and pack the blocks (the serving engine does this)"
        )
    if isinstance(start_pos, torch.Tensor) and not vector_pos:
        start_pos = int(start_pos)
    if vector_pos:
        positions = start_pos.to(ids.device)[:, None]
    else:
        positions = (start_pos + torch.arange(T, device=ids.device))[None, :].expand(B, T)
    # this rank's (slots, KV heads) of the cache
    tp = tp_slices(mesh, KVH, B)[:2] if mesh is not None and cache is not None else None
    rows = None
    if vector_pos and cache is not None:
        # a dense cache's piece holds this rank's slots; a pool holds every slot
        mine = start_pos if tp is None or isinstance(cache, PagedKVCache) else start_pos[tp[0]]
        rows = _decode_rows(cache, mine)

    for li, layer in enumerate(params["layers"]):
        l_lora = lora["layers"][li] if lora is not None else {}
        h = _rmsnorm(x, layer["attn_norm"], cfg.rms_eps, cfg.norm_plus_one)
        if "wqkv" in layer:
            qkv = _apply_linear(h, layer["wqkv"], None, int8_threshold)
            if "wqkv_b" in layer:
                qkv = qkv + layer["wqkv_b"].to(qkv.dtype)
            q, k, v = torch.split(qkv, [H * hd, KVH * hd, KVH * hd], dim=-1)
            q = _add_lora(q, h, l_lora.get("wq"))
            k = _add_lora(k, h, l_lora.get("wk"))
            v = _add_lora(v, h, l_lora.get("wv"))
        else:
            q = _apply_linear(h, layer["wq"], l_lora.get("wq"), int8_threshold)
            k = _apply_linear(h, layer["wk"], l_lora.get("wk"), int8_threshold)
            v = _apply_linear(h, layer["wv"], l_lora.get("wv"), int8_threshold)
            if "wq_b" in layer:
                q = q + layer["wq_b"].to(q.dtype)
                k = k + layer["wk_b"].to(k.dtype)
                v = v + layer["wv_b"].to(v.dtype)
        q = _rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta)
        k = _rope(k.reshape(B, T, KVH, hd), positions, cfg.rope_theta)
        v = v.reshape(B, T, KVH, hd)

        if isinstance(cache, PagedKVCache):
            attn = _paged_attention(q, k, v, cache, li, start_pos, rows, cfg, mesh, tp)
        elif cache is not None:
            attn = _cached_attention(q, k, v, cache, li, start_pos, rows, cfg, mesh, tp)
        elif ring:
            G = H // KVH
            k, v = (torch.repeat_interleave(t, G, dim=2) for t in (k, v))
            attn = ring_attention(q, k, v, mesh, axis="seq", causal=True, window=cfg.sliding_window).reshape(
                B, T, H * hd)
        elif not vector_pos and _flash_ok(cfg, T, hd, x.device):
            attn = _flash_attention_causal(q, k, v, cfg)
        else:
            valid = torch.ones(B, T, dtype=torch.bool, device=x.device)
            attn = _attention(q, k, v, positions, valid, cfg)

        x = x + _apply_linear(attn, layer["wo"], l_lora.get("wo"), int8_threshold)
        h = _rmsnorm(x, layer["mlp_norm"], cfg.rms_eps, cfg.norm_plus_one)
        if "gate_up" in layer:
            gate, up = torch.chunk(_apply_linear(h, layer["gate_up"], None, int8_threshold), 2, dim=-1)
            gate = _add_lora(gate, h, l_lora.get("gate"))
            up = _add_lora(up, h, l_lora.get("up"))
        else:
            gate = _apply_linear(h, layer["gate"], l_lora.get("gate"), int8_threshold)
            up = _apply_linear(h, layer["up"], l_lora.get("up"), int8_threshold)
        g32 = gate.to(torch.float32)
        act = torch.nn.functional.silu(g32) if cfg.act == "silu" else torch.nn.functional.gelu(
            g32, approximate="tanh"
        )
        x = x + _apply_linear(act.to(x.dtype) * up, layer["down"], l_lora.get("down"), int8_threshold)

    x = _rmsnorm(x, params["final_norm"], cfg.rms_eps, cfg.norm_plus_one)
    if return_hidden:
        return x, cache
    return lm_logits(params, x, int8_threshold), cache


def lm_logits(params: dict, h: torch.Tensor, int8_threshold: float = 0.0) -> torch.Tensor:
    """The lm_head over final-norm hidden states ``h [..., D]``: f32 logits."""
    return _apply_linear(h, params["lm_head"], threshold=int8_threshold).to(torch.float32)


@torch.no_grad()
def prefill(params, ids, cfg, cache, lora=None, mesh=None):
    return forward(params, ids, cfg, cache=cache, start_pos=0, lora=lora, mesh=mesh)


@torch.no_grad()
def decode_step(params, token, cfg, cache, pos, lora=None, mesh=None):
    """One decode step: ``token [B]`` at position ``pos`` (an int, or a
    per-slot ``[B]`` tensor).  Returns ``(logits [B, V], cache)``."""
    logits, cache = forward(params, token[:, None], cfg, cache=cache, start_pos=pos, lora=lora, mesh=mesh)
    return logits[:, 0], cache


# -- QLoRA training ------------------------------------------------------------

_LORA_DIMS = {
    "wq": lambda c: (c.num_heads * c.head_dim, c.hidden_size),
    "wk": lambda c: (c.num_kv_heads * c.head_dim, c.hidden_size),
    "wv": lambda c: (c.num_kv_heads * c.head_dim, c.hidden_size),
    "wo": lambda c: (c.hidden_size, c.num_heads * c.head_dim),
    "gate": lambda c: (c.intermediate_size, c.hidden_size),
    "up": lambda c: (c.intermediate_size, c.hidden_size),
    "down": lambda c: (c.hidden_size, c.intermediate_size),
}


def add_lora(
    cfg: LlamaConfig,
    rank: int = 8,
    alpha: float = 16.0,
    targets: tuple = ("wq", "wk", "wv", "wo"),
    generator: Optional[torch.Generator] = None,
    device=None,
) -> dict:
    """LoRA adapters for every layer (QLoRA, arXiv:2305.14314): per target
    ``a [rank, in]`` normal times ``in ** -0.5``, ``b [out, rank]`` zeros and
    ``scale = alpha / rank`` as a 0-d f32 tensor, all trainable (the scale
    too, as in the JAX package's tree).  Drawn from ``generator`` (on
    ``device``; seed 0 when omitted); CUDA unless ``device`` names another."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def leaf(name):
        n, m = _LORA_DIMS[name](cfg)
        a = torch.randn(rank, m, dtype=torch.float32, generator=generator, device=device) * m**-0.5
        return {
            "a": a.requires_grad_(),
            "b": torch.zeros(n, rank, dtype=torch.float32, device=device, requires_grad=True),
            "scale": torch.tensor(alpha / rank, dtype=torch.float32, device=device, requires_grad=True),
        }

    return {"layers": [{name: leaf(name) for name in targets} for _ in range(cfg.num_layers)]}


def lora_parameters(lora: dict) -> list:
    """The adapter tensors in a fixed order (layer, target, then ``a``,
    ``b``, ``scale``): what an optimizer is built over."""
    return [t for layer in lora["layers"] for ad in layer.values() for t in (ad["a"], ad["b"], ad["scale"])]


def _chunk_nll(hc, tc, lm_head, threshold):
    logits = _apply_linear(hc, lm_head, threshold=threshold).to(torch.float32)  # [C, V]
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(1, tc[:, None])[:, 0]
    return (lse - tl).sum()


def _local_tokens(ids: torch.Tensor, mesh):
    """This rank's inputs and targets of ``ids [B, T+1]``: its rows over
    ``"data"`` and its ``ceil(T / seq)`` tokens over ``"seq"``.  Where T does
    not split, the last tokens are padding (id 0), as GSPMD pads an uneven
    split: causal attention keeps every real token from seeing them, and
    the targets hold the real tokens' alone (fewer on the last ranks)."""
    B, T = ids.shape[0], ids.shape[1] - 1
    d, s = mesh.axis_size("data"), mesh.axis_size("seq")
    if B % d:
        raise ValueError(f"batch {B} does not split over the 'data' axis of size {d}")
    b0, Bl = mesh.index("data") * (B // d), B // d
    Tl = -(-T // s)
    t0 = mesh.index("seq") * Tl
    rows = ids[b0 : b0 + Bl]
    inputs = rows[:, :T][:, t0 : t0 + Tl]
    if inputs.shape[1] < Tl:
        inputs = torch.nn.functional.pad(inputs, (0, Tl - inputs.shape[1]))
    return inputs, rows[:, t0 + 1 : t0 + 1 + Tl]


def _sum_over_batch_axes(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the mesh's ``"data"`` and ``"seq"`` axes (those it
    has); backward, the cotangent as it is (every rank's loss is the same)."""
    for axis in ("data", "seq"):
        if axis in mesh.shape:
            t = reduce_from_axis(t, mesh, axis)
    return t


def lm_loss(params: dict, lora: Optional[dict], ids: torch.Tensor, cfg: LlamaConfig,
            token_chunk: Optional[int] = None, int8_threshold: float = 0.0, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over ``ids [B, T+1]`` (mean over B*T).

    ``token_chunk`` applies the lm_head and the softmax to that many tokens
    at a time instead of materializing the ``[B, T, V]`` logits; each chunk
    runs under ``torch.utils.checkpoint``, so the backward recomputes its
    logits rather than keep them.  The chunk sums add up in order.
    ``int8_threshold`` goes to :func:`forward`; on an int8 lm_head under
    ``token_chunk`` the outlier columns are found per chunk, as in the JAX
    package, so the loss equals the dense one in meaning, not bit for bit.

    ``mesh`` (a ``parallel.Mesh`` over process groups) trains over ranks:
    ``params`` is this rank's tree from ``parallel.llama_param_specs``,
    ``lora`` replicated, and ``ids`` the global batch, the same on every
    rank.  A rank takes its rows over ``"data"`` (the batch must divide)
    and its tokens over ``"seq"`` (an uneven T is padded at its end, as
    GSPMD pads it), sums its tokens' NLL
    (``token_chunk`` chunks them), and the sums add up in f32 over both
    axes; divided by B*T, the loss is the same bits on every rank."""
    if mesh is not None:
        inputs, targets = _local_tokens(ids, mesh)
        h, _ = forward(params, inputs, cfg, lora=lora, return_hidden=True, int8_threshold=int8_threshold,
                       mesh=mesh)
        h = h[:, : targets.shape[1]]  # the padding's positions carry no loss
        total = _nll_sum(h.reshape(-1, h.shape[-1]), targets.reshape(-1), params["lm_head"], int8_threshold,
                         token_chunk)
        return _sum_over_batch_axes(total, mesh) / (ids.shape[0] * (ids.shape[1] - 1))
    if token_chunk is None:
        logits, _ = forward(params, ids[:, :-1], cfg, lora=lora, int8_threshold=int8_threshold)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, ids[:, 1:, None])[..., 0].mean()
    h, _ = forward(params, ids[:, :-1], cfg, lora=lora, return_hidden=True, int8_threshold=int8_threshold)
    h = h.reshape(-1, h.shape[-1])
    return _nll_sum(h, ids[:, 1:].reshape(-1), params["lm_head"], int8_threshold, token_chunk) / h.shape[0]


def _nll_sum(h, targets, lm_head, threshold, token_chunk):
    """The f32 sum of the NLL of ``targets`` under the logits of ``h [N, D]``,
    ``token_chunk`` tokens a checkpointed chunk (all at once if None)."""
    if token_chunk is None:
        return _chunk_nll(h, targets, lm_head, threshold)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, h.shape[0], token_chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_nll, h[c : c + token_chunk], targets[c : c + token_chunk], lm_head, threshold,
            use_reentrant=False,
        )
    return total


def _sum_grads(params, mesh) -> None:
    """Each gradient summed over ``"data"`` and ``"seq"`` in place: the
    gradients of one type go as one flat buffer, one all-reduce an axis."""
    axes = [a for a in ("data", "seq") if a in mesh.shape]
    if not axes:
        return
    by_type = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for axis in axes:
            flat = mesh.all_reduce(flat, axis)
        torch._foreach_copy_(grads, [piece.view_as(g) for piece, g in zip(flat.split([g.numel() for g in grads]),
                                                                             grads)])


def lora_train_step(params: dict, lora: dict, optimizer: torch.optim.Optimizer, ids: torch.Tensor,
                    cfg: LlamaConfig, token_chunk: Optional[int] = None, mesh=None) -> torch.Tensor:
    """One QLoRA step: gradients flow into the adapters only (the 4-bit base
    is frozen), then ``optimizer`` (built over :func:`lora_parameters`)
    updates them in place.  Returns the loss before the step, detached.

    ``mesh``: :func:`lm_loss` over the mesh, then every adapter gradient
    summed over ``"data"`` and ``"seq"`` before the step (over ``"model"``
    each rank's is the whole gradient already), so every rank's adapters and
    optimizer states stay the same bits."""
    optimizer.zero_grad(set_to_none=True)
    loss = lm_loss(params, lora, ids, cfg, token_chunk=token_chunk, mesh=mesh)
    loss.backward()
    if mesh is not None:
        _sum_grads([p for group in optimizer.param_groups for p in group["params"]], mesh)
    optimizer.step()
    return loss.detach()
