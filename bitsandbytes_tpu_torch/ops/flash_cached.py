"""Flash attention over the KV cache: kernel wrapper and plain version.

Replaces the TPU kernel ``flash_attention_cached`` (``_kernel`` /
``_flash_step``) of the JAX package's ``ops/pallas/flash_cached.py`` in its
bf16-KV mode; the CUDA source is ``csrc/flash_cached.cu``.  It is bound by
bytes on the H100: every live K and V row is read once per block of query
rows.  The kernel stops at the last position its rows can attend, so dead
cache positions cost neither bytes nor compute, and it splits the folded
query rows over blocks, since rows are independent.

The int8-KV mode of the TPU kernel is not ported yet: int8 K/V raise.
"""

from __future__ import annotations

import torch

from . import _lib
from .dispatch import use_kernel

__all__ = ["GT_MAX", "flash_attention_cached", "flash_attention_cached_plain"]

_NEG_INF = -1e30

# Folded query rows per call; longer cached prefills are chunked over T by
# the caller (models/llama.py), as in the JAX package.
GT_MAX = 2048


def flash_attention_cached_plain(q, k, v, lengths, T: int, window, out_dtype) -> torch.Tensor:
    """One-shot softmax with the kernel's numerics: f32 scores from bf16
    inputs times hd^-0.5, -1e30 fill, p rounded to bf16 before the PV
    product, division by max(l, 1e-38)."""
    B, KVH, GT, hd = q.shape
    S = k.shape[2]
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * hd**-0.5
    t_of_row = torch.arange(GT, device=q.device) % T
    q_pos = lengths.to(torch.int64)[:, None] - (T - 1) + t_of_row[None, :]  # [B, GT]
    kv_pos = torch.arange(S, device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask = mask & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
    mask = mask[:, None]  # [B, 1, GT, S]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp(min=1e-38)
    pv = torch.matmul(p.to(torch.bfloat16).to(torch.float32), v.to(torch.float32))
    return (pv / denom).to(out_dtype)


def flash_attention_cached(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    T: int,
    k_scale=None,
    v_scale=None,
    window=None,
    out_dtype=None,
) -> torch.Tensor:
    """Blockwise attention of new-token queries against a KV cache.

    ``q [B, KVH, G*T, hd]`` with rows ``r = g*T + t``; ``k, v [B, KVH, S, hd]``;
    ``lengths [B]`` the position of each slot's newest query token.  kv
    positions ``<= q_pos`` attend, the oldest query of a chunk sitting at
    ``lengths - (T-1)``.  Returns ``[B, KVH, G*T, hd]`` in ``out_dtype``
    (default ``q.dtype``)."""
    if k.dtype == torch.int8 or k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV is not supported by this port yet")
    B, KVH, GT, hd = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, KVH, S, hd) or tuple(v.shape) != (B, KVH, S, hd):
        raise ValueError(f"k/v must be [{B}, {KVH}, S, {hd}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}]")
    if GT > GT_MAX or GT % T:
        raise ValueError(f"folded rows {GT} must be a multiple of T={T} and <= {GT_MAX}")
    out_dtype = out_dtype or q.dtype
    window = None if window is None else int(window)
    if not use_kernel(q, k, v, lengths):
        return flash_attention_cached_plain(q, k, v, lengths, T, window, out_dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous bf16 {name}")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned q/k/v")
    if hd != 128:
        raise ValueError(f"the CUDA kernel takes head_dim 128, got {hd}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel writes bf16")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(B, KVH, GT, hd, dtype=torch.bfloat16, device=q.device)
    if B * KVH * GT == 0:
        return out
    err = _lib.lib().bnb_flash_attention_cached(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, KVH, GT, S, hd, T, -1 if window is None else window, float(hd**-0.5),
        _lib.stream(q),
    )
    _lib.check(err, "flash_attention_cached")
    _lib.LAUNCHES["flash_attention_cached"] += 1
    return out
