"""Ring attention: exact attention with the sequence split over a mesh axis.

Counterpart of the JAX package's ``parallel/ring_attention.py``.  Each rank
holds its ``[B, T/n, H, d]`` shard of q, k and v; the K/V blocks travel a
ring (one ``ppermute`` a step) while each rank folds the block it holds into
its queries' online-softmax state, the flash recurrence: f32 scores, a
running max ``m``, denominator ``l`` and accumulator ``acc``.  At step ``i``
rank ``idx`` holds the block of rank ``(idx - i) % n``.  Exact, and
O(T/n) of K/V a rank.

The recurrence of one rank is :func:`ring_attention_local`, a plain function
of the local queries and the blocks in ring order: :func:`ring_attention`
feeds it blocks that arrive over the mesh, and one process can feed it any
rank's blocks to compute that rank's shard.  The backward is autograd's,
through the differentiable ``collectives.ppermute``, as the JAX package
differentiates through ``ppermute``.  A block is masked by causality and,
with ``window``, by the sliding window (``k_pos > q_pos - window``, the
JAX package's dense ``_attention``).  A block with no visible (query, key)
pair skips its einsums: its m, l and acc pass through unchanged, and it
still takes part in the graph (``_Skip``), so it carries a zero gradient
back and every rank runs every backward exchange.  The running max is a
constant to autograd (the output does not depend on it), and an exponent
is ``s - m`` with ``m`` finite, or ``-inf`` at a masked score, whose
``exp`` and its derivative are 0: no ``exp(-inf - -inf)``, so no NaN
reaches a gradient.  A query row that sees no key so far keeps m = -inf;
with a window that can happen after the first block too.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from .collectives import ppermute
from .mesh import Mesh

__all__ = ["ring_attention", "ring_attention_local"]


def _block_attn(q, k, v, mask, m, l, acc, scale):
    """One online-softmax step.  q ``[B, Tq, H, d]``, k/v ``[B, Tk, H, d]``,
    mask ``[Tq, Tk]`` bool or None (all visible); carries m, l ``[B, H, Tq]``
    and acc ``[B, Tq, H, d]``, all f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    with torch.no_grad():
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row with every key masked so far keeps m = -inf; its exponents use 0
        safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    p = torch.exp(s - safe_m[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return m_new, l_new, acc * corr.transpose(1, 2)[..., None] + pv


class _Skip(torch.autograd.Function):
    """``l`` as it is; backward, zero gradients for the skipped block's k and
    v, so the exchange that brought them runs its backward on this rank."""

    @staticmethod
    def forward(ctx, l, k, v):
        ctx.shapes = (k.shape, k.dtype, v.shape, v.dtype, k.device)
        return l.clone()

    @staticmethod
    def backward(ctx, g):
        ks, kt, vs, vt, dev = ctx.shapes
        return g, torch.zeros(ks, dtype=kt, device=dev), torch.zeros(vs, dtype=vt, device=dev)


def _visible(q0: int, k0: int, Tl: int, causal: bool, window: Optional[int]) -> bool:
    """Whether a query block at ``q0..q0+Tl-1`` sees any key of the block at
    ``k0..k0+Tl-1``: causality keeps keys up to the last query, the window
    keys past the first query's ``q0 - window``."""
    if causal and k0 > q0 + Tl - 1:
        return False
    return window is None or k0 + Tl - 1 > q0 - window


def ring_attention_local(q: torch.Tensor, blocks: Iterable[Tuple[torch.Tensor, torch.Tensor]], idx: int, n: int,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Rank ``idx``'s shard of an ``n``-rank ring: ``q [B, Tl, H, d]`` its
    queries (global positions ``idx * Tl + arange(Tl)``), ``blocks`` the
    ``(k, v)`` shards ``[B, Tl, H, d]`` in ring order (at step ``i`` rank
    ``(idx - i) % n``'s).  ``window``: a query at ``p`` sees keys past
    ``p - window`` only.  Returns ``[B, Tl, H, d]`` in q's type."""
    B, Tl, H, d = q.shape
    dev = q.device
    scale = d**-0.5
    q0 = idx * Tl
    q_pos = q0 + torch.arange(Tl, device=dev)
    m = torch.full((B, H, Tl), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Tl, H, d), dtype=torch.float32, device=dev)
    steps = 0
    for i, (kb, vb) in enumerate(blocks):
        if kb.shape != q.shape or vb.shape != q.shape:
            raise ValueError(f"k/v shard {tuple(kb.shape)}/{tuple(vb.shape)} must match q's {tuple(q.shape)} "
                             "(repeat grouped KV heads first)")
        steps += 1
        k0 = ((idx - i) % n) * Tl
        if not _visible(q0, k0, Tl, causal, window):
            l = _Skip.apply(l, kb, vb)
            continue
        k_pos = k0 + torch.arange(Tl, device=dev)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            recent = k_pos[None, :] > q_pos[:, None] - window
            mask = recent if mask is None else mask & recent
        m, l, acc = _block_attn(q, kb, vb, mask, m, l, acc, scale)
    if steps != n:
        raise ValueError(f"{steps} blocks for a ring of {n}")
    return (acc / l.clamp_min(1e-38).transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, axis: str = "seq",
                   causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Exact attention over a sequence split along ``axis``: ``q``, ``k``,
    ``v`` are this rank's ``[B, T/n, H, d]`` shards (the same H: the caller
    repeats grouped KV heads), the output this rank's shard, in q's type.
    The K/V pair travels as one tensor, one exchange a step; the n-th
    rotation would bring each block home unused and is skipped.
    ``window`` (the model's ``sliding_window``, None for none) masks keys
    at or before ``q_pos - window``."""
    mesh.group(axis)  # a virtual mesh raises: ring_attention_local computes one rank alone
    n, idx = mesh.axis_size(axis), mesh.index(axis)

    def blocks():
        kv = torch.stack([k, v])
        for i in range(n):
            yield kv[0], kv[1]
            if i < n - 1:
                kv = ppermute(kv, mesh, axis)

    return ring_attention_local(q, blocks(), idx, n, causal, window)
