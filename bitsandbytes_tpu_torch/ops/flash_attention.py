"""Causal flash attention of the training path (no cache): forward, dK/dV
and dQ kernels, their plain versions and the autograd function over them.

Replaces the three TPU kernels that the JAX package reaches through
``models/llama.py:_flash_call``: the forward, the dK/dV and the dQ kernel of
``jax/experimental/pallas/ops/tpu/flash_attention.py`` (``causal=True``,
``sm_scale = hd**-0.5``, its default 128 x 128 blocks).  The CUDA source is
``csrc/flash_attention.cu``: three ``mma.sync`` kernels with a ``cp.async``
ring, bf16 only, head_dim 128 or 256, T a multiple of 128.

Layouts are the model's: ``q [B, T, H, hd]``, ``k, v [B, T, KVH, hd]`` with
``H`` a multiple of ``KVH`` (query head ``h`` reads KV head ``h // G``, as
``jnp.repeat`` gives it, never materialized).  The kernels read q, k, v and
the output's gradient through their batch and token strides, so the views
the model splits out of its fused qkv projection go in without a copy.  The
residuals ``m`` (row max) and ``l`` (row sum) are f32 ``[B, H, T]``.

Numerics follow the TPU kernels:

* the score is ``f32(q . k) * scale``; a key after the query gets the
  additive mask ``-0.7 * float32 max``; key blocks wholly above the diagonal
  are skipped;
* forward: online softmax over 128-key blocks, ``p`` rounded to v's type
  before the PV product, which accumulates in f32; the output in q's type;
* backward: ``p = exp(s - m) * (1 / l)`` in f32, ``ds = (do . v - di) * p *
  scale`` with ``di = sum(o * do)`` in f32 (computed with torch ops, as the
  JAX package computes it outside the kernels); ``p`` and ``ds`` rounded to
  bf16 before the dV, dK and dQ products, all three accumulated in f32 and
  stored once in the input's type.  The GQA group's dK/dV add up in f32
  before that one rounding (the JAX package rounds per query head, then
  sums the repeat's transpose).

The plain versions take bf16 and f32 and follow the TPU kernels block for
block, the forward's per-step normalization included; the CUDA kernels
divide by ``l`` once at the end, the same function up to f32 rounding.
"""

from __future__ import annotations

import torch

from . import _lib
from .dispatch import use_kernel

__all__ = [
    "MASK_VALUE",
    "BLOCK",
    "HEAD_DIMS",
    "flash_attention_causal_fwd",
    "flash_attention_causal_fwd_plain",
    "flash_attention_causal_bwd_dkv",
    "flash_attention_causal_bwd_dkv_plain",
    "flash_attention_causal_bwd_dq",
    "flash_attention_causal_bwd_dq_plain",
    "FlashAttentionCausal",
    "flash_attention_causal",
]

# the TPU kernels' DEFAULT_MASK_VALUE and block size
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 128

# head_dims the CUDA kernels take; T must be a multiple of BLOCK
HEAD_DIMS = (128, 256)


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, T, H, hd] and k, v [B, T, KVH, hd], got {q.shape}, {k.shape}, {v.shape}")
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != hd or KVH == 0 or H % KVH:
        raise ValueError(f"k/v {tuple(k.shape)} do not go with q {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one type, bf16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    return B, T, H, KVH, hd


def _heads(t: torch.Tensor, G: int) -> torch.Tensor:
    """``[B, T, KVH, hd]`` -> ``[B, H, T, hd]`` in f32, each KV head repeated
    for its G query heads (the plain versions only)."""
    return t.to(torch.float32).repeat_interleave(G, dim=2).transpose(1, 2)


def _scores(qb, kb, scale, rows, cols):
    """f32 ``qb . kb^T * scale`` plus the mask where a key follows its query;
    ``rows``/``cols`` are the absolute positions."""
    s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
    keep = cols[None, :] <= rows[:, None]
    return s + torch.where(keep, 0.0, MASK_VALUE)


def flash_attention_causal_fwd_plain(q, k, v):
    """The TPU forward kernel's recurrence in PyTorch: ``(o [B, T, H, hd] in
    q's type, m [B, H, T] f32, l [B, H, T] f32)``.  Key block ``j`` updates
    the rows of query blocks ``>= j`` only, as the kernel skips the tiles
    above the diagonal."""
    B, T, H, KVH, hd = _shapes(q, k, v)
    scale = hd**-0.5
    qh = q.to(torch.float32).transpose(1, 2)  # [B, H, T, hd]
    kh, vh = _heads(k, H // KVH), _heads(v, H // KVH)
    pos = torch.arange(T, device=q.device)
    m = torch.full((B, H, T), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, T, dtype=torch.float32, device=q.device)
    acc = torch.zeros(B, H, T, hd, dtype=torch.float32, device=q.device)
    for c0 in range(0, T, BLOCK):  # key block c0 // BLOCK updates the query blocks from the same index on
        c1 = min(c0 + BLOCK, T)
        s = _scores(qh[:, :, c0:], kh[:, :, c0:c1], scale, pos[c0:], pos[c0:c1])
        m_prev, l_prev = m[:, :, c0:], l[:, :, c0:]
        m_next = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_next[..., None])
        l_corr = torch.exp(m_prev - m_next) * l_prev
        l_next = p.sum(dim=-1) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32), vh[:, :, c0:c1])
        acc[:, :, c0:] = acc[:, :, c0:] * (l_corr * inv)[..., None] + pv * inv[..., None]
        m[:, :, c0:], l[:, :, c0:] = m_next, l_next
    return acc.transpose(1, 2).to(q.dtype), m, l


def _probs_and_ds(q, k, v, do, m, l, di, i0, i1):
    """For query rows ``[i0, i1)`` and the keys ``[0, i1)`` they can reach:
    ``p`` and ``ds`` [B, H, rows, keys] in f32, as the TPU backward kernels
    recompute them."""
    B, T, H, KVH, hd = _shapes(q, k, v)
    G, scale = H // KVH, hd**-0.5
    pos = torch.arange(T, device=q.device)
    qb = q[:, i0:i1].to(torch.float32).transpose(1, 2)
    dob = do[:, i0:i1].to(torch.float32).transpose(1, 2)
    kh, vh = _heads(k[:, :i1], G), _heads(v[:, :i1], G)
    s = _scores(qb, kh, scale, pos[i0:i1], pos[:i1])
    p = torch.exp(s - m[:, :, i0:i1, None]) * (1.0 / l[:, :, i0:i1, None])
    dp = torch.matmul(dob, vh.transpose(-1, -2))
    ds = (dp - di[:, :, i0:i1, None]) * p * scale
    return p, ds, qb, dob, kh


def _check_bwd(q, k, v, do, m, l, di):
    B, T, H, KVH, hd = _shapes(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {q.dtype} {tuple(q.shape)}, got {do.dtype} {tuple(do.shape)}")
    for name, t in (("m", m), ("l", l), ("di", di)):
        if tuple(t.shape) != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{B}, {H}, {T}], got {t.dtype} {tuple(t.shape)}")
    return B, T, H, KVH, hd


def flash_attention_causal_bwd_dkv_plain(q, k, v, do, m, l, di):
    """The TPU dK/dV kernel in PyTorch: ``dv = sum p^T do``, ``dk = sum
    ds^T q`` over query blocks, ``p`` and ``ds`` rounded to the inputs' type
    before each product, f32 sums, the GQA group added in f32, stored in
    k's type: ``(dk, dv) [B, T, KVH, hd]``."""
    B, T, H, KVH, hd = _check_bwd(q, k, v, do, m, l, di)
    dk = torch.zeros(B, H, T, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, T, BLOCK):
        i1 = min(i0 + BLOCK, T)
        p, ds, qb, dob, _ = _probs_and_ds(q, k, v, do, m, l, di, i0, i1)
        dv[:, :, :i1] += torch.matmul(p.to(q.dtype).to(torch.float32).transpose(-1, -2), dob)
        dk[:, :, :i1] += torch.matmul(ds.to(q.dtype).to(torch.float32).transpose(-1, -2), qb)
    G = H // KVH

    def fold(t):  # [B, H, T, hd] -> [B, T, KVH, hd], the group summed
        return t.transpose(1, 2).reshape(B, T, KVH, G, hd).sum(dim=3).to(k.dtype)

    return fold(dk), fold(dv)


def flash_attention_causal_bwd_dq_plain(q, k, v, do, m, l, di):
    """The TPU dQ kernel in PyTorch: ``dq = sum ds k`` over the key blocks up
    to the diagonal, ``ds`` rounded to the inputs' type, an f32 sum, stored
    in q's type: ``dq [B, T, H, hd]``."""
    B, T, H, KVH, hd = _check_bwd(q, k, v, do, m, l, di)
    dq = torch.empty(B, H, T, hd, dtype=torch.float32, device=q.device)
    for i0 in range(0, T, BLOCK):
        i1 = min(i0 + BLOCK, T)
        _, ds, _, _, kh = _probs_and_ds(q, k, v, do, m, l, di, i0, i1)
        dq[:, :, i0:i1] = torch.matmul(ds.to(q.dtype).to(torch.float32), kh)
    return dq.transpose(1, 2).to(q.dtype)


# -- the CUDA kernels ------------------------------------------------------------


def _strides(name: str, t: torch.Tensor):
    """``(batch, token)`` strides in elements of a ``[B, T, heads, hd]`` tensor
    whose heads and head_dim are packed; anything else raises (the kernels
    read rows in place, never a copy)."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        raise ValueError(f"the CUDA kernel takes {name} with packed heads and head_dim, got strides {t.stride()}")
    if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel needs 16-byte aligned rows of {name}, got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def _check_cuda(q, k, v, T: int, hd: int) -> None:
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernels take bf16 q/k/v, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim {HEAD_DIMS}, got {hd}")
    if T % BLOCK or T == 0:
        raise ValueError(f"the CUDA kernels take T a positive multiple of {BLOCK}, got {T}")


def _f32_rows(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"the CUDA kernel takes a contiguous {name}")


def flash_attention_causal_fwd(q, k, v):
    """Causal attention of ``q [B, T, H, hd]`` over ``k, v [B, T, KVH, hd]``
    (no cache, positions from 0): ``(o [B, T, H, hd], m [B, H, T] f32,
    l [B, H, T] f32)``.  Kernel on CUDA tensors, plain version on CPU
    tensors."""
    B, T, H, KVH, hd = _shapes(q, k, v)
    if not use_kernel(q, k, v):
        return flash_attention_causal_fwd_plain(q, k, v)
    _check_cuda(q, k, v, T, hd)
    sq, sk, sv = _strides("q", q), _strides("k", k), _strides("v", v)
    o = torch.empty(B, T, H, hd, dtype=q.dtype, device=q.device)
    m = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if B:
        err = _lib.lib().bnb_flash_attention_causal_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), B, T, H, KVH, hd,
            *sq, *sk, *sv, hd**-0.5, _lib.stream(q))
        _lib.check(err, "flash_attention_causal_fwd")
        _lib.LAUNCHES["flash_attention_causal_fwd"] += 1
    return o, m, l


def _bwd_args(q, k, v, do, m, l, di):
    B, T, H, KVH, hd = _check_bwd(q, k, v, do, m, l, di)
    _check_cuda(q, k, v, T, hd)
    for name, t in (("m", m), ("l", l), ("di", di)):
        _f32_rows(name, t)
    strides = (*_strides("q", q), *_strides("k", k), *_strides("v", v), *_strides("do", do))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr())
    return (B, T, H, KVH, hd), ptrs, strides


def flash_attention_causal_bwd_dkv(q, k, v, do, m, l, di):
    """The gradients of k and v, ``(dk, dv) [B, T, KVH, hd]``, from the
    forward's ``m``, ``l`` and ``di = sum(o * do, -1)`` (f32 ``[B, H, T]``).
    A block owns 64 keys of one KV head and walks its group's query heads
    and the query tiles from the diagonal down, in a fixed order."""
    if not use_kernel(q, k, v, do, m, l, di):
        return flash_attention_causal_bwd_dkv_plain(q, k, v, do, m, l, di)
    (B, T, H, KVH, hd), ptrs, strides = _bwd_args(q, k, v, do, m, l, di)
    dk = torch.empty(B, T, KVH, hd, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if B:
        err = _lib.lib().bnb_flash_attention_causal_bwd_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), B, T, H, KVH, hd, *strides, hd**-0.5, _lib.stream(q))
        _lib.check(err, "flash_attention_causal_bwd_dkv")
        _lib.LAUNCHES["flash_attention_causal_bwd_dkv"] += 1
    return dk, dv


def flash_attention_causal_bwd_dq(q, k, v, do, m, l, di):
    """The gradient of q, ``dq [B, T, H, hd]``: a block owns 64 query rows
    and walks the key tiles up to the diagonal, in order (no atomics)."""
    if not use_kernel(q, k, v, do, m, l, di):
        return flash_attention_causal_bwd_dq_plain(q, k, v, do, m, l, di)
    (B, T, H, KVH, hd), ptrs, strides = _bwd_args(q, k, v, do, m, l, di)
    dq = torch.empty(B, T, H, hd, dtype=q.dtype, device=q.device)
    if B:
        err = _lib.lib().bnb_flash_attention_causal_bwd_dq(
            *ptrs, dq.data_ptr(), B, T, H, KVH, hd, *strides, hd**-0.5, _lib.stream(q))
        _lib.check(err, "flash_attention_causal_bwd_dq")
        _lib.LAUNCHES["flash_attention_causal_bwd_dq"] += 1
    return dq


class FlashAttentionCausal(torch.autograd.Function):
    """``o = softmax(q k^T * scale, causal) v`` with the flash kernels both
    ways: saves q, k, v, o, m and l; the backward computes ``di`` with torch
    ops, then runs the dK/dV and the dQ kernel."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, m, l = flash_attention_causal_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        if do.stride(3) != 1 or do.stride(2) != do.shape[3]:
            do = do.contiguous()
        di = (o.to(torch.float32) * do.to(torch.float32)).sum(dim=-1).transpose(1, 2).contiguous()
        dk, dv = flash_attention_causal_bwd_dkv(q, k, v, do, m, l, di)
        dq = flash_attention_causal_bwd_dq(q, k, v, do, m, l, di)
        return dq, dk, dv


def flash_attention_causal(q, k, v) -> torch.Tensor:
    """Differentiable causal flash attention, ``softmax(q k^T / sqrt(hd))
    v`` over the keys up to each query: ``o [B, T, H, hd]`` in q's type."""
    return FlashAttentionCausal.apply(q, k, v)
