"""Flash attention over the KV cache, dense or paged: kernel wrappers and
plain versions.

Replaces two TPU kernels of the JAX package's ``ops/pallas/flash_cached.py``:
``flash_attention_cached`` (``_kernel`` / ``_flash_step``) in its bf16- and
int8-KV modes, and ``flash_attention_paged`` (``_paged_kernel``), the same
recurrence over a shared block pool.  The CUDA source is
``csrc/flash_cached.cu``.  Both are bound by bytes on the H100: every live K
and V row is read once per block of query rows.  The kernels stop at the
last position their rows can attend, so dead cache positions cost neither
bytes nor compute, and they split the folded query rows over blocks, since
rows are independent.

An int8 cache carries per-(slot, head, position) f32 scales.  Both the
kernels and the plain versions follow the TPU kernel's order: the K scale
multiplies the f32 score after the dot, m and l come from the unscaled
probabilities, and the V scale multiplies the probabilities before they are
rounded to bf16 for the PV product.  (The JAX package's CPU fallback
dequantizes K/V to bf16 before the dot instead; the port does not mirror it.)
"""

from __future__ import annotations

import torch

from . import _lib
from .dispatch import use_kernel

__all__ = [
    "GT_MAX",
    "flash_attention_cached",
    "flash_attention_cached_plain",
    "flash_attention_paged",
    "flash_attention_paged_plain",
]

_NEG_INF = -1e30

# Folded query rows per call; longer cached prefills are chunked over T by
# the caller (models/llama.py), as in the JAX package.
GT_MAX = 2048


def flash_attention_cached_plain(q, k, v, lengths, T: int, window, out_dtype, k_scale=None,
                                 v_scale=None) -> torch.Tensor:
    """One-shot softmax with the kernel's numerics: f32 scores from bf16
    inputs (int8 codes exact), times the K scale (int8), times hd^-0.5,
    -1e30 fill, p times the V scale (int8) rounded to bf16 before the PV
    product, division by max(l, 1e-38) of the unscaled p."""
    B, KVH, GT, hd = q.shape
    S = k.shape[2]
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s * hd**-0.5
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
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    pv = torch.matmul(p.to(torch.bfloat16).to(torch.float32), v.to(torch.float32))
    return (pv / denom).to(out_dtype)


def _check_scales(kv: torch.Tensor, k_scale, v_scale, shape) -> bool:
    """Whether the cache is int8; raises on scales that do not go with it."""
    int8 = kv.dtype == torch.int8
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise ValueError("an int8 cache needs k_scale and v_scale; a bf16 cache takes none")
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 {list(shape)}, got {t.dtype} {list(t.shape)}")
    return int8


def _check_cuda(q, k, v, int8: bool, hd: int, out_dtype, window, scales=()) -> None:
    """What the CUDA kernels take; anything else raises."""
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous bf16 q")
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    for name, t in (("k", k), ("v", v)):
        if t.dtype != kv_dtype or not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {kv_dtype} {name}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned q/k/v")
    for t in scales:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous scales")
    if hd != 128:
        raise ValueError(f"the CUDA kernel takes head_dim 128, got {hd}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel writes bf16")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")


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

    ``q [B, KVH, G*T, hd]`` with rows ``r = g*T + t``; ``k, v [B, KVH, S, hd]``
    bf16, or int8 with ``k_scale``/``v_scale [B, KVH, S]`` f32; ``lengths
    [B]`` the position of each slot's newest query token.  kv positions
    ``<= q_pos`` attend, the oldest query of a chunk sitting at ``lengths -
    (T-1)``.  Returns ``[B, KVH, G*T, hd]`` in ``out_dtype`` (default
    ``q.dtype``)."""
    B, KVH, GT, hd = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, KVH, S, hd) or tuple(v.shape) != (B, KVH, S, hd):
        raise ValueError(f"k/v must be [{B}, {KVH}, S, {hd}], got {tuple(k.shape)}, {tuple(v.shape)}")
    int8 = _check_scales(k, k_scale, v_scale, (B, KVH, S))
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}]")
    if GT > GT_MAX or GT % T:
        raise ValueError(f"folded rows {GT} must be a multiple of T={T} and <= {GT_MAX}")
    out_dtype = out_dtype or q.dtype
    window = None if window is None else int(window)
    scales = (k_scale, v_scale) if int8 else ()
    if not use_kernel(q, k, v, lengths, *scales):
        return flash_attention_cached_plain(q, k, v, lengths, T, window, out_dtype, k_scale, v_scale)
    _check_cuda(q, k, v, int8, hd, out_dtype, window, scales)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(B, KVH, GT, hd, dtype=torch.bfloat16, device=q.device)
    if B * KVH * GT == 0:
        return out
    err = _lib.lib().bnb_flash_attention_cached(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, lengths.data_ptr(), out.data_ptr(), B, KVH, GT, S, hd, T,
        -1 if window is None else window, float(hd**-0.5), int(int8), _lib.stream(q),
    )
    name = "flash_attention_cached_int8" if int8 else "flash_attention_cached"
    _lib.check(err, name)
    _lib.LAUNCHES[name] += 1
    return out


def _gather_pool(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """``pool [NB, KVH, BS, ...]`` through ``tables [B, MAXB]`` -> each slot's
    logical cache ``[B, KVH, MAXB*BS, ...]``."""
    g = pool[tables.to(torch.int64)]  # [B, MAXB, KVH, BS, ...]
    B, MAXB, KVH, BS = g.shape[:4]
    return g.transpose(1, 2).reshape(B, KVH, MAXB * BS, *pool.shape[3:])


def flash_attention_paged_plain(q, pool_k, pool_v, tables, lengths, T: int, window, out_dtype,
                                k_scale=None, v_scale=None) -> torch.Tensor:
    """Gather each slot's logical cache out of the pool through its table,
    then run :func:`flash_attention_cached_plain` on it: on a pool scattered
    from a dense cache this is the dense plain version, bit for bit."""
    gather = (lambda t: None if t is None else _gather_pool(t, tables))  # noqa: E731
    return flash_attention_cached_plain(
        q, gather(pool_k), gather(pool_v), lengths, T, window, out_dtype, gather(k_scale), gather(v_scale)
    )


def flash_attention_paged(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    T: int = 1,
    k_scale=None,
    v_scale=None,
    window=None,
    out_dtype=None,
) -> torch.Tensor:
    """Paged flash attention: KV lives in a shared block pool ``[NB, KVH,
    BS, hd]`` (bf16, or int8 with ``k_scale``/``v_scale [NB, KVH, BS]``);
    ``tables [B, MAXB]`` int32 maps each slot's logical block j to its
    physical pool block.  ``q`` and ``lengths`` as in
    :func:`flash_attention_cached`; the logical cache holds ``MAXB * BS``
    positions.  The CUDA kernel takes a power-of-two ``BS >= 8`` and reads
    no table entry past the block of the slot's newest position."""
    B, KVH, GT, hd = q.shape
    NB, _, BS = pool_k.shape[:3]
    if tuple(pool_k.shape) != (NB, KVH, BS, hd) or tuple(pool_v.shape) != (NB, KVH, BS, hd):
        raise ValueError(f"pools must be [NB, {KVH}, BS, {hd}], got {tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    int8 = _check_scales(pool_k, k_scale, v_scale, (NB, KVH, BS))
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"tables must be [{B}, MAXB] and lengths [{B}]")
    if GT > GT_MAX or GT % T:
        raise ValueError(f"folded rows {GT} must be a multiple of T={T} and <= {GT_MAX}")
    out_dtype = out_dtype or q.dtype
    window = None if window is None else int(window)
    scales = (k_scale, v_scale) if int8 else ()
    if not use_kernel(q, pool_k, pool_v, tables, lengths, *scales):
        return flash_attention_paged_plain(q, pool_k, pool_v, tables, lengths, T, window, out_dtype,
                                           k_scale, v_scale)
    _check_cuda(q, pool_k, pool_v, int8, hd, out_dtype, window, scales)
    if BS < 8 or BS & (BS - 1):
        raise ValueError(f"the CUDA kernel takes a power-of-two block size >= 8, got {BS}")
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous int32 tables")
    MAXB = tables.shape[1]
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(B, KVH, GT, hd, dtype=torch.bfloat16, device=q.device)
    if B * KVH * GT == 0:
        return out
    err = _lib.lib().bnb_flash_attention_paged(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, KVH, GT, MAXB, BS, hd, T,
        -1 if window is None else window, float(hd**-0.5), int(int8), _lib.stream(q),
    )
    name = "flash_attention_paged_int8" if int8 else "flash_attention_paged"
    _lib.check(err, name)
    _lib.LAUNCHES[name] += 1
    return out
