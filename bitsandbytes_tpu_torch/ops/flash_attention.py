"""Causal flash attention of the training path (no cache): forward, dK/dV
and dQ kernels, their plain versions and the autograd function over them.

Replaces the three TPU kernels that the JAX package reaches through
``models/llama.py:_flash_call``: the forward, the dK/dV and the dQ kernel of
``jax/experimental/pallas/ops/tpu/flash_attention.py`` (``causal=True``,
``sm_scale = hd**-0.5``, its default 128 x 128 blocks).  The CUDA source is
``csrc/flash_attention.cu``; it takes q, k, v in bf16, f16 or f32, any
head_dim that is a multiple of 128 and T a multiple of 128: every case the
model's route (``models/llama._flash_ok``) sends, as the JAX package's does.
Two families of hand-written kernels share that source, and the wrappers
pick one by type and head_dim alone (:func:`uses_wgmma`):

* bf16 and f16 at head_dim 128 and 256 run on ``wgmma`` over tiles that one
  producer thread loads by TMA for consumer warpgroups (``csrc/sm90.cuh``);
* f32 at any head_dim, and bf16 and f16 at 384 and up, run the wide family
  on CUDA cores: full f32 FMA, not TF32, because the JAX package's f32 route
  runs at "highest" precision (one TF32 pass keeps about three digits, and
  TF32 ``wgmma`` cannot read V MN-major); and because a warpgroup's f32 O
  or dQ of 64 rows takes hd / 2 registers a thread, which with S and dP
  passes the 255-register limit above hd 256.  A block owns 128 columns of
  its output and recomputes the scores over all of head_dim.  Each kernel
  of this family counts under its own name (``..._wide``).

Both dK/dV kernels walk a work plan built here (:func:`dkv_plan`), and one
combine kernel adds the pieces of the key tiles it splits.

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
  the inputs' type before the dV, dK and dQ products (no-ops in f32), all
  three accumulated in f32 and stored once in the inputs' type.  The GQA
  group's dK/dV add up in f32 before that one rounding (the JAX package
  rounds per query head, then sums the repeat's transpose).

The plain versions take bf16, f16 and f32 and follow the TPU kernels block
for block, the forward's per-step normalization included; the CUDA kernels
divide by ``l`` once at the end, the same function up to f32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib
from .dispatch import use_kernel
from .gemm4bit_paired import _KIND  # the C entry points' element types (csrc/common.cuh's Kind)

__all__ = [
    "MASK_VALUE",
    "BLOCK",
    "HEAD_DIM_STEP",
    "WGMMA_HEAD_DIMS",
    "uses_wgmma",
    "flash_attention_causal_fwd",
    "flash_attention_causal_fwd_plain",
    "flash_attention_causal_bwd_dkv",
    "flash_attention_causal_bwd_dkv_plain",
    "DkvPlan",
    "dkv_plan",
    "flash_attention_causal_bwd_dkv_combine",
    "flash_attention_causal_bwd_dkv_combine_plain",
    "flash_attention_causal_bwd_dq",
    "flash_attention_causal_bwd_dq_plain",
    "FlashAttentionCausal",
    "flash_attention_causal",
]

# the TPU kernels' DEFAULT_MASK_VALUE and block size
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 128

# the CUDA kernels take head_dim a multiple of this, and T of BLOCK
HEAD_DIM_STEP = 128
# the head_dims of the wgmma kernels (bf16 and f16); the wide family takes the rest
WGMMA_HEAD_DIMS = (128, 256)


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, T, H, hd] and k, v [B, T, KVH, hd], got {q.shape}, {k.shape}, {v.shape}")
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != hd or KVH == 0 or H % KVH:
        raise ValueError(f"k/v {tuple(k.shape)} do not go with q {tuple(q.shape)}")
    if q.dtype not in _KIND or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one type, bf16, f16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
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


def uses_wgmma(dtype: torch.dtype, hd: int) -> bool:
    """Whether q/k/v of ``dtype`` at ``hd`` run the wgmma kernels; the wide
    family takes every other type and head_dim the CUDA kernels take."""
    return dtype != torch.float32 and hd in WGMMA_HEAD_DIMS


def _check_cuda(q, k, v, T: int, hd: int) -> None:
    """What both families refuse (the type is ``_shapes``'): head_dim off
    multiples of 128 and T off multiples of 128, which the model's route
    never sends."""
    if hd % HEAD_DIM_STEP or hd == 0:
        raise ValueError(f"the CUDA kernels take head_dim a positive multiple of {HEAD_DIM_STEP}, got {hd}")
    if T % BLOCK or T == 0:
        raise ValueError(f"the CUDA kernels take T a positive multiple of {BLOCK}, got {T}")


# what a TMA tensor map takes (``cuTensorMapEncodeTiled``) beyond a 16-byte
# aligned base and byte strides that are multiples of 16 (``_strides``)
TMA_MAX_DIM = 1 << 32
TMA_MAX_STRIDE_BYTES = 1 << 40


def _tma_ok(name: str, t: torch.Tensor) -> None:
    """The three wgmma kernels read ``t`` through a tensor map over its ``[B,
    T, heads, hd]`` view: every dimension at most 2^32 elements and every byte
    stride under 2^40, or it raises."""
    if max(t.shape) > TMA_MAX_DIM:
        raise ValueError(f"the CUDA kernels read {name} through TMA: a dimension over 2^32 in {tuple(t.shape)}")
    if max(st * t.element_size() for st in t.stride()) >= TMA_MAX_STRIDE_BYTES:
        raise ValueError(f"the CUDA kernels read {name} through TMA: a stride of 2^40 bytes or more in {t.stride()}")


def _f32_rows(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"the CUDA kernel takes a contiguous {name}")


def flash_attention_causal_fwd(q, k, v):
    """Causal attention of ``q [B, T, H, hd]`` over ``k, v [B, T, KVH, hd]``
    (no cache, positions from 0): ``(o [B, T, H, hd], m [B, H, T] f32,
    l [B, H, T] f32)``.  Kernel on CUDA tensors, plain version on CPU
    tensors.  On ``wgmma`` a block owns 128 query rows of one head (64 at
    head_dim 256) and reads q, k and v in place through TMA tensor maps over
    their strides; in the wide family 64 rows and 128 columns of o."""
    B, T, H, KVH, hd = _shapes(q, k, v)
    if not use_kernel(q, k, v):
        return flash_attention_causal_fwd_plain(q, k, v)
    _check_cuda(q, k, v, T, hd)
    sq, sk, sv = _strides("q", q), _strides("k", k), _strides("v", v)
    wgmma = uses_wgmma(q.dtype, hd)
    if wgmma:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _tma_ok(name, t)
    o = torch.empty(B, T, H, hd, dtype=q.dtype, device=q.device)
    m = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if B:
        name = "flash_attention_causal_fwd" + ("" if wgmma else "_wide")
        err = getattr(_lib.lib(), "bnb_" + name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), B, T, H, KVH, hd,
            *sq, *sk, *sv, hd**-0.5, _KIND[q.dtype], _lib.stream(q))
        _lib.check(err, name)
        _lib.LAUNCHES[name] += 1
    return o, m, l


def _bwd_args(q, k, v, do, m, l, di):
    B, T, H, KVH, hd = _check_bwd(q, k, v, do, m, l, di)
    _check_cuda(q, k, v, T, hd)
    for name, t in (("m", m), ("l", l), ("di", di)):
        _f32_rows(name, t)
    strides = (*_strides("q", q), *_strides("k", k), *_strides("v", v), *_strides("do", do))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr())
    return (B, T, H, KVH, hd), ptrs, strides


# -- the dK/dV kernel's work plan ---------------------------------------------

# An item of the plan is 64 keys of one KV head (DKV_KEYS), 128 columns of dK
# and dV (DKV_COLS: hd / 128 items a key tile) and a range of the key tile's
# iterations, one (query head, 64-row query tile) each.  A block takes an
# item, and one block fits an SM (its registers), in both families.
DKV_KEYS = 64
DKV_COLS = 128
DKV_BLOCKS_PER_SM = 1
# the least target: a key tile of at most this many iterations is never split
DKV_MIN_PIECE = 8


class DkvPlan(NamedTuple):
    """The dK/dV kernel's work plan.

    ``items``: eight ints an item, ``(b, kvh, kj, half, i0, i1, slot, 0)``,
    longest first: iterations ``[i0, i1)`` of key tile ``kj``, where
    iteration ``i`` is query head ``kvh * G + i // nq`` and query tile ``kj +
    i % nq`` (``nq = T // 64 - kj``: each head from the diagonal down), and
    ``slot`` the f32 partials it writes, or -1 for a key tile's only item.
    ``combine``: a row a split key tile, ``(b, kvh, kj, half, slot0, pieces,
    0, 0)``; its pieces hold slots ``slot0..`` in iteration order and are
    added in that order.  ``slots``: the partials all split key tiles write.
    ``target``: no item carries more iterations, the mean work of a slot
    rounded up, or ``DKV_MIN_PIECE`` if that is more."""

    items: list
    combine: list
    slots: int
    target: int


def dkv_plan(B: int, T: int, H: int, KVH: int, hd: int, slots: int) -> DkvPlan:
    """The dK/dV kernel's plan for ``slots`` resident blocks: a key tile (and
    column half) with more iterations than the target is cut into the fewest
    contiguous pieces of at most the target, their sizes at most one apart.
    The items are sorted longest first (ties in key tile order), so blocks
    handed out in order fill the card from the longest down.  It depends on
    the shapes and ``slots`` alone, and every call sums in the same order."""
    G, ntiles, halves = H // KVH, T // DKV_KEYS, hd // DKV_COLS
    total = B * KVH * halves * G * ntiles * (ntiles + 1) // 2
    target = max(-(-total // slots), DKV_MIN_PIECE)
    items, combine, used = [], [], 0
    for b in range(B):
        for kvh in range(KVH):
            for kj in range(ntiles):
                work = G * (ntiles - kj)
                pieces = -(-work // target)
                for half in range(halves):
                    if pieces == 1:
                        items.append((b, kvh, kj, half, 0, work, -1, 0))
                        continue
                    combine.append((b, kvh, kj, half, used, pieces, 0, 0))
                    items.extend((b, kvh, kj, half, p * work // pieces, (p + 1) * work // pieces, used + p, 0)
                                 for p in range(pieces))
                    used += pieces
    items.sort(key=lambda it: it[4] - it[5])
    return DkvPlan(items, combine, used, target)


_DKV_TABLES: dict = {}


def _dkv_tables(B, T, H, KVH, hd, device):
    """The plan for this card (``DKV_BLOCKS_PER_SM`` blocks an SM) and its
    item and combine tables on the device, made once a shape."""
    key = (B, T, H, KVH, hd, str(device))
    if key not in _DKV_TABLES:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = dkv_plan(B, T, H, KVH, hd, sms * DKV_BLOCKS_PER_SM)
        items = torch.tensor(plan.items, dtype=torch.int32, device=device)
        combine = torch.tensor(plan.combine, dtype=torch.int32, device=device).reshape(-1, 8)
        _DKV_TABLES[key] = (plan, items, combine)
    return _DKV_TABLES[key]


def _rows_aligned(name: str, t: torch.Tensor) -> None:
    """The dK/dV kernel copies 64 rows of ``t`` (m, l or di) at a time in
    bulk: its base must lie on 16 bytes."""
    if t.data_ptr() % 16:
        raise ValueError(f"the CUDA dK/dV kernel copies {name} in bulk: its base must be 16-byte aligned")


def _dq_checks(q, k, v, do) -> None:
    """What the dQ kernel takes beyond ``_bwd_args``: q, k, v and do through
    TMA tensor maps."""
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _tma_ok(name, t)


def _dkv_checks(q, k, v, do, m, l, di) -> None:
    """What the dK/dV kernel takes beyond ``_bwd_args``: the dQ kernel's
    tensor maps, and m, l and di on 16-byte aligned bases."""
    _dq_checks(q, k, v, do)
    for name, t in (("m", m), ("l", l), ("di", di)):
        _rows_aligned(name, t)


def flash_attention_causal_bwd_dkv_combine_plain(part_k, part_v, table, dk, dv):
    """The combine in PyTorch: for each row of ``table`` (a split key tile:
    batch, KV head, key tile, column half, first slot, pieces), the pieces'
    f32 partials (``[slots, 64, 128]``) added in piece order and rounded once
    into the tile's rows and columns of ``dk``, ``dv`` (``[B, T, KVH, hd]``,
    written in place)."""
    for b, kvh, kj, half, s0, pieces, _, _ in table.tolist():
        rows, cols = slice(kj * DKV_KEYS, (kj + 1) * DKV_KEYS), slice(half * DKV_COLS, (half + 1) * DKV_COLS)
        for part, out in ((part_k, dk), (part_v, dv)):
            acc = part[s0].clone()
            for p in range(1, pieces):
                acc += part[s0 + p]
            out[b, rows, kvh, cols] = acc.to(out.dtype)
    return dk, dv


def flash_attention_causal_bwd_dkv_combine(part_k, part_v, table, dk, dv):
    """Adds the pieces of the key tiles a dK/dV plan splits into ``dk``,
    ``dv`` (in place; see the plain version): kernel on CUDA tensors, plain
    version on CPU tensors."""
    if not use_kernel(part_k, part_v, table, dk, dv):
        return flash_attention_causal_bwd_dkv_combine_plain(part_k, part_v, table, dk, dv)
    if (part_k.dtype != torch.float32 or part_v.dtype != torch.float32 or part_k.shape != part_v.shape
            or tuple(part_k.shape[1:]) != (DKV_KEYS, DKV_COLS) or not part_k.is_contiguous()
            or not part_v.is_contiguous()):
        raise ValueError(f"the combine takes contiguous f32 partials [slots, {DKV_KEYS}, {DKV_COLS}]")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != 8 or not table.is_contiguous():
        raise ValueError("the combine takes a contiguous int32 table [units, 8]")
    if (dk.dim() != 4 or dv.shape != dk.shape or dk.dtype not in _KIND or dv.dtype != dk.dtype
            or not dk.is_contiguous() or not dv.is_contiguous() or dk.shape[3] % DKV_COLS):
        raise ValueError(f"the combine writes contiguous dk, dv [B, T, KVH, hd] of one float type, hd a multiple "
                         f"of {DKV_COLS}")
    _, T, KVH, hd = dk.shape
    if table.shape[0]:
        err = _lib.lib().bnb_flash_attention_causal_bwd_dkv_combine(
            part_k.data_ptr(), part_v.data_ptr(), table.data_ptr(), table.shape[0], dk.data_ptr(), dv.data_ptr(),
            T, KVH, hd, _KIND[dk.dtype], _lib.stream(dk))
        _lib.check(err, "flash_attention_causal_bwd_dkv_combine")
        _lib.LAUNCHES["flash_attention_causal_bwd_dkv_combine"] += 1
    return dk, dv


def flash_attention_causal_bwd_dkv(q, k, v, do, m, l, di):
    """The gradients of k and v, ``(dk, dv) [B, T, KVH, hd]``, from the
    forward's ``m``, ``l`` and ``di = sum(o * do, -1)`` (f32 ``[B, H, T]``).
    A block takes one item of :func:`dkv_plan`: 64 keys of one KV head and a
    range of its group's query heads and query tiles from the diagonal down,
    in a fixed order.  The pieces of a split key tile write f32 partials,
    which the combine adds in piece order, so every call gives the same
    bits.  Both families take the same plan."""
    if not use_kernel(q, k, v, do, m, l, di):
        return flash_attention_causal_bwd_dkv_plain(q, k, v, do, m, l, di)
    (B, T, H, KVH, hd), ptrs, strides = _bwd_args(q, k, v, do, m, l, di)
    wgmma = uses_wgmma(q.dtype, hd)
    if wgmma:
        _dkv_checks(q, k, v, do, m, l, di)
    dk = torch.empty(B, T, KVH, hd, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if B:
        plan, items, table = _dkv_tables(B, T, H, KVH, hd, q.device)
        part_k = part_v = None
        if plan.slots:
            part_k = torch.empty(plan.slots, DKV_KEYS, DKV_COLS, dtype=torch.float32, device=q.device)
            part_v = torch.empty_like(part_k)
        name = "flash_attention_causal_bwd_dkv" + ("" if wgmma else "_wide")
        err = getattr(_lib.lib(), "bnb_" + name)(
            *ptrs, dk.data_ptr(), dv.data_ptr(), None if part_k is None else part_k.data_ptr(),
            None if part_v is None else part_v.data_ptr(), items.data_ptr(), len(plan.items), B, T, H, KVH, hd,
            *strides, hd**-0.5, _KIND[q.dtype], _lib.stream(q))
        _lib.check(err, name)
        _lib.LAUNCHES[name] += 1
        if plan.slots:
            flash_attention_causal_bwd_dkv_combine(part_k, part_v, table, dk, dv)
    return dk, dv


def _dq_args(q, k, v, do, m, l, di):
    """Everything the dQ kernel checks before a launch (``_bwd_args``, and
    ``_dq_checks`` on the wgmma kernel): ``(shapes, pointers, strides)``, or
    it raises."""
    args = _bwd_args(q, k, v, do, m, l, di)
    if uses_wgmma(q.dtype, args[0][4]):
        _dq_checks(q, k, v, do)
    return args


def flash_attention_causal_bwd_dq(q, k, v, do, m, l, di):
    """The gradient of q, ``dq [B, T, H, hd]``: a block owns 128 query rows
    of one head (64 at head_dim 256; in the wide family 64 rows and 128
    columns of dq) and walks the key tiles up to the diagonal in key order,
    the sum in f32 registers (no atomics, so every call gives the same
    bits); the wgmma kernel reads q, k, v and do in place through TMA tensor
    maps over their strides."""
    if not use_kernel(q, k, v, do, m, l, di):
        return flash_attention_causal_bwd_dq_plain(q, k, v, do, m, l, di)
    (B, T, H, KVH, hd), ptrs, strides = _dq_args(q, k, v, do, m, l, di)
    dq = torch.empty(B, T, H, hd, dtype=q.dtype, device=q.device)
    if B:
        name = "flash_attention_causal_bwd_dq" + ("" if uses_wgmma(q.dtype, hd) else "_wide")
        err = getattr(_lib.lib(), "bnb_" + name)(
            *ptrs, dq.data_ptr(), B, T, H, KVH, hd, *strides, hd**-0.5, _KIND[q.dtype], _lib.stream(q))
        _lib.check(err, name)
        _lib.LAUNCHES[name] += 1
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
