"""Flash attention over the KV cache, dense or paged: kernel wrappers and
plain versions.

Replaces two TPU kernels of the JAX package's ``ops/pallas/flash_cached.py``:
``flash_attention_cached`` (``_kernel`` / ``_flash_step``) in its bf16- and
int8-KV modes, and ``flash_attention_paged`` (``_paged_kernel``), the same
recurrence over a shared block pool, at head_dim 64, 128 or 256.  The CUDA
source is ``csrc/flash_cached.cu``: one template that runs both products on
the tensor cores (``mma.sync``), streams K/V tiles through a double-buffered
``cp.async`` ring, gives a prefill block 64 query rows and a decode block
every row of its kv head, and splits the live positions of each (slot, kv
head) over several blocks when the grid would not fill the card
(:func:`flash_splits`).  The splits' partial results are added in split
order by a second kernel, :func:`flash_attention_combine`, so a result is
the same from run to run.  The kernels stop at the last position their rows
can attend, so dead cache positions cost neither bytes nor compute.

An int8 cache carries per-(slot, head, position) f32 scales.  Both the
kernels and the plain versions follow the TPU kernel's order: the K scale
multiplies the f32 score after the dot, m and l come from the unscaled
probabilities, and the V scale multiplies the probabilities before they are
rounded to bf16 for the PV product.  (The JAX package's CPU fallback
dequantizes K/V to bf16 before the dot instead; the port does not mirror it.)

Over a mesh (``parallel.Mesh``), :func:`flash_attention_cached_tp` and
:func:`flash_attention_paged_tp` run the same kernels on each rank's KV
heads (and slots), as the JAX package's ``shard_map`` wrappers split them,
and gather the outputs.
"""

from __future__ import annotations

import torch

from . import _lib
from .dispatch import use_kernel
from .gemm4bit_paired import _sm_count

__all__ = [
    "GT_MAX",
    "HEAD_DIMS",
    "flash_splits",
    "flash_attention_cached",
    "flash_attention_cached_plain",
    "flash_attention_paged",
    "flash_attention_paged_plain",
    "flash_attention_combine",
    "flash_attention_combine_plain",
    "tp_axes",
    "tp_slices",
    "flash_attention_cached_tp",
    "flash_attention_paged_tp",
]

_NEG_INF = -1e30

# Folded query rows per call; longer cached prefills are chunked over T by
# the caller (models/llama.py), as in the JAX package.
GT_MAX = 2048

# head_dims the CUDA kernels take
HEAD_DIMS = (64, 128, 256)

# the kernels' geometry (csrc/flash_cached.cu): kv positions per tile, rows a
# decode block takes, rows a prefill block takes; a split holds at most
# _MAX_SPLIT positions, which bounds a paged block's staged table
_KV_TILE, _DECODE_ROWS, _PREFILL_ROWS, _MAX_SPLIT = 64, 16, 64, 8192


def flash_splits(BH: int, GT: int, S: int, sms: int):
    """``(split_len, nsplit)`` for ``BH = B * KVH`` kv heads of ``GT`` folded
    rows over ``S`` logical positions on a card of ``sms`` SMs: one split
    when the (kv head, row tile) blocks fill a wave, else splits of whole
    64-position tiles until they cover about two waves.  A function of the
    shapes alone, so the dense and the paged kernel split alike."""
    tiles = -(-S // _KV_TILE)
    blocks = BH * (1 if GT <= _DECODE_ROWS else -(-GT // _PREFILL_ROWS))
    want = 1 if blocks >= sms else -(-2 * sms // blocks)
    split_tiles = max(1, tiles // want)
    split_len = min(split_tiles * _KV_TILE, _MAX_SPLIT)
    return split_len, -(-S // split_len)


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIMS}, got {hd}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel writes bf16")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")


def flash_attention_combine_plain(part_acc: torch.Tensor, part_ml: torch.Tensor) -> torch.Tensor:
    """The splits' partial results ``part_acc [nsplit, rows, hd]`` and
    ``part_ml [nsplit, rows, 2]`` (f32 m, l) -> ``[rows, hd]`` bf16:
    ``sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-38)``, ``M``
    the largest ``m_s``."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    w = torch.exp(m - m.amax(dim=0, keepdim=True))
    den = (l * w).sum(dim=0).clamp(min=1e-38)
    return ((part_acc * w[..., None]).sum(dim=0) / den[:, None]).to(torch.bfloat16)


def flash_attention_combine(part_acc: torch.Tensor, part_ml: torch.Tensor) -> torch.Tensor:
    """Kernel on CUDA tensors (the splits added in split order), plain
    version on CPU tensors.  Kernels 4 and 16 queue the same kernel
    themselves after a split call."""
    nsplit, rows, hd = part_acc.shape
    if part_acc.dtype != torch.float32 or tuple(part_ml.shape) != (nsplit, rows, 2) or \
            part_ml.dtype != torch.float32:
        raise ValueError("part_acc must be f32 [nsplit, rows, hd] and part_ml f32 [nsplit, rows, 2]")
    if not use_kernel(part_acc, part_ml):
        return flash_attention_combine_plain(part_acc, part_ml)
    if not (part_acc.is_contiguous() and part_ml.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous partials")
    out = torch.empty(rows, hd, dtype=torch.bfloat16, device=part_acc.device)
    if rows == 0:
        return out
    err = _lib.lib().bnb_flash_attention_combine(part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), rows,
                                                  hd, nsplit, _lib.stream(part_acc))
    _lib.check(err, "flash_attention_combine")
    _lib.LAUNCHES["flash_attention_combine"] += 1
    return out


def _launch(entry: str, name: str, q, args, shape_args, B: int, KVH: int, GT: int, S: int, hd: int):
    """Run kernel 4 or 16 (C entry ``entry``, counted as ``name``) into a new
    ``[B, KVH, GT, hd]`` bf16 output, through split partials and the combine
    kernel when :func:`flash_splits` cuts the positions (the C entry queues
    both, one host call)."""
    out = torch.empty(B, KVH, GT, hd, dtype=torch.bfloat16, device=q.device)
    if B * KVH * GT == 0:
        return out
    split_len, nsplit = flash_splits(B * KVH, GT, S, _sm_count(q.device.index or 0))
    part_acc = part_ml = None
    if nsplit > 1:
        rows = B * KVH * GT
        part_acc = torch.empty(nsplit, rows, hd, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(nsplit, rows, 2, dtype=torch.float32, device=q.device)
    err = getattr(_lib.lib(), entry)(
        *args, out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), *shape_args, split_len, nsplit, _lib.stream(q),
    )
    _lib.check(err, name)
    _lib.LAUNCHES[name] += 1
    if nsplit > 1:
        _lib.LAUNCHES["flash_attention_combine"] += 1
    return out


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
    return _launch(
        "bnb_flash_attention_cached", "flash_attention_cached_int8" if int8 else "flash_attention_cached", q,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr() if int8 else None,
         v_scale.data_ptr() if int8 else None, lengths.data_ptr()),
        (B, KVH, GT, S, hd, T, -1 if window is None else window, float(hd**-0.5), int(int8)),
        B, KVH, GT, S, hd)


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
    no table entry past the block of the slot's newest position; it splits
    the positions as the dense kernel does, so a pool scattered from a dense
    cache gives the dense kernel's bits."""
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
    return _launch(
        "bnb_flash_attention_paged", "flash_attention_paged_int8" if int8 else "flash_attention_paged", q,
        (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), k_scale.data_ptr() if int8 else None,
         v_scale.data_ptr() if int8 else None, tables.data_ptr(), lengths.data_ptr()),
        (B, KVH, GT, MAXB, BS, hd, T, -1 if window is None else window, float(hd**-0.5), int(int8)),
        B, KVH, GT, MAXB * BS, hd)


# -- over a mesh: attention split by KV heads (and batch rows) ------------------
#
# Attention is independent across KV heads and across slots, so each rank
# runs the kernel on its heads over the ``model`` axis and, where the batch
# divides, its slots over ``data``, with no collective inside; the outputs
# are gathered back over both axes.  ``mesh`` is a ``parallel.Mesh``.


def tp_axes(mesh, n_kvh: int, n_batch: int, model_axis: str = "model", data_axis: str = "data"):
    """``(batch_axis | None, head_axis | None)``: the axes of ``mesh`` larger
    than 1 that divide the batch and the KV heads, as the JAX package splits
    them; both None sends the call unmapped."""
    ma = model_axis if mesh.axis_size(model_axis) > 1 and n_kvh % mesh.axis_size(model_axis) == 0 else None
    da = data_axis if mesh.axis_size(data_axis) > 1 and n_batch % mesh.axis_size(data_axis) == 0 else None
    return da, ma


def tp_slices(mesh, n_kvh: int, n_batch: int, model_axis: str = "model", data_axis: str = "data"):
    """This rank's ``(batch slice, head slice, batch_axis, head_axis)``
    under :func:`tp_axes`."""
    da, ma = tp_axes(mesh, n_kvh, n_batch, model_axis, data_axis)
    nb = n_batch // mesh.axis_size(da) if da else n_batch
    nh = n_kvh // mesh.axis_size(ma) if ma else n_kvh
    b0 = mesh.index(da) * nb if da else 0
    h0 = mesh.index(ma) * nh if ma else 0
    return slice(b0, b0 + nb), slice(h0, h0 + nh), da, ma


def _gather_out(mesh, out: torch.Tensor, da, ma) -> torch.Tensor:
    if ma is not None:
        out = mesh.all_gather(out, ma, dim=1)
    if da is not None:
        out = mesh.all_gather(out, da, dim=0)
    return out


def flash_attention_cached_tp(mesh, q, k, v, lengths, *, T: int, k_scale=None, v_scale=None, window=None,
                              out_dtype=None, model_axis: str = "model", data_axis: str = "data"):
    """:func:`flash_attention_cached` over a mesh.  ``q [B, KVH, G*T, hd]``
    and ``lengths [B]`` are whole on every rank; ``k``, ``v`` (and the int8
    scales) are this rank's piece of the cache as ``parallel.shard_kv_cache``
    cuts it: its slots over ``data_axis`` and its KV heads over
    ``model_axis`` where :func:`tp_axes` splits them.  Each rank runs the
    kernel on its piece and the output ``[B, KVH, G*T, hd]`` is gathered
    over both axes.  With no axis to split, the call runs unmapped."""
    B, KVH = q.shape[0], q.shape[1]
    bsl, hsl, da, ma = tp_slices(mesh, KVH, B, model_axis, data_axis)
    if da is None and ma is None:
        return flash_attention_cached(q, k, v, lengths, T=T, k_scale=k_scale, v_scale=v_scale, window=window,
                                      out_dtype=out_dtype)
    out = flash_attention_cached(q[bsl, hsl].contiguous(), k, v, lengths[bsl].contiguous(), T=T, k_scale=k_scale,
                                 v_scale=v_scale, window=window, out_dtype=out_dtype)
    return _gather_out(mesh, out, da, ma)


def flash_attention_paged_tp(mesh, q, pool_k, pool_v, tables, lengths, *, T: int = 1, k_scale=None, v_scale=None,
                             window=None, out_dtype=None, model_axis: str = "model", data_axis: str = "data"):
    """:func:`flash_attention_paged` over a mesh: the pool (and its int8
    scales) is this rank's piece, its KV heads over ``model_axis``, every
    pool block present (the tables stay local); ``q``, ``tables`` and
    ``lengths`` are whole and each rank takes its slots over ``data_axis``
    where the batch divides.  The output is gathered over both axes."""
    B, KVH = q.shape[0], q.shape[1]
    bsl, hsl, da, ma = tp_slices(mesh, KVH, B, model_axis, data_axis)
    if da is None and ma is None:
        return flash_attention_paged(q, pool_k, pool_v, tables, lengths, T=T, k_scale=k_scale, v_scale=v_scale,
                                     window=window, out_dtype=out_dtype)
    out = flash_attention_paged(q[bsl, hsl].contiguous(), pool_k, pool_v, tables[bsl].contiguous(),
                                lengths[bsl].contiguous(), T=T, k_scale=k_scale, v_scale=v_scale, window=window,
                                out_dtype=out_dtype)
    return _gather_out(mesh, out, da, ma)
