"""Blockwise 8-bit quantize and dequantize: kernel wrappers and plain versions.

Replace the TPU kernels ``quantize_blockwise_pallas`` and
``dequantize_blockwise_pallas`` of the JAX package's
``ops/pallas/blockwise8.py``; the CUDA source is ``csrc/blockwise8.cu``.
Both are bound by bytes on the H100.  The quantize streams tiles of 16384
elements (a lane's 16 in registers, each element read once, the absmax by
shuffles or across warps in shared memory) and ranks sorted midpoints by a
bucket table built here per codebook (:func:`bucket_table`: the scaled
value's sign, exponent and top mantissa bits give the count below the
bucket and the next midpoint); the dequantize looks 8 codes up in a
shared-memory table per thread.  The tables go to the device once per
codebook (``_device_tables``).

Both take whole blocks (``n % blocksize == 0``) of any blocksize; on CUDA
the tiles serve the blocksizes the tiles were built for (quantize:
``QUANTIZE_BLOCKSIZES``, dequantize: multiples of 8) and ``_any`` instances
of the same kernels every other one, one CUDA block a quantization block
(quantize) or one element a thread (dequantize), with the same arithmetic.
``functional/blockwise.py`` pads a partial last block.  Semantics, as the
TPU kernels':

* ``scaled = clip(x * (1 / absmax), -1, 1)`` with scale inf below the
  smallest normal float32 (an all-zero block ranks 0, code 0);
* ``q = #{midpoints < scaled}``, the midpoints ``(code[:-1] + code[1:]) / 2``
  in float32;
* stochastic mode, given uniforms ``u``: move to the neighbouring entry on
  the far side of ``scaled`` when ``u < |scaled - code[q]| / gap``;
* ``dequant = code[q] * absmax``, the product in float32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import _lib
from .dispatch import use_kernel

__all__ = [
    "QUANTIZE_BLOCKSIZES",
    "bucket_table",
    "quantize_blockwise8",
    "quantize_blockwise8_plain",
    "dequantize_blockwise8",
    "dequantize_blockwise8_plain",
]

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _tables(code_t: tuple):
    """The codebook and its float32 midpoints, as host tuples."""
    code = np.asarray(code_t, dtype=np.float32)
    mid = ((code[:-1] + code[1:]) * np.float32(0.5)).astype(np.float32)
    return tuple(float(x) for x in code), tuple(float(x) for x in mid)


# The bucket table of the quantize kernel's rank (csrc/blockwise8.cu,
# rank_bucket): |scaled|'s exponent and top mantissa bits index it, at most
# BUCKET_MAX_ENTRIES entries (32 KB of shared memory) of at most one midpoint
# each, magnitudes under 2**-E sharing one bucket.  The kernel's rank modes:
RANK_LINEAR, RANK_SEARCH, RANK_BUCKET = 0, 1, 2
BUCKET_MAX_ENTRIES = 4096
BUCKET_MAX_BINADES = 40


def bucket_table(mid: np.ndarray, mantissa_bits: int):
    """The buckets of sorted float32 midpoints ``mid`` at ``mantissa_bits``
    of resolution: ``(table, nh, shift, lo, most)``.

    ``table`` is float32 ``[2 * nh, 2]``: for each bucket the count of
    midpoints below its least value (as int32 bits), then the next midpoint
    (+inf past the last).  A value ``c`` in [-1, 1] with float32 bits ``b``
    falls in bucket ``nh + i`` for ``c >= +0`` and ``nh - 1 - i`` for negative
    ``c`` (sign bit set), ``i = max(((b << 1) mod 2**32) >> shift - lo, 0)``.
    ``most`` is the most midpoints a bucket's values can count beyond its
    entry's count: the kernel's one compare gives ``#{mid < c}`` wherever it
    is at most 1."""
    mid = np.asarray(mid, dtype=np.float32)
    M = mantissa_bits
    nz = np.abs(mid[mid != 0])
    lowest_binade = int(nz.view(np.uint32).min() >> 23) if nz.size else 127
    # one binade below the least nonzero midpoint's: bucket 0 then holds
    # none of them, only a midpoint at 0
    E = min(max(128 - lowest_binade, 1), BUCKET_MAX_BINADES)
    lo = (127 - E) << M
    nh = (E << M) + 1
    unit = 23 - M  # a bucket's width in the bits of |c|
    mags = np.arange(nh, dtype=np.int64)
    # the least and greatest magnitude of each bucket, within [0, 1]
    small = np.where(mags == 0, 0, (mags + lo) << unit)
    large = np.minimum(((mags + lo + 1) << unit) - 1, 0x3F800000)
    small, large = (v.astype(np.uint32).view(np.float32) for v in (small, large))
    least = np.concatenate([-large[::-1], small])
    greatest = np.concatenate([-small[::-1], large])
    count = np.searchsorted(mid, least, side="left")  # #{mid < least}: float32 compares
    most = int((np.searchsorted(mid, greatest, side="left") - count).max())
    table = np.empty((2 * nh, 2), dtype=np.float32)
    table[:, 0] = count.astype(np.int32).view(np.float32)
    table[:, 1] = np.concatenate([mid, np.full(1, np.inf, np.float32)])[count]
    return table, nh, unit + 1, lo, most


def _buckets(mid: np.ndarray):
    """The coarsest :func:`bucket_table` of at most one midpoint a bucket
    within ``BUCKET_MAX_ENTRIES``: ``(table, nh, shift, lo)``, or None."""
    for M in range(4, 8):
        table, nh, shift, lo, most = bucket_table(mid, M)
        if 2 * nh > BUCKET_MAX_ENTRIES:
            return None
        if most <= 1:
            return table, nh, shift, lo
    return None


@functools.lru_cache(maxsize=None)
def _device_tables(code_t: tuple, device: str):
    """The kernels' table on ``device`` and how the quantize ranks:
    ``(table, rank, nh, shift, lo)``.  The table holds the codebook padded to
    256 floats and its midpoints padded to 256 with +inf, then, for sorted
    midpoints that :func:`_buckets` resolves, the buckets (``RANK_BUCKET``);
    other sorted midpoints take the binary search (``RANK_SEARCH``), unsorted
    ones the linear count (``RANK_LINEAR``).  Built once per codebook and
    device."""
    code, mid = _tables(code_t)
    mid = np.asarray(mid, dtype=np.float32)
    head = np.zeros(512, dtype=np.float32)
    head[: len(code)] = code
    head[256:] = np.inf
    head[256 : 256 + len(mid)] = mid
    if not all(b >= a for a, b in zip(mid, mid[1:])):
        return torch.from_numpy(head).to(device), RANK_LINEAR, 0, 0, 0
    buckets = _buckets(mid)
    if buckets is None:
        return torch.from_numpy(head).to(device), RANK_SEARCH, 0, 0, 0
    table, nh, shift, lo = buckets
    return torch.from_numpy(np.concatenate([head, table.reshape(-1)])).to(device), RANK_BUCKET, nh, shift, lo


def code_tuple(code) -> tuple:
    """A codebook (numpy array, tensor or sequence) as a tuple of at most 256
    float32 values, the key of its tables.  A device tensor is read back: pass
    a numpy codebook on a hot path."""
    if isinstance(code, torch.Tensor):
        code = code.detach().cpu().numpy()
    arr = np.asarray(code, dtype=np.float32).reshape(-1)[:256]
    if arr.size < 2:
        raise ValueError("a blockwise codebook needs at least 2 entries")
    return tuple(float(x) for x in arr)


def _rank(scaled: torch.Tensor, mid: tuple) -> torch.Tensor:
    """#{midpoints < scaled}, counted; a NaN ranks 0."""
    m = torch.tensor(mid, dtype=torch.float32, device=scaled.device)
    if bool((m[1:] >= m[:-1]).all()):
        return torch.searchsorted(m, scaled.nan_to_num(nan=-float("inf")), right=False).to(torch.int32)
    rank = torch.zeros(scaled.shape, dtype=torch.int32, device=scaled.device)
    for v in mid:
        rank += scaled > v
    return rank


def quantize_blockwise8_plain(x: torch.Tensor, code_t: tuple, blocksize: int,
                              u: Optional[torch.Tensor] = None):
    """``x`` f32 ``[n]`` (whole blocks) -> (codes u8 ``[n]``, absmax f32
    ``[n / blocksize]``), with the kernel's arithmetic."""
    code, mid = _tables(code_t)
    blocks = x.reshape(-1, blocksize)
    absmax = blocks.abs().amax(dim=1)
    tiny = torch.finfo(torch.float32).tiny
    scale = torch.where(absmax < tiny, torch.inf, torch.div(1.0, absmax))
    scaled = (blocks * scale[:, None]).clamp(-1.0, 1.0).reshape(-1)
    q = _rank(scaled, mid)
    if u is not None:
        table = torch.tensor(code, dtype=torch.float32, device=x.device)
        lower = table[q.long()]
        nbr = (q + torch.where(scaled > lower, 1, -1)).clamp(0, len(code) - 1)
        gap = (table[nbr.long()] - lower).abs()
        p = torch.where(gap > 0, (scaled - lower).abs() / gap.clamp(min=1e-20), 0.0)
        q = torch.where(u.reshape(-1) < p, nbr, q)
    return q.to(torch.uint8), absmax


def _check_blocks(n: int, blocksize: int) -> None:
    if blocksize < 1 or n % blocksize:
        raise ValueError(f"{n} elements are not whole blocks of {blocksize}")


# the blocksizes of the quantize tile; the _any instance takes the others
QUANTIZE_BLOCKSIZES = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def quantize_blockwise8(x: torch.Tensor, code, blocksize: int, u: Optional[torch.Tensor] = None):
    """Kernel on a CUDA tensor, plain version on a CPU tensor.  ``x`` is a
    contiguous 1-D float32 tensor of whole blocks; a blocksize in
    ``QUANTIZE_BLOCKSIZES`` takes the tile, any other the ``_any`` instance.
    ``u``, when given, holds one float32 uniform per element and turns on
    stochastic rounding."""
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("quantize_blockwise8 takes a contiguous 1-D float32 tensor")
    n = x.numel()
    _check_blocks(n, blocksize)
    if u is not None and (u.dtype != torch.float32 or u.numel() != n or not u.is_contiguous()):
        raise ValueError(f"u must be a contiguous float32 tensor of {n} uniforms")
    code_t = code_tuple(code)
    tensors = (x,) if u is None else (x, u)
    if not use_kernel(*tensors):
        return quantize_blockwise8_plain(x, code_t, blocksize, u)
    tables, rank, nh, shift, lo = _device_tables(code_t, str(x.device))
    q = torch.empty(n, dtype=torch.uint8, device=x.device)
    absmax = torch.empty(n // blocksize, dtype=torch.float32, device=x.device)
    if n == 0:
        return q, absmax
    if blocksize not in QUANTIZE_BLOCKSIZES:
        err = _lib.lib().bnb_quantize_blockwise8_any(
            x.data_ptr(), None if u is None else u.data_ptr(), q.data_ptr(), absmax.data_ptr(),
            n, blocksize, tables.data_ptr(), len(code_t), rank, nh, shift, lo, _lib.stream(x),
        )
        _lib.check(err, "quantize_blockwise8_any")
        _lib.LAUNCHES["quantize_blockwise8_any"] += 1
        return q, absmax
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    err = _lib.lib().bnb_quantize_blockwise8(
        x.data_ptr(), None if u is None else u.data_ptr(), q.data_ptr(), absmax.data_ptr(),
        n, blocksize, tables.data_ptr(), len(code_t), rank, nh, shift, lo, _lib.stream(x),
    )
    _lib.check(err, "quantize_blockwise8")
    _lib.LAUNCHES["quantize_blockwise8"] += 1
    return q, absmax


def dequantize_blockwise8_plain(q: torch.Tensor, absmax: torch.Tensor, code_t: tuple,
                                blocksize: int, dtype) -> torch.Tensor:
    table = torch.tensor(_tables(code_t)[0], dtype=torch.float32, device=q.device)
    vals = table[q.reshape(-1).long()].reshape(-1, blocksize)
    return (vals * absmax.to(torch.float32)[:, None]).reshape(-1).to(dtype)


def dequantize_blockwise8(q: torch.Tensor, absmax: torch.Tensor, code, blocksize: int,
                          dtype=torch.float32) -> torch.Tensor:
    """``code[q] * absmax[block]`` -> 1-D ``dtype`` (float32, bfloat16 or
    float16 on CUDA).  ``q`` is a contiguous uint8 tensor of whole blocks,
    ``absmax`` float32 with one entry per block.  A blocksize that is a
    multiple of 8 takes the 8-code kernel, any other the ``_any``
    instance."""
    n = q.numel()
    _check_blocks(n, blocksize)
    if q.dtype != torch.uint8 or not q.is_contiguous():
        raise ValueError("q must be a contiguous uint8 tensor")
    if absmax.dtype != torch.float32 or absmax.numel() != n // blocksize or not absmax.is_contiguous():
        raise ValueError(f"absmax must be a contiguous float32 tensor of {n // blocksize} blocks")
    code_t = code_tuple(code)
    if not use_kernel(q, absmax):
        return dequantize_blockwise8_plain(q, absmax, code_t, blocksize, dtype)
    if dtype not in _OUT_KINDS:
        raise ValueError(f"the CUDA kernel writes float32, bfloat16 or float16, not {dtype}")
    out = torch.empty(n, dtype=dtype, device=q.device)
    if n == 0:
        return out
    tables = _device_tables(code_t, str(q.device))[0]
    if blocksize % 8:
        err = _lib.lib().bnb_dequantize_blockwise8_any(
            q.data_ptr(), absmax.data_ptr(), out.data_ptr(), n, blocksize, tables.data_ptr(), _OUT_KINDS[dtype],
            _lib.stream(q),
        )
        _lib.check(err, "dequantize_blockwise8_any")
        _lib.LAUNCHES["dequantize_blockwise8_any"] += 1
        return out
    if q.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("the kernel needs 16-byte aligned tensors")
    err = _lib.lib().bnb_dequantize_blockwise8(
        q.data_ptr(), absmax.data_ptr(), out.data_ptr(), n, blocksize, tables.data_ptr(), _OUT_KINDS[dtype],
        _lib.stream(q),
    )
    _lib.check(err, "dequantize_blockwise8")
    _lib.LAUNCHES["dequantize_blockwise8"] += 1
    return out
