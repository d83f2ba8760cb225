"""4-bit blockwise quantize: kernel wrapper and plain version.

Replaces the TPU kernel ``quantize_4bit_codes_pallas`` of the JAX package's
``ops/pallas/quant4bit.py``; the CUDA source is ``csrc/quant4bit.cu``.  It
is bound by bytes on the H100 (2 or 4 B read and 1 B written per element),
and streams tiles of 16384 elements: a lane holds 16 contiguous elements in
registers from the absmax through the compare-rank, so the input is read
once, and stores their codes as one 16-byte word.

The input is float32, bfloat16 or float16 (``QUANTIZE_DTYPES``), read in its
type and upcast in registers as the TPU kernel upcasts in VMEM; the upcast is
exact, so a 16-bit input gives the codes and absmax of its float32 copy.
Both versions take the flattened input padded with zeros to a whole number
of blocks (a blocksize in ``QUANTIZE_BLOCKSIZES``), and return unpacked
codes (one per byte) plus the f32 absmax of every block; the caller packs
the codes in its layout.  Given one f32 uniform per element (``u``), both
round stochastically as the TPU kernel's mode "u" does
(``_stochastic_move16``): the value-sorted rank moves to its neighbour
toward the scaled value with probability proportional to the distance from
the nearest code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..functional.codebooks import get_4bit_code, quantize_tables
from . import _lib
from .dispatch import use_kernel

__all__ = ["QUANTIZE_DTYPES", "QUANTIZE_BLOCKSIZES", "order_word", "quantize_4bit_codes",
           "quantize_4bit_codes_plain"]

QUANTIZE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # the C entry's x_kind
QUANTIZE_BLOCKSIZES = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _sorted_code(quant_type: str, blocksize: int) -> np.ndarray:
    """The codebook in value order (the order of the compare-rank)."""
    _, order, _ = quantize_tables(quant_type, blocksize)
    return get_4bit_code(quant_type, blocksize)[order].astype(np.float32)


def order_word(order) -> int:
    """The rank -> bit-pattern map as the kernel reads it: nibble r of a
    64-bit word, ``(word >> 4 * r) & 15 == order[r]``."""
    return sum(int(o) << (4 * r) for r, o in enumerate(order))


def quantize_4bit_codes_plain(x: torch.Tensor, quant_type: str, blocksize: int,
                              u: Optional[torch.Tensor] = None):
    """``x`` ``[n]`` (n % blocksize == 0) -> (codes u8 ``[n]``, absmax f32
    ``[n / blocksize]``), with the kernel's arithmetic on ``x`` upcast to
    f32; ``u`` f32 ``[n]`` rounds stochastically."""
    midpoints, order, identity = quantize_tables(quant_type, blocksize)
    blocks = x.to(torch.float32).reshape(-1, blocksize)
    absmax = blocks.abs().amax(dim=1)
    # 1 / max(absmax, 1e-38) as the JAX package computes it with subnormals
    # flushed: an all-zero block gets scale inf and, through NaN, rank 0
    tiny = torch.finfo(torch.float32).tiny
    scale = torch.where(absmax < tiny, torch.inf, torch.div(1.0, absmax))
    scaled = (blocks * scale[:, None]).clamp(-1.0, 1.0)
    rank = torch.zeros(scaled.shape, dtype=torch.int64, device=x.device)
    for m in midpoints.tolist():
        rank += scaled > m
    if u is not None:
        sc = torch.as_tensor(_sorted_code(quant_type, blocksize), device=x.device)
        lower = sc[rank]
        nbr = (rank + torch.where(scaled > lower, 1, -1)).clamp(0, 15)
        gap = (sc[nbr] - lower).abs()
        p_move = torch.where(gap > 0, (scaled - lower).abs() / gap.clamp(min=1e-20), 0.0)
        rank = torch.where(u.reshape(rank.shape) < p_move, nbr, rank)
    if not identity:
        rank = torch.as_tensor(order, device=x.device).long()[rank]
    return rank.to(torch.uint8).reshape(-1), absmax


def quantize_4bit_codes(x: torch.Tensor, quant_type: str, blocksize: int, u: Optional[torch.Tensor] = None):
    """Kernel on a CUDA tensor, plain version on a CPU tensor.  ``x`` is a
    contiguous 1-D tensor of a type in ``QUANTIZE_DTYPES``; ``u`` (f32, one
    uniform per element of ``x``) turns on stochastic rounding."""
    if x.dtype not in QUANTIZE_DTYPES or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("quantize_4bit_codes takes a contiguous 1-D float32, bfloat16 or float16 tensor")
    n = x.numel()
    if blocksize not in QUANTIZE_BLOCKSIZES or n % blocksize:
        raise ValueError(f"length {n} is not a multiple of a blocksize in {QUANTIZE_BLOCKSIZES}")
    if u is not None and (u.dtype != torch.float32 or u.numel() != n or not u.is_contiguous()):
        raise ValueError(f"u must be {n} contiguous float32 uniforms")
    tensors = (x,) if u is None else (x, u)
    if not use_kernel(*tensors):
        return quantize_4bit_codes_plain(x, quant_type, blocksize, u)
    midpoints, order, identity = quantize_tables(quant_type, blocksize)
    codes = torch.empty(n, dtype=torch.uint8, device=x.device)
    absmax = torch.empty(n // blocksize, dtype=torch.float32, device=x.device)
    if n == 0:
        return codes, absmax
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    err = _lib.lib().bnb_quantize_4bit_codes(
        x.data_ptr(), None if u is None else u.data_ptr(), codes.data_ptr(), absmax.data_ptr(), n, blocksize,
        _lib.host_f32(midpoints), _lib.host_f32(_sorted_code(quant_type, blocksize)), order_word(order),
        int(identity), QUANTIZE_DTYPES[x.dtype], _lib.stream(x),
    )
    _lib.check(err, "quantize_4bit_codes")
    _lib.LAUNCHES["quantize_4bit_codes"] += 1
    return codes, absmax
