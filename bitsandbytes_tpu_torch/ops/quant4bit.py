"""4-bit blockwise quantize: kernel wrapper and plain version.

Replaces the TPU kernel ``quantize_4bit_codes_pallas`` of the JAX package's
``ops/pallas/quant4bit.py``; the CUDA source is ``csrc/quant4bit.cu``.  It
is bound by bytes on the H100 (4 B read and 1 B written per element), and
reads its input once: one warp per quantization block keeps the block in
registers from the absmax through the compare-rank.

Both versions take the flattened input padded with zeros to a whole number
of blocks, and return unpacked codes (one per byte) plus the f32 absmax of
every block; the caller packs the codes in its layout.
"""

from __future__ import annotations

import torch

from ..functional.codebooks import quantize_tables
from . import _lib
from .dispatch import use_kernel

__all__ = ["quantize_4bit_codes", "quantize_4bit_codes_plain"]


def quantize_4bit_codes_plain(x: torch.Tensor, quant_type: str, blocksize: int):
    """``x`` f32 ``[n]`` (n % blocksize == 0) -> (codes u8 ``[n]``, absmax
    f32 ``[n / blocksize]``), with the kernel's arithmetic."""
    midpoints, order, identity = quantize_tables(quant_type, blocksize)
    blocks = x.reshape(-1, blocksize)
    absmax = blocks.abs().amax(dim=1)
    # 1 / max(absmax, 1e-38) as the JAX package computes it with subnormals
    # flushed: an all-zero block gets scale inf and, through NaN, rank 0
    tiny = torch.finfo(torch.float32).tiny
    scale = torch.where(absmax < tiny, torch.inf, torch.div(1.0, absmax))
    scaled = (blocks * scale[:, None]).clamp(-1.0, 1.0)
    rank = torch.zeros(scaled.shape, dtype=torch.uint8, device=x.device)
    for m in midpoints.tolist():
        rank += scaled > m
    if not identity:
        rank = torch.as_tensor(order, device=x.device).to(torch.uint8)[rank.long()]
    return rank.reshape(-1), absmax


def quantize_4bit_codes(x: torch.Tensor, quant_type: str, blocksize: int):
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("quantize_4bit_codes takes a contiguous 1-D float32 tensor")
    n = x.numel()
    if n % blocksize:
        raise ValueError(f"length {n} is not a multiple of blocksize {blocksize}")
    if not use_kernel(x):
        return quantize_4bit_codes_plain(x, quant_type, blocksize)
    midpoints, order, identity = quantize_tables(quant_type, blocksize)
    codes = torch.empty(n, dtype=torch.uint8, device=x.device)
    absmax = torch.empty(n // blocksize, dtype=torch.float32, device=x.device)
    err = _lib.lib().bnb_quantize_4bit_codes(
        x.data_ptr(), codes.data_ptr(), absmax.data_ptr(), n, blocksize,
        _lib.host_f32(midpoints), _lib.host_i32(order), int(identity), _lib.stream(x),
    )
    _lib.check(err, "quantize_4bit_codes")
    _lib.LAUNCHES["quantize_4bit_codes"] += 1
    return codes, absmax
