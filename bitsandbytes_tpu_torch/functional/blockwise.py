"""Blockwise 8-bit quantization against a 256-entry codebook.

Counterpart of the JAX package's ``functional/blockwise.py``.  The input is
flattened, padded with zeros to whole blocks and quantized per block of
``blocksize`` elements (kernels 12 and 13 of ``ops/blockwise8.py`` on CUDA,
their plain versions on the CPU):

  scaled  = clip(x * (1 / absmax_block), -1, 1)
  q       = #{midpoints(code) < scaled}        (ties round down)
  dequant = code[q] * absmax_block, cast to dtype

``nested=True`` quantizes the absmax once more, at blocksize 256 after
subtracting its mean, as the reference's double quantization does.  The
port follows the JAX package's kernel tier, which on an all-zero block gives
code 0 where its jnp tier gives 255.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.blockwise8 import dequantize_blockwise8, quantize_blockwise8
from .codebooks import create_dynamic_map, is_dynamic_map
from .quant_state import QuantState

__all__ = [
    "VALID_BLOCKSIZES",
    "blockwise_absmax",
    "fixed_order_mean",
    "quantize_blockwise",
    "dequantize_blockwise",
    "quantize_blockwise_with_code",
    "dequantize_blockwise_with_code",
]

VALID_BLOCKSIZES = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _pad_to_blocks(flat: torch.Tensor, blocksize: int) -> torch.Tensor:
    rem = flat.numel() % blocksize
    if rem:
        flat = torch.nn.functional.pad(flat, (0, blocksize - rem))
    return flat


def blockwise_absmax(A: torch.Tensor, blocksize: int) -> torch.Tensor:
    """Per-block max |x| over the row-major flattened input, float32
    ``[ceil(n/blocksize)]``."""
    flat = _pad_to_blocks(A.reshape(-1).to(torch.float32), blocksize)
    return flat.reshape(-1, blocksize).abs().amax(dim=-1)


def quantize_blockwise_with_code(
    A: torch.Tensor, code, blocksize: int, u: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize to uint8 codebook indices: ``(q[A.shape], absmax)``.  ``u``,
    one uniform per element of ``A``, rounds stochastically."""
    flat = A.reshape(-1).to(torch.float32).contiguous()
    n = flat.numel()
    padded = _pad_to_blocks(flat, blocksize)
    if u is not None:
        u = _pad_to_blocks(u.reshape(-1).to(torch.float32), blocksize).contiguous()
    q, absmax = quantize_blockwise8(padded, code, blocksize, u)
    return q[:n].reshape(A.shape), absmax


def dequantize_blockwise_with_code(
    A: torch.Tensor, absmax: torch.Tensor, code, blocksize: int, dtype
) -> torch.Tensor:
    """Dequantize uint8 codebook indices: the product in float32, cast to
    ``dtype`` at the end."""
    flat = A.reshape(-1).contiguous()
    n = flat.numel()
    padded = _pad_to_blocks(flat, blocksize)
    am = absmax.reshape(-1).to(torch.float32).contiguous()
    if dtype in (torch.float32, torch.bfloat16, torch.float16):
        out = dequantize_blockwise8(padded, am, code, blocksize, dtype)
    else:
        out = dequantize_blockwise8(padded, am, code, blocksize, torch.float32).to(dtype)
    return out[:n].reshape(A.shape)


def fixed_order_mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean of a 1-D float32 tensor, summed in float64 as a pairwise
    tree of elementwise adds: one fixed order, so the CPU and the card give
    the same bits (a reduction kernel sums in an order of its own).  It is
    the correctly rounded mean in every draw tested; the JAX package's
    ``jnp.mean`` sums in float32 and lands up to 3 ulp from it.
    """
    v = x.reshape(-1).to(torch.float64)
    n = v.numel()
    size = 1
    while size < n:
        size *= 2
    v = torch.nn.functional.pad(v, (0, size - n))
    while v.numel() > 1:
        half = v.numel() // 2
        v = v[:half] + v[half:]
    return (v.reshape(()) / n).to(torch.float32)


def quantize_blockwise(
    A: torch.Tensor,
    code=None,
    blocksize: int = 4096,
    nested: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, QuantState]:
    """Blockwise 8-bit quantization, with the dynamic codebook by default.

    ``nested=True`` double-quantizes the absmax (blocksize 256, after
    subtracting its mean).  ``generator`` turns on stochastic rounding: one
    uniform per element is drawn from it, on ``A``'s device, and handed to
    the kernel."""
    if blocksize not in VALID_BLOCKSIZES:
        raise ValueError(f"blocksize {blocksize} not in {VALID_BLOCKSIZES}")
    if code is None:
        code = create_dynamic_map()
    dynamic = is_dynamic_map(code)  # once, here: never per call
    u = None
    if generator is not None:
        u = torch.rand(A.numel(), generator=generator, device=A.device, dtype=torch.float32)
    q, absmax = quantize_blockwise_with_code(A, code, blocksize, u)
    if not isinstance(code, torch.Tensor):
        code = torch.from_numpy(np.array(code, dtype=np.float32))
    code_t = code.to(device=A.device, dtype=torch.float32)
    offset = state2 = None
    if nested:
        offset = fixed_order_mean(absmax)
        absmax, state2 = quantize_blockwise(absmax - offset, blocksize=256)
    state = QuantState(
        absmax=absmax, code=code_t, blocksize=blocksize, quant_type="8bit", dtype=A.dtype,
        shape=tuple(A.shape), offset=offset, state2=state2, dynamic_code=dynamic,
    )
    return q, state


def dequantize_blockwise(
    A: torch.Tensor,
    quant_state: Optional[QuantState] = None,
    absmax: Optional[torch.Tensor] = None,
    code=None,
    blocksize: int = 4096,
    dtype=torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`."""
    if quant_state is not None:
        absmax = quant_state.dequant_absmax()
        # the static flag, not the code tensor: no device read per call
        code = create_dynamic_map() if quant_state.dynamic_code else quant_state.code
        blocksize = quant_state.blocksize
        dtype = quant_state.dtype
    if code is None:
        code = create_dynamic_map()
    if absmax is None:
        raise ValueError("either quant_state or absmax must be provided")
    out = dequantize_blockwise_with_code(A, absmax, code, blocksize, dtype)
    if quant_state is not None:
        out = out.reshape(quant_state.shape)
    return out
