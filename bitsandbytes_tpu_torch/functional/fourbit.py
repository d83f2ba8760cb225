"""4-bit blockwise quantization: NF4 / FP4 / int4 / af4.

Counterpart of the JAX package's ``functional/fourbit.py``.  The flattened
tensor is quantized in blocks of ``blocksize`` elements (the quantize kernel
of ``ops/quant4bit.py`` on CUDA, its plain version on the CPU), then the
codes are packed in one of three byte layouts:

* ``"flat"``: ``packed[j] = (q[2j] << 4) | q[2j+1]``, shape ``[(n+1)//2, 1]``
  (the checkpoint interop order);
* ``"2d"``: the same bytes viewed as ``[N, K/2]``;
* ``"paired"``: ``[N/2, K]``, ``byte[n2, k] = (q[2n2, k] << 4) | q[2n2+1, k]``,
  with the absmax stored transposed ``[K/blocksize, N]`` (the decode kernels'
  layout, ``ops/gemm4bit_paired.py``).

The input is upcast to float32 before quantizing, so bf16 weights quantize
exactly as the JAX package quantizes them.

``compress_statistics=True`` double-quantizes the absmax, as the reference's
``bnb_4bit_use_double_quant``: its mean is subtracted and the rest quantized
to uint8 over the dynamic map at blocksize 256 (the blockwise-8 quantize
kernel), over the flat block order.  The paired layout stores the uint8
codes transposed ``[K/blocksize, N]``, as it stores an f32 absmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.gemm4bit_paired import pack_npaired, repack_npaired_to_2d
from ..ops.quant4bit import quantize_4bit_codes
from .blockwise import fixed_order_mean, quantize_blockwise
from .codebooks import get_4bit_code
from .quant_state import QuantState

__all__ = [
    "VALID_4BIT_BLOCKSIZES",
    "quantize_4bit",
    "dequantize_4bit",
    "pack_4bit",
    "unpack_4bit",
    "quantize_nf4",
    "quantize_fp4",
    "dequantize_nf4",
    "dequantize_fp4",
]

VALID_4BIT_BLOCKSIZES = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def pack_4bit(q: torch.Tensor) -> torch.Tensor:
    """Pack flat 4-bit codes (even length) pairwise, high nibble first."""
    q = q.reshape(-1).to(torch.uint8)
    return (q[0::2] << 4) | q[1::2]


def unpack_4bit(packed: torch.Tensor) -> torch.Tensor:
    """Unpack bytes into flat 4-bit codes: ``out[2j] = hi, out[2j+1] = lo``."""
    flat = packed.reshape(-1)
    return torch.stack([flat >> 4, flat & 0xF], dim=-1).reshape(-1)


def quantize_4bit(
    A: torch.Tensor,
    blocksize: int = 64,
    quant_type: str = "nf4",
    compress_statistics: bool = False,
    layout: str = "flat",
):
    """Quantize ``A`` to packed 4-bit codes.  Returns ``(packed, QuantState)``.

    ``layout="2d"`` and ``"paired"`` need a 2-D input with
    ``K % blocksize == 0`` (and an even N for ``"paired"``).  With
    ``compress_statistics`` the state is nested: its offset is the absmax's
    mean, summed in one fixed order (the CPU and the card agree bit for bit;
    the JAX package's ``jnp.mean`` may differ by a few ulp, and then a nested
    code near a rounding midpoint may differ by one step)."""
    if blocksize not in VALID_4BIT_BLOCKSIZES:
        raise ValueError(f"blocksize {blocksize} not in {VALID_4BIT_BLOCKSIZES}")
    if layout not in ("flat", "2d", "paired"):
        raise ValueError(f"layout must be 'flat', '2d' or 'paired', got {layout!r}")
    if layout == "2d" and (A.dim() != 2 or A.shape[-1] % blocksize or A.shape[-1] % 2):
        raise ValueError("layout='2d' requires a 2-D input with K % blocksize == 0")
    if layout == "paired" and (A.dim() != 2 or A.shape[-1] % blocksize or A.shape[0] % 2):
        raise ValueError("layout='paired' requires a 2-D input with K % blocksize == 0 and even N")

    n = A.numel()
    x = A.reshape(-1).to(torch.float32).contiguous()
    if n % blocksize:
        x = torch.nn.functional.pad(x, (0, blocksize - n % blocksize))
    codes, absmax = quantize_4bit_codes(x, quant_type, blocksize)
    offset = state2 = None
    if compress_statistics:
        offset = fixed_order_mean(absmax)
        absmax, state2 = quantize_blockwise(absmax - offset, blocksize=256)

    if layout == "paired":
        N, K = A.shape
        packed = pack_npaired(codes[:n].reshape(N, K))
        absmax = absmax.reshape(N, K // blocksize).t().contiguous()
    else:
        # an odd tail pairs with the code of a padded zero, as in the JAX package
        packed = pack_4bit(codes[: n + n % 2]).reshape(-1, 1)
        if layout == "2d":
            packed = packed.reshape(A.shape[0], -1)
    state = QuantState.make(absmax, A.shape, quant_type, blocksize, A.dtype, offset=offset,
                            state2=state2, layout=layout)
    return packed, state


def dequantize_4bit(
    A: torch.Tensor,
    quant_state: Optional[QuantState] = None,
    absmax: Optional[torch.Tensor] = None,
    blocksize: int = 64,
    quant_type: str = "nf4",
    shape: Optional[tuple] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dequantize a packed 4-bit tensor to ``dtype`` (f32 products, exact).

    This is the plain tensor path on every device: the decode and prefill
    routes never call it (they use the paired kernels of
    ``ops/gemm4bit_paired.py``)."""
    if quant_state is not None:
        absmax = quant_state.dequant_absmax()
        blocksize = quant_state.blocksize
        quant_type = quant_state.quant_type
        shape = quant_state.shape
        dtype = quant_state.dtype
        if quant_state.layout == "paired":
            N, K = int(shape[-2]), int(shape[-1])
            A = repack_npaired_to_2d(A.reshape(N // 2, K))
    if shape is None or absmax is None:
        raise ValueError("either quant_state or (absmax, shape) must be provided")
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    code = torch.from_numpy(get_4bit_code(quant_type, blocksize).copy()).to(A.device)
    vals = code[unpack_4bit(A)[:n].long()]
    if n % blocksize:
        vals = torch.nn.functional.pad(vals, (0, blocksize - n % blocksize))
    out = (vals.reshape(-1, blocksize) * absmax.to(torch.float32)[:, None]).reshape(-1)
    return out[:n].reshape(shape).to(dtype)


def quantize_nf4(A, blocksize: int = 64, **kwargs):
    """``quantize_4bit(..., quant_type='nf4')`` under the reference's name."""
    return quantize_4bit(A, blocksize=blocksize, quant_type="nf4", **kwargs)


def quantize_fp4(A, blocksize: int = 64, **kwargs):
    """``quantize_4bit(..., quant_type='fp4')`` under the reference's name."""
    return quantize_4bit(A, blocksize=blocksize, quant_type="fp4", **kwargs)


def dequantize_nf4(A, quant_state=None, **kwargs):
    """``dequantize_4bit(..., quant_type='nf4')`` under the reference's name."""
    kwargs.setdefault("quant_type", "nf4")
    return dequantize_4bit(A, quant_state, **kwargs)


def dequantize_fp4(A, quant_state=None, **kwargs):
    """``dequantize_4bit(..., quant_type='fp4')`` under the reference's name."""
    kwargs.setdefault("quant_type", "fp4")
    return dequantize_4bit(A, quant_state, **kwargs)
