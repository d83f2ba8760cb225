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

``quant_storage`` reinterprets the flat and 2d payload bytes as a wider
integer type (the reference's ``bnb_4bit_quant_storage``, which lets FSDP
shard packed weights): uint8, int8, uint16 or uint32, with the float types
mapped to the unsigned integer of their width (bf16 and f16 to uint16, f32
to uint32), as the JAX package maps them, so that no payload is ever a float
tensor.  The bytes stay in their order: ``payload.view(torch.uint8)`` gives
them back.  The paired layout takes uint8 only.

A float32, bfloat16 or float16 input goes to the quantize kernel in its own
type, which upcasts it exactly in registers (the TPU kernel upcasts in VMEM);
any other type is upcast to float32 first.  Either way a bf16 weight
quantizes exactly as the JAX package quantizes it.

``compress_statistics=True`` double-quantizes the absmax, as the reference's
``bnb_4bit_use_double_quant``: its mean is subtracted and the rest quantized
to uint8 over the dynamic map at blocksize 256 (the blockwise-8 quantize
kernel), over the flat block order.  The paired layout stores the uint8
codes transposed ``[K/blocksize, N]``, as it stores an f32 absmax.

:func:`dequantize_4bit` is kernel 10 (``ops/gemm4bit.dequantize_4bit_2d``)
on CUDA, the plain version beside it on the CPU; a paired payload is repacked
to the K-adjacent order first.  A flat or 2d state whose double-quantized
absmax the ``_dq`` kernels decode in place (``QuantState.inline_nested``)
takes kernel 10's ``_dq`` mode, with no decode before the call.  The serving
routes reach the dequantize through ``functional/gemm.py``, which calls the
kernels directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.gemm4bit import dequantize_4bit_2d, dequantize_4bit_2d_dq
from ..ops.gemm4bit_paired import pack_npaired, repack_npaired_to_2d
from ..ops.quant4bit import QUANTIZE_DTYPES, quantize_4bit_codes
from .blockwise import fixed_order_mean, quantize_blockwise
from .codebooks import get_4bit_code
from .quant_state import QuantState

__all__ = [
    "VALID_4BIT_BLOCKSIZES",
    "QUANT_STORAGE_BITS",
    "storage_dtype",
    "payload_bytes",
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

# payload storage types; a float storage is the unsigned integer of its width
QUANT_STORAGE_BITS = {torch.uint8: 8, torch.int8: 8, torch.uint16: 16, torch.uint32: 32}
_STORAGE_ALIAS = {torch.float16: torch.uint16, torch.bfloat16: torch.uint16, torch.float32: torch.uint32}


def storage_dtype(quant_storage) -> torch.dtype:
    """The integer type a payload is stored in for ``quant_storage``."""
    d = _STORAGE_ALIAS.get(quant_storage, quant_storage)
    if d not in QUANT_STORAGE_BITS:
        raise ValueError(f"unsupported quant_storage {quant_storage}")
    return d


def payload_bytes(packed: torch.Tensor) -> torch.Tensor:
    """A payload of any storage type as its flat uint8 bytes (a view)."""
    if packed.dtype == torch.uint8:
        return packed
    return packed.reshape(-1).view(torch.uint8)


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
    quant_storage: torch.dtype = torch.uint8,
    generator: Optional[torch.Generator] = None,
):
    """Quantize ``A`` to packed 4-bit codes.  Returns ``(packed, QuantState)``.

    ``layout="2d"`` and ``"paired"`` need a 2-D input with
    ``K % blocksize == 0`` (and an even N for ``"paired"``).  A
    ``quant_storage`` wider than a byte gives a flat ``[bytes/width, 1]`` or
    2d ``[N, K/2/width]`` payload of the storage's integer type.  With
    ``compress_statistics`` the state is nested: its offset is the absmax's
    mean, summed in one fixed order (the CPU and the card agree bit for bit;
    the JAX package's ``jnp.mean`` may differ by a few ulp, and then a nested
    code near a rounding midpoint may differ by one step).  ``generator``
    turns on stochastic rounding (the JAX package's ``stochastic_key``): one
    uniform per element is drawn from it, on ``A``'s device, and each code
    moves to its value-adjacent neighbour with probability proportional to
    the distance; the two packages draw different uniforms, so they agree
    to rank adjacency."""
    if blocksize not in VALID_4BIT_BLOCKSIZES:
        raise ValueError(f"blocksize {blocksize} not in {VALID_4BIT_BLOCKSIZES}")
    if layout not in ("flat", "2d", "paired"):
        raise ValueError(f"layout must be 'flat', '2d' or 'paired', got {layout!r}")
    if layout == "2d" and (A.dim() != 2 or A.shape[-1] % blocksize or A.shape[-1] % 2):
        raise ValueError("layout='2d' requires a 2-D input with K % blocksize == 0")
    if layout == "paired" and (A.dim() != 2 or A.shape[-1] % blocksize or A.shape[0] % 2):
        raise ValueError("layout='paired' requires a 2-D input with K % blocksize == 0 and even N")
    storage = storage_dtype(quant_storage)
    if layout == "paired" and storage != torch.uint8:
        raise ValueError("layout='paired' stores uint8 bytes only")

    n = A.numel()
    x = A.reshape(-1).contiguous()
    if x.dtype not in QUANTIZE_DTYPES:
        x = x.to(torch.float32)
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16-byte words
        x = x.clone()
    u = None
    if generator is not None:
        u = torch.rand(x.numel(), generator=generator, device=x.device, dtype=torch.float32)
    if n % blocksize:
        x = torch.nn.functional.pad(x, (0, blocksize - n % blocksize))
        if u is not None:
            u = torch.nn.functional.pad(u, (0, blocksize - n % blocksize))
    codes, absmax = quantize_4bit_codes(x, quant_type, blocksize, u)
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
        packed = pack_4bit(codes[: n + n % 2])
        if storage != torch.uint8:
            if packed.numel() % (QUANT_STORAGE_BITS[storage] // 8):
                raise ValueError(f"{packed.numel()} payload bytes do not fill whole {storage} words")
            packed = packed.view(storage)
        packed = packed.reshape(-1, 1)
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
    """Dequantize a packed 4-bit tensor to ``dtype``: the exact f32 product
    ``code[q] * absmax``, rounded to ``dtype``.  Kernel 10 on CUDA (bf16,
    f16 or f32), its plain version on the CPU; a payload of a wider storage
    type is read as its bytes, a paired one repacked first.  A flat or 2d
    state's nested absmax is decoded in the kernel (its ``_dq`` mode); a
    paired one's, or one over another map, on the device first."""
    in_kernel = False
    if quant_state is not None:
        blocksize = quant_state.blocksize
        quant_type = quant_state.quant_type
        shape = quant_state.shape
        dtype = quant_state.dtype
        in_kernel = quant_state.layout != "paired" and quant_state.inline_nested
        if not in_kernel:
            absmax = quant_state.dequant_absmax()
        if quant_state.layout == "paired":
            N, K = int(shape[-2]), int(shape[-1])
            A = repack_npaired_to_2d(A.reshape(N // 2, K))
    elif shape is None or absmax is None:
        raise ValueError("either quant_state or (absmax, shape) must be provided")
    code = get_4bit_code(quant_type, blocksize)
    B = payload_bytes(A.contiguous()).reshape(-1)
    if in_kernel:
        return dequantize_4bit_2d_dq(B, quant_state.absmax.reshape(-1), quant_state.state2.absmax, quant_state.offset,
                                     code, blocksize, shape, dtype)
    return dequantize_4bit_2d(B, absmax.reshape(-1).to(torch.float32).contiguous(), code, blocksize, shape, dtype)


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
