"""QuantState: the metadata that describes a blockwise-quantized tensor.

Counterpart of the JAX package's ``functional/quant_state.py``.  A plain
dataclass of tensors and static fields; the tensors live on the device the
payload lives on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .codebooks import get_4bit_code
from .dynamic_segments import dequant_nested_dynamic

__all__ = ["QuantState"]


@dataclasses.dataclass
class QuantState:
    """Attributes:
      absmax: per-block scale, ``[nblocks]`` in the flat and 2d layouts,
        stored transposed ``[K/blocksize, N]`` in the ``"paired"`` layout (the
        kernels' orientation, so decode pays no per-call transpose).  float32,
        or uint8 codes when the state is nested.
      code: the codebook, float32 (16 entries for 4-bit types, 256 for 8-bit).
      blocksize, quant_type, dtype (the dequantized dtype), shape.
      offset, state2: the double-quantized absmax (``compress_statistics``):
        ``offset`` is the mean that was subtracted, a one-element float32
        tensor, and ``state2`` the 8-bit state of the absmax codes (blocksize
        256 over the flat block order).
      layout: ``"flat"`` ([(n+1)//2, 1] bytes, K-adjacent pairs, the interop
        order), ``"2d"`` (the same bytes as [N, K/2]) or ``"paired"``
        ([N/2, K], rows 2i and 2i+1 share a byte).
      dynamic_code: ``code`` is the canonical signed dynamic map.  Decided
        when the state is built or carried across, and kept here, so that no
        matmul reads the code back from the device to find out.
    """

    absmax: torch.Tensor
    code: torch.Tensor
    blocksize: int
    quant_type: str
    dtype: torch.dtype
    shape: tuple
    offset: Optional[torch.Tensor] = None
    state2: Optional["QuantState"] = None
    layout: str = "flat"
    dynamic_code: bool = False

    @property
    def nested(self) -> bool:
        return self.state2 is not None

    @property
    def inline_nested(self) -> bool:
        """A nested state the ``_dq`` kernels decode in place, in any layout:
        nested blocksize 256 over the canonical dynamic map, an offset."""
        return (
            self.nested
            and self.state2.blocksize == 256
            and self.state2.dynamic_code
            and self.offset is not None
        )

    def _nested_codes_flat(self) -> torch.Tensor:
        codes = self.absmax
        if self.layout == "paired":
            codes = codes.t()  # stored [K/bs, N] -> canonical [N, K/bs]
        return codes.reshape(-1)

    def dequant_absmax(self) -> torch.Tensor:
        """f32 per-block absmax in the canonical flat block order, resolving
        a double quantization.  Over the canonical dynamic map the codes
        decode by segment arithmetic with fused multiply-adds, as the JAX
        package's jitted decode and the ``_dq`` kernels do; another map takes
        the table lookup, ``code2[q] * absmax2 + offset``.  Everything stays
        on the codes' device with no read back to the host: the K-adjacent
        routes of ``functional/gemm.py`` call this before each call of
        kernel 11, and before every call on a state that is not
        ``inline_nested``."""
        if not self.nested:
            if self.layout == "paired":
                return self.absmax.t().reshape(-1)
            return self.absmax.reshape(-1)
        codes = self._nested_codes_flat()
        st2 = self.state2
        if st2.dynamic_code:
            flat = torch.arange(codes.numel(), device=codes.device)
            return dequant_nested_dynamic(codes, st2.absmax, self.offset, flat, st2.blocksize)
        from .blockwise import dequantize_blockwise_with_code

        absmax = dequantize_blockwise_with_code(codes, st2.absmax, st2.code, st2.blocksize, torch.float32)
        return absmax + self.offset.reshape(()).to(torch.float32)

    def dequant_absmax_t(self) -> torch.Tensor:
        """Per-block absmax in the kernels' orientation ``[K/blocksize, N]``;
        free for a plain paired state, one decode or transpose otherwise."""
        if not self.nested and self.layout == "paired":
            return self.absmax
        N, K = int(self.shape[-2]), int(self.shape[-1])
        return self.dequant_absmax().reshape(N, K // self.blocksize).t().contiguous()

    def resolve_nested(self) -> "QuantState":
        """A plain copy with the double-quantized absmax decoded to float32
        once, in each layout's own orientation; bit-identical outputs."""
        if not self.nested:
            return self
        absmax = self.dequant_absmax()
        if self.layout == "paired":
            N, K = int(self.shape[-2]), int(self.shape[-1])
            absmax = absmax.reshape(N, K // self.blocksize).t().contiguous()
        return dataclasses.replace(self, absmax=absmax, offset=None, state2=None)

    @classmethod
    def make(cls, absmax, shape, quant_type, blocksize, dtype, offset=None, state2=None,
             layout="flat") -> "QuantState":
        code = torch.from_numpy(get_4bit_code(quant_type, blocksize).copy()).to(absmax.device)
        return cls(
            absmax=absmax,
            code=code,
            blocksize=blocksize,
            quant_type=quant_type,
            dtype=dtype,
            shape=tuple(int(s) for s in shape),
            offset=offset,
            state2=state2,
            layout=layout,
        )
