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

__all__ = ["QuantState"]


@dataclasses.dataclass
class QuantState:
    """Attributes:
      absmax: per-block f32 scale, ``[nblocks]`` in the flat and 2d layouts,
        stored transposed ``[K/blocksize, N]`` in the ``"paired"`` layout (the
        kernels' orientation, so decode pays no per-call transpose).
      code: the 16-entry codebook, float32.
      blocksize, quant_type, dtype (the dequantized dtype), shape.
      offset, state2: the double-quantized absmax.  The fields exist for the
        checkpoint format, but this port does not produce or read them yet.
      layout: ``"flat"`` ([(n+1)//2, 1] bytes, K-adjacent pairs, the interop
        order), ``"2d"`` (the same bytes as [N, K/2]) or ``"paired"``
        ([N/2, K], rows 2i and 2i+1 share a byte).
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

    @property
    def nested(self) -> bool:
        return self.state2 is not None

    def _require_plain(self) -> None:
        if self.nested:
            raise NotImplementedError("double-quantized absmax is not supported by this port yet")

    def dequant_absmax(self) -> torch.Tensor:
        """f32 per-block absmax in the canonical flat block order."""
        self._require_plain()
        if self.layout == "paired":
            return self.absmax.t().reshape(-1)
        return self.absmax.reshape(-1)

    def dequant_absmax_t(self) -> torch.Tensor:
        """Per-block absmax in the kernels' orientation ``[K/blocksize, N]``;
        free for the paired layout, one transpose for the others."""
        self._require_plain()
        if self.layout == "paired":
            return self.absmax
        N, K = int(self.shape[-2]), int(self.shape[-1])
        return self.absmax.reshape(N, K // self.blocksize).t().contiguous()

    @classmethod
    def make(cls, absmax, shape, quant_type, blocksize, dtype, layout="flat") -> "QuantState":
        code = torch.from_numpy(get_4bit_code(quant_type, blocksize).copy()).to(absmax.device)
        return cls(
            absmax=absmax,
            code=code,
            blocksize=blocksize,
            quant_type=quant_type,
            dtype=dtype,
            shape=tuple(int(s) for s in shape),
            layout=layout,
        )
