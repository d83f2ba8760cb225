"""QuantState: the metadata that describes a blockwise-quantized tensor.

Counterpart of the JAX package's ``functional/quant_state.py``.  A plain
dataclass of tensors and static fields; the tensors live on the device the
payload lives on.  :meth:`QuantState.as_dict` and :meth:`QuantState.from_dict`
carry it through the reference's packed-dict format, the one checkpoints
(and HF Transformers' pre-quantized bnb checkpoints) store next to a 4-bit
payload: ``absmax``, ``quant_map``, ``nested_absmax``, ``nested_quant_map``
and a JSON-in-uint8 tensor ``quant_state.bitsandbytes__{quant_type}``.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.dispatch import resolve_device
from .codebooks import get_4bit_code, is_dynamic_map
from .dynamic_segments import dequant_nested_dynamic

__all__ = ["QuantState", "dtype_name", "dtype_from_name", "host_array"]

_VALID_QUANT_TYPES = ("nf4", "fp4", "int4", "af4", "8bit")

# the key of the packed metadata tensor, followed by the quant type
_META_PREFIX = "quant_state.bitsandbytes__"


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the names the packed metadata
    holds (numpy's, never ``"torch.float32"``)."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def host_array(t) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 goes out as its uint16
    bits, since numpy has no bfloat16 of its own."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


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

    def as_dict(self, packed: bool = False) -> dict:
        """The state as a dict of numpy arrays on the host and metadata, the
        reference's serialization.  ``packed=True`` puts the metadata into a
        uint8 tensor ``quant_state.bitsandbytes__{quant_type}`` holding
        ``json.dumps(..., sort_keys=True)``, byte for byte the JAX package's.
        A paired state's absmax comes out in the canonical flat block order;
        its payload, which is not part of the dict, is still paired and needs
        ``QuantizedTensor.to_layout("flat")`` before it is stored beside it
        (``utils/serialization.py`` does that)."""
        qs_dict = {
            "quant_type": self.quant_type,
            "blocksize": self.blocksize,
            "dtype": dtype_name(self.dtype),
            "shape": tuple(int(s) for s in self.shape),
        }
        absmax = self.absmax
        if self.layout == "paired":
            absmax = absmax.t().reshape(-1)
            warnings.warn(
                "QuantState.as_dict on a 'paired'-layout state: the stats are in the flat "
                "interop order, but the payload is not part of this dict; convert the tensor "
                "with to_layout('flat') before storing payload and stats together "
                "(utils.serialization.state_dict_from_params does this).",
                stacklevel=2,
            )
        tensors = {"absmax": host_array(absmax), "quant_map": host_array(self.code)}
        if self.nested:
            qs_dict.update(
                {
                    "nested_blocksize": self.state2.blocksize,
                    "nested_dtype": dtype_name(self.state2.dtype),
                    "nested_offset": float(self.offset.item()),
                }
            )
            tensors["nested_absmax"] = host_array(self.state2.absmax)
            tensors["nested_quant_map"] = host_array(self.state2.code)
        if not packed:
            return {**qs_dict, **tensors}
        meta = json.dumps(qs_dict, sort_keys=True).encode("utf8")
        return {**tensors, _META_PREFIX + self.quant_type: np.frombuffer(meta, dtype=np.uint8).copy()}

    @classmethod
    def from_dict(cls, qs_dict: dict, device=None) -> "QuantState":
        """Rebuild a state from :meth:`as_dict`'s output, packed or not, with
        numpy arrays or tensors as its arrays, on ``device`` (CUDA unless
        named).  The layout is ``"flat"``.  Whether the nested map is the
        canonical dynamic map is decided here, on the host, once."""
        from ..utils.interop import as_device_tensor as _to_tensor

        device = resolve_device(device)
        qs_dict = dict(qs_dict)
        meta_key = next((k for k in qs_dict if k.startswith(_META_PREFIX)), None)
        if meta_key is not None:
            meta = host_array(qs_dict.pop(meta_key)).astype(np.uint8, copy=False)
            qs_dict.update(json.loads(meta.tobytes().decode("utf8")))
        quant_type = qs_dict["quant_type"]
        if quant_type not in _VALID_QUANT_TYPES:
            raise ValueError(f"invalid quant_type {quant_type!r}")
        absmax = _to_tensor(qs_dict["absmax"], device)
        offset = state2 = None
        if "nested_absmax" in qs_dict:
            nested_code = qs_dict["nested_quant_map"]
            offset = torch.tensor(float(qs_dict["nested_offset"]), dtype=torch.float32, device=device)
            state2 = cls(
                absmax=_to_tensor(qs_dict["nested_absmax"], device),
                code=_to_tensor(nested_code, device),
                blocksize=int(qs_dict["nested_blocksize"]),
                quant_type="8bit",
                dtype=dtype_from_name(qs_dict["nested_dtype"]),
                shape=(absmax.numel(),),
                dynamic_code=is_dynamic_map(nested_code),  # read on the host, as given
            )
        return cls(
            absmax=absmax,
            code=_to_tensor(qs_dict["quant_map"], device),
            blocksize=int(qs_dict["blocksize"]),
            quant_type=quant_type,
            dtype=dtype_from_name(qs_dict["dtype"]),
            shape=tuple(int(s) for s in qs_dict["shape"]),
            offset=offset,
            state2=state2,
        )

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
