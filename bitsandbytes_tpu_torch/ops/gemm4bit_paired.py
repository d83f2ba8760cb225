"""N-paired 4-bit payload: layout helpers, the decode GEMM and the dequantize.

Counterpart of the JAX package's ``ops/pallas/gemm4bit_paired.py``.  The
byte at ``[n2, k]`` holds weight rows ``2*n2`` (high nibble) and ``2*n2+1``
(low nibble) at column ``k``; quantization blocks still run along K per row,
and the absmax is stored transposed ``[K/blocksize, N]``.

Two kernels, both in ``csrc/gemm4bit_paired.cu``:

* :func:`gemm_4bit_paired` replaces ``gemm_4bit_paired`` (``_paired_kernel``):
  ``out[M, N] = A[M, K] @ dequant(P)^T`` with bf16-rounded unit codes, an f32
  partial dot per quant block scaled by the f32 absmax and summed in f32.
  Bound by bytes at decode M (the payload is N*K/2 bytes); one warp streams
  one row pair along K with A staged in shared memory.
* :func:`dequantize_paired_fast` replaces ``dequantize_paired_fast``
  (``_paired_dequant_kernel``): ``W[N, K] = bf16(unit(code) * absmax)`` for the
  large-M route.  Bound by bytes (N*K/2 read, N*K*2 written); one pass.

A CPU tensor goes to the plain version of each, written to the same
numerics; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _lib
from .dispatch import use_kernel

__all__ = [
    "pack_npaired",
    "unpack_npaired",
    "repack_2d_to_npaired",
    "repack_npaired_to_2d",
    "decode_units",
    "gemm_4bit_paired",
    "gemm_4bit_paired_plain",
    "dequantize_paired_fast",
    "dequantize_paired_fast_plain",
]

# Quant blocks per batched product in the plain GEMM: bounds its
# [blocks, M, N] f32 intermediate.
_PLAIN_BLOCK_CHUNK = 16


def pack_npaired(q: torch.Tensor) -> torch.Tensor:
    """Pack codes ``q [N, K]`` along N: ``byte[n2, k] = q[2n2, k] << 4 | q[2n2+1, k]``."""
    q = q.to(torch.uint8)
    return (q[0::2, :] << 4) | q[1::2, :]


def unpack_npaired(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_npaired`: ``[N/2, K] -> [N, K]`` codes."""
    n2, K = packed.shape
    return torch.stack([packed >> 4, packed & 0xF], dim=1).reshape(2 * n2, K)


def repack_2d_to_npaired(packed_2d: torch.Tensor, shape) -> torch.Tensor:
    """K-adjacent pair layout ``[N, K/2]`` (interop order) -> ``[N/2, K]``."""
    N, K = shape
    flat = packed_2d.reshape(N, K // 2)
    q = torch.stack([flat >> 4, flat & 0xF], dim=-1).reshape(N, K)
    return pack_npaired(q)


def repack_npaired_to_2d(packed_p: torch.Tensor) -> torch.Tensor:
    """Inverse relayout: ``[N/2, K] -> [N, K/2]`` interop byte order."""
    q = unpack_npaired(packed_p)
    N, K = q.shape
    pairs = q.reshape(N, K // 2, 2)
    return (pairs[..., 0] << 4) | pairs[..., 1]


@functools.lru_cache(maxsize=None)
def _units(code_t: tuple) -> tuple:
    """bf16-rounded (nearest even) codebook entries as f32 floats."""
    t = torch.tensor(code_t, dtype=torch.float32).to(torch.bfloat16).to(torch.float32)
    return tuple(float(x) for x in t)


def _code_tuple(code) -> tuple:
    return tuple(float(x) for x in np.asarray(code, dtype=np.float32).reshape(-1)[:16])


def decode_units(P: torch.Tensor, units: tuple) -> torch.Tensor:
    """Paired bytes ``[N/2, K]`` -> f32 unit values ``[N, K]`` in row order."""
    table = torch.tensor(units, dtype=torch.float32, device=P.device)
    n2, K = P.shape
    hi = table[(P >> 4).long()]
    lo = table[(P & 0xF).long()]
    return torch.stack([hi, lo], dim=1).reshape(2 * n2, K)


def gemm_4bit_paired_plain(A2, P, absmax_t, units, blocksize: int) -> torch.Tensor:
    """``A2 [M, K]`` -> f32 ``[M, N]``: one f32 sub-dot per quant block times
    its f32 absmax, summed in f32."""
    M, K = A2.shape
    U = decode_units(P, units)
    N = U.shape[0]
    nb = K // blocksize
    A3 = A2.to(torch.float32).reshape(M, nb, blocksize).transpose(0, 1)  # [nb, M, bs]
    U3 = U.reshape(N, nb, blocksize).permute(1, 2, 0)  # [nb, bs, N]
    out = torch.zeros(M, N, dtype=torch.float32, device=A2.device)
    for c in range(0, nb, _PLAIN_BLOCK_CHUNK):
        sub = torch.bmm(A3[c : c + _PLAIN_BLOCK_CHUNK], U3[c : c + _PLAIN_BLOCK_CHUNK])
        out += (sub * absmax_t[c : c + _PLAIN_BLOCK_CHUNK, None, :]).sum(0)
    return out


def _check_payload(P, absmax_t, N: int, K: int, blocksize: int) -> None:
    if P.dtype != torch.uint8 or tuple(P.shape) != (N // 2, K) or not P.is_contiguous():
        raise ValueError(f"P must be a contiguous uint8 [{N // 2}, {K}] tensor")
    if (
        absmax_t.dtype != torch.float32
        or tuple(absmax_t.shape) != (K // blocksize, N)
        or not absmax_t.is_contiguous()
    ):
        raise ValueError(f"absmax_t must be a contiguous float32 [{K // blocksize}, {N}] tensor")


def _check_aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernels need 16-byte aligned tensors")


def gemm_4bit_paired(
    A: torch.Tensor,
    P: torch.Tensor,
    absmax_t: torch.Tensor,
    code,
    blocksize: int,
    shapeB: tuple,
    out_dtype=None,
) -> torch.Tensor:
    """Fused ``A @ dequant(B)^T`` over the N-paired layout.

    ``A [..., K]``; ``P [N/2, K]`` uint8; ``absmax_t [K/blocksize, N]`` f32;
    ``code`` the 16-entry codebook; ``shapeB = (N, K)``.  Returns
    ``[..., N]`` in ``out_dtype`` (default ``A.dtype``).  On CUDA, A must be
    contiguous bf16 and the output bf16 or f32."""
    N, K = (int(s) for s in shapeB)
    if N % 2 or blocksize < 32 or K % blocksize or A.shape[-1] != K:
        raise ValueError(f"unsupported shape: A {tuple(A.shape)}, B {(N, K)}, blocksize {blocksize}")
    _check_payload(P, absmax_t, N, K, blocksize)
    lead = tuple(A.shape[:-1])
    M = 1
    for s in lead:
        M *= s
    out_dtype = out_dtype or A.dtype
    units = _units(_code_tuple(code))
    if not use_kernel(A, P, absmax_t):
        out = gemm_4bit_paired_plain(A.reshape(M, K), P, absmax_t, units, blocksize)
        return out.to(out_dtype).reshape(*lead, N)
    if A.dtype != torch.bfloat16 or not A.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous bf16 A")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel writes bf16 or float32, not {out_dtype}")
    if M == 0:
        return torch.empty(*lead, N, dtype=out_dtype, device=A.device)
    _check_aligned(A, P, absmax_t)
    out = torch.empty(M, N, dtype=out_dtype, device=A.device)
    err = _lib.lib().bnb_gemm_4bit_paired(
        A.data_ptr(), P.data_ptr(), absmax_t.data_ptr(), out.data_ptr(),
        M, N, K, blocksize, _lib.host_f32(units), int(out_dtype == torch.bfloat16),
        _lib.stream(A),
    )
    _lib.check(err, "gemm_4bit_paired")
    _lib.LAUNCHES["gemm_4bit_paired"] += 1
    return out.reshape(*lead, N)


def dequantize_paired_fast_plain(P, absmax_t, units, blocksize: int, dtype) -> torch.Tensor:
    U = decode_units(P, units)
    scale = absmax_t.t().repeat_interleave(blocksize, dim=1)
    return (U * scale).to(dtype)


def dequantize_paired_fast(P, absmax_t, code, blocksize: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Paired payload ``[N/2, K]`` -> weight ``[N, K]`` in ``dtype`` (bf16 on
    CUDA): ``bf16(unit(code) * absmax)`` with the product in exact f32."""
    N2, K = P.shape
    N = 2 * N2
    if blocksize < 8 or K % blocksize:
        raise ValueError(f"unsupported shape: B {(N, K)}, blocksize {blocksize}")
    _check_payload(P, absmax_t, N, K, blocksize)
    units = _units(_code_tuple(code))
    if not use_kernel(P, absmax_t):
        return dequantize_paired_fast_plain(P, absmax_t, units, blocksize, dtype)
    if dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel writes bf16")
    _check_aligned(P, absmax_t)
    W = torch.empty(N, K, dtype=torch.bfloat16, device=P.device)
    err = _lib.lib().bnb_dequantize_paired(
        P.data_ptr(), absmax_t.data_ptr(), W.data_ptr(), N, K, blocksize,
        _lib.host_f32(units), _lib.stream(P),
    )
    _lib.check(err, "dequantize_paired_fast")
    _lib.LAUNCHES["dequantize_paired_fast"] += 1
    return W
