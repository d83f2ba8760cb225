"""Collectives over packed quantized payloads.

Counterpart of the JAX package's ``parallel/collectives.py``.  When a
4-bit weight must move, the packed payload and its absmax travel on the
wire, and each rank dequantizes after the collective (kernel 2 below
``functional/gemm.LARGE_M_THRESHOLD`` rows of A, kernel 3 and
``torch.matmul`` from it): a quarter of the bytes of a bf16 gather.

The weight arguments are this rank's shard as :class:`~.sharding.Sharded`
keeps it in ``local``: the payload piece, and a state of the full logical
shape whose absmax is this rank's piece (the whole codes of a
double-quantized state, which each rank resolves to f32 and slices before
the collective, as the JAX package does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..functional.gemm import gemm_4bit
from ..functional.quant_state import QuantState
from .mesh import Mesh

__all__ = ["all_gather_packed", "tp_gemm_4bit_allgather", "tp_gemm_4bit_ring"]


def all_gather_packed(packed_shard: torch.Tensor, absmax_shard: torch.Tensor, mesh: Mesh, axis_name: str = "model",
                      absmax_dim: int = 0):
    """Gather a packed 4-bit payload shard (along dim 0) and its absmax
    (along ``absmax_dim``: 1 for the paired layout's ``[K/bs, N]``) over
    ``axis_name``, the payload still packed.  Returns ``(packed, absmax)``."""
    return mesh.all_gather(packed_shard, axis_name, 0), mesh.all_gather(absmax_shard, axis_name, absmax_dim)


def _rows(state: QuantState, mesh: Mesh, axis_name: str):
    N = int(state.shape[0])
    s = mesh.axis_size(axis_name)
    Ns = N // s
    return N, s, Ns, mesh.index(axis_name) * Ns


def _plain(state: QuantState, absmax: torch.Tensor, shape, layout: str) -> QuantState:
    """``state``'s static fields and codebook tensor over an f32 ``absmax``."""
    return dataclasses.replace(state, absmax=absmax, shape=tuple(shape), layout=layout, offset=None, state2=None)


def _local_absmax_t(state: QuantState, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """This rank's ``[K/bs, N/s]`` f32 scales of a paired N-shard; a nested
    state is resolved whole (its codes replicate) and sliced."""
    N, s, Ns, n0 = _rows(state, mesh, axis_name)
    if state.nested:
        return state.dequant_absmax_t()[:, n0 : n0 + Ns].contiguous()
    return state.absmax.contiguous()


def tp_gemm_4bit_allgather(A: torch.Tensor, packed: torch.Tensor, state: QuantState, mesh: Mesh,
                           axis_name: str = "model", bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ZeRO-3-style 4-bit matmul: the weight lives N-split over
    ``axis_name``, ``A`` is the same on every rank.  Each rank gathers the
    packed payload and its absmax, then runs the full product, so the result
    is bit for bit the unsharded call's."""
    N, K = (int(d) for d in state.shape)
    _, s, Ns, n0 = _rows(state, mesh, axis_name)
    if state.layout == "paired":
        if N % s or Ns % 2:
            raise ValueError(f"N={N} must split into whole row pairs over {s} shards")
        p_full, am_full = all_gather_packed(packed.reshape(Ns // 2, K), _local_absmax_t(state, mesh, axis_name),
                                            mesh, axis_name, absmax_dim=1)
        out = gemm_4bit(A, p_full, _plain(state, am_full, (N, K), "paired"))
    else:
        if N % s or (Ns * K) % 2 or K % state.blocksize:
            raise ValueError(f"N={N} must split into whole packed rows of whole blocks over {s} shards")
        KB = K // state.blocksize
        if state.nested or state.absmax.numel() == N * KB:  # replicated: this rank's rows
            am = state.dequant_absmax().reshape(N, KB)[n0 : n0 + Ns].contiguous()
        else:
            am = state.absmax.reshape(Ns, KB)
        p_full, am_full = all_gather_packed(packed.reshape(Ns, -1), am, mesh, axis_name)
        full = _plain(state, am_full.reshape(-1), (N, K), state.layout)
        out = gemm_4bit(A, p_full.reshape(-1, 1) if state.layout == "flat" else p_full, full)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def tp_gemm_4bit_ring(A: torch.Tensor, packed: torch.Tensor, state: QuantState, mesh: Mesh,
                      axis_name: str = "model", bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same product with the gather overlapped: the N-split paired
    chunks circulate a ring, each rank computing on the chunk it holds while
    ``isend``/``irecv`` pass it to the previous rank and take the next.  At
    step ``t`` rank ``i`` holds chunk ``(i + t) % s`` and writes its columns
    of the f32 output.  Every chunk runs the kernels at its own N, so on
    the card a chunk's split plan (``ops/gemm4bit_paired.gemm_plan``) may
    differ from the whole weight's."""
    if state.layout != "paired":
        raise ValueError("tp_gemm_4bit_ring requires the 'paired' payload layout")
    N, K = (int(d) for d in state.shape)
    _, s, Ns, _ = _rows(state, mesh, axis_name)
    if N % s or Ns % 2:
        raise ValueError(f"N={N} must split into whole row pairs over {s} shards")
    lead = tuple(A.shape[:-1])
    A2 = A.reshape(-1, K)
    c_p = packed.reshape(Ns // 2, K).contiguous()
    c_am = _local_absmax_t(state, mesh, axis_name)
    me = mesh.index(axis_name)
    out = torch.empty(A2.shape[0], N, dtype=torch.float32, device=A.device)
    if s > 1:
        group = mesh.group(axis_name)
        ranks = dist.get_process_group_ranks(group)
        to, frm = ranks[(me - 1) % s], ranks[(me + 1) % s]
    for t in range(s):
        reqs = []
        if t < s - 1:
            nxt_p, nxt_am = torch.empty_like(c_p), torch.empty_like(c_am)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, c_p, to, group), dist.P2POp(dist.irecv, nxt_p, frm, group),
                dist.P2POp(dist.isend, c_am, to, group), dist.P2POp(dist.irecv, nxt_am, frm, group),
            ])
        chunk = _plain(state, c_am, (Ns, K), "paired")
        src = (me + t) % s
        out[:, src * Ns : (src + 1) * Ns] = gemm_4bit(A2, c_p, chunk).to(torch.float32)
        for r in reqs:
            r.wait()
        if reqs:
            c_p, c_am = nxt_p, nxt_am
    out = out.reshape(*lead, N).to(A.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
