"""Collectives over packed quantized payloads, and the differentiable
collectives of training over a mesh.

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

The JAX package differentiates through its collectives because GSPMD and
``shard_map`` transpose them.  Here each one used on a training path is a
``torch.autograd.Function`` over the mesh's per-axis group with its adjoint
written out: :func:`ppermute` (the ring exchange; its adjoint is the
exchange the other way) and the four Megatron-style regions of a split
linear.  Every rank computes the same replicated loss, so a replicated
tensor's cotangent is the same on every rank and never summed for itself:
:func:`copy_to_axis` (identity forward, the cotangent summed over the axis
backward: a replicated input of a split computation), :func:`reduce_from_axis`
(a sum over the axis forward, identity backward), :func:`gather_from_axis`
(the axis's pieces concatenated forward, this rank's piece of the cotangent
backward) and :func:`scatter_to_axis` (this rank's piece forward, the
cotangent's pieces concatenated backward).  Their forwards are the plain
collectives', bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..functional.gemm import gemm_4bit
from ..functional.quant_state import QuantState
from .mesh import Mesh

__all__ = [
    "all_gather_packed",
    "tp_gemm_4bit_allgather",
    "tp_gemm_4bit_ring",
    "ppermute",
    "copy_to_axis",
    "reduce_from_axis",
    "gather_from_axis",
    "scatter_to_axis",
]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh.ppermute(t, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.ppermute(g, ctx.axis, -ctx.shift), None, None, None


def ppermute(t: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """``t`` sent ``shift`` ranks on along ``axis``'s ring (rank ``i`` to
    ``(i + shift) % n``), the JAX ring permutation ``j -> j + shift``;
    backward sends the cotangent ``shift`` ranks back.  At one rank a copy."""
    mesh.group(axis)  # a virtual mesh raises here, at any size
    return _PPermute.apply(t, mesh, axis, shift)


def _sum_f32(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` summed over ``axis`` in f32, back in its type."""
    return mesh.all_reduce(t.to(torch.float32), axis).to(t.dtype)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(ctx.mesh, g, ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.size, ctx.start = dim, x.shape[dim], mesh.index(axis) * x.shape[dim]
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size).contiguous(), None, None, None


class _ScatterToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, start, length):
        ctx.mesh, ctx.axis = mesh, axis
        return x[..., start : start + length].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axis, dim=-1), None, None, None, None


def copy_to_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` as it is; backward, the cotangent summed over ``axis`` (in f32):
    the input of a computation whose ranks each see part of its use."""
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis`` in its type (the same bits on every rank);
    backward, the cotangent as it is."""
    return _ReduceFromAxis.apply(x, mesh, axis)


def gather_from_axis(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The axis's pieces of ``x`` concatenated along ``dim``; backward, this
    rank's piece of the cotangent, with no communication."""
    return _GatherFromAxis.apply(x, mesh, axis, dim)


def scatter_to_axis(x: torch.Tensor, mesh: Mesh, axis: str, start: int, length: int) -> torch.Tensor:
    """This rank's columns ``start:start + length`` of ``x`` (every rank's
    piece the same length); backward, the axis's pieces of the cotangent
    concatenated."""
    return _ScatterToAxis.apply(x, mesh, axis, start, length)


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
