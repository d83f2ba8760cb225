"""A named device mesh over ``torch.distributed`` ranks.

The JAX package shards over its device mesh and lets GSPMD place
the data; here placement is explicit.  A :class:`Mesh` holds the axis names
and sizes, this process's coordinate on each axis and one process group per
axis (the ranks that differ from this one on that axis alone), and runs the
collectives the sharded paths need over those groups.  Ranks map to
coordinates in row-major order over the axes, as the JAX package lays its
devices out (``devices[:n].reshape(sizes)``).

A mesh can also be built for a given coordinate with no groups (a virtual
mesh): it computes any rank's shard in one process, and raises where a
collective would run.  An axis of size 1 still runs its collectives
through its group: nothing special-cases one rank away.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


def _gather_single():
    # torch 2.13 names it all_gather_single; earlier releases all_gather_into_tensor
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Mesh:
    """Axis names and sizes, this process's coordinate, and one process
    group per axis (None on a virtual mesh)."""

    def __init__(self, axes: Dict[str, int], coord: Dict[str, int], groups: Optional[dict] = None):
        self.axis_names = tuple(axes)
        self.shape = {a: int(s) for a, s in axes.items()}
        self.coord = {a: int(coord[a]) for a in self.axis_names}
        for a in self.axis_names:
            if not 0 <= self.coord[a] < self.shape[a]:
                raise ValueError(f"coordinate {self.coord[a]} outside axis {a!r} of size {self.shape[a]}")
        self._groups = groups

    @property
    def virtual(self) -> bool:
        return self._groups is None

    def axis_size(self, axis) -> int:
        """Size of ``axis`` (1 for None or an axis the mesh lacks)."""
        if axis is None or axis not in self.shape:
            return 1
        return self.shape[axis]

    def index(self, axis) -> int:
        """This process's coordinate on ``axis`` (0 for None or a missing axis)."""
        if axis is None or axis not in self.coord:
            return 0
        return self.coord[axis]

    def at(self, coord: Union[int, Dict[str, int]]) -> "Mesh":
        """A virtual mesh of the same axes at ``coord`` (a rank or a dict)."""
        if not isinstance(coord, dict):
            sizes = tuple(self.shape[a] for a in self.axis_names)
            coord = dict(zip(self.axis_names, (int(i) for i in np.unravel_index(int(coord), sizes))))
        return Mesh(self.shape, coord)

    def sub(self, axes: Sequence[str]) -> "Mesh":
        """The mesh of ``axes`` alone, at this coordinate, sharing their groups."""
        groups = None if self._groups is None else {a: self._groups[a] for a in axes}
        return Mesh({a: self.shape[a] for a in axes}, {a: self.coord[a] for a in axes}, groups)

    def group(self, axis: str):
        if self._groups is None:
            raise RuntimeError("a virtual mesh (built for a coordinate) runs no collectives; "
                               "build the mesh with make_mesh on initialized process groups")
        return self._groups[axis]

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The axis's shards of ``t`` concatenated along ``dim`` in
        coordinate order, on every rank of the axis.  The bytes move as they
        are (a float tensor travels as its bytes), so every rank holds the
        same bits."""
        group = self.group(axis)
        n = self.shape[axis]
        src = t.contiguous().reshape(-1).view(torch.uint8)
        out = torch.empty(n * src.numel(), dtype=torch.uint8, device=t.device)
        _gather_single()(out, src, group=group)
        parts = out.view(t.dtype).reshape(n, *t.shape)
        if t.dim() == 0:
            return parts
        if dim % t.dim() == 0:
            return parts.reshape(n * t.shape[0], *t.shape[1:])
        return torch.cat(parts.unbind(0), dim=dim)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the axis's ranks, in ``t``'s type, the same
        bits on every rank."""
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group(axis))
        return out

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
        """The ring exchange: ``t`` goes to the rank ``shift`` places further
        along ``axis`` (cyclically), and what the rank ``shift`` places back
        sent is returned, in one ``batch_isend_irecv``.  At one rank it is a
        copy.  No gradient: ``collectives.ppermute`` is the differentiable
        one."""
        group = self.group(axis)
        n = self.shape[axis]
        if n == 1:
            return t.clone()
        me = self.coord[axis]
        ranks = dist.get_process_group_ranks(group)
        src = t.contiguous()
        out = torch.empty_like(src)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, ranks[(me + shift) % n], group),
            dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group),
        ])
        for r in reqs:
            r.wait()
        return out

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual else ""
        return f"{kind}Mesh({self.shape}, coord={self.coord})"


def make_mesh(axes: Dict[str, int], coord: Optional[Union[int, Dict[str, int]]] = None) -> Mesh:
    """Build a mesh from ``{'data': d, 'model': m, ...}`` axis sizes.

    Without ``coord``, ``torch.distributed`` must be initialized with a world
    of exactly ``d * m * ...`` ranks; every rank calls this with the same
    axes (the groups are created collectively) and gets its own coordinate.
    With ``coord`` (a rank or a dict of indices) the mesh is virtual: no
    groups, for computing that rank's shard in one process."""
    axes = {a: int(s) for a, s in axes.items()}
    sizes = tuple(axes.values())
    n = int(np.prod(sizes, dtype=np.int64))
    if coord is not None:
        return Mesh(axes, {a: 0 for a in axes}).at(coord)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh without coord needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {axes} needs {n} ranks, the world has {world}")
    rank = dist.get_rank()
    names = tuple(axes)
    grid = np.arange(n).reshape(sizes)
    groups = {}
    for i, a in enumerate(names):
        # one group for each line along axis a, created in the same order on every rank
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(i, slice(None))
            ranks = [int(r) for r in grid[tuple(idx)]]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[a] = g
    coord = dict(zip(names, (int(i) for i in np.unravel_index(rank, sizes))))
    return Mesh(axes, coord, groups)
