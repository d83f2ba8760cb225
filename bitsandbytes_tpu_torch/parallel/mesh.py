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

An axis may also be a tuple of axis names, as a ``PartitionSpec`` entry
may: its size is the product of theirs and this rank's index is row-major
over them in the tuple's order, as JAX orders a dimension split over
several axes.  Its process group is made the first time a collective asks
for it, on every rank at once (as every collective runs), and its members
are kept in that index order.
"""

from __future__ import annotations

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

    def __init__(self, axes: Dict[str, int], coord: Dict[str, int], groups: Optional[dict] = None, world=None):
        self.axis_names = tuple(axes)
        self.shape = {a: int(s) for a, s in axes.items()}
        self.coord = {a: int(coord[a]) for a in self.axis_names}
        for a in self.axis_names:
            if not 0 <= self.coord[a] < self.shape[a]:
                raise ValueError(f"coordinate {self.coord[a]} outside axis {a!r} of size {self.shape[a]}")
        self._groups = groups
        # (axis names, rank grid, coordinate) of the whole world, from which a
        # tuple axis's groups are made; shared with every sub-mesh
        self._world = world

    @property
    def virtual(self) -> bool:
        return self._groups is None

    @staticmethod
    def _names(axis) -> tuple:
        return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)

    def has(self, axis) -> bool:
        """Whether ``axis`` (a name or a tuple of names) is made of this
        mesh's axes, each named once."""
        names = self._names(axis)
        return len(set(names)) == len(names) and all(a in self.shape for a in names)

    def axis_size(self, axis) -> int:
        """Size of ``axis`` (1 for None or an axis the mesh lacks; the
        product of the sizes for a tuple of axes)."""
        if axis is None:
            return 1
        return int(np.prod([self.shape.get(a, 1) for a in self._names(axis)], dtype=np.int64))

    def index(self, axis) -> int:
        """This process's coordinate on ``axis`` (0 for None or a missing
        axis; row-major over a tuple's axes in its order)."""
        if axis is None:
            return 0
        idx = 0
        for a in self._names(axis):
            idx = idx * self.shape.get(a, 1) + self.coord.get(a, 0)
        return idx

    def at(self, coord: Union[int, Dict[str, int]]) -> "Mesh":
        """A virtual mesh of the same axes at ``coord`` (a rank or a dict)."""
        if not isinstance(coord, dict):
            sizes = tuple(self.shape[a] for a in self.axis_names)
            coord = dict(zip(self.axis_names, (int(i) for i in np.unravel_index(int(coord), sizes))))
        return Mesh(self.shape, coord)

    def sub(self, axes: Sequence[str]) -> "Mesh":
        """The mesh of ``axes`` alone, at this coordinate, sharing their groups."""
        groups = None if self._groups is None else {a: self._groups[a] for a in axes}
        return Mesh({a: self.shape[a] for a in axes}, {a: self.coord[a] for a in axes}, groups, self._world)

    def group(self, axis):
        """The process group of the ranks that differ from this one on
        ``axis`` alone."""
        return self._line(axis)[0]

    def ranks(self, axis) -> list:
        """The global ranks of ``axis``'s group in the axis's index order."""
        return self._line(axis)[1]

    def _line(self, axis):
        """``(group, members, order)`` of ``axis`` (:func:`_new_lines`), made
        on first use for a tuple."""
        if self._groups is None:
            raise RuntimeError("a virtual mesh (built for a coordinate) runs no collectives; "
                               "build the mesh with make_mesh on initialized process groups")
        names = self._names(axis)
        key = names[0] if len(names) == 1 else names
        if key not in self._groups:
            if not self.has(names):
                raise KeyError(f"axis {axis!r} is not an axis of {self.shape}")
            self._groups[key] = _new_lines(*self._world, names)
        return self._groups[key]

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The axis's shards of ``t`` concatenated along ``dim`` in
        coordinate order, on every rank of the axis.  The bytes move as they
        are (a float tensor travels as its bytes), so every rank holds the
        same bits."""
        group, _, order = self._line(axis)
        n = self.axis_size(axis)
        src = t.contiguous().reshape(-1).view(torch.uint8)
        out = torch.empty(n * src.numel(), dtype=torch.uint8, device=t.device)
        _gather_single()(out, src, group=group)
        parts = out.view(t.dtype).reshape(n, *t.shape)
        if order is not None:  # the group gathers in rank order, the axis runs in index order
            parts = parts[order]
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
        group, ranks, _ = self._line(axis)
        n = self.axis_size(axis)
        if n == 1:
            return t.clone()
        me = self.index(axis)
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
    world = (names, grid, rank)
    groups = {a: _new_lines(*world, (a,)) for a in names}
    coord = dict(zip(names, (int(i) for i in np.unravel_index(rank, sizes))))
    return Mesh(axes, coord, groups, world)


def _new_lines(names: tuple, grid: np.ndarray, rank: int, axes: tuple):
    """One process group for each line of the world's rank ``grid`` along
    ``axes`` (a tuple of its axis names), created in the same order on
    every rank; returns this rank's ``(group, members, order)``: the
    members' global ranks row-major over ``axes`` in their order, and for
    each index along the line its member's place in the group's rank order
    (sorted global ranks), or None where the two agree."""
    pos = [names.index(a) for a in axes]
    others = [i for i in range(len(names)) if i not in pos]
    # the grid with the other axes first, then ``axes`` in their order
    lines = np.transpose(grid, others + pos).reshape(-1, int(np.prod([grid.shape[i] for i in pos], dtype=np.int64)))
    mine = None
    for line in lines:
        members = [int(r) for r in line]
        g = dist.new_group(members)
        if rank in members:
            ordered = sorted(members)
            mine = (g, members, None if ordered == members else [ordered.index(r) for r in members])
    return mine
