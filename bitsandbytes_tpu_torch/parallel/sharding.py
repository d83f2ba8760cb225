"""Sharding rules for quantized parameter trees and KV caches.

Counterpart of the JAX package's ``parallel/sharding.py``.  A spec is a
tuple with an axis name or None per dimension, as a ``PartitionSpec`` is;
``()`` replicates.  The rules are the JAX package's, so every leaf gets the
spec it gets there: a shard owns whole quantization blocks and whole packed
bytes.

* ``"flat"`` ``[(N*K)/2, 1]`` and ``"2d"`` ``[N, K/2]`` payloads shard N
  only (whole rows); their flat absmax shards with them when its blocks
  divide evenly, else replicates; K-sharding raises.
* ``"paired"`` ``[N/2, K]`` shards N in whole row pairs and K in whole
  blocks; its absmax ``[K/bs, N]`` shards congruently (dim 1 for N).
* An axis that does not divide replicates; a double-quantized absmax (its
  uint8 codes, ``state2`` and the offset) replicates.

There is no GSPMD here, so placement is explicit: :func:`shard_quantized_tree`
returns this rank's tree.  A leaf that some axis splits becomes a
:class:`Sharded`: ``local`` holds exactly the pieces the JAX package's
``addressable_shards`` hold at this coordinate (contiguous copies, the
paired absmax's strided N-slice made contiguous once, here), and
``compute`` the same weight as a leaf of its local logical shape, ready
for the kernels.  A replicated leaf stays as it is.

A double-quantized state keeps its codes whole in ``local``.  Its
``compute`` leaf takes this rank's columns of the codes and the slice of
``state2``'s scales that covers them, when the rank's first block is a
multiple of the nested blocksize (256), so kernels 5 and 6 decode it in
place as they decode a whole weight; otherwise it takes this rank's slice
of the resolved f32 absmax and runs kernels 2 and 3 (the JAX package
resolves the nested absmax before its collectives in the same way).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..nn.modules import Int8TensorState, QuantizedTensor
from .collectives import copy_to_axis, gather_from_axis, reduce_from_axis, scatter_to_axis
from .mesh import Mesh, make_mesh

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "leaf_sharding",
    "shard_quantized_tree",
    "llama_param_specs",
    "llama_tp_rules",
    "kv_cache_specs",
    "shard_kv_cache",
]

_NESTED_BS = 256


def _axis_size(mesh: Optional[Mesh], axis) -> int:
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        raise NotImplementedError("a dimension sharded over several mesh axes is not supported")
    return mesh.axis_size(axis)


def _dim(spec, i):
    return spec[i] if len(spec) > i else None


def _quantized_tensor_specs(qt: QuantizedTensor, spec, mesh: Optional[Mesh] = None) -> QuantizedTensor:
    """Per-piece specs of a QuantizedTensor from the spec of its logical
    ``[N, K]`` weight, as a QuantizedTensor whose tensor fields hold specs."""
    state = qt.state
    N, K = (int(s) for s in state.shape)
    n_axis, k_axis = _dim(spec, 0), _dim(spec, 1)
    layout, bs = state.layout, state.blocksize
    if k_axis is not None and layout != "paired":
        raise NotImplementedError(
            "K-sharding of 4-bit weights requires layout='paired' ([N/2, K] payload with [K/bs, N] absmax); "
            "relayout with QuantizedTensor.to_layout('paired')"
        )
    n_sh, k_sh = _axis_size(mesh, n_axis), _axis_size(mesh, k_axis)
    if N % n_sh:
        n_axis, n_sh = None, 1
    if layout == "paired":
        if n_axis is not None and (N // n_sh) % 2:
            n_axis = None
        if k_axis is not None and (K // k_sh) % bs:
            k_axis = None
        data_spec = (n_axis, k_axis)
        absmax_spec = () if state.nested else (k_axis, n_axis)  # [K/bs, N]
    else:
        data_spec = (n_axis, None)
        nblocks = -(-N * K // bs)
        absmax_axis = n_axis if (N * K) % bs == 0 and nblocks % n_sh == 0 else None
        absmax_spec = () if state.nested else (absmax_axis,)
    state2 = None
    if state.state2 is not None:
        state2 = dataclasses.replace(state.state2, absmax=(), code=())
    state_specs = dataclasses.replace(
        state, absmax=absmax_spec, code=(), offset=None if state.offset is None else (), state2=state2
    )
    return QuantizedTensor(data=data_spec, state=state_specs)


def _int8_specs(w: Int8TensorState, spec) -> Int8TensorState:
    n_axis, k_axis = _dim(spec, 0), _dim(spec, 1)
    return Int8TensorState(CB=(n_axis, k_axis), SCB=(n_axis,))


def leaf_sharding(leaf, spec, mesh: Optional[Mesh] = None):
    """The spec of every piece of ``leaf`` given its logical weight's spec:
    a QuantizedTensor or Int8TensorState whose tensor fields hold specs, or
    ``spec`` itself for a plain tensor."""
    if isinstance(leaf, QuantizedTensor):
        return _quantized_tensor_specs(leaf, spec, mesh)
    if isinstance(leaf, Int8TensorState):
        return _int8_specs(leaf, spec)
    return tuple(spec)


def _bounds(mesh: Mesh, axis, dim: int):
    """This rank's ``(start, length)`` along a dimension of size ``dim``
    split over ``axis``."""
    s = _axis_size(mesh, axis)
    if dim % s:
        raise ValueError(f"dimension {dim} does not split over axis {axis!r} of size {s}")
    n = dim // s
    return mesh.index(axis) * n, n


def _take(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of ``t`` under ``spec``: a contiguous copy where any
    dimension is split, ``t`` itself where none is."""
    index, split = [], False
    for i in range(t.dim()):
        axis = _dim(spec, i)
        if axis is None:
            index.append(slice(None))
            continue
        start, n = _bounds(mesh, axis, t.shape[i])
        index.append(slice(start, start + n))
        split = split or n != t.shape[i]
    if not split:
        return t
    return t[tuple(index)].clone(memory_format=torch.contiguous_format)


@dataclasses.dataclass
class Sharded:
    """A leaf split over a mesh.

    ``local``: this rank's pieces, in the leaf's own type (a QuantizedTensor
    keeps its full logical shape in its state, as the JAX package's does);
    ``compute``: the same weight as a leaf of the local logical shape, ready
    for the kernels (None where this rank's rows hold no whole quantization
    blocks); ``spec``: the logical weight's spec after the fallbacks,
    ``(n_axis, k_axis)``; ``shape``: the logical shape; ``mesh``: where the
    collectives of :meth:`linear` and :meth:`embedding` run."""

    local: Any
    compute: Any
    spec: tuple
    shape: tuple
    mesh: Mesh

    def _compute(self):
        if self.compute is None:
            raise NotImplementedError(
                "this shard's rows hold no whole quantization blocks of the flat absmax; "
                "relayout the weight to 'paired' before sharding it"
            )
        return self.compute

    def linear(self, x: torch.Tensor, apply: Callable) -> torch.Tensor:
        """``x @ W^T`` over the mesh: ``apply(x_local, compute)`` computes this
        rank's piece through the kernels; a K-split adds the f32 partial sums
        over its axis, an N-split gathers the output columns over its axis.

        Differentiable in ``x`` (Megatron's regions, ``collectives.py``):
        ``x`` is replicated, and each rank's piece of the weight sees part
        of it, so an N-split sums ``grad_x`` over its axis and a K-split
        gathers its columns of ``grad_x``; the gathered output's cotangent
        is replicated, so a rank takes its columns of it, and the K-split's
        sum passes it on as it is."""
        n_axis, k_axis = _dim(self.spec, 0), _dim(self.spec, 1)
        w = self._compute()
        if n_axis is not None:
            x = copy_to_axis(x, self.mesh, n_axis)
        if k_axis is not None:
            k0, kn = _bounds(self.mesh, k_axis, int(self.shape[1]))
            part = apply(scatter_to_axis(x, self.mesh, k_axis, k0, kn), w).to(torch.float32)
            out = reduce_from_axis(part, self.mesh, k_axis).to(x.dtype)
        else:
            out = apply(x, w)
        if n_axis is not None:
            out = gather_from_axis(out, self.mesh, n_axis, dim=-1)
        return out

    @torch.no_grad()
    def embedding(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of a table split over its rows: each rank looks up the
        ids it holds (zeros for the rest), and an f32 sum over the axis puts
        every row together, exactly (one nonzero term a row).  Outside
        autograd: the table is frozen and the ids are integers."""
        n_axis, k_axis = _dim(self.spec, 0), _dim(self.spec, 1)
        w = self._compute()
        if not isinstance(w, torch.Tensor) or k_axis is not None:
            raise NotImplementedError("only a float table split over its rows is looked up sharded")
        if n_axis is None:
            return w[ids]
        v0, vn = _bounds(self.mesh, n_axis, int(self.shape[0]))
        mine = (ids >= v0) & (ids < v0 + vn)
        rows = w[(ids - v0).clamp(0, vn - 1)].to(torch.float32) * mine[..., None]
        return self.mesh.all_reduce(rows, n_axis).to(w.dtype)


def _nested_compute(qt: QuantizedTensor, n0: int, Ns: int, k0: int, Kl: int) -> QuantizedTensor:
    """The compute leaf of a double-quantized state's shard (rows n0.., K
    columns k0..): its own nested state where the shard's first block sits
    on a nested-block boundary and K is whole, else the resolved absmax's
    slice."""
    st = qt.state
    N, K = (int(s) for s in st.shape)
    KB, bs = K // st.blocksize, st.blocksize
    first = n0 * KB  # the shard's first block in the flat block order
    if st.inline_nested and Kl == K and first % _NESTED_BS == 0:
        if st.layout == "paired":
            codes = st.absmax[:, n0 : n0 + Ns].contiguous()
        else:
            codes = st.absmax.reshape(-1)[first : first + Ns * KB].contiguous()
        s2 = st.state2.absmax[first // _NESTED_BS : -(-(first + Ns * KB) // _NESTED_BS)].contiguous()
        state2 = dataclasses.replace(st.state2, absmax=s2, shape=(Ns * KB,))
        return dataclasses.replace(st, absmax=codes, state2=state2, shape=(Ns, Kl))
    absmax = st.dequant_absmax().reshape(N, KB)[n0 : n0 + Ns, k0 // bs : (k0 + Kl) // bs]
    absmax = absmax.t().contiguous() if st.layout == "paired" else absmax.reshape(-1).contiguous()
    return dataclasses.replace(st, absmax=absmax, offset=None, state2=None, shape=(Ns, Kl))


def _shard_quantized(qt: QuantizedTensor, spec, mesh: Mesh):
    specs = _quantized_tensor_specs(qt, spec, mesh)
    st, sst = qt.state, specs.state
    N, K = (int(s) for s in st.shape)
    data = _take(qt.data, specs.data, mesh)
    absmax = _take(st.absmax, sst.absmax, mesh)
    local = QuantizedTensor(data=data, state=dataclasses.replace(st, absmax=absmax))
    if st.layout == "paired":
        n_axis, k_axis = specs.data
    else:
        n_axis, k_axis = specs.data[0], None
    if n_axis is None and k_axis is None:
        return qt
    n0, Ns = _bounds(mesh, n_axis, N)
    k0, Kl = _bounds(mesh, k_axis, K)
    if st.nested and (st.layout == "paired" or K % st.blocksize == 0):
        cstate = _nested_compute(qt, n0, Ns, k0, Kl)
    elif st.nested:
        cstate = None
    elif st.layout == "paired" or sst.absmax[0] is not None:
        cstate = dataclasses.replace(st, absmax=absmax, shape=(Ns, Kl))
    elif K % st.blocksize == 0:  # rows own whole blocks: slice the replicated absmax
        KB = K // st.blocksize
        cstate = dataclasses.replace(st, absmax=st.absmax[n0 * KB : (n0 + Ns) * KB].contiguous(), shape=(Ns, Kl))
    else:
        cstate = None
    compute = None if cstate is None else QuantizedTensor(data=data, state=cstate)
    return Sharded(local=local, compute=compute, spec=(n_axis, k_axis), shape=(N, K), mesh=mesh)


def _shard_leaf(leaf, spec, mesh: Mesh):
    if isinstance(leaf, QuantizedTensor):
        return _shard_quantized(leaf, spec, mesh)
    if isinstance(leaf, Int8TensorState):
        specs = _int8_specs(leaf, spec)
        n_axis, k_axis = specs.CB
        if n_axis is None and k_axis is None:
            return leaf
        local = Int8TensorState(CB=_take(leaf.CB, specs.CB, mesh), SCB=_take(leaf.SCB, specs.SCB, mesh))
        compute = local if k_axis is None else None  # the row quantize of A needs all of K
        return Sharded(local=local, compute=compute, spec=(n_axis, k_axis), shape=tuple(leaf.CB.shape), mesh=mesh)
    spec = tuple(spec)
    if all(a is None for a in spec):
        return leaf
    local = _take(leaf, spec, mesh)
    return Sharded(local=local, compute=local, spec=(_dim(spec, 0), _dim(spec, 1)), shape=tuple(leaf.shape),
                   mesh=mesh)


def _is_q(x) -> bool:
    return isinstance(x, (QuantizedTensor, Int8TensorState))


def shard_quantized_tree(params, mesh: Mesh, spec_fn: Callable):
    """This rank's tree: ``spec_fn(path, leaf) -> spec`` gives each leaf's
    logical weight spec (``path`` a tuple of dict keys and list indices);
    quantized leaves get congruent payload and absmax specs.  Split leaves
    become :class:`Sharded`, replicated ones stay as they are."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not _is_q(node):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        if node is None:
            return None
        return _shard_leaf(node, spec_fn(path, node), mesh)

    return walk(params, ())


# -- Llama rules ----------------------------------------------------------------

# Megatron-style tensor parallelism over the model axis, every linear split on
# its output dimension N, as in the JAX package.  The fused wqkv / gate_up of
# quantize_params_4bit(fuse=True) are not named, so they replicate there too.
_LLAMA_TP_N_SHARDED = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def llama_tp_rules(model_axis: str = "model"):
    """``spec_fn`` for :func:`shard_quantized_tree`: tensor parallelism on a
    Llama tree."""

    def spec_fn(path, leaf):
        last = path[-1] if path else None
        if last in _LLAMA_TP_N_SHARDED or last in ("embed", "lm_head"):
            return (model_axis, None)
        return ()

    return spec_fn


def llama_param_specs(mesh: Mesh, params, model_axis: str = "model"):
    """This rank's shard of a Llama tree (float or quantized) under
    :func:`llama_tp_rules`."""
    return shard_quantized_tree(params, mesh, llama_tp_rules(model_axis))


def kv_cache_specs(cache, data_axis: str = "data", model_axis: str = "model", mesh: Optional[Mesh] = None):
    """Specs of a KV cache's tensors, a cache of the same type holding
    specs: a dense ``[L, B, KVH, S, hd]`` cache (and its ``[L, B, KVH, S]``
    int8 scales) splits batch over ``data_axis`` and KV heads over
    ``model_axis``; a paged pool ``[L, NB, KVH, BS, hd]`` splits its heads
    only (every rank holds all pool blocks of its heads) and the tables
    replicate.  An axis that does not divide, or that the mesh lacks,
    replicates."""
    from ..models.llama import PagedKVCache

    def fit(axis, dim):
        if mesh is not None and (axis not in mesh.shape or dim % mesh.shape[axis]):
            return None
        return axis

    def spec(x, paged: bool):
        if x is None:
            return None
        if paged:
            if x.dim() >= 4:
                return (None, None, fit(model_axis, x.shape[2])) + (None,) * (x.dim() - 3)
            return ()
        if x.dim() >= 4:
            return (None, fit(data_axis, x.shape[1]), fit(model_axis, x.shape[2])) + (None,) * (x.dim() - 3)
        return ()

    paged = isinstance(cache, PagedKVCache)
    return type(cache)(*(spec(x, paged) for x in cache))


def shard_kv_cache(cache, mesh: Mesh, data_axis: str = "data", model_axis: str = "model"):
    """This rank's piece of a KV cache, in the cache's own type."""
    specs = kv_cache_specs(cache, data_axis, model_axis, mesh=mesh)
    return type(cache)(*(None if x is None else _take(x, s, mesh) for x, s in zip(cache, specs)))
