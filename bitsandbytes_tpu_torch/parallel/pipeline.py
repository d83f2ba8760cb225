"""Pipeline parallelism (GPipe) over a mesh axis.

Counterpart of the JAX package's ``parallel/pipeline.py``.  The layers are
stacked along a leading stage axis (:func:`stack_stage_params`), each rank of
the ``pipe`` axis runs its own stage, and microbatches flow stage to stage
through ring exchanges: over ``T = M + n - 1`` steps stage ``s`` runs
microbatch ``t - s`` at step ``t`` (bubble steps compute nothing), and the
last stage's outputs reach every rank at the end.

The schedule is one ``torch.autograd.Function``.  Its forward saves each
stage's microbatch inputs; its backward runs the reverse schedule, every
stage recomputing its layers for a microbatch under ``enable_grad`` and
sending the input's gradient to the stage on its left.  So every rank runs
every backward exchange (``T - 1`` of them, zeros in the bubbles), whatever
its stage consumes; a stage that ignores what it received still answers its
neighbour.  The output is replicated and every rank computes the same loss
on it, so its cotangent is the same on every rank: the last stage takes its
own and the others ignore theirs (summing them would scale the gradients by
n).  The gradients of ``x`` (stage 0's) and of the stacked float leaves
(each stage's slice) are gathered over the axis, so every rank gets the
gradient of the whole stack, as the JAX package's transposed ``shard_map``
gives it.  Quantized payloads are frozen, as in ``matmul_4bit``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from .mesh import Mesh

__all__ = ["gpipe", "stack_stage_params"]


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of a tree of dicts, lists, tuples and
    dataclasses (``QuantizedTensor``, ``QuantState``): a dataclass's tensor
    and dataclass fields are mapped, its other fields (blocksize, shape,
    layout, ...) kept from ``tree``.  ``rest`` are trees of the same
    structure whose leaves ``fn`` takes too."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        changes = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
                changes[f.name] = _tree_map(fn, v, *(getattr(r, f.name) for r in rest))
        return dataclasses.replace(tree, **changes)
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    _tree_map(lambda t: out.append(t) or t, tree)
    return out


def _replace_leaves(tree, slots, new):
    """``tree`` with its leaves at positions ``slots`` (in :func:`_leaves`
    order) replaced by ``new``."""
    pos = dict(zip(slots, new))
    counter = iter(range(len(_leaves(tree))))
    return _tree_map(lambda t: pos.get(next(counter), t), tree)


def stack_stage_params(layer_params_list, n_stages: int):
    """Stack ``L`` per-layer trees into one whose tensor leaves are
    ``[n_stages, L // n_stages, ...]``: the payload and absmax of a
    quantized weight too; its static fields are shared."""
    L = len(layer_params_list)
    if L % n_stages:
        raise ValueError(f"{L} layers do not split over {n_stages} stages")
    per = L // n_stages
    return _tree_map(lambda *xs: torch.stack(xs).reshape(n_stages, per, *xs[0].shape), *layer_params_list)


def _apply_stage(layer_fn, stage, a):
    """``layer_fn`` over a stage's layers (leaves ``[per, ...]``) in order."""
    per = _leaves(stage)[0].shape[0]
    for i in range(per):
        a = layer_fn(_tree_map(lambda t: t[i], stage), a)
    return a


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *grad_leaves):
        layer_fn, stage_params, slots, mesh, axis, M = run
        n, idx = mesh.axis_size(axis), mesh.index(axis)
        stage = _tree_map(lambda t: t[idx], stage_params)
        xs = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        T = M + n - 1
        saved, outbuf, state = [None] * M, torch.zeros_like(xs), None
        for t in range(T):
            j = t - idx
            out = None
            if 0 <= j < M:
                inp = xs[j] if idx == 0 else state
                saved[j] = inp
                out = _apply_stage(layer_fn, stage, inp)
                if out.shape != inp.shape or out.dtype != inp.dtype:
                    raise ValueError(f"a stage maps {tuple(inp.shape)} {inp.dtype} to {tuple(out.shape)} "
                                     f"{out.dtype}: layer_fn must keep the activations' shape and type")
                if idx == n - 1:
                    outbuf[j] = out
            if t < T - 1:
                state = mesh.ppermute(torch.zeros_like(xs[0]) if out is None else out, axis, 1)
        ctx.run, ctx.stage, ctx.saved = run, stage, saved
        # the last stage's buffer, on every rank
        outbuf = mesh.all_gather(outbuf.unsqueeze(0), axis)[n - 1]
        return outbuf.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        layer_fn, stage_params, slots, mesh, axis, M = ctx.run
        n, idx = mesh.axis_size(axis), mesh.index(axis)
        stage, saved = ctx.stage, ctx.saved
        gs = g.reshape(M, g.shape[0] // M, *g.shape[1:])
        s_leaves = _leaves(stage)
        grads = [torch.zeros_like(s_leaves[j]) for j in slots]
        dxs = torch.zeros_like(gs)
        T = M + n - 1
        dinp = None
        for t in reversed(range(T)):
            j = t - idx
            if t < T - 1:
                # the stage on the right sends the gradient of the input it took at step t + 1
                recv = mesh.ppermute(torch.zeros_like(gs[0]) if dinp is None else dinp, axis, -1)
            dinp = None
            if not 0 <= j < M:
                continue
            gout = gs[j] if idx == n - 1 else recv
            with torch.enable_grad():
                inp = saved[j].detach().requires_grad_()
                params = [s_leaves[k].detach().requires_grad_() for k in slots]
                out = _apply_stage(layer_fn, _replace_leaves(stage, slots, params), inp)
                got = torch.autograd.grad(out, [inp] + params, gout, allow_unused=True)
            dinp = got[0] if got[0] is not None else torch.zeros_like(inp)
            for acc, gp in zip(grads, got[1:]):
                if gp is not None:
                    acc += gp
            if idx == 0:
                dxs[j] = dinp
        # stage 0 holds x's gradient and each stage its slice of the stack's: gathered, every rank holds all
        dx = mesh.all_gather(dxs.unsqueeze(0), axis)[0].reshape(g.shape)
        dparams = [mesh.all_gather(gp.unsqueeze(0), axis) for gp in grads]
        return (None, dx, *dparams)


def gpipe(layer_fn: Callable, stage_params, x: torch.Tensor, mesh: Mesh, axis: str = "pipe",
          n_microbatches: int = None) -> torch.Tensor:
    """Run ``x`` through ``n_stages * layers_per_stage`` layers pipelined over
    ``axis``.

    ``layer_fn(one_layer_params, activations) -> activations`` keeps the
    activations' shape and type; ``stage_params`` (every stage's, as
    :func:`stack_stage_params` gives them) has leaves ``[n_stages,
    layers_per_stage, ...]`` and this rank runs ``stage_params[index]``;
    ``x [batch, ...]`` is the same on every rank, its batch a multiple of
    ``n_microbatches`` (the number of stages by default).  Returns the
    activations after every layer, the same on every rank, differentiable in
    ``x`` and in the floating-point leaves of ``stage_params`` that require
    a gradient."""
    mesh.group(axis)  # a virtual mesh raises
    n = mesh.axis_size(axis)
    M = n if n_microbatches is None else n_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not divide into {M} microbatches")
    leaves = _leaves(stage_params)
    if any(t.shape[0] != n for t in leaves):
        raise ValueError(f"stage_params' leaves must lead with the {n} stages of axis {axis!r}")
    slots = tuple(j for j, t in enumerate(leaves) if t.is_floating_point() and t.requires_grad)
    run = (layer_fn, stage_params, slots, mesh, axis, M)
    return _GPipe.apply(run, x, *(leaves[j] for j in slots))
