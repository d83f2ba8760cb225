"""Paged optimizer states: held in host memory between steps.

Counterpart of the JAX package's ``optim/paged.py``.  The reference library
puts paged states in CUDA managed memory and prefetches them; the JAX
package keeps them in pinned host memory and streams them to the device
for the update.  Here a paged state is a pinned host tensor (a plain CPU
tensor when its parameter lies on the CPU): a step copies it to the
parameter's device (``non_blocking``), updates the copy, copies the result
back into the pinned tensor, and frees the copy, so no state bytes stay on
the card between steps.

The JAX module's ``host_memory_supported``, ``repin_if_eager`` and
``unpin_if_eager`` have no counterpart: pinned host memory needs only a
CUDA device, and eager PyTorch has no traced values to leave alone.
``paged_state_sharding`` gives the placement of each state between steps,
where the JAX function gives ``jit`` shardings.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..nn.parametrize import map_tree
from ..ops.dispatch import resolve_device

__all__ = ["to_host", "paged_state_sharding", "make_paged_update", "page_in", "page_out"]


def _tensors(fn, tree):
    """``fn(leaf)`` on every tensor of a tree; other leaves kept as they are."""
    return map_tree(lambda _, t: fn(t) if isinstance(t, torch.Tensor) else t, tree)


def to_host(tree):
    """Every tensor of a tree (dicts, lists, tuples) copied to host memory,
    pinned when a CUDA device is there to pin it for."""
    pin = torch.cuda.is_available()

    def host(t):
        t = t.detach().to("cpu", copy=True)
        return t.pin_memory() if pin else t

    return _tensors(host, tree)


def paged_state_sharding(tree):
    """Where each tensor of a paged state tree lives between steps: the
    host (``torch.device("cpu")``), pinned when a CUDA device is there."""
    return _tensors(lambda t: torch.device("cpu"), tree)


def page_in(tree, device):
    """A tree of host tensors copied to ``device`` on the current stream
    (``non_blocking``: the copies of pinned tensors overlap the host)."""
    return _tensors(lambda t: t.to(device, non_blocking=True), tree)


def page_out(host_tree, device_tree) -> None:
    """Copy each tensor of ``device_tree`` back into its host tensor in
    ``host_tree``, stream-ordered, and wait for the copies to land, so that
    the host may read the states at once."""
    cuda = set()

    def copy(path, h):
        if isinstance(h, torch.Tensor):
            d = functools.reduce(lambda t, k: t[k], path, device_tree)
            h.copy_(d, non_blocking=True)
            if d.is_cuda:
                cuda.add(d.device)

    map_tree(copy, host_tree)
    for dev in cuda:
        torch.cuda.current_stream(dev).synchronize()


def make_paged_update(update: Callable, device=None) -> Callable:
    """Wrap ``update(states, *args, **kwargs)``, which updates a tree of
    state tensors in place, so that it takes the tree in host memory: the
    states are paged in to ``device`` (``ops/dispatch.resolve_device``:
    CUDA unless the caller names the CPU), updated, and paged out into the
    host tensors; on the CPU the host tensors are updated in place.
    Returns ``paged(host_states, *args, **kwargs) -> update's result``."""
    device = resolve_device(device)

    def paged(host_states, *args, **kwargs):
        if device.type == "cpu":
            return update(host_states, *args, **kwargs)
        dev_states = page_in(host_states, device)
        out = update(dev_states, *args, **kwargs)
        page_out(host_states, dev_states)
        return out

    return paged
