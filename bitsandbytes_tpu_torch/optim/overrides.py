"""Per-parameter overrides of the optimizer options.

Counterpart of the JAX package's ``optim/overrides.py`` (the reference's
``GlobalOptimManager`` overrides, most often ``optim_bits=32`` for an
embedding).  A rule is ``(path_regex, options)``, matched against the
parameter's name as ``named_parameters()`` gives it (``embedding.weight``);
the first rule that matches wins.  Where the JAX package builds one optax
transformation per label, here the labels become param groups of one
:class:`BnbOptimizer`, each with its merged options.  A group's 8-bit
tensors still take one launch of kernel 14 a step, its 32-bit ones the
stacked elementwise update.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch

from .base import GROUP_OPTIONS, BnbOptimizer, LearningRate

__all__ = ["make_optimizer_with_overrides", "STABLE_EMBEDDING_RULE", "path_labels", "named_parameters"]

# StableEmbedding's table keeps 32-bit optimizer states (the reference's
# register_module_override({"optim_bits": 32}))
STABLE_EMBEDDING_RULE: Tuple[str, dict] = (r"(^|.*[./])embedding([./].*|$)", {"optim_bits": 32})


def named_parameters(params) -> list:
    """``(name, tensor)`` pairs of an ``nn.Module`` or of an iterable of
    such pairs."""
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    named = list(params)
    for item in named:
        if not (isinstance(item, tuple) and len(item) == 2 and isinstance(item[0], str)
                and isinstance(item[1], torch.Tensor)):
            raise TypeError("params must be an nn.Module or (name, tensor) pairs")
    return named


def path_labels(params, rules: Sequence[Tuple[str, dict]]) -> dict:
    """``{name: label}`` for the parameters of ``params`` (a module or
    ``(name, tensor)`` pairs): the index, as a string, of the first rule
    whose regex matches the name, else ``"default"``."""
    compiled = [re.compile(rx) for rx, _ in rules]
    return {name: next((str(i) for i, rx in enumerate(compiled) if rx.search(name)), "default")
            for name, _ in named_parameters(params)}


def _rule_group(options: dict) -> dict:
    """A rule's options as a param group's: ``learning_rate`` (the JAX
    name) or ``lr`` sets the group's learning rate."""
    group = dict(options)
    if "learning_rate" in group:
        group["lr"] = group.pop("learning_rate")
    unknown = set(group) - GROUP_OPTIONS
    if unknown:
        raise TypeError(f"unknown optimizer options in an override: {sorted(unknown)}")
    if group.get("optim_bits", 8) not in (8, 32):
        raise ValueError("optim_bits must be 8 or 32")
    return group


def make_optimizer_with_overrides(
    name: str,
    params,
    lr: LearningRate = 1e-3,
    rules: Sequence[Tuple[str, dict]] = (),
    **kwargs,
) -> BnbOptimizer:
    """One :class:`BnbOptimizer` of rule ``name`` over ``params`` (a module
    or ``(name, tensor)`` pairs) with a param group per label of
    :func:`path_labels`: the rule's options over ``kwargs``.  Example, Adam
    with 8-bit states and the embeddings at 32 bits::

        opt = make_optimizer_with_overrides("adam", model, 1e-3, rules=[STABLE_EMBEDDING_RULE], optim_bits=8)
    """
    named = named_parameters(params)
    labels = path_labels(named, rules)
    members = {}
    for n, p in named:
        members.setdefault(labels[n], []).append(p)
    groups = [{"params": members["default"]}] if "default" in members else []
    for i, (_, options) in enumerate(rules):
        if str(i) in members:
            groups.append({"params": members[str(i)], **_rule_group(options)})
    return BnbOptimizer(groups, name, lr, **kwargs)
