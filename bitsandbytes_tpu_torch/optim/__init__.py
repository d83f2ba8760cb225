"""Optimizer family (the JAX package's ``optim/__init__.py``).

Every factory returns a :class:`BnbOptimizer` over ``params``.  Naming
follows the reference library: the plain name takes ``optim_bits`` (default
32), ``*8bit``/``*32bit`` fix the width, ``paged_*`` keeps the states of CUDA
parameters in pinned host memory between steps (``paged``).  CamelCase
names (``AdamW8bit``, ...) are the same factories.  Per-parameter options
come from ``make_optimizer_with_overrides`` or ``GlobalOptimManager``.
"""

from __future__ import annotations

import functools

from .base import BnbOptimizer, make_optimizer
from .compat import GlobalOptimManager, MockArgs, Optimizer1State, Optimizer2State, Optimizer8bit, PytorchLARS
from .overrides import STABLE_EMBEDDING_RULE, make_optimizer_with_overrides, path_labels
from .paged import make_paged_update, paged_state_sharding, to_host

__all__ = [
    "BnbOptimizer",
    "GlobalOptimManager",
    "MockArgs",
    "Optimizer1State",
    "Optimizer2State",
    "Optimizer8bit",
    "PytorchLARS",
    "STABLE_EMBEDDING_RULE",
    "make_optimizer",
    "make_optimizer_with_overrides",
    "make_paged_update",
    "paged_state_sharding",
    "path_labels",
    "to_host",
]


def _family(name, fname, *, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0, lr=1e-3, **extra):
    """{fname, fname8bit, fname32bit, paged_*} factories of one rule."""

    def factory(params, lr=lr, *, optim_bits=32, is_paged=False, **kw):
        args = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay, **extra)
        args.update(kw)
        return make_optimizer(name, params, lr, optim_bits=optim_bits, is_paged=is_paged, **args)

    return {
        fname: factory,
        f"{fname}8bit": functools.partial(factory, optim_bits=8),
        f"{fname}32bit": functools.partial(factory, optim_bits=32),
        f"paged_{fname}": functools.partial(factory, is_paged=True),
        f"paged_{fname}8bit": functools.partial(factory, optim_bits=8, is_paged=True),
        f"paged_{fname}32bit": functools.partial(factory, optim_bits=32, is_paged=True),
    }


def _sgd_factory(params, lr=1e-2, momentum=0.9, *, optim_bits=32, is_paged=False, **kw):
    """SGD with momentum (the momentum rule; momentum 0 is unsupported, as
    in the reference)."""
    if momentum == 0:
        raise ValueError("bitsandbytes SGD requires momentum > 0")
    kw.setdefault("beta1", momentum)
    kw.setdefault("eps", 0.0)
    return make_optimizer("momentum", params, lr, optim_bits=optim_bits, is_paged=is_paged, **kw)


_factories = {}
# Adam / AdamW (AdamW defaults weight_decay=1e-2)
_factories.update(_family("adam", "adam"))
_factories.update(_family("adam", "adamw", weight_decay=1e-2))
# Lion: betas (0.9, 0.99), no eps
_factories.update(_family("lion", "lion", beta1=0.9, beta2=0.99, eps=0.0, lr=1e-4))
# RMSprop: alpha -> beta1 = 0.99
_factories.update(_family("rmsprop", "rmsprop", beta1=0.99, eps=1e-8, lr=1e-2))
_factories.update(_family("adagrad", "adagrad", beta1=0.0, beta2=0.0, eps=1e-10, lr=1e-2))
# LAMB: the adam rule with max_unorm trust clipping
_factories.update(_family("adam", "lamb", max_unorm=1.0))
# LARS: the momentum rule with max_unorm
_factories.update(_family("momentum", "lars", beta1=0.9, eps=0.0, max_unorm=0.02, lr=1e-2))
# AdEMAMix: betas (0.9, 0.999, 0.9999), alpha 5
_factories.update(_family("ademamix", "ademamix", beta1=0.9, beta2=0.999, beta3=0.9999, alpha=5.0, lr=1e-3))
_factories["sgd"] = _sgd_factory
_factories["sgd8bit"] = functools.partial(_sgd_factory, optim_bits=8)
_factories["sgd32bit"] = functools.partial(_sgd_factory, optim_bits=32)

# CamelCase names of the reference's classes
_CAMEL = {
    "Adam": "adam", "Adam8bit": "adam8bit", "Adam32bit": "adam32bit",
    "PagedAdam": "paged_adam", "PagedAdam8bit": "paged_adam8bit", "PagedAdam32bit": "paged_adam32bit",
    "AdamW": "adamw", "AdamW8bit": "adamw8bit", "AdamW32bit": "adamw32bit",
    "PagedAdamW": "paged_adamw", "PagedAdamW8bit": "paged_adamw8bit", "PagedAdamW32bit": "paged_adamw32bit",
    "Lion": "lion", "Lion8bit": "lion8bit", "Lion32bit": "lion32bit",
    "PagedLion": "paged_lion", "PagedLion8bit": "paged_lion8bit", "PagedLion32bit": "paged_lion32bit",
    "SGD": "sgd", "SGD8bit": "sgd8bit", "SGD32bit": "sgd32bit",
    "RMSprop": "rmsprop", "RMSprop8bit": "rmsprop8bit", "RMSprop32bit": "rmsprop32bit",
    "Adagrad": "adagrad", "Adagrad8bit": "adagrad8bit", "Adagrad32bit": "adagrad32bit",
    "LAMB": "lamb", "LAMB8bit": "lamb8bit", "LAMB32bit": "lamb32bit",
    "LARS": "lars", "LARS8bit": "lars8bit", "LARS32bit": "lars32bit",
    "AdEMAMix": "ademamix", "AdEMAMix8bit": "ademamix8bit", "AdEMAMix32bit": "ademamix32bit",
    "PagedAdEMAMix": "paged_ademamix", "PagedAdEMAMix8bit": "paged_ademamix8bit",
    "PagedAdEMAMix32bit": "paged_ademamix32bit",
}
_factories.update({camel: _factories[snake] for camel, snake in _CAMEL.items()})

globals().update(_factories)
__all__ += list(_factories)
