"""The reference's names for the optimizer layer.

Counterpart of the JAX package's ``optim/compat.py``: code ported from the
reference library finds the classes it configured.  The factories of
``optim`` and :func:`make_optimizer_with_overrides` stay the first-class
API; these delegate to them.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from .base import BnbOptimizer, LearningRate, make_optimizer
from .overrides import make_optimizer_with_overrides, named_parameters

__all__ = [
    "GlobalOptimManager",
    "MockArgs",
    "Optimizer1State",
    "Optimizer2State",
    "Optimizer8bit",
    "PytorchLARS",
]


class MockArgs:
    """An attribute bag over a dict, for configuration code that reads
    ``args.key``."""

    def __init__(self, initial_data: dict):
        for key, value in initial_data.items():
            setattr(self, key, value)


class GlobalOptimManager:
    """Per-parameter overrides of the optimizer options, gathered before
    the optimizer is built (the reference's singleton).

    ``override_config(path_regex, ...)`` adds a rule over parameter names,
    as the JAX package's manager does; ``register_module_override(module,
    param_name, config)`` overrides one parameter, as the reference's does,
    and takes precedence over the rules.  :meth:`build` makes the optimizer
    through :func:`make_optimizer_with_overrides`."""

    _instance: Optional["GlobalOptimManager"] = None

    def __init__(self):
        self.initialize()

    @classmethod
    def get_instance(cls) -> "GlobalOptimManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def initialize(self) -> None:
        """Forget every override."""
        self.rules: list = []
        self.param_overrides: list = []  # (tensor, options)

    def register_parameters(self, params) -> None:
        """Nothing to record: :meth:`build` matches overrides to the
        parameters it is given, by name and by identity."""

    def override_config(
        self, path_regex: str, key: Optional[str] = None, value=None, key_value_dict: Optional[dict] = None,
    ) -> None:
        """Override options of every parameter whose name matches
        ``path_regex``: ``key=value``, or the options of
        ``key_value_dict``."""
        if not isinstance(path_regex, str):
            raise TypeError("override_config takes a regex over parameter names; override one parameter with "
                            "register_module_override(module, param_name, config)")
        merged = dict(key_value_dict or {})
        if key is not None:
            merged[key] = value
        self.rules.append((path_regex, merged))

    def register_module_override(self, module: torch.nn.Module, param_name: str, config: dict) -> None:
        """Override the options of ``module``'s parameter ``param_name``
        (for example ``{"optim_bits": 32}``)."""
        if not (isinstance(module, torch.nn.Module) and isinstance(param_name, str) and isinstance(config, dict)):
            raise TypeError("register_module_override(module, param_name, config) takes an nn.Module, the name "
                            "of one of its parameters and a dict of options")
        p = getattr(module, param_name, None)
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{type(module).__name__} has no tensor {param_name!r}")
        self.param_overrides.append((p, dict(config)))

    def build(self, name: str, params, lr: LearningRate = 1e-3, **kwargs) -> BnbOptimizer:
        """The optimizer of rule ``name`` over ``params`` (a module or
        ``(name, tensor)`` pairs) with the registered overrides."""
        named = named_parameters(params)
        exact = [(f"^{re.escape(n)}$", options) for p, options in self.param_overrides
                 for n, q in named if q is p]
        return make_optimizer_with_overrides(name, named, lr, rules=exact + list(self.rules), **kwargs)


def Optimizer2State(optimizer_name: str, params, lr: LearningRate = 1e-3, optim_bits: int = 32,
                    **kwargs) -> BnbOptimizer:
    """A two-state rule's optimizer (the reference's base class of Adam,
    AdamW, LAMB and AdEMAMix): :func:`make_optimizer`."""
    return make_optimizer(optimizer_name, params, lr, optim_bits=optim_bits, **kwargs)


def Optimizer1State(optimizer_name: str, params, lr: LearningRate = 1e-3, optim_bits: int = 32,
                    **kwargs) -> BnbOptimizer:
    """A one-state rule's optimizer (the reference's base class of SGD,
    RMSprop, Adagrad, Lion and LARS): :func:`make_optimizer`."""
    return make_optimizer(optimizer_name, params, lr, optim_bits=optim_bits, **kwargs)


def Optimizer8bit(optimizer_name: str, params, lr: LearningRate = 1e-3, **kwargs) -> BnbOptimizer:
    """An optimizer with 8-bit states."""
    return make_optimizer(optimizer_name, params, lr, optim_bits=8, **kwargs)


def PytorchLARS(params, lr: LearningRate = 1e-2, **kwargs) -> BnbOptimizer:
    """The reference's plain LARS baseline: the 32-bit ``lars`` rule."""
    return make_optimizer("lars", params, lr, optim_bits=32, **kwargs)
