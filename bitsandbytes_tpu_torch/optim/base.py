"""bitsandbytes-style optimizers with 8-bit blockwise states.

Counterpart of the JAX package's ``optim/base.py``: ``make_optimizer`` builds
a ``torch.optim.Optimizer`` for one of eight rules (``OPTIMIZER_NAMES``).  A
parameter with at least ``min_8bit_size`` elements under ``optim_bits=8``
keeps its moments as uint8 codes with one float32 absmax per 256 elements;
any other keeps float32 moments.  Per parameter, ``optimizer.state[p]``
holds ``step`` and ``state1`` (and ``state2`` for the two-state rules), plus
``absmax1``/``absmax2`` when 8-bit: the JAX package's per-leaf layout.

A step groups the parameters of each param group that share a type and a
step count.  The 8-bit ones of a group take one launch of the fused kernel
on CUDA: kernel 14, or kernel 15 for AdEMAMix's three states.  The 32-bit
ones of a group that also share a shape (the small tensors, such as LoRA's
0-d scales) take one elementwise update over their stack, whose results go
back to each tensor: the bits of a per-tensor update.  With ``max_unorm`` (LAMB, LARS)
each parameter steps alone, and an 8-bit one takes the blockwise dequantize
(kernel 12), the clipped fp32 step, and the blockwise quantize (kernel 13)
instead, as the JAX package does.  The steps run in place under
``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..functional.blockwise import dequantize_blockwise_with_code, quantize_blockwise_with_code
from ..functional.codebooks import create_dynamic_map
from ..functional.optim_update import (
    BLOCKSIZE_8BIT_STATE,
    OPTIMIZER_NAMES,
    optimizer_update_32bit,
)
from ..ops.optim8bit import RULES, StateCodes, StateLeaf, UpdateScalars, optimizer_update_leaves_

__all__ = ["BnbOptimizer", "GlobalOptimManager", "make_optimizer"]

_TWO_STATE = ("adam", "lamb", "ademamix")

LearningRate = Union[float, Callable[[int], float]]


class GlobalOptimManager:
    """Per-parameter overrides of the optimizer config: not ported yet
    (ROADMAP Queue 1, slice D, ``optim/overrides.py`` and ``optim/compat.py``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GlobalOptimManager is not ported yet (ROADMAP Queue 1, slice D: optim/overrides.py)")

    @classmethod
    def get_instance(cls):
        return cls()


def _ademamix_schedules(step: int, alpha: float, beta3: float, t_alpha, t_beta3):
    """AdEMAMix's alpha and beta3 warm-ups at ``step``, computed as the JAX
    package computes them: every operation in float32, in its order (the
    beta3 warm-up interpolates in log space from ``ln 0.9``)."""
    f32 = np.float32
    step_f = f32(step)
    alpha_t = min(step_f * f32(alpha) / f32(t_alpha), f32(alpha)) if t_alpha else f32(alpha)
    if t_beta3 and step_f < f32(t_beta3):
        frac = min(max(step_f / f32(t_beta3), f32(0.0)), f32(1.0))
        denom = (f32(1.0) - frac) / f32(math.log(0.9)) + frac / f32(math.log(beta3))
        beta3_t = math.exp(f32(1.0) / denom)
    else:
        beta3_t = f32(beta3)
    return float(alpha_t), float(f32(beta3_t))


class BnbOptimizer(torch.optim.Optimizer):
    """One of the eight rules over ``params``, with 8-bit or 32-bit states.

    ``lr`` may be a callable of the step (a schedule).  ``is_paged`` raises:
    paged states (``optim/paged.py``) are not ported yet.  AdEMAMix takes
    ``max_unorm`` at 0 only, as in the JAX package."""

    def __init__(
        self,
        params,
        name: str,
        lr: LearningRate = 1e-3,
        *,
        beta1: float = 0.9,
        beta2: float = 0.999,
        beta3: float = 0.0,
        alpha: float = 0.0,
        t_alpha: Optional[int] = None,
        t_beta3: Optional[int] = None,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        optim_bits: int = 32,
        min_8bit_size: int = 4096,
        max_unorm: float = 0.0,
        gnorm_scale: float = 1.0,
        is_paged: bool = False,
    ):
        if name not in OPTIMIZER_NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        if optim_bits not in (8, 32):
            raise ValueError("optim_bits must be 8 or 32")
        if is_paged:
            raise NotImplementedError("paged optimizer states are not ported yet "
                                      "(ROADMAP Queue 1, slice D: optim/paged.py)")
        if name == "ademamix" and max_unorm > 0.0:
            raise NotImplementedError("ademamix does not use max_unorm")
        defaults = dict(lr=lr, beta1=beta1, beta2=beta2, beta3=beta3, alpha=alpha, t_alpha=t_alpha,
                        t_beta3=t_beta3, eps=eps, weight_decay=weight_decay, optim_bits=optim_bits,
                        min_8bit_size=min_8bit_size, max_unorm=max_unorm, gnorm_scale=gnorm_scale)
        super().__init__(params, defaults)
        self.name = name
        self.qmap1 = create_dynamic_map(signed=True)
        self.qmap2 = create_dynamic_map(signed=False)
        self.codes = StateCodes(self.qmap1, self.qmap2 if name in _TWO_STATE else None)
        self._leaves = {}  # parameter -> its StateLeaf, checked once

    def _init_state(self, p: torch.Tensor, group: dict) -> dict:
        two = self.name in _TWO_STATE
        lead = (2,) if self.name == "ademamix" else ()
        state = {"step": 0}
        if group["optim_bits"] == 8 and p.numel() >= group["min_8bit_size"]:
            nb = -(-p.numel() // BLOCKSIZE_8BIT_STATE)
            state["state1"] = torch.zeros(lead + tuple(p.shape), dtype=torch.uint8, device=p.device)
            state["absmax1"] = torch.zeros(lead + (nb,), dtype=torch.float32, device=p.device)
            if two:
                state["state2"] = torch.zeros(tuple(p.shape), dtype=torch.uint8, device=p.device)
                state["absmax2"] = torch.zeros(nb, dtype=torch.float32, device=p.device)
        else:
            state["state1"] = torch.zeros(lead + tuple(p.shape), dtype=torch.float32, device=p.device)
            if two:
                state["state2"] = torch.zeros(tuple(p.shape), dtype=torch.float32, device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            fused, flat = {}, {}  # (device, p and grad types, step[, shape]) -> parameters
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p, group))
                state["step"] += 1
                if group["max_unorm"] > 0.0:
                    self._update(p, p.grad, state, group)
                    continue
                key = (p.device, p.dtype, p.grad.dtype, state["step"])
                if state["state1"].dtype == torch.uint8:
                    fused.setdefault(key, []).append(p)
                else:
                    flat.setdefault(key + (p.shape,), []).append(p)
            for (_, _, _, step), ps in fused.items():
                self._update_8bit(ps, step, group)
            for (_, _, _, step, _), ps in flat.items():
                self._update_32bit(ps, step, group)
        return loss

    def _hyper(self, step: int, group: dict) -> dict:
        """The rule's keyword arguments at ``step``: AdEMAMix's alpha and
        beta3 are this step's scheduled values."""
        lr = group["lr"](step) if callable(group["lr"]) else group["lr"]
        alpha, beta3 = group["alpha"], group["beta3"]
        if self.name == "ademamix":
            alpha, beta3 = _ademamix_schedules(step, alpha, beta3, group["t_alpha"], group["t_beta3"])
        return dict(beta1=group["beta1"], beta2=group["beta2"], eps=group["eps"],
                    weight_decay=group["weight_decay"], step=step, lr=lr, gnorm_scale=group["gnorm_scale"],
                    beta3=beta3, alpha=alpha)

    def _leaf(self, p: torch.Tensor) -> StateLeaf:
        """``p``'s StateLeaf, made again only when one of its state tensors
        was replaced (``load_state_dict``)."""
        state, leaf = self.state[p], self._leaves.get(p)
        tensors = (state["state1"], state.get("state2"), state["absmax1"], state.get("absmax2"))
        if leaf is None or any(a is not b for a, b in zip((leaf.s1, leaf.s2, leaf.am1, leaf.am2), tensors)):
            leaf = StateLeaf(RULES[self.name], p, *tensors)
            self._leaves[p] = leaf
        return leaf

    def _update_8bit(self, ps: list, step: int, group: dict) -> None:
        """One fused 8-bit step over ``ps``: one kernel launch on CUDA."""
        sc = UpdateScalars.make(self.name, **self._hyper(step, group))
        optimizer_update_leaves_(sc, [p.grad.contiguous() for p in ps], [self._leaf(p) for p in ps], self.codes)

    def _update_32bit(self, ps: list, step: int, group: dict) -> None:
        """One elementwise fp32 step over ``ps``, tensors of one shape, and
        their states, stacked on a new last dimension and copied back into
        each: the per-tensor bits."""
        states = [self.state[p] for p in ps]
        s1 = [st["state1"] for st in states]
        s2 = [st["state2"] for st in states] if "state2" in states[0] else None
        new_p, n1, n2 = optimizer_update_32bit(
            self.name, torch.stack([p.grad for p in ps], -1), torch.stack(ps, -1), torch.stack(s1, -1),
            None if s2 is None else torch.stack(s2, -1), **self._hyper(step, group))
        torch._foreach_copy_(ps, new_p.unbind(-1))
        torch._foreach_copy_(s1, n1.unbind(-1))
        if s2 is not None:
            torch._foreach_copy_(s2, n2.unbind(-1))

    def _update(self, p: torch.Tensor, g: torch.Tensor, state: dict, group: dict) -> None:
        """One step of ``p`` alone under ``max_unorm`` (LAMB, LARS), on
        either kind of state."""
        hyper = self._hyper(state["step"], group)
        s1, s2 = state["state1"], state.get("state2")
        eight_bit = s1.dtype == torch.uint8
        bs = BLOCKSIZE_8BIT_STATE
        param_norm = torch.sqrt((p.to(torch.float32) ** 2).sum())
        if eight_bit:  # the update norm needs every element: dequantize, clipped fp32 step, requantize
            s1 = dequantize_blockwise_with_code(s1, state["absmax1"], self.qmap1, bs, torch.float32)
            if s2 is not None:
                s2 = dequantize_blockwise_with_code(s2, state["absmax2"], self.qmap2, bs, torch.float32)
        new_p, n1, n2 = optimizer_update_32bit(self.name, g, p, s1, s2, max_unorm=group["max_unorm"],
                                               param_norm=param_norm, **hyper)
        p.copy_(new_p)
        if eight_bit:
            q1, am1 = quantize_blockwise_with_code(n1, self.qmap1, bs)
            state["state1"].copy_(q1)
            state["absmax1"].copy_(am1)
            if n2 is not None:
                q2, am2 = quantize_blockwise_with_code(n2, self.qmap2, bs)
                state["state2"].copy_(q2)
                state["absmax2"].copy_(am2)
        else:
            state["state1"].copy_(n1)
            if n2 is not None:
                state["state2"].copy_(n2)


def make_optimizer(name: str, params, lr: LearningRate = 1e-3, **kwargs) -> BnbOptimizer:
    """A :class:`BnbOptimizer` of rule ``name`` over ``params`` (keyword
    arguments as its constructor's)."""
    return BnbOptimizer(params, name, lr, **kwargs)
