"""Optimizer update rules on 32-bit and 8-bit blockwise states.

Counterpart of the JAX package's ``functional/optim_update.py``.  Eight
rules (``OPTIMIZER_NAMES``): adam, lamb (the adam rule), momentum, lars (the
momentum rule), rmsprop, adagrad, lion and ademamix.

* :func:`optimizer_update_32bit` runs the fp32 rule in plain PyTorch, with
  ``max_unorm`` clipping against the update norm (LAMB/LARS).
* :func:`optimizer_update_8bit_blockwise` keeps the states as uint8 codes
  against the dynamic maps (signed for state1, unsigned for state2) with one
  float32 absmax per 256 elements.  Each step decodes the codes by segment
  arithmetic, runs the fp32 rule, takes the new block absmax and requantizes
  by segment arithmetic with the sign fixup on state1; an element whose
  gradient is NaN or Inf keeps its parameter and zeroes its states.  On CUDA
  this is always kernel 14 (``ops/optim8bit.py``), or kernel 15 for
  AdEMAMix's three states, the reference CUDA library's default; the JAX
  package's environment knobs that pick a tier have no counterpart.

Both return new tensors, as the JAX package's pure functions do; the
optimizers of ``optim/`` update in place instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.optim8bit import (
    StateCodes,
    UpdateScalars,
    optimizer_update_8bit_,
    state_dequant_blocks,
    state_requant_blocks,
)

__all__ = [
    "OPTIMIZER_NAMES",
    "BLOCKSIZE_8BIT_STATE",
    "state_dequant_blocks",
    "state_requant_blocks",
    "optimizer_update_32bit",
    "optimizer_update_8bit_blockwise",
]

OPTIMIZER_NAMES = ("adam", "lamb", "momentum", "lars", "rmsprop", "adagrad", "lion", "ademamix")
BLOCKSIZE_8BIT_STATE = 256


def _core_update(name, g, p, s1, s2, *, beta1, beta2, beta3, alpha, eps, weight_decay, step, lr,
                 update_scale):
    """The fp32 rules of the 32-bit path, in the JAX package's order.
    Returns ``(new_p, new_s1, new_s2)``; the per-step scalars are float32,
    computed on the host."""
    f32 = np.float32
    new_s2 = None
    lr32 = f32(lr)
    if name in ("adam", "lamb"):
        new_s1 = s1 * float(f32(beta1)) + float(f32(1.0 - beta1)) * g
        new_s2 = s2 * float(f32(beta2)) + float(f32(1.0 - beta2)) * g * g
        c1 = f32(1.0) - f32(beta1) ** f32(step)
        c2 = np.sqrt(f32(1.0) - f32(beta2) ** f32(step))
        step_size = -lr32 * c2 / c1
        if weight_decay > 0.0:
            p = p * float(f32(1.0) - lr32 * f32(weight_decay))
        new_p = p + update_scale * float(step_size) * (new_s1 / (torch.sqrt(new_s2) + float(f32(eps) * c2)))
    elif name == "ademamix":
        m1, m2 = s1[0], s1[1]
        new_m1 = m1 * float(f32(beta1)) + float(f32(1.0 - beta1)) * g
        new_m2 = m2 * float(f32(beta3)) + float(f32(1.0 - beta3)) * g
        new_s2 = s2 * float(f32(beta2)) + float(f32(1.0 - beta2)) * g * g
        c1 = f32(1.0) - f32(beta1) ** f32(step)
        c2 = np.sqrt(f32(1.0) - f32(beta2) ** f32(step))
        if weight_decay > 0.0:
            p = p * float(f32(1.0) - lr32 * f32(weight_decay))
        mixed = new_m1 / float(c1) + float(f32(alpha)) * new_m2
        adaptive = torch.sqrt(new_s2) / float(c2) + float(f32(eps))
        new_p = p - float(lr32) * (mixed / adaptive)
        new_s1 = torch.stack([new_m1, new_m2])
    elif name in ("momentum", "lars"):
        g = g + p * float(f32(weight_decay))
        new_s1 = g if step == 1 else s1 * float(f32(beta1)) + g
        new_p = p + update_scale * (float(-lr32) * new_s1)
    elif name == "lion":
        if weight_decay > 0.0:
            p = p * float(f32(1.0) - lr32 * f32(weight_decay))
        update_dir = torch.sign(s1 * float(f32(beta1)) + float(f32(1.0 - beta1)) * g)
        new_p = p - update_scale * float(lr32) * update_dir
        new_s1 = s1 * float(f32(beta2)) + float(f32(1.0 - beta2)) * g
    elif name == "rmsprop":
        g = g + p * float(f32(weight_decay))
        new_s1 = s1 * float(f32(beta1)) + float(f32(1.0 - beta1)) * g * g
        new_p = p - update_scale * float(lr32) * g / (torch.sqrt(new_s1) + float(f32(eps)))
    elif name == "adagrad":
        g = g + p * float(f32(weight_decay))
        new_s1 = s1 + g * g
        new_p = p - float(lr32) * g / (torch.sqrt(new_s1) + float(f32(eps)))
    else:
        raise ValueError(f"unsupported optimizer {name!r}")
    return new_p, new_s1, new_s2


def _update_norm(name, g, s1, s2, *, beta1, beta2, eps, step):
    """Squared norm of the update the rule would take (Lion: of its updated
    state), for ``max_unorm``."""
    f32 = np.float32
    if name in ("adam", "lamb"):
        c1 = float(f32(1.0) / (f32(1.0) - f32(beta1) ** f32(step)))
        c2 = float(f32(1.0) / (f32(1.0) - f32(beta2) ** f32(step)))
        s1n = (s1 * float(f32(beta1)) + float(f32(1.0 - beta1)) * g) * c1
        s2n = (s2 * float(f32(beta2)) + float(f32(1.0 - beta2)) * g * g) * c2
        upd = s1n / (torch.sqrt(s2n) + float(f32(eps)))
        return (upd * upd).sum()
    if name == "ademamix":
        return s1.sum()
    if name in ("momentum", "lars"):
        s1n = g if step == 1 else s1 * float(f32(beta1)) + g
        return (s1n * s1n).sum()
    if name == "lion":
        return (s1 * float(f32(beta2)) + float(f32(1.0 - beta2)) * g).sum()
    if name == "rmsprop":
        s1n = s1 * float(f32(beta1)) + float(f32(1.0 - beta1)) * g * g
        upd = g / (torch.sqrt(s1n) + float(f32(eps)))
        return (upd * upd).sum()
    if name == "adagrad":
        upd = g / (torch.sqrt(s1 + g * g) + float(f32(eps)))
        return (upd * upd).sum()
    raise ValueError(name)


def optimizer_update_32bit(
    name: str,
    g: torch.Tensor,
    p: torch.Tensor,
    state1: torch.Tensor,
    state2: Optional[torch.Tensor] = None,
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    beta3: float = 0.0,
    alpha: float = 0.0,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    step: int,
    lr: float,
    gnorm_scale: float = 1.0,
    max_unorm: float = 0.0,
    param_norm=0.0,
):
    """One fp32 step on any parameter dtype: ``(new_p, new_state1,
    new_state2)``.  ``max_unorm > 0`` scales the update down to
    ``max_unorm * param_norm`` (plus eps for the rules without a second
    moment) when its norm is larger."""
    g_f = g.to(torch.float32) * float(np.float32(gnorm_scale))
    p_f = p.to(torch.float32)
    s1 = state1.to(torch.float32)
    s2 = state2.to(torch.float32) if state2 is not None else None
    update_scale = 1.0
    if max_unorm > 0.0:
        current = torch.sqrt(_update_norm(name, g_f, s1, s2, beta1=beta1, beta2=beta2, eps=eps, step=step))
        limit = max_unorm * param_norm
        if name in ("momentum", "lars", "rmsprop", "adagrad", "lion"):
            limit = limit + eps
        update_scale = torch.where(current > limit, limit / current, 1.0).to(torch.float32)
    new_p, new_s1, new_s2 = _core_update(
        name, g_f, p_f, s1, s2, beta1=beta1, beta2=beta2, beta3=beta3, alpha=alpha, eps=eps,
        weight_decay=weight_decay, step=step, lr=lr, update_scale=update_scale,
    )
    new_p = new_p.to(p.dtype)
    new_s1 = new_s1.to(state1.dtype)
    if new_s2 is not None and state2 is not None:
        new_s2 = new_s2.to(state2.dtype)
    return new_p, new_s1, new_s2


def optimizer_update_8bit_blockwise(
    name: str,
    g: torch.Tensor,
    p: torch.Tensor,
    state1: torch.Tensor,
    state2: Optional[torch.Tensor],
    qmap1,
    qmap2,
    absmax1: torch.Tensor,
    absmax2: Optional[torch.Tensor],
    *,
    beta1: float,
    beta2: float,
    beta3: float = 0.0,
    alpha: float = 0.0,
    eps: float,
    weight_decay: float = 0.0,
    step: int,
    lr: float,
    gnorm_scale: float = 1.0,
    apply_sign_fixup: bool = True,
):
    """One 8-bit blockwise step: ``(new_p, new_state1, new_state2,
    new_absmax1, new_absmax2)``, the inputs left as they were.  ``qmap1``
    and ``qmap2`` are the state codebooks (numpy).  AdEMAMix takes this
    step's scheduled ``beta3`` and ``alpha``, its momenta as ``state1 [2,
    ...]`` and their absmax as ``absmax1 [2, nb]``."""
    outs = [t.clone() if t is not None else None for t in (p, state1, state2, absmax1, absmax2)]
    sc = UpdateScalars.make(name, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
                            step=step, lr=lr, gnorm_scale=gnorm_scale, beta3=beta3, alpha=alpha)
    codes = StateCodes(qmap1, qmap2 if sc.two_state else None)
    optimizer_update_8bit_(sc, g, *outs, codes, fixup=apply_sign_fixup)
    return tuple(outs)
