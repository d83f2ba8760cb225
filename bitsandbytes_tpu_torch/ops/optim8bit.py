"""Fused 8-bit blockwise optimizer update: kernel wrappers and plain version.

Replaces the TPU kernels of the JAX package's ``ops/pallas/optim8bit.py``:
``optimizer_update_8bit_pallas`` -> ``_run`` (body ``_kernel``, kernel 14,
seven rules) and -> ``_run_ademamix`` (body ``_kernel_ademamix``, kernel 15,
AdEMAMix's three states); the CUDA source is ``csrc/optim8bit.cu``.  One
pass per 256-element block:

1. decode the uint8 states by segment arithmetic (``dynamic_segments``),
   times the block absmax;
2. run the fp32 rule (adam/lamb, momentum/lars, lion, rmsprop, adagrad,
   ademamix); an element whose gradient is NaN or Inf keeps its parameter
   and zeroes its states;
3. take the new block absmax of each state;
4. requantize by segment arithmetic, with the sign fixup on the signed
   states (state1; both AdEMAMix momenta, never its ``nu``);
5. write the parameter, the uint8 states and their absmax arrays, in place.

AdEMAMix keeps its two momenta as ``state1 [2, *shape]`` with ``absmax1
[2, nb]`` (the JAX package's leaf layout) and ``nu`` as state2.

The gradient and the parameter share one type, f32, bf16 or f16: both
versions compute in f32 and store the parameter in its own type, rounded to
nearest even (the JAX package's ``new_p.astype(p.dtype)``).

Bound on the H100 by bytes: 16 B an element in f32 (gradient read,
parameter read and written, each uint8 state read and written; 10 B in
bf16), 18 B for AdEMAMix.  The kernel gives one warp to each block, 8 elements a lane, so the absmax
reduces in registers by shuffles; a grid-stride loop amortizes each CUDA
block's shared-memory decode tables over many quantization blocks.

The per-step scalars (bias corrections, step size, decay, AdEMAMix's
scheduled ``alpha_t`` and ``beta3_t``) are computed once per call, in
float32 on the host, and handed to the kernel and the plain version alike.
The bias corrections are ``1 - exp(step * log(beta))`` as the TPU kernels
compute them (the JAX package's jnp tier uses ``beta**step``).
The kernel writes every operation with an explicitly rounded intrinsic in
the plain version's order, so the two give the same states bit for bit.
A ragged tail (``n % 256``) is masked in the kernel, which gives the result
of the TPU kernel's zero padding without a copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..functional.dynamic_segments import (
    SymSegmentTable,
    build_state_tables,
    fma_f32,
    segment_decode,
    segment_decode_sym,
    segment_requant,
    segment_requant_sym,
    sign_fixup,
    state_map,
)
from . import _lib
from .dispatch import use_kernel
from .gemm4bit_paired import _KIND

__all__ = [
    "RULES",
    "StateCodes",
    "UpdateScalars",
    "optimizer_update_8bit_",
    "optimizer_update_8bit_plain",
    "state_dequant_blocks",
    "state_requant_blocks",
]

BLOCK = 256
# rule id of the CUDA kernel's template, per optimizer name
RULES = {"adam": 0, "lamb": 0, "momentum": 1, "lars": 1, "lion": 2, "rmsprop": 3, "adagrad": 4,
         "ademamix": 5}
_ADEMAMIX = 5
_TWO_STATE = (0, _ADEMAMIX)
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class UpdateScalars:
    """One step's float32 scalars, as the kernel and the plain version take
    them (every field already rounded to float32)."""

    rule: int
    beta1: float
    beta2: float
    omb1: float        # 1 - beta1
    omb2: float        # 1 - beta2
    eps: float
    eps_c2: float      # adam: eps * sqrt(1 - beta2**step)
    step_size: float   # adam: -lr * sqrt(1 - beta2**step) / (1 - beta1**step)
    lr: float
    weight_decay: float
    decay: Optional[float]  # 1 - lr * weight_decay where the rule decays p first
    first_step: bool
    gnorm_scale: float
    c1: float = 0.0       # adam, ademamix: 1 - beta1**step
    c2: float = 0.0       # adam, ademamix: sqrt(1 - beta2**step)
    alpha_t: float = 0.0  # ademamix: the scheduled alpha of this step
    beta3_t: float = 0.0  # ademamix: the scheduled beta3 of this step
    omb3: float = 0.0     # ademamix: 1 - beta3_t, a float32 subtraction

    @property
    def two_state(self) -> bool:
        """A second state (adam's and AdEMAMix's ``nu``) beside state1."""
        return self.rule in _TWO_STATE

    @property
    def ademamix(self) -> bool:
        """Three states: two momenta in ``state1 [2, ...]`` and ``nu``."""
        return self.rule == _ADEMAMIX

    @classmethod
    @functools.lru_cache(maxsize=256)
    def make(cls, name: str, *, beta1: float, beta2: float, eps: float, weight_decay: float,
             step: int, lr: float, gnorm_scale: float = 1.0, beta3: float = 0.0,
             alpha: float = 0.0) -> "UpdateScalars":
        """The scalars of one step, built once per distinct step and
        hyperparameters: an optimizer step asks for them for every tensor.
        For AdEMAMix, ``beta3`` and ``alpha`` are this step's scheduled
        values (``optim/base._ademamix_schedules``)."""
        if name not in RULES:
            raise NotImplementedError(f"the fused 8-bit update has no rule {name!r}")
        rule = RULES[name]
        f32 = np.float32
        lr32 = f32(lr)
        eps_c2 = step_size = c1 = c2 = f32(0.0)
        if rule in (0, _ADEMAMIX):
            with np.errstate(divide="ignore"):
                lb1, lb2 = f32(np.log(np.float64(beta1))), f32(np.log(np.float64(beta2)))
            c1 = f32(1.0) - _exp_f32(f32(step) * lb1)
            c2 = np.sqrt(f32(1.0) - _exp_f32(f32(step) * lb2))
            step_size = -lr32 * c2 / c1
            eps_c2 = f32(eps) * c2
        decay = None
        if weight_decay > 0.0 and rule in (0, 2, _ADEMAMIX):
            decay = float(f32(1.0) - lr32 * f32(weight_decay))
        return cls(
            rule=rule, beta1=float(f32(beta1)), beta2=float(f32(beta2)),
            omb1=float(f32(1.0 - beta1)), omb2=float(f32(1.0 - beta2)), eps=float(f32(eps)),
            eps_c2=float(f32(eps_c2)), step_size=float(f32(step_size)), lr=float(lr32),
            weight_decay=float(f32(weight_decay)), decay=decay, first_step=step == 1,
            gnorm_scale=float(f32(gnorm_scale)), c1=float(f32(c1)), c2=float(f32(c2)),
            alpha_t=float(f32(alpha)), beta3_t=float(f32(beta3)), omb3=float(f32(1.0) - f32(beta3)),
        )


def _exp_f32(x) -> np.float32:
    """The float32 exp of a float32 value, correctly rounded.  Neither
    numpy's float32 exp nor XLA's on the CPU (a polynomial) always is: the
    JAX kernels' bias corrections can sit 1 ulp from these."""
    return np.float32(math.exp(float(x)))


def _full(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.full_like(x, c)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once: a tensor divisor, since CUDA divides by a
    host scalar as a multiplication by its reciprocal."""
    return x / _full(x, c)


def _update_plain(sc: UpdateScalars, g, p, s1, s2):
    """The fp32 rule of the fused kernel, one rounded operation at a time.
    AdEMAMix takes and returns its two momenta as a pair."""
    g = g * sc.gnorm_scale
    ns2 = None
    if sc.ademamix:  # the fused multiply-adds where XLA contracts the JAX kernel's
        m1, m2 = s1
        nm1 = fma_f32(_full(g, sc.omb1), g, m1 * sc.beta1)
        nm2 = fma_f32(_full(g, sc.omb3), g, m2 * sc.beta3_t)
        ns2 = fma_f32(sc.omb2 * g, g, s2 * sc.beta2)
        mixed = fma_f32(_full(nm2, sc.alpha_t), nm2, _div(nm1, sc.c1))
        adaptive = _div(torch.sqrt(ns2), sc.c2) + sc.eps
        step = mixed / adaptive
        if sc.decay is not None:
            new_p = fma_f32(p, _full(p, sc.decay), -(sc.lr * step))
        else:
            new_p = fma_f32(_full(p, -sc.lr), step, p)
        ns1 = (nm1, nm2)
    elif sc.rule == 0:
        ns1 = s1 * sc.beta1 + sc.omb1 * g
        ns2 = s2 * sc.beta2 + sc.omb2 * g * g
        pd = p * sc.decay if sc.decay is not None else p
        new_p = pd + sc.step_size * (ns1 / (torch.sqrt(ns2) + sc.eps_c2))
    elif sc.rule == 1:
        gw = g + p * sc.weight_decay
        ns1 = gw if sc.first_step else s1 * sc.beta1 + gw
        new_p = p - sc.lr * ns1
    elif sc.rule == 2:
        pd = p * sc.decay if sc.decay is not None else p
        direction = torch.sign(s1 * sc.beta1 + sc.omb1 * g)
        new_p = pd - sc.lr * direction
        ns1 = s1 * sc.beta2 + sc.omb2 * g
    elif sc.rule == 3:
        gw = g + p * sc.weight_decay
        ns1 = s1 * sc.beta1 + sc.omb1 * gw * gw
        new_p = p - sc.lr * gw / (torch.sqrt(ns1) + sc.eps)
    else:
        gw = g + p * sc.weight_decay
        ns1 = s1 + gw * gw
        new_p = p - sc.lr * gw / (torch.sqrt(ns1) + sc.eps)
    finite = torch.isfinite(g)
    new_p = torch.where(finite, new_p, p)
    if sc.ademamix:
        ns1 = tuple(torch.where(finite, m, 0.0) for m in ns1)
    else:
        ns1 = torch.where(finite, ns1, 0.0)
    if ns2 is not None:
        ns2 = torch.where(finite, ns2, 0.0)
    return new_p, ns1, ns2


def state_dequant_blocks(codes2d: torch.Tensor, absmax_col: torch.Tensor, table) -> torch.Tensor:
    """uint8 state codes ``[NB, 256]`` times their block absmax ``[NB, 1]``,
    the codes decoded by segment arithmetic."""
    if isinstance(table, SymSegmentTable):
        vals = segment_decode_sym(codes2d.to(torch.int32), table)
    else:
        vals = segment_decode(codes2d.to(torch.int32), table)
    return vals * absmax_col


def state_requant_blocks(x2d: torch.Tensor, table, fixup: bool, am: Optional[torch.Tensor] = None):
    """f32 states ``[NB, 256]`` -> (uint8 codes, absmax ``[NB, 1]``).  The
    scale is infinite below the smallest normal float32, as the JAX package
    computes it with subnormals flushed; the sign fixup applies to a signed
    map only."""
    if am is None:
        axes = tuple(range(1, x2d.dim())) if x2d.dim() > 1 else (0,)
        am = x2d.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(am < _F32_TINY, torch.inf, torch.div(1.0, am))
    scaled = torch.clamp(x2d * scale, -1.0, 1.0)
    if isinstance(table, SymSegmentTable):
        q = segment_requant_sym(scaled, table)
    else:
        q = segment_requant(scaled, table)
    if fixup:
        q = sign_fixup(q, scaled, table)
    return q.to(torch.uint8), am


def _zero_index(code_t: tuple) -> int:
    return int(np.abs(np.asarray(code_t, dtype=np.float32)).argmin())


def optimizer_update_8bit_plain(sc: UpdateScalars, g, p, s1, s2, am1, am2, code1_t: tuple,
                                code2_t: Optional[tuple], fixup: bool):
    """The kernel's function on flat tensors of ``n`` elements: returns
    ``(new_p, new_s1, new_s2, new_am1, new_am2)`` (None for a missing state
    2).  AdEMAMix's ``s1`` holds ``2n`` codes and ``am1`` two rows of
    absmax, as its results do.  Padded to whole blocks with zero gradients
    and parameters and the codes of 0.0, which changes no absmax."""
    n = p.numel()
    pad = (-n) % BLOCK

    def blocks(x, fill=0):
        flat = x.reshape(-1)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad), value=fill)
        return flat.reshape(-1, BLOCK)

    def un(x):
        return x.reshape(-1)[:n]

    t1 = build_state_tables(code1_t)
    z1 = _zero_index(code1_t)
    if sc.ademamix:
        s1_2, am1_2 = s1.reshape(2, -1), am1.reshape(2, -1)
        s1f = tuple(state_dequant_blocks(blocks(s1_2[i], z1), am1_2[i].reshape(-1, 1), t1) for i in range(2))
    else:
        s1f = state_dequant_blocks(blocks(s1, z1), am1.reshape(-1, 1), t1)
    s2f = None
    if sc.two_state:
        t2 = build_state_tables(code2_t)
        s2f = state_dequant_blocks(blocks(s2, _zero_index(code2_t)), am2.reshape(-1, 1), t2)
    new_p, ns1, ns2 = _update_plain(sc, blocks(g).to(torch.float32), blocks(p).to(torch.float32), s1f, s2f)
    if sc.ademamix:
        pairs = [state_requant_blocks(m, t1, fixup) for m in ns1]
        q1 = torch.stack([un(q) for q, _ in pairs])
        nam1 = torch.stack([am.reshape(-1) for _, am in pairs])
    else:
        q1, nam1 = state_requant_blocks(ns1, t1, fixup)
        q1, nam1 = un(q1), nam1.reshape(-1)
    q2 = nam2 = None
    if ns2 is not None:
        q2, nam2 = state_requant_blocks(ns2, t2, False)

    return (un(new_p).to(p.dtype), q1, None if q2 is None else un(q2), nam1,
            None if nam2 is None else nam2.reshape(-1))


_MAX_SEG = 16


class _StateMap(ctypes.Structure):
    """``StateMap`` of ``csrc/optim8bit.cu``."""

    _fields_ = [
        ("sym", ctypes.c_int),
        ("signed_map", ctypes.c_int),
        ("zero_idx", ctypes.c_int),
        ("nseg", ctypes.c_int),
        ("start", ctypes.c_int * _MAX_SEG),
        ("sub", ctypes.c_int * _MAX_SEG),
        ("cnt1", ctypes.c_int * _MAX_SEG),
        ("step", ctypes.c_float * _MAX_SEG),
        ("add", ctypes.c_float * _MAX_SEG),
        ("bound", ctypes.c_float * _MAX_SEG),
        ("rsub", ctypes.c_float * _MAX_SEG),
        ("inv", ctypes.c_float * _MAX_SEG),
        ("radd", ctypes.c_float * _MAX_SEG),
    ]


class _Scalars(ctypes.Structure):
    """``OptScalars`` of ``csrc/optim8bit.cu``."""

    _fields_ = [(f, ctypes.c_float) for f in (
        "beta1", "beta2", "omb1", "omb2", "eps", "eps_c2", "step_size", "lr", "weight_decay",
        "decay", "gnorm_scale")] + [("use_decay", ctypes.c_int), ("first_step", ctypes.c_int)] + [
        (f, ctypes.c_float) for f in ("c1", "c2", "alpha_t", "beta3_t", "omb3")]


@functools.lru_cache(maxsize=None)
def _state_map(code_t: tuple) -> _StateMap:
    sym, z, starts, subs, steps, adds, bounds, cnt1, rsubs, invs, radds = state_map(code_t)
    if len(starts) > _MAX_SEG:
        raise ValueError(f"the kernel takes at most {_MAX_SEG} segments, the codebook has {len(starts)}")
    m = _StateMap()
    m.sym, m.zero_idx, m.nseg = int(sym), z, len(starts)
    m.signed_map = int(sym or np.asarray(code_t, dtype=np.float32)[0] < 0)
    for i in range(len(starts)):
        m.start[i], m.sub[i], m.cnt1[i] = starts[i], subs[i], cnt1[i]
        m.step[i], m.add[i], m.inv[i], m.rsub[i], m.radd[i] = steps[i], adds[i], invs[i], rsubs[i], radds[i]
    for i, b in enumerate(bounds):
        m.bound[i] = b
    return m


@functools.lru_cache(maxsize=256)
def _scalars_struct(sc: UpdateScalars) -> _Scalars:
    cs = _Scalars()
    for f in ("beta1", "beta2", "omb1", "omb2", "eps", "eps_c2", "step_size", "lr", "weight_decay",
              "gnorm_scale", "c1", "c2", "alpha_t", "beta3_t", "omb3"):
        setattr(cs, f, getattr(sc, f))
    cs.decay = sc.decay if sc.decay is not None else 1.0
    cs.use_decay = int(sc.decay is not None)
    cs.first_step = int(sc.first_step)
    return cs


def _code_t(code) -> tuple:
    return tuple(float(x) for x in np.asarray(code, dtype=np.float32).reshape(-1)[:256])


class StateCodes:
    """The two state codebooks (state2's None for the one-state rules),
    converted once: float tuples for the plain version, segment tables for
    the kernel."""

    def __init__(self, code1, code2=None):
        self.code1 = _code_t(code1)
        self.code2 = None if code2 is None else _code_t(code2)

    @functools.cached_property
    def maps(self):
        m1 = _state_map(self.code1)
        return m1, (m1 if self.code2 is None else _state_map(self.code2))


def optimizer_update_8bit_(sc: UpdateScalars, g, p, s1, s2, am1, am2, codes: StateCodes,
                           fixup: bool = True) -> None:
    """One fused 8-bit step, in place on ``p``, ``s1``, ``s2``, ``am1`` and
    ``am2`` (``s2``/``am2`` None for a one-state rule).  ``g`` and ``p`` are
    float32, bf16 or f16 (on CUDA: one type, contiguous, 16-byte aligned); ``s1``/``s2`` uint8 of
    ``p``'s shape; ``am1``/``am2`` float32 ``[ceil(n / 256)]``; ``codes`` the
    state codebooks.  AdEMAMix's ``s1`` is ``[2, *p.shape]`` and ``am1``
    ``[2, ceil(n / 256)]``: the kernel takes their two halves as separate
    pointers."""
    n = p.numel()
    nb = -(-n // BLOCK)
    lead = 2 if sc.ademamix else 1
    if g.numel() != n or s1.numel() != lead * n or s1.dtype != torch.uint8:
        raise ValueError("g, p and state1 must have the same number of elements "
                         "(twice as many in AdEMAMix's state1), state1 uint8")
    if am1.dtype != torch.float32 or am1.numel() != lead * nb:
        raise ValueError(f"absmax1 must be float32 with {lead} x {nb} blocks")
    if sc.two_state and (s2 is None or s2.numel() != n or am2 is None or am2.numel() != nb):
        raise ValueError("a two-state rule needs state2 and absmax2 of the same sizes")
    if sc.two_state and codes.code2 is None:
        raise ValueError("a two-state rule needs state2's codebook")
    tensors = [g, p, s1, am1] + ([s2, am2] if sc.two_state else [])
    if not use_kernel(*tensors):
        new = optimizer_update_8bit_plain(sc, g, p, s1, s2, am1, am2, codes.code1,
                                          codes.code2 if sc.two_state else None, fixup)
        for dst, src in zip((p, s1, s2, am1, am2), new):
            if dst is not None:
                dst.copy_(src.reshape(dst.shape))
        return
    if p.dtype not in _KIND or g.dtype != p.dtype:
        raise ValueError("the CUDA kernel takes a gradient and a parameter of one type: f32, bf16 or f16")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned tensors")
    if n == 0:
        return
    m1, m2 = codes.maps
    cs = _scalars_struct(sc)
    if sc.ademamix:  # kernel 15: the second momentum and its absmax start n codes and nb scales in
        s1v, am1v = s1.reshape(2, n), am1.reshape(2, nb)
        err = _lib.lib().bnb_optimizer_update_8bit_ademamix(
            g.data_ptr(), p.data_ptr(), s1v[0].data_ptr(), s1v[1].data_ptr(), s2.data_ptr(),
            am1v[0].data_ptr(), am1v[1].data_ptr(), am2.data_ptr(), n, ctypes.addressof(cs),
            ctypes.addressof(m1), ctypes.addressof(m2), int(fixup), _KIND[p.dtype], _lib.stream(p),
        )
        _lib.check(err, "optimizer_update_8bit_ademamix")
        _lib.LAUNCHES["optimizer_update_8bit_ademamix"] += 1
        return
    err = _lib.lib().bnb_optimizer_update_8bit(
        g.data_ptr(), p.data_ptr(), s1.data_ptr(), s2.data_ptr() if sc.two_state else None,
        am1.data_ptr(), am2.data_ptr() if sc.two_state else None, n, sc.rule,
        ctypes.addressof(cs), ctypes.addressof(m1), ctypes.addressof(m2), int(fixup), _KIND[p.dtype],
        _lib.stream(p),
    )
    _lib.check(err, "optimizer_update_8bit")
    _lib.LAUNCHES["optimizer_update_8bit"] += 1
