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
bf16), 18 B for AdEMAMix.  One launch updates a whole group of tensors
(:func:`optimizer_update_8bit_multi_`; an optimizer step makes one group of
its 8-bit tensors per param group, type and step count): a table of
descriptors, rebuilt every step because the gradients move, goes to the
device from pinned memory, and the kernel walks the concatenation of the
tensors' 256-element blocks on a grid of what the card holds resident.  One
warp owns a quantization block at a time, 8 elements a lane, so the absmax
reduces in registers by shuffles; each CUDA block stages the decode tables
and requant segments once.  The single-tensor entry is a table of one.

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
    sqrt_f32,
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
    "StateLeaf",
    "UpdateScalars",
    "leaf_blocks",
    "leaf_table",
    "optimizer_update_8bit_",
    "optimizer_update_8bit_multi_",
    "optimizer_update_8bit_plain",
    "optimizer_update_leaves_",
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
        adaptive = _div(sqrt_f32(ns2), sc.c2) + sc.eps
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
        new_p = pd + sc.step_size * (ns1 / (sqrt_f32(ns2) + sc.eps_c2))
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
        new_p = p - sc.lr * gw / (sqrt_f32(ns1) + sc.eps)
    else:
        gw = g + p * sc.weight_decay
        ns1 = s1 + gw * gw
        new_p = p - sc.lr * gw / (sqrt_f32(ns1) + sc.eps)
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
# StateMapWords and Leaf of csrc/optim8bit.cu, in 32-bit and 64-bit words
_MAP_WORDS = 4 + _MAX_SEG + 4 * _MAX_SEG + 256 + 512 // 4
_LEAF_FIELDS = 10  # g, p, three states, three absmax, n, first block


def _decode_table(code_t: tuple) -> np.ndarray:
    """The 256 codes of a state codebook decoded by the plain version."""
    t = build_state_tables(code_t)
    idx = torch.arange(256, dtype=torch.int32)
    vals = segment_decode_sym(idx, t) if isinstance(t, SymSegmentTable) else segment_decode(idx, t)
    return vals.numpy().astype(np.float32)


def _binade_firsts(bounds: np.ndarray) -> np.ndarray:
    """Per sign-and-exponent byte pair of a float32 (its top 9 bits), the
    number of ``bounds`` below every value with those bits: 0 for NaN and
    infinity.  The kernel adds one compare, so no such binade may hold two
    bounds."""
    top = np.arange(512, dtype=np.uint32) << 23
    neg = np.arange(512) >= 256
    lo = np.where(neg, top | 0x7FFFFF, top).view(np.float32)  # the lowest value of each binade
    hi = np.where(neg, top, top | 0x7FFFFF).view(np.float32)
    finite = np.isfinite(lo)
    with np.errstate(invalid="ignore"):
        first = np.where(finite, np.searchsorted(bounds, lo, side="left"), 0)
        inside = np.where(finite, np.searchsorted(bounds, hi, side="right"), 0) - first
    if inside.max(initial=0) > 1:
        raise ValueError("the kernel takes codebooks whose segment bounds lie in distinct binades")
    return first.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _map_words(code_t: tuple) -> np.ndarray:
    """One state codebook as the kernel stages it in shared memory
    (``StateMapWords``): sym, signed, zero_idx and the segment count; the
    sorted segment bounds, +inf past the used ones; per segment rsub, inv,
    radd and ``start | cnt1 << 16``; the 256 decoded codes; the bounds below
    each binade (:func:`_binade_firsts`)."""
    sym, z, starts, _, _, _, bounds, cnt1, rsubs, invs, radds = state_map(code_t)
    nseg = len(starts)
    if nseg > _MAX_SEG:
        raise ValueError(f"the kernel takes at most {_MAX_SEG} segments, the codebook has {nseg}")
    b = np.asarray(bounds, dtype=np.float32)
    if np.any(b[1:] < b[:-1]):
        raise ValueError("the kernel's requant takes sorted segment bounds")
    w = np.zeros(_MAP_WORDS, dtype=np.uint32)
    f = w.view(np.float32)
    w[:4] = (int(sym), int(sym or np.float32(code_t[0]) < 0), z, nseg)
    f[4:4 + _MAX_SEG] = np.inf
    f[4:4 + len(b)] = b
    seg_f, seg_w = f[4 + _MAX_SEG:-384].reshape(_MAX_SEG, 4), w[4 + _MAX_SEG:-384].reshape(_MAX_SEG, 4)
    seg_f[:nseg, 0], seg_f[:nseg, 1], seg_f[:nseg, 2] = rsubs, invs, radds
    seg_w[:nseg, 3] = np.asarray(starts, dtype=np.uint32) | (np.asarray(cnt1, dtype=np.uint32) << 16)
    f[-384:-128] = _decode_table(code_t)
    w[-128:] = _binade_firsts(b).view(np.uint32)
    return w


@functools.lru_cache(maxsize=None)
def _device_maps(code1: tuple, code2: Optional[tuple], device: torch.device) -> torch.Tensor:
    """Both codebooks' words on ``device`` (state2's repeats state1's for a
    one-state rule), uploaded once per codebook pair and device."""
    words = np.concatenate([_map_words(code1), _map_words(code1 if code2 is None else code2)])
    return torch.from_numpy(words.view(np.int32)).to(device)


class _Scalars(ctypes.Structure):
    """``OptScalars`` of ``csrc/optim8bit.cu``."""

    _fields_ = [(f, ctypes.c_float) for f in (
        "beta1", "beta2", "omb1", "omb2", "eps", "eps_c2", "step_size", "lr", "weight_decay",
        "decay", "gnorm_scale")] + [("use_decay", ctypes.c_int), ("first_step", ctypes.c_int)] + [
        (f, ctypes.c_float) for f in ("c1", "c2", "alpha_t", "beta3_t", "omb3")]


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


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _code_t(code) -> tuple:
    return tuple(float(x) for x in np.asarray(code, dtype=np.float32).reshape(-1)[:256])


class StateCodes:
    """The two state codebooks (state2's None for the one-state rules) as
    float tuples, the key of the kernel's device tables."""

    def __init__(self, code1, code2=None):
        self.code1 = _code_t(code1)
        self.code2 = None if code2 is None else _code_t(code2)


class StateLeaf:
    """One parameter and its 8-bit states as the kernel takes them: ``p``,
    ``s1``/``s2`` uint8 of ``p``'s shape, ``am1``/``am2`` float32 ``[ceil(n /
    256)]`` (``s2``/``am2`` None for a one-state rule); AdEMAMix's ``s1`` is
    ``[2, *p.shape]`` and ``am1`` ``[2, ceil(n / 256)]``, whose halves the
    kernel takes as separate pointers.  Checked where it is made, and again
    only when one of its tensors moves; on CUDA, ``p`` is f32, bf16 or f16 and
    every tensor contiguous and 16-byte aligned."""

    __slots__ = ("rule", "p", "s1", "s2", "am1", "am2", "n", "nb", "cuda", "device", "dtype", "_raw")

    def __init__(self, rule: int, p, s1, s2, am1, am2):
        self.rule, self.p, self.s1, self.s2, self.am1, self.am2 = rule, p, s1, s2, am1, am2
        self._check()

    def _tensors(self) -> list:
        return [self.p, self.s1, self.am1] + ([self.s2, self.am2] if self.rule in _TWO_STATE else [])

    def _check(self) -> None:
        p, s1, s2, am1, am2 = self.p, self.s1, self.s2, self.am1, self.am2
        n = p.numel()
        nb = -(-n // BLOCK)
        lead = 2 if self.rule == _ADEMAMIX else 1
        if s1.numel() != lead * n or s1.dtype != torch.uint8:
            raise ValueError("p and state1 must have the same number of elements "
                             "(twice as many in AdEMAMix's state1), state1 uint8")
        if am1.dtype != torch.float32 or am1.numel() != lead * nb:
            raise ValueError(f"absmax1 must be float32 with {lead} x {nb} blocks")
        if self.rule in _TWO_STATE and (s2 is None or s2.numel() != n or am2 is None or am2.numel() != nb):
            raise ValueError("a two-state rule needs state2 and absmax2 of the same sizes")
        tensors = self._tensors()
        self.cuda = use_kernel(*tensors)
        if self.cuda:
            if p.dtype not in _KIND:
                raise ValueError("the CUDA kernel takes a parameter of type f32, bf16 or f16")
            for t in tensors:
                if not t.is_contiguous() or t.data_ptr() % 16:
                    raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned tensors")
        self.n, self.nb, self.device, self.dtype = n, nb, p.device, p.dtype
        self._raw = tuple(t.data_ptr() for t in tensors)

    def pointers(self) -> tuple:
        """The leaf's seven pointers as the kernel's ``Leaf`` holds them: p,
        three states and three absmax arrays (0 where the rule has none)."""
        raw = tuple(t.data_ptr() for t in self._tensors())
        if raw != self._raw:  # a tensor moved (its .data replaced): check it again
            self._check()
            raw = self._raw
        if self.rule == _ADEMAMIX:  # the second momentum and its absmax start n codes and nb scales in
            p, s1, am1, s2, am2 = raw
            return p, s1, s1 + self.n, s2, am1, am1 + 4 * self.nb, am2
        if len(raw) == 5:
            p, s1, am1, s2, am2 = raw
            return p, s1, s2, 0, am1, am2, 0
        p, s1, am1 = raw
        return p, s1, 0, 0, am1, 0, 0


def leaf_blocks(ns) -> tuple:
    """The kernel's table layout for leaves of ``ns`` elements: the indices
    of the non-empty leaves, the first 256-element block of each in the
    concatenation of their blocks (the prefix sums of the block counts), and
    the total block count."""
    keep, first, total = [], [], 0
    for i, n in enumerate(ns):
        if n > 0:
            keep.append(i)
            first.append(total)
            total += -(-n // BLOCK)
    return keep, first, total


def leaf_table(sc: UpdateScalars, grads, leaves) -> tuple:
    """The kernel's descriptor table for ``leaves`` (``StateLeaf``s) and
    their gradients: one int64 row a non-empty leaf, ``Leaf`` of
    ``csrc/optim8bit.cu`` (g, p, three states, three absmax, n, first
    block), and the total block count.  Checks only what a step can change:
    each gradient's device, type, size, contiguity and alignment, and whether
    a leaf's tensors moved."""
    dev, dtype = leaves[0].device, leaves[0].dtype
    rows = []
    for g, lf in zip(grads, leaves):
        ptrs = lf.pointers()
        if lf.rule != sc.rule or lf.device != dev or g.device != dev:
            raise ValueError("one launch takes leaves of the step's rule and their gradients on one device")
        gp = g.data_ptr()
        if lf.dtype != dtype or g.dtype != dtype or g.numel() != lf.n or gp % 16 or not g.is_contiguous():
            raise ValueError("the CUDA kernel takes gradients and parameters of one type (f32, bf16 or f16), "
                             "each gradient contiguous, 16-byte aligned and of its parameter's size")
        rows.append((gp, *ptrs, lf.n))
    keep, first, total = leaf_blocks([lf.n for lf in leaves])
    table = np.array([rows[i] + (f,) for i, f in zip(keep, first)], dtype=np.int64).reshape(-1, _LEAF_FIELDS)
    return table, total


def _group_launch(sc: UpdateScalars, grads, leaves, codes: StateCodes, fixup: bool) -> None:
    """One launch over CUDA ``leaves`` and their gradients (none when every
    leaf is empty): the descriptor table goes to the device from pinned
    memory on the current stream, which orders its reuse after the kernel."""
    rows, total = leaf_table(sc, grads, leaves)
    if not total:
        return
    dev = leaves[0].device
    table = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)  # the pinned block waits for the copy
    maps = _device_maps(codes.code1, codes.code2 if sc.two_state else None, dev)
    name = "optimizer_update_8bit_ademamix" if sc.ademamix else "optimizer_update_8bit"
    _lib.check(_lib.lib().bnb_optimizer_update_8bit(
        table.data_ptr(), len(rows), total, maps.data_ptr(), ctypes.addressof(_scalars_struct(sc)), sc.rule,
        int(fixup), _KIND[leaves[0].dtype], _sms(dev.index), _lib.stream(leaves[0].p)), name)
    _lib.LAUNCHES[name] += 1


def optimizer_update_leaves_(sc: UpdateScalars, grads, leaves, codes: StateCodes, fixup: bool = True) -> None:
    """One fused 8-bit step over ``leaves`` (``StateLeaf``s of rule
    ``sc.rule``) with their gradients ``grads``, in place.  On CUDA, one
    launch for all of them; on the CPU, the plain version leaf by leaf."""
    if sc.two_state and codes.code2 is None:
        raise ValueError("a two-state rule needs state2's codebook")
    if not leaves:
        return
    if leaves[0].cuda:
        _group_launch(sc, grads, leaves, codes, fixup)
        return
    for g, lf in zip(grads, leaves):
        if use_kernel(g, *lf._tensors()) or lf.rule != sc.rule or g.numel() != lf.n:
            raise ValueError("one group takes leaves of the step's rule on one device, each gradient of its "
                             "parameter's size")
        new = optimizer_update_8bit_plain(sc, g, lf.p, lf.s1, lf.s2, lf.am1, lf.am2, codes.code1,
                                          codes.code2 if sc.two_state else None, fixup)
        for dst, src in zip((lf.p, lf.s1, lf.s2, lf.am1, lf.am2), new):
            if dst is not None:
                dst.copy_(src.reshape(dst.shape))


def optimizer_update_8bit_multi_(sc: UpdateScalars, leaves, codes: StateCodes, fixup: bool = True) -> None:
    """One fused 8-bit step over a group of tensors, in place: ``leaves`` a
    sequence of ``(g, p, s1, s2, am1, am2)`` as :func:`optimizer_update_8bit_`
    takes them, of one rule under one ``UpdateScalars`` (on CUDA, also of one
    type).  On CUDA one launch updates them all; on the CPU each takes the
    plain version in turn."""
    optimizer_update_leaves_(sc, [lf[0] for lf in leaves], [StateLeaf(sc.rule, *lf[1:]) for lf in leaves],
                             codes, fixup)


def optimizer_update_8bit_(sc: UpdateScalars, g, p, s1, s2, am1, am2, codes: StateCodes,
                           fixup: bool = True) -> None:
    """One fused 8-bit step, in place on ``p``, ``s1``, ``s2``, ``am1`` and
    ``am2`` (``s2``/``am2`` None for a one-state rule): a table of one leaf
    (:class:`StateLeaf` for the layout).  ``g`` has ``p``'s type on CUDA."""
    optimizer_update_8bit_multi_(sc, [(g, p, s1, s2, am1, am2)], codes, fixup)
