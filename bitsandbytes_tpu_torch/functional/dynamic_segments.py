"""Piecewise-linear segment decode and requant for 256-entry dynamic codebooks.

The port's copy of the JAX package's ``functional/dynamic_segments.py``.  The dynamic 8-bit map is piecewise
linear: sorted, it splits into ~16 runs of uniform spacing, so a code index
decodes as ``value = (idx - seg_start) * seg_step + seg_first`` (or
``idx * seg_step + b`` where the intercept form verifies bit-exact).  The
JAX package decodes the nested (double-quantized) absmax this way, in its
jnp tier and inside its kernels alike, and the port must give the same bits.

Both multiply-adds round once, as fused multiply-adds: XLA contracts them
when it compiles, and the JAX package's jitted decode is what the port is
held to.  :func:`fma_f32` gives that rounding in plain PyTorch, on any
device; the CUDA kernels use ``__fmaf_rn``.

The table builders are numpy only and run once per codebook.

The requant half serves the 8-bit optimizer states: a value finds its
segment by comparing against the segment boundary midpoints, then rounds to
the segment's uniform grid, ``j = clamp(floor(fma(x, inv, b)), 0, count-1)``.
That breaks ties at the quantization midpoints otherwise than a search over
the true table's midpoints (kernel 13), so the optimizer uses this form and
not that one.  A NaN scaled value (an all-zero block: ``0 * inf``) counts as
negative, as the default NaN of the x86 CPUs the JAX package is held on is.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .codebooks import create_dynamic_map

__all__ = [
    "SegmentTable",
    "SymSegmentTable",
    "build_segments",
    "build_segments_sym",
    "build_state_tables",
    "dynamic_sym_table",
    "dequant_nested_dynamic",
    "fma_f32",
    "sqrt_f32",
    "segment_decode",
    "segment_decode_sym",
    "segment_requant",
    "segment_requant_sym",
    "sign_fixup",
]


class SegmentTable(NamedTuple):
    """Static description of a piecewise-linear codebook."""

    starts: Tuple[int, ...]       # first code index of each segment
    counts: Tuple[int, ...]       # entries per segment
    firsts: Tuple[float, ...]     # code[start] per segment (f32 values)
    steps: Tuple[float, ...]      # uniform spacing per segment (f32)
    inv_steps: Tuple[float, ...]  # 1/step (f32; 0.0 for singletons)
    bounds: Tuple[float, ...]     # len-1 segment boundary midpoints (f32)
    zero_idx: int                 # index of the entry closest to 0
    signed: bool                  # True if the map contains negative values
    # decode value = idx * step + b_dec, when verified bit-exact per entry
    b_dec: Optional[Tuple[float, ...]] = None
    b_req: Optional[Tuple[float, ...]] = None


class SymSegmentTable(NamedTuple):
    """Odd-symmetric codebook (``c[z-j] == -c[z+j]`` exactly, ``c[z] == 0``):
    decode runs on the positive half map, then the sign of ``idx - z``."""

    half: SegmentTable
    zero_idx: int
    n: int


@functools.lru_cache(maxsize=None)
def _build_segments_cached(code_t: Tuple[float, ...]) -> Optional[SegmentTable]:
    c = np.asarray(code_t, dtype=np.float32)
    n = c.size
    if n < 4 or not np.all(np.diff(c.astype(np.float64)) > 0):
        return None

    c64 = c.astype(np.float64)
    d = np.diff(c64)

    # greedy maximal uniform runs; the f32 checks below reject a bad split
    segments = []  # (start, count)
    s = 0
    while s < n:
        if s == n - 1:
            segments.append((s, 1))
            break
        step = d[s]
        e = s + 1
        while e + 1 <= n - 1 and abs(d[e] - step) <= 1e-3 * abs(step):
            e += 1
        segments.append((s, e - s + 1))
        s = e + 1

    if len(segments) > 40:
        return None

    firsts, steps, inv_steps, cnts, sts = [], [], [], [], []
    for s, cnt in segments:
        first = float(c[s])
        if cnt > 1:
            step64 = (c64[s + cnt - 1] - c64[s]) / (cnt - 1)
            step = float(np.float32(step64))
            inv = float(np.float32(1.0 / step64))
            js = np.arange(cnt, dtype=np.float32)
            recon = js * np.float32(step) + np.float32(first)
            err = np.abs(recon.astype(np.float64) - c64[s : s + cnt])
            tol = np.maximum(np.abs(c64[s : s + cnt]), 1e-30) * 5e-6 + 1e-12
            if np.any(err > tol):
                return None
            t = (c[s : s + cnt] - np.float32(first)) * np.float32(inv) + np.float32(0.5)
            j_back = np.clip(np.floor(t.astype(np.float32)), 0, cnt - 1).astype(int)
            if not np.array_equal(j_back, np.arange(cnt)):
                return None
        else:
            step, inv = 0.0, 0.0
        firsts.append(first)
        steps.append(step)
        inv_steps.append(inv)
        cnts.append(cnt)
        sts.append(s)

    bounds = []
    for k in range(len(segments) - 1):
        s_next = segments[k + 1][0]
        bounds.append(float(np.float32((c64[s_next - 1] + c64[s_next]) * 0.5)))

    # intercept forms, each attached only if f32-verified (unfused numpy
    # arithmetic, as the JAX package verifies them)
    f32 = np.float32
    b_dec, b_req = [], []
    dec_ok = req_ok = True
    for (s, cnt), first, step, inv in zip(segments, firsts, steps, inv_steps):
        bd = f32(f32(first) - f32(s) * f32(step))
        idxs = np.arange(s, s + cnt, dtype=np.float32)
        recon = (idxs * f32(step)).astype(np.float32) + bd
        if not np.array_equal(recon.astype(np.float32), c[s : s + cnt]):
            dec_ok = False
        b_dec.append(float(bd))
        br = f32(f32(0.5) - f32(first) * f32(inv))
        t = (c[s : s + cnt] * f32(inv)).astype(np.float32) + br
        j_back = np.clip(np.floor(t.astype(np.float32)), 0, cnt - 1).astype(int)
        if not np.array_equal(j_back, np.arange(cnt)):
            req_ok = False
        b_req.append(float(br))

    return SegmentTable(
        starts=tuple(sts),
        counts=tuple(cnts),
        firsts=tuple(firsts),
        steps=tuple(steps),
        inv_steps=tuple(inv_steps),
        bounds=tuple(bounds),
        zero_idx=int(np.abs(c).argmin()),
        signed=bool(c[0] < 0),
        b_dec=tuple(b_dec) if dec_ok else None,
        b_req=tuple(b_req) if req_ok else None,
    )


def build_segments(code) -> Optional[SegmentTable]:
    """Segment table for a sorted codebook, or None if not piecewise-linear."""
    arr = np.asarray(code, dtype=np.float32).reshape(-1)
    return _build_segments_cached(tuple(float(x) for x in arr))


@functools.lru_cache(maxsize=None)
def _build_segments_sym_cached(code_t: Tuple[float, ...]) -> Optional[SymSegmentTable]:
    c = np.asarray(code_t, dtype=np.float32)
    n = c.size
    z = int(np.abs(c).argmin())
    if z == 0 or c[z] != 0.0 or z > n - 1 - z:
        return None
    j = np.arange(1, z + 1)
    if not np.array_equal(c[z - j], -c[z + j]):
        return None
    half = _build_segments_cached(tuple(float(x) for x in c[z:]))
    if half is None or len(half.starts) < 2:
        return None
    return SymSegmentTable(half=half, zero_idx=z, n=n)


def build_segments_sym(code) -> Optional[SymSegmentTable]:
    arr = np.asarray(code, dtype=np.float32).reshape(-1)
    return _build_segments_sym_cached(tuple(float(x) for x in arr))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 values, rounded once to float32 as a fused
    multiply-add rounds it, on any device.

    The product of two float32 values is exact in float64 and TwoSum gives
    the float64 sum's error ``e`` exactly, so ``s + e`` is the exact result.
    Rounding ``s`` to float32 is then right except where ``s`` lies exactly
    on a float32 midpoint; there the sign of ``e`` picks the side."""
    a64, b64, c64 = (t.to(torch.float64) for t in (a, b, c))
    p = a64 * b64
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))  # neighbour on s's side
    on_mid = (s != r64) & ((r64 + other.to(torch.float64)) * 0.5 == s) & (e != 0)
    up = e > 0
    pick_other = on_mid & (up == (other > r))
    return torch.where(pick_other, other, r)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root of float32 values, correctly rounded on any
    device, as the kernels' ``__fsqrt_rn`` and XLA's rounds it.  The square
    root in float64 rounded to float32 is correctly rounded (53 >= 2 * 24 +
    2 bits); ``torch.sqrt`` on float32 CPU tensors is not on every host (1
    ulp off at about 17% of inputs on one AMD EPYC build)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _segment_of(idx: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """Segment number of each code: how many segment starts after the first
    it has reached (the JAX package's select tree over the same masks)."""
    k = torch.zeros_like(idx)
    for s in table.starts[1:]:
        k += idx >= s
    return k


def segment_decode(idx: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """int codes -> f32 values by per-segment linear reconstruction, one
    fused multiply-add each."""
    idx = idx.to(torch.int32)
    dev = idx.device
    k = _segment_of(idx, table).long()
    step = torch.tensor(table.steps, dtype=torch.float32, device=dev)[k]
    if table.b_dec is not None:
        b = torch.tensor(table.b_dec, dtype=torch.float32, device=dev)[k]
        return fma_f32(idx.to(torch.float32), step, b)
    start = torch.tensor(table.starts, dtype=torch.int32, device=dev)[k]
    first = torch.tensor(table.firsts, dtype=torch.float32, device=dev)[k]
    return fma_f32((idx - start).to(torch.float32), step, first)


def segment_decode_sym(idx: torch.Tensor, t: SymSegmentTable) -> torch.Tensor:
    """int codes -> f32 values through the half map: ``|idx - z|`` decodes,
    then the sign of ``idx - z`` is applied."""
    d = idx.to(torch.int32) - t.zero_idx
    v = segment_decode(d.abs(), t.half)
    return torch.where(d < 0, -v, v)


def _negative(x: torch.Tensor) -> torch.Tensor:
    """The sign bit, with every NaN counted as negative (see the module
    docstring): the same answer on the CPU and on the card."""
    return torch.signbit(x) | torch.isnan(x)


def segment_requant(x: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """f32 values scaled to the codebook's range -> int32 codes: the segment
    by boundary compares (``x > bound``: a value on a boundary goes to the
    lower segment), then the nearest slot of its grid, half up in index
    space.  One fused multiply-add, as the JAX package's jitted requant
    rounds it; a NaN lands on the segment's first slot."""
    dev = x.device
    k = torch.zeros(x.shape, dtype=torch.long, device=dev)
    for b in table.bounds:
        k += x > b
    inv = torch.tensor(table.inv_steps, dtype=torch.float32, device=dev)[k]
    if table.b_req is not None:
        b = torch.tensor(table.b_req, dtype=torch.float32, device=dev)[k]
        t = fma_f32(x, inv, b)
    else:
        first = torch.tensor(table.firsts, dtype=torch.float32, device=dev)[k]
        t = fma_f32(x - first, inv, torch.full_like(x, 0.5))
    cnt1 = torch.tensor([c - 1 for c in table.counts], dtype=torch.int32, device=dev)[k]
    j = torch.floor(t).nan_to_num(nan=0.0).clamp(min=0.0)
    j = torch.minimum(j.to(torch.int32), cnt1)
    return torch.tensor(table.starts, dtype=torch.int32, device=dev)[k] + j


def segment_requant_sym(x: torch.Tensor, t: SymSegmentTable) -> torch.Tensor:
    """f32 values -> int32 codes through the half map: requantize ``|x|``,
    then mirror the slot for negatives (clamped to the ``zero_idx`` mirror
    slots the negative half has)."""
    jg = segment_requant(x.abs(), t.half)
    jn = torch.clamp(jg, max=t.zero_idx)
    return t.zero_idx + torch.where(_negative(x), -jn, jg)


def build_state_tables(code):
    """The segment structure of an optimizer-state codebook: a
    :class:`SymSegmentTable` when the map is odd-symmetric, else a
    :class:`SegmentTable`, else None."""
    sym = build_segments_sym(code)
    return sym if sym is not None else build_segments(code)


def sign_fixup(idx: torch.Tensor, x: torch.Tensor, table) -> torch.Tensor:
    """The reference CUDA kernel's sign preservation: where the code's sign
    differs from the value's, move the code one step toward the value's
    sign.  Only a signed map changes anything."""
    if isinstance(table, SymSegmentTable):
        zero_idx = table.zero_idx
    elif table.signed:
        zero_idx = table.zero_idx
    else:
        return idx
    x_neg = _negative(x)
    mismatch = (idx < zero_idx) != x_neg
    return torch.where(mismatch, torch.where(x_neg, idx - 1, idx + 1), idx)


def state_map(code) -> tuple:
    """An optimizer-state codebook as the CUDA update kernel takes it:
    ``(sym, zero_idx, starts, subs, steps, adds, bounds, counts1, rsubs,
    invs, radds)`` over the half map of a symmetric codebook, else over the
    whole map.  Decode is ``fma(float(a - subs[k]), steps[k], adds[k])`` for
    ``a`` in segment k by ``starts``; requant is ``starts[k] + clamp(floor(
    fma(x - rsubs[k], invs[k], radds[k])), 0, counts1[k])`` for ``x`` in
    segment k by ``bounds``; both cover the intercept and three-table forms."""
    t = build_state_tables(code)
    if t is None:
        raise ValueError("the codebook is not piecewise linear")
    sym = isinstance(t, SymSegmentTable)
    h = t.half if sym else t
    if h.b_dec is not None:
        subs, adds = (0,) * len(h.starts), h.b_dec
    else:
        subs, adds = h.starts, h.firsts
    if h.b_req is not None:
        rsubs, radds = (0.0,) * len(h.starts), h.b_req
    else:
        rsubs, radds = h.firsts, (0.5,) * len(h.starts)
    counts1 = tuple(c - 1 for c in h.counts)
    return (sym, t.zero_idx, h.starts, subs, h.steps, adds, h.bounds, counts1, rsubs,
            h.inv_steps, radds)


@functools.lru_cache(maxsize=None)
def dynamic_sym_table() -> SymSegmentTable:
    """The half-map table of the canonical signed dynamic map."""
    t = build_segments_sym(create_dynamic_map())
    assert t is not None, "the canonical dynamic map must be odd-symmetric"
    return t


def dequant_nested_dynamic(codes: torch.Tensor, s2: torch.Tensor, offset: torch.Tensor,
                           flat_block: torch.Tensor, nested_blocksize: int = 256) -> torch.Tensor:
    """A double-quantized absmax over the canonical dynamic map:
    ``fma(code2(codes), s2[flat_block // nested_blocksize], offset)``, both
    multiply-adds fused.  ``flat_block`` is each code's first-level block in
    the flat (canonical) order, which the second level groups by."""
    v = segment_decode_sym(codes, dynamic_sym_table())
    s2v = s2.reshape(-1).to(torch.float32)[flat_block // nested_blocksize]
    off = offset.reshape(()).to(torch.float32).expand_as(v)
    return fma_f32(v, s2v, off)


def kernel_table(t: SymSegmentTable) -> tuple:
    """The half map's segments as the CUDA decode takes them:
    ``(zero_idx, starts, subs, steps, adds)`` with
    ``v = fma(float(a - subs[k]), steps[k], adds[k])`` for ``a`` in segment k,
    which covers both the three-table and the intercept form."""
    h = t.half
    if h.b_dec is not None:
        subs, adds = (0,) * len(h.starts), h.b_dec
    else:
        subs, adds = h.starts, h.firsts
    return t.zero_idx, h.starts, subs, h.steps, adds
