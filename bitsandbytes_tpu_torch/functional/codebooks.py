"""Quantization codebooks: NF4, FP4, int4, af4 and the dynamic 8-bit map.

The port's own copy of the JAX package's ``functional/codebooks.py``.  The
tables are tiny float32 numpy arrays, and must equal the JAX package's bit
for bit: they decide the quantization codes, and checkpoints interoperate
through them.

* ``nf4``: 16 quantiles of N(0, 1) normalized to [-1, 1] (QLoRA), sorted.
* ``fp4``: 1-2-1 sign/exponent/mantissa float with bias 2, stored in
  bit-pattern order.
* ``int4`` / ``af4``: linear and AbnormalFloat tables (af4 for blocksize 64).
* ``dynamic`` 8-bit: dynamic exponent + linear fraction, 256 sorted entries.
* the map constructors ``create_linear_map``, ``create_normal_map`` and
  ``create_fp8_map``: 256-entry tables for 8-bit or narrower codes.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

__all__ = [
    "CODE_DTYPE",
    "create_dynamic_map",
    "create_fp8_map",
    "create_linear_map",
    "create_normal_map",
    "get_4bit_code",
    "is_dynamic_map",
]

CODE_DTYPE = np.float32

_NF4_TABLE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=CODE_DTYPE,
)

# FP4 magnitudes in bit-pattern order; get_4bit_code divides by the max (12).
_FP4_TABLE = np.array(
    [0.0, 0.0625, 8.0, 12.0, 4.0, 6.0, 2.0, 3.0, -0.0, -0.0625, -8.0, -12.0, -4.0, -6.0, -2.0, -3.0],
    dtype=CODE_DTYPE,
)

_INT4_TABLE = np.array(
    [7, 6, 5, 4, 3, 2, 1, 0, -0.0, -1, -2, -3, -4, -5, -6, -7], dtype=CODE_DTYPE
)

# AF4 (AbnormalFloat, arXiv:2306.06965), blocksize-64 table, stored reversed.
_AF4_TABLE = np.array(
    [
        -1.0,
        -0.69441008,
        -0.51243739,
        -0.3736951,
        -0.25607552,
        -0.14982478,
        -0.04934812,
        0.0,
        0.04273164,
        0.12934483,
        0.21961274,
        0.31675666,
        0.42563882,
        0.55496234,
        0.72424863,
        1.0,
    ],
    dtype=CODE_DTYPE,
)[::-1]


def create_linear_map(signed: bool = True, total_bits: int = 8, add_zero: bool = True) -> np.ndarray:
    """Evenly spaced levels in [-1, 1] (or [0, 1] unsigned).  A signed map
    gives up one slot so that zero is a level; a map narrower than 8 bits is
    padded with zeros in the middle up to 256 entries."""
    lo = -1.0 if signed else 0.0
    n = 2**total_bits
    if add_zero or total_bits < 8:
        n = n - 1 if signed else n
    values = np.linspace(lo, 1.0, n, dtype=np.float64)
    gap = 256 - values.size
    if gap == 0:
        return values.astype(CODE_DTYPE)
    half = values.size // 2
    out = np.concatenate([values[:half], np.zeros(gap), values[half:]])
    return out.astype(CODE_DTYPE)


def create_normal_map(offset: float = 0.9677083, use_extra_value: bool = True) -> np.ndarray:
    """The NF4 levels from quantiles of N(0, 1), scaled to [-1, 1]: 256
    sorted entries, 15 of them non-zero (8 negative and 7 positive with
    ``use_extra_value``, else 7 and 7), the rest zero padding."""
    from scipy.stats import norm

    if use_extra_value:
        v1 = norm.ppf(np.linspace(offset, 0.5, 9)[:-1]).tolist()
        v2 = [0.0] * (256 - 15)
    else:
        v1 = norm.ppf(np.linspace(offset, 0.5, 8)[:-1]).tolist()
        v2 = [0.0] * (256 - 14)
    v3 = (-norm.ppf(np.linspace(offset, 0.5, 8)[:-1])).tolist()
    values = np.sort(np.asarray(v1 + v2 + v3, dtype=np.float64))
    values /= values.max()
    return values.astype(CODE_DTYPE)


def create_fp8_map(
    signed: bool = True, exponent_bits: int = 5, precision_bits: int = 2, total_bits: int = 8
) -> np.ndarray:
    """Sorted levels of a small float format scaled to [-1, 1]: exponent
    bias ``2 ** (exponent_bits - 1)``, subnormals at exponent field 0,
    zero-padded to 256 entries below 8 bits."""
    e, p = exponent_bits, precision_bits
    has_sign = 1 if signed else 0
    assert e + p == total_bits - has_sign
    bias = 2 ** (e - 1)
    values = []
    for evalue in range(2**e):
        for bits in itertools.product([0, 1], repeat=p):
            mant = 1.0 if evalue != 0 else 0.0
            for i, b in enumerate(bits):
                mant += b * 2.0 ** -(i + 1)
            if evalue == 0:
                val = mant * 2.0**-bias  # subnormal
            else:
                val = mant * 2.0 ** -(evalue - bias - 1)
            values.append(val)
            if signed:
                values.append(-val)
    assert len(values) == 2**total_bits
    values.sort()
    values.extend([0.0] * (256 - len(values)))
    values.sort()  # stable sort keeps the order of -0.0 and 0.0
    code = np.asarray(values, dtype=np.float64)
    code /= code.max()
    return code.astype(CODE_DTYPE)


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``torch.linspace`` in float32, whose rounding (float64 chunk bases,
    float32 lane offsets) the dynamic map's entries depend on; numpy's
    linspace differs by one ulp at about 9% of them."""
    return torch.linspace(start, stop, num, dtype=torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def create_dynamic_map(signed: bool = True, max_exponent_bits: int = 7, total_bits: int = 8) -> np.ndarray:
    """Dynamic-exponent 8-bit codebook (arXiv:1511.04561): a unary prefix
    picks a base-10 exponent, the remaining bits a linear fraction.  256
    sorted float32 entries including 0 and +-1.  The fractions come from
    :func:`_linspace_f32`."""
    data: list[float] = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1
            if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1
        )
        boundaries = _linspace_f32(0.1, 1, fraction_items)
        means = ((boundaries[:-1] + boundaries[1:]) / 2.0).astype(np.float32)
        scale = np.float32(10.0 ** (-(max_exponent_bits - 1) + i))
        data += (scale * means).tolist()
        if signed:
            data += (-scale * means).tolist()
    if additional_items > 0:
        boundaries = _linspace_f32(0.1, 1, additional_items + 1)
        means = ((boundaries[:-1] + boundaries[1:]) / 2.0).astype(np.float32)
        scale = np.float32(10.0 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1))
        data += (scale * means).tolist()
        if signed:
            data += (-scale * means).tolist()
    data.append(0.0)
    data.append(1.0)
    assert len(data) == 2**total_bits
    data.extend([0.0] * (256 - len(data)))
    data.sort()  # stable sort keeps the order of -0.0 and 0.0
    return np.asarray(data, dtype=CODE_DTYPE)


def is_dynamic_map(code) -> bool:
    """Whether ``code`` (numpy, tensor or sequence) is the canonical signed
    dynamic map, bit for bit.  Reads a device tensor back once: callers
    decide it when a state is built and keep the answer."""
    if isinstance(code, torch.Tensor):
        code = code.detach().cpu().numpy()
    arr = np.asarray(code, dtype=np.float32).reshape(-1)
    dyn = create_dynamic_map()
    return arr.shape == dyn.shape and np.array_equal(arr.view(np.uint32), dyn.view(np.uint32))


@functools.lru_cache(maxsize=None)
def get_4bit_code(quant_type: str, blocksize: int = 64) -> np.ndarray:
    """The 16-entry 4-bit codebook for ``quant_type``, scaled to max |v| = 1.
    NF4 is sorted (index == rank); FP4, int4 and af4 are in bit-pattern
    order (index == the 4-bit encoding)."""
    if quant_type == "nf4":
        data = _NF4_TABLE
    elif quant_type == "fp4":
        data = _FP4_TABLE
    elif quant_type == "int4":
        data = _INT4_TABLE
    elif quant_type == "af4":
        if blocksize != 64:
            raise NotImplementedError("af4 only supports blocksize 64")
        data = _AF4_TABLE
    else:
        raise NotImplementedError(f"4-bit quant type {quant_type!r} not supported")
    data = data / np.abs(data).max()
    return data.astype(CODE_DTYPE)


@functools.lru_cache(maxsize=None)
def quantize_tables(quant_type: str, blocksize: int = 64):
    """``(midpoints [15] f32, order [16] int32, identity)`` for the compare-
    rank quantizer: midpoints of the sorted code, the rank -> bit-pattern
    map, and whether that map is the identity (NF4)."""
    code = get_4bit_code(quant_type, blocksize)
    order = np.argsort(code, kind="stable").astype(np.int32)
    sorted_code = code[order]
    midpoints = ((sorted_code[:-1] + sorted_code[1:]) * 0.5).astype(np.float32)
    identity = bool(np.array_equal(order, np.arange(16)))
    return midpoints, order, identity
