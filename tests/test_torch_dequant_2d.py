"""The K-adjacent 4-bit dequantize (kernel 10, plain and ``_dq``) on the CPU,
at the shapes the card's tiled kernel finds hard: flat element counts at and
around its 16384-element tile (one tile, a tile +- 8 elements, an odd count
whose last byte holds one element), blocksizes 16 (1025 scale slots a tile),
48 and 96 (blocks that do not divide the tile, so a tile starts inside one)
and 4096 (one slot a tile or less), in bf16, f16 and f32.

The port's plain versions are held bit for bit against a numpy reference
(``dtype(code[q] * absmax)``, the product one f32 multiply) and against the
JAX package's default tier (``bitsandbytes_tpu.functional.dequantize_4bit``);
the ``_dq`` cases use second-level scales made by hand, decoded by the port's
nested decode and by the JAX package's jitted ``dequant_absmax``.
chip_smoke.py holds the CUDA kernel against these plain versions on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import fourbit as JF
from bitsandbytes_tpu.functional.codebooks import create_dynamic_map as j_create_dynamic_map
from bitsandbytes_tpu.functional.quant_state import QuantState as JQS
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit import dequantize_4bit_2d, dequantize_4bit_2d_dq, nested_absmax

torch.set_num_threads(1)

TILE = 16384  # the CUDA kernel's tile of flat elements (csrc/gemm4bit.cu, kDqTile)
SHAPES = [(TILE,), (TILE - 8,), (TILE + 8,), (TILE + 5,), (3, 5463)]
BLOCKSIZES = [16, 48, 96, 4096]
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16),
          "f32": (torch.float32, jnp.float32)}


def _n(shape):
    return int(np.prod(shape))


def _case(shape, bs):
    """Random payload bytes, f32 absmax and nested scales (u8 codes, s2, offset)."""
    n = _n(shape)
    rng = np.random.default_rng(n * 131 + bs)
    nb = -(-n // bs)
    B = rng.integers(0, 256, size=(n + 1) // 2, dtype=np.uint8)
    absmax = (rng.random(nb) * 3 + 0.01).astype(np.float32)
    codes = rng.integers(0, 256, size=nb, dtype=np.uint8)
    s2 = (rng.random(-(-nb // 256)) + 0.5).astype(np.float32)
    offset = np.full(1, 0.25, np.float32)
    return B, absmax, codes, s2, offset


def _reference(B, absmax, bs, shape, tdt):
    """dtype(code[q] * absmax[e // bs]): q the high nibble of byte e // 2 for
    even e, the low one for odd e; one f32 multiply, rounded to nearest even
    in the output type (by torch, from an exact f32 array)."""
    n = _n(shape)
    code = np.asarray(get_4bit_code("nf4", bs), np.float32)
    q = np.stack([B >> 4, B & 15], axis=-1).reshape(-1)[:n]
    scale = np.repeat(absmax, bs)[:n]
    return torch.from_numpy((code[q] * scale).astype(np.float32).reshape(shape)).to(tdt)


def _bits(t) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def _tbits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _jax_nested_absmax(codes, s2, offset, bs, n):
    """The JAX package's jitted decode of a hand-made nested flat state."""
    nb = codes.size
    state2 = JQS(absmax=jnp.asarray(s2), code=jnp.asarray(j_create_dynamic_map()), blocksize=256,
                 quant_type="8bit", dtype=jnp.float32, shape=(nb,))
    st = JQS(absmax=jnp.asarray(codes), code=jnp.zeros(16, jnp.float32), blocksize=bs, quant_type="nf4",
             dtype=jnp.float32, shape=(n,), offset=jnp.asarray(offset[0]), state2=state2, layout="flat")
    return jax.jit(lambda s: s.dequant_absmax())(st)


ids = {"shape": lambda s: "x".join(map(str, s)), "bs": lambda b: f"bs{b}"}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bs", BLOCKSIZES, ids=ids["bs"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids["shape"])
def test_plain_matches_numpy_and_jax(shape, bs, dtype):
    tdt, jdt = DTYPES[dtype]
    B, absmax, *_ = _case(shape, bs)
    out = dequantize_4bit_2d(torch.from_numpy(B), torch.from_numpy(absmax), get_4bit_code("nf4", bs), bs, shape,
                             tdt)
    assert out.dtype == tdt and tuple(out.shape) == shape
    np.testing.assert_array_equal(_tbits(out), _tbits(_reference(B, absmax, bs, shape, tdt)))
    ref = JF.dequantize_4bit(jnp.asarray(B), absmax=jnp.asarray(absmax), blocksize=bs, quant_type="nf4",
                             shape=shape, dtype=jdt)
    np.testing.assert_array_equal(_tbits(out), _bits(ref))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bs", BLOCKSIZES, ids=ids["bs"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids["shape"])
def test_dq_matches_numpy_and_jax(shape, bs, dtype):
    """The ``_dq`` mode on hand-made nested scales: the numpy reference on the
    decoded absmax, the plain mode on it, and the JAX package's default tier
    on its jitted decode of the same scales, bit for bit."""
    tdt, jdt = DTYPES[dtype]
    B, _, codes, s2, offset = _case(shape, bs)
    nest = (torch.from_numpy(codes), torch.from_numpy(s2), torch.from_numpy(offset))
    code = get_4bit_code("nf4", bs)
    out = dequantize_4bit_2d_dq(torch.from_numpy(B), *nest, code, bs, shape, tdt)
    assert out.dtype == tdt and tuple(out.shape) == shape
    absmax = nested_absmax(*nest)
    np.testing.assert_array_equal(_tbits(out), _tbits(_reference(B, absmax.numpy(), bs, shape, tdt)))
    np.testing.assert_array_equal(_tbits(out), _tbits(dequantize_4bit_2d(torch.from_numpy(B), absmax, code, bs,
                                                                          shape, tdt)))
    j_absmax = _jax_nested_absmax(codes, s2, offset, bs, _n(shape))
    np.testing.assert_array_equal(absmax.numpy().view(np.uint32), np.asarray(j_absmax).view(np.uint32))
    ref = JF.dequantize_4bit(jnp.asarray(B), absmax=j_absmax, blocksize=bs, quant_type="nf4", shape=shape,
                             dtype=jdt)
    np.testing.assert_array_equal(_tbits(out), _bits(ref))
