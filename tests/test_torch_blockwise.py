"""The port's blockwise 8-bit quantize and dequantize (kernels 12 and 13 of
``ops/blockwise8.py``, their plain versions here) against the JAX package's
Pallas kernels (interpret mode) and its jnp tier.

Contract: codes and absmax bit-identical to the Pallas tier; bit-identical
to the jnp tier too, except on an all-zero block, where the jnp tier gives
code 255 (its NaN scaled values sort last in ``searchsorted``) and the
Pallas tier and the port give 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import blockwise as JB
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.blockwise8 import quantize_blockwise_pallas
from bitsandbytes_tpu_torch.functional import blockwise as TB
from bitsandbytes_tpu_torch.functional.codebooks import create_dynamic_map
from bitsandbytes_tpu_torch.ops.blockwise8 import dequantize_blockwise8, quantize_blockwise8

torch.set_num_threads(1)

CODE = create_dynamic_map()
CODE_T = tuple(float(x) for x in CODE)


def _x(seed, n, bs, zero_block=True):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if zero_block:
        x[bs : 2 * bs] = 0.0  # the second block all zero
    x[7] = 30.0  # an outlier dominating the first block
    return x


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("bs", [128, 256, 512, 1024, 2048, 4096])
def test_codes_match_pallas_tier(bs):
    x = _x(bs, 8 * bs, bs)
    try:
        dispatch.set_backend("pallas")
        jq, js = JB.quantize_blockwise(jnp.asarray(x), blocksize=bs)
    finally:
        dispatch.set_backend("auto")
    tq, ts = TB.quantize_blockwise(torch.from_numpy(x), blocksize=bs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.absmax.numpy()), _bits(js.absmax))
    assert (tq[bs : 2 * bs] == 0).all()
    assert ts.dynamic_code and not ts.nested


@pytest.mark.parametrize("bs", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_codes_match_jnp_tier_but_the_zero_block(bs):
    """A partial last block too: n is not a multiple of the blocksize."""
    n = 3 * bs + bs // 2 + 5
    x = _x(bs + 1, n, bs)
    jq, js = JB.quantize_blockwise(jnp.asarray(x), blocksize=bs)
    tq, ts = TB.quantize_blockwise(torch.from_numpy(x), blocksize=bs)
    jq, tq = np.asarray(jq), tq.numpy()
    assert tq.shape == jq.shape == (n,)
    zero = slice(bs, 2 * bs)
    assert (jq[zero] == 255).all() and (tq[zero] == 0).all()
    rest = np.ones(n, bool)
    rest[zero] = False
    np.testing.assert_array_equal(tq[rest], jq[rest])
    np.testing.assert_array_equal(_bits(ts.absmax.numpy()), _bits(js.absmax))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bs", [64, 256])
def test_dequantize_bit_identical(bs, dtype):
    n = 16 * bs + 3  # a partial last block
    x = _x(2, n, bs, zero_block=False)
    jq, js = JB.quantize_blockwise(jnp.asarray(x), blocksize=bs)
    js.dtype = jnp.dtype(dtype)
    ref = JB.dequantize_blockwise(jq, js)
    tdt = getattr(torch, dtype)
    out = TB.dequantize_blockwise(
        torch.from_numpy(np.asarray(jq)), absmax=torch.from_numpy(np.asarray(js.absmax)),
        blocksize=bs, dtype=tdt,
    )
    assert out.dtype == tdt and tuple(out.shape) == (n,)
    view = {"float32": (torch.int32, np.int32)}.get(dtype, (torch.int16, np.int16))
    np.testing.assert_array_equal(out.view(view[0]).numpy(), np.asarray(ref).view(view[1]))


def test_dequantize_kernel_matches_pallas():
    from bitsandbytes_tpu.ops.pallas.blockwise8 import dequantize_blockwise_pallas

    bs = 256
    x = _x(3, 8 * bs, bs)
    jq, jam = quantize_blockwise_pallas(jnp.asarray(x), code_t=CODE_T, blocksize=bs)
    ref = dequantize_blockwise_pallas(jq, jam, code_t=CODE_T, blocksize=bs, dtype="bfloat16")
    out = dequantize_blockwise8(
        torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(jam)), CODE, bs, torch.bfloat16
    )
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("bs", [128, 4096])
def test_stochastic_matches_pallas_u_mode(bs):
    """The same uniforms through the TPU kernel's ``stochastic_u`` mode and
    the port: bit-identical codes, including the zero block."""
    x = _x(4, 8 * bs, bs)
    u = np.random.default_rng(5).random(x.size).astype(np.float32)
    jq, jam = quantize_blockwise_pallas(
        jnp.asarray(x), code_t=CODE_T, blocksize=bs, stochastic_u=jnp.asarray(u)
    )
    tq, tam = quantize_blockwise8(torch.from_numpy(x), CODE, bs, torch.from_numpy(u))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(tam.numpy()), _bits(jam))
    det, _ = quantize_blockwise8(torch.from_numpy(x), CODE, bs)
    moved = (tq != det).sum().item()
    assert 0 < moved and ((tq.int() - det.int()).abs() <= 1).all()


def test_stochastic_generator_is_reproducible_and_adjacent():
    x = torch.from_numpy(_x(6, 2 * 4096 + 100, 4096))
    a, _ = TB.quantize_blockwise(x, generator=torch.Generator().manual_seed(3))
    b, _ = TB.quantize_blockwise(x, generator=torch.Generator().manual_seed(3))
    det, _ = TB.quantize_blockwise(x)
    assert torch.equal(a, b)
    assert ((a.int() - det.int()).abs() <= 1).all() and (a != det).any()


def test_nested_matches_jax():
    """``nested=True``: the payload codes bit-identical; the offset is the
    correctly rounded mean of the absmax, and the JAX package's float32
    ``jnp.mean`` within 3 ulp of it (its own rounding; 3 is the most seen in
    300 random draws); the absmax codes and second-level scales as close as
    those ulps allow."""
    bs = 64
    x = _x(7, 600 * bs + 11, bs, zero_block=False)
    jq, js = JB.quantize_blockwise(jnp.asarray(x), blocksize=bs, nested=True)
    tq, ts = TB.quantize_blockwise(torch.from_numpy(x), blocksize=bs, nested=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.nested and ts.state2.blocksize == 256 and ts.state2.dynamic_code
    am = np.asarray(JB.blockwise_absmax(jnp.asarray(x), bs), np.float64)
    assert ts.offset.numpy() == np.float32(am.sum() / am.size)
    ulps = abs(int(np.asarray(js.offset, np.float32).view(np.int32)) - int(ts.offset.numpy().view(np.int32)))
    assert ulps <= 3
    jc, tc = np.asarray(js.absmax).astype(int), ts.absmax.numpy().astype(int)
    assert (jc == tc).mean() >= 0.999 and np.abs(jc - tc).max() <= 1
    np.testing.assert_allclose(ts.state2.absmax.numpy(), np.asarray(js.state2.absmax), rtol=1e-6)
    # and the round trip through the port's own state
    back = TB.dequantize_blockwise(tq, ts)
    ref = np.asarray(JB.dequantize_blockwise(jq, js))
    np.testing.assert_allclose(back.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_dequantize_nested_state_carried_across():
    """A JAX nested state, carried across as numpy, dequantizes bit-identical
    to the JAX package's jitted dequantize (whose absmax decode contracts
    to fused multiply-adds)."""
    from bitsandbytes_tpu_torch.functional.quant_state import QuantState

    bs = 128
    x = _x(8, 300 * bs, bs, zero_block=False)
    jq, js = JB.quantize_blockwise(jnp.asarray(x), blocksize=bs, nested=True)
    ref = np.asarray(jax.jit(lambda q, s: JB.dequantize_blockwise(q, s))(jq, js))
    st2 = QuantState(
        absmax=torch.from_numpy(np.array(js.state2.absmax)), code=torch.from_numpy(CODE.copy()),
        blocksize=256, quant_type="8bit", dtype=torch.float32, shape=tuple(js.state2.shape),
        dynamic_code=True,
    )
    ts = QuantState(
        absmax=torch.from_numpy(np.array(js.absmax)), code=torch.from_numpy(CODE.copy()), blocksize=bs,
        quant_type="8bit", dtype=torch.float32, shape=tuple(js.shape),
        offset=torch.tensor(float(np.asarray(js.offset)), dtype=torch.float32), state2=st2,
        dynamic_code=True,
    )
    out = TB.dequantize_blockwise(torch.from_numpy(np.array(jq)), ts)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_blockwise_absmax_and_valid_blocksizes():
    x = _x(9, 1000, 64)
    np.testing.assert_array_equal(
        TB.blockwise_absmax(torch.from_numpy(x), 64).numpy(), np.asarray(JB.blockwise_absmax(jnp.asarray(x), 64))
    )
    assert TB.VALID_BLOCKSIZES == JB.VALID_BLOCKSIZES
    with pytest.raises(ValueError):
        TB.quantize_blockwise(torch.zeros(64), blocksize=96)


@pytest.mark.parametrize("bs", [12, 40, 48, 100, 8192])
@pytest.mark.parametrize("n", [1000, 4097])
def test_with_code_any_blocksize_matches_jax(bs, n):
    """``quantize_blockwise_with_code`` and ``dequantize_blockwise_with_code``
    take every blocksize the JAX functions take, a ragged last block too:
    codes, absmax and dequantized values bit for bit (signed dynamic map;
    blocksizes off the quantize tile's powers of two and off multiples of 8
    take the ``_any`` instances on CUDA)."""
    x = np.random.default_rng(bs + n).standard_normal(n).astype(np.float32)
    jq, jam = JB.quantize_blockwise_with_code(jnp.asarray(x), jnp.asarray(CODE), bs)
    tq, tam = TB.quantize_blockwise_with_code(torch.from_numpy(x), CODE, bs)
    assert tam.numel() == -(-n // bs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(tam.numpy()), _bits(jam))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(JB.dequantize_blockwise_with_code(jq, jam, jnp.asarray(CODE), bs, jdt)).astype(np.float32)
        out = TB.dequantize_blockwise_with_code(tq, tam, CODE, bs, tdt)
        assert out.dtype == tdt and out.shape == (n,)
        np.testing.assert_array_equal(_bits(out.to(torch.float32).numpy()), _bits(ref))


@pytest.mark.parametrize("bs", [12, 100])
def test_with_code_any_blocksize_stochastic_matches_pallas_u_mode(bs):
    """The stochastic mode at a blocksize off the tile, on the same uniforms
    as the JAX kernel's "u" mode (whole blocks: the kernel takes no other)."""
    n = 8 * bs
    x = _x(bs, n, bs, zero_block=False)
    u = np.random.default_rng(bs).random(n, dtype=np.float32)
    jq, jam = quantize_blockwise_pallas(jnp.asarray(x), code_t=CODE_T, blocksize=bs, stochastic_u=jnp.asarray(u))
    tq, tam = quantize_blockwise8(torch.from_numpy(x), CODE, bs, torch.from_numpy(u))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(tam.numpy()), _bits(jam))


@pytest.mark.parametrize("bad", ["ragged", "dtype", "u_length", "absmax_length"])
def test_wrappers_reject_bad_inputs(bad):
    with pytest.raises(ValueError):
        if bad == "ragged":
            quantize_blockwise8(torch.zeros(100), CODE, 64)
        elif bad == "dtype":
            quantize_blockwise8(torch.zeros(128, dtype=torch.bfloat16), CODE, 64)
        elif bad == "u_length":
            quantize_blockwise8(torch.zeros(128), CODE, 64, torch.zeros(64))
        else:
            dequantize_blockwise8(torch.zeros(128, dtype=torch.uint8), torch.zeros(3), CODE, 64)


def test_fixed_order_mean():
    """The mean behind every nested offset: float64 pairwise sums give the
    correctly rounded mean on every draw, however the input was made; the
    JAX package's float32 ``jnp.mean`` lands within 3 ulp of it."""
    rng = np.random.default_rng(0)
    worst = 0
    for n in [1, 7, 4096] + [int(v) for v in rng.integers(500, 300_000, 20)]:
        v = (np.abs(rng.standard_normal(n)) * rng.uniform(0.1, 3)).astype(np.float32)
        m = TB.fixed_order_mean(torch.from_numpy(v))
        assert m.dtype == torch.float32 and m.dim() == 0
        assert m.numpy() == np.float32(np.sum(v.astype(np.float64)) / n)
        j = np.asarray(jnp.mean(jnp.asarray(v)), np.float32)
        worst = max(worst, abs(int(j.view(np.int32)) - int(m.numpy().view(np.int32))))
    assert worst <= 3
