"""The port's 4-bit quantize against the JAX package's: packed bytes, absmax
and the interop byte order bit-identical, for the flat, 2d and paired
layouts.  The JAX side runs both its jnp tier and its Pallas quantize kernel
(interpret mode on the CPU); the port runs the kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_tpu.functional as JF
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops.pallas.quant4bit import quantize_4bit_codes_pallas
from bitsandbytes_tpu_torch.functional import fourbit as TF
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor as TQT
from bitsandbytes_tpu_torch.ops.quant4bit import quantize_4bit_codes

torch.set_num_threads(1)

N, K, BS = 64, 256, 64


def _weight(seed=0, n=N, k=K):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((n, k)).astype(np.float32)
    W[3, :BS] = 0.0  # an all-zero block: absmax clamps to 1e-38
    W[5, 7] = 40.0  # an outlier dominating its block
    return W


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_codes_match_pallas_kernel(quant_type):
    W = _weight(1)
    code_t = tuple(float(x) for x in get_4bit_code(quant_type, BS))
    jq, jam = quantize_4bit_codes_pallas(jnp.asarray(W), code_t=code_t, blocksize=BS)
    tq, tam = quantize_4bit_codes(torch.from_numpy(W).reshape(-1), quant_type, BS)
    np.testing.assert_array_equal(tq.numpy().reshape(N, K), np.asarray(jq))
    np.testing.assert_array_equal(tam.numpy().view(np.uint32), np.asarray(jam).reshape(-1).view(np.uint32))


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("layout", ["flat", "2d", "paired"])
def test_quantize_4bit_bit_identical(layout, quant_type):
    W = _weight(2)
    jp, js = JF.quantize_4bit(jnp.asarray(W), blocksize=BS, quant_type=quant_type, layout=layout)
    tp, ts = TF.quantize_4bit(torch.from_numpy(W), blocksize=BS, quant_type=quant_type, layout=layout)
    assert tuple(tp.shape) == tuple(jp.shape) and ts.layout == js.layout
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.absmax.numpy().view(np.uint32), np.asarray(js.absmax).view(np.uint32))
    np.testing.assert_array_equal(
        TF.dequantize_4bit(tp, quant_state=ts).numpy(),
        np.asarray(JF.dequantize_4bit(jp, quant_state=js)),
    )


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_interop_flat_bytes_from_paired(quant_type):
    """Quantized with layout="auto" (paired) in both packages, the bytes in
    the flat interop order are equal, and the round trip is exact."""
    W = _weight(3)
    jq = JQT.quantize(jnp.asarray(W), blocksize=BS, quant_type=quant_type)
    tq = TQT.quantize(torch.from_numpy(W), blocksize=BS, quant_type=quant_type)
    assert tq.state.layout == "paired" == jq.state.layout
    jf, tf = jq.to_layout("flat"), tq.to_layout("flat")
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    np.testing.assert_array_equal(tf.state.absmax.numpy(), np.asarray(jf.state.absmax))
    back = tf.to_layout("paired")
    np.testing.assert_array_equal(back.data.numpy(), tq.data.numpy())
    np.testing.assert_array_equal(back.state.absmax.numpy(), tq.state.absmax.numpy())


def test_odd_length_flat_and_bf16_upcast():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(101).astype(np.float32)
    jp, js = JF.quantize_4bit(jnp.asarray(x), blocksize=BS)
    tp, ts = TF.quantize_4bit(torch.from_numpy(x), blocksize=BS)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.absmax.numpy(), np.asarray(js.absmax))
    # bf16 weights quantize after the f32 upcast, as the model's loader does
    Wb = jnp.asarray(_weight(5), jnp.bfloat16)
    jp, js = JF.quantize_4bit(Wb.astype(jnp.float32), blocksize=BS, layout="paired")
    tW = torch.from_numpy(np.array(Wb.astype(jnp.float32))).to(torch.bfloat16)
    tp, ts = TF.quantize_4bit(tW, blocksize=BS, layout="paired")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.absmax.numpy(), np.asarray(js.absmax))


def test_compress_statistics_not_supported_yet():
    """compress_statistics is supported now (``test_torch_double_quant.py``
    holds it against the JAX package): the state comes out nested, with the
    same payload bytes as the plain quantize."""
    W = torch.from_numpy(_weight(6))
    tp, ts = TF.quantize_4bit(W, blocksize=BS, compress_statistics=True)
    pp, ps = TF.quantize_4bit(W, blocksize=BS)
    assert ts.nested and ts.absmax.dtype == torch.uint8 and torch.equal(tp, pp)
    am = ps.absmax.numpy()
    np.testing.assert_allclose(ts.dequant_absmax().numpy(), am, rtol=0, atol=0.01 * am.max())


@pytest.mark.parametrize("bad", ["ragged", "dtype", "rank"])
def test_codes_wrapper_rejects_bad_inputs(bad):
    # bf16 and f16 are taken (tests/test_torch_quant4bit_dtypes.py); float64 is not
    x = {"ragged": torch.zeros(BS + 1), "dtype": torch.zeros(BS, dtype=torch.float64),
         "rank": torch.zeros(2, BS)}[bad]
    with pytest.raises(ValueError):
        quantize_4bit_codes(x, "nf4", BS)
