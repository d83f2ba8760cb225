"""The port's host quantizer (``utils/native.py``, C++ with OpenMP) against
the JAX package's and against the port's plain quantize, bit for bit."""

import numpy as np
import pytest
import torch

from bitsandbytes_tpu_torch.functional.blockwise import quantize_blockwise_with_code
from bitsandbytes_tpu_torch.functional.codebooks import create_dynamic_map
from bitsandbytes_tpu_torch.functional.fourbit import dequantize_4bit, quantize_4bit
from bitsandbytes_tpu_torch.utils import native

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("blocksize", [64, 128])
def test_quantize_4bit_host_matches_jax_and_plain(quant_type, blocksize):
    """Bit for bit against the JAX package's host quantizer everywhere, and
    against the plain quantize everywhere but an all-zero block: there the
    host library codes 0.0 by its rank (NF4 0x77, FP4 0x00) where the plain
    quantize and kernel 1 give the JAX package's codes (0x00, 0xBB); both
    dequantize to zeros."""
    from bitsandbytes_tpu.utils import native as jnative

    W = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    W[3, :blocksize] = 0.0  # an all-zero block
    packed, absmax = native.quantize_4bit_host(W, blocksize, quant_type)
    jp, ja = jnative.quantize_4bit_host(W, blocksize, quant_type)
    np.testing.assert_array_equal(packed, jp)
    np.testing.assert_array_equal(absmax.view(np.uint32), ja.view(np.uint32))
    tp, ts = quantize_4bit(torch.from_numpy(W), blocksize=blocksize, quant_type=quant_type, layout="flat")
    tp = tp.numpy().reshape(-1)
    zero = np.zeros(packed.size, bool)
    zero[3 * 128 : 3 * 128 + blocksize // 2] = True
    np.testing.assert_array_equal(packed[~zero], tp[~zero])
    assert (packed[zero] == {"nf4": 0x77, "fp4": 0x00}[quant_type]).all()
    assert (tp[zero] == {"nf4": 0x00, "fp4": 0xBB}[quant_type]).all()
    np.testing.assert_array_equal(absmax.view(np.uint32), ts.absmax.numpy().view(np.uint32))
    back = native.dequantize_4bit_host(packed, absmax, W.shape, blocksize, quant_type)
    assert (back[3, :blocksize] == 0).all()


@pytest.mark.parametrize("blocksize", [256, 4096])
def test_quantize_blockwise_host_matches_jax_and_plain(blocksize):
    from bitsandbytes_tpu.utils import native as jnative

    x = np.random.default_rng(1).normal(size=(8192 + 100,)).astype(np.float32) * 0.01
    q, am = native.quantize_blockwise_host(x, blocksize)
    jq, jam = jnative.quantize_blockwise_host(x, blocksize)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(am.view(np.uint32), jam.view(np.uint32))
    tq, tam = quantize_blockwise_with_code(torch.from_numpy(x), torch.from_numpy(create_dynamic_map()), blocksize)
    np.testing.assert_array_equal(q, tq.numpy())
    np.testing.assert_array_equal(am.view(np.uint32), tam.numpy().view(np.uint32))


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequantize_4bit_host_matches_jax_and_plain(quant_type):
    from bitsandbytes_tpu.utils import native as jnative

    W = np.random.default_rng(2).normal(size=(128, 256)).astype(np.float32)
    packed, absmax = native.quantize_4bit_host(W, 64, quant_type)
    out = native.dequantize_4bit_host(packed, absmax, W.shape, 64, quant_type)
    ref = jnative.dequantize_4bit_host(packed, absmax, W.shape, 64, quant_type)
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    tp, ts = quantize_4bit(torch.from_numpy(W), blocksize=64, quant_type=quant_type, layout="flat")
    plain = dequantize_4bit(tp, quant_state=ts).to(torch.float32).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), plain.view(np.uint32))
    assert np.abs(out - W).mean() < 0.1


def test_host_functions_refuse_odd_counts_and_short_inputs():
    with pytest.raises(ValueError, match="even"):
        native.quantize_4bit_host(np.ones(7, np.float32))
    with pytest.raises(ValueError, match="cover"):
        native.dequantize_4bit_host(np.zeros(3, np.uint8), np.ones(1, np.float32), (8,))
