"""The paired 4-bit dequantize (kernels 3 and 6) on the CPU: the port's plain
versions bit for bit against the JAX package's Pallas kernels in interpret
mode, plain and with a double-quantized absmax, in every output type, both
4-bit codebooks and blocksizes 32-256; and at shapes off the JAX tiling that
the card's kernel takes (odd row-pair counts, tiles partial in N and K,
blocksizes 8, 16 and 96) against a numpy reference.  chip_smoke.py holds the
CUDA kernels against these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    _dequant_tiles_paired,
    dequantize_paired_fast as j_dequantize_paired_fast,
    dequantize_paired_fast_dq as j_dequantize_paired_fast_dq,
)
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
    dequantize_paired_fast,
    dequantize_paired_fast_dq,
    nested_absmax_t,
)

torch.set_num_threads(1)

# one JAX tile at every blocksize: TN 32, TK 2048
N, K = 32, 2048
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16),
          "f32": (torch.float32, jnp.float32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _quantized(quant_type, blocksize, nested, seed):
    W = (np.random.default_rng(seed).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=blocksize, quant_type=quant_type, layout="paired",
                      compress_statistics=nested)
    assert jq.state.layout == "paired" and jq.state.nested == nested
    return jq


@pytest.mark.parametrize("blocksize", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_plain_bit_identical_to_pallas(quant_type, dtype, blocksize):
    assert all(t is not None for t in _dequant_tiles_paired(N, K, blocksize))
    tdt, jdt = DTYPES[dtype]
    jq = _quantized(quant_type, blocksize, False, seed=blocksize)
    code = get_4bit_code(quant_type, blocksize)
    ref = j_dequantize_paired_fast(jq.data, jq.state.absmax, code=tuple(float(x) for x in code),
                                   blocksize=blocksize, dtype=jdt)
    P, am_t = torch.from_numpy(np.array(jq.data)), torch.from_numpy(np.array(jq.state.absmax))
    assert tuple(am_t.shape) == (K // blocksize, N)
    out = dequantize_paired_fast(P, am_t, code, blocksize, tdt)
    assert out.dtype == tdt and tuple(out.shape) == (N, K)
    np.testing.assert_array_equal(_bits(out), np.asarray(ref).view(np.uint8))


@pytest.mark.parametrize("blocksize", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_nested_plain_bit_identical_to_pallas(quant_type, dtype, blocksize):
    """The double-quantized absmax decoded as the jitted JAX kernel decodes it
    (one fused multiply-add), then the plain dequantize: the JAX kernel's bits,
    and the plain dequantize's on the resolved absmax."""
    tdt, jdt = DTYPES[dtype]
    jq = _quantized(quant_type, blocksize, True, seed=100 + blocksize)
    st = jq.state
    code = get_4bit_code(quant_type, blocksize)
    ref = j_dequantize_paired_fast_dq(jq.data, st.absmax, st.state2.absmax, st.offset,
                                      code=tuple(float(x) for x in code), blocksize=blocksize, dtype=jdt)
    P = torch.from_numpy(np.array(jq.data))
    codes_t = torch.from_numpy(np.array(st.absmax))
    s2 = torch.from_numpy(np.array(st.state2.absmax, np.float32).reshape(-1))
    offset = torch.from_numpy(np.array(st.offset, np.float32).reshape(1))
    assert codes_t.dtype == torch.uint8 and tuple(codes_t.shape) == (K // blocksize, N)
    out = dequantize_paired_fast_dq(P, codes_t, s2, offset, code, blocksize, tdt)
    assert out.dtype == tdt and tuple(out.shape) == (N, K)
    np.testing.assert_array_equal(_bits(out), np.asarray(ref).view(np.uint8))
    resolved = dequantize_paired_fast(P, nested_absmax_t(codes_t, s2, offset), code, blocksize, tdt)
    np.testing.assert_array_equal(_bits(out), _bits(resolved))


# (N, K, blocksize): N/2 odd (a partial group of 8 row pairs), K off the
# kernel's 1024-column tiles, blocksizes the JAX tiling does not take
RAGGED = [(2, 8, 8), (18, 96, 16), (130, 4160, 64), (6, 2112, 96), (34, 1040, 8)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_plain_at_ragged_shapes_matches_numpy(shape, dtype):
    """W[2 n2 + h, k] = dtype(unit[nibble] * absmax_t[k // blocksize, 2 n2 + h]):
    the unit the bf16-rounded code, the product one f32 multiply, rounded to
    nearest even in the output type (by torch from an exact f32 array)."""
    n, k, bs = shape
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(n * 7919 + k)
    P = rng.integers(0, 256, size=(n // 2, k), dtype=np.uint8)
    am_t = (rng.random((k // bs, n)) * 3 + 0.01).astype(np.float32)
    code = get_4bit_code("nf4", bs)
    unit = torch.tensor(np.asarray(code, np.float32)).to(torch.bfloat16).to(torch.float32).numpy()
    q = np.empty((n, k), np.int64)
    q[0::2], q[1::2] = P >> 4, P & 15
    scale = np.repeat(am_t.T, bs, axis=1)
    ref = torch.from_numpy((unit[q] * scale).astype(np.float32)).to(tdt)
    out = dequantize_paired_fast(torch.from_numpy(P), torch.from_numpy(am_t), code, bs, tdt)
    assert out.dtype == tdt and tuple(out.shape) == (n, k)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
