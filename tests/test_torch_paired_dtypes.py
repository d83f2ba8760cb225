"""f16 and f32 activations on the port's default (paired) 4-bit layout,
against the JAX package on the CPU.

``functional/gemm.gemm_4bit`` on paired and paired-nested states takes
f16 and f32 A at decode M (kernels 2 and 5) and past
``LARGE_M_THRESHOLD`` (kernels 3 and 6 in A's type, then the matmul).  It is
held against the JAX package's ``gemm_4bit`` on its Pallas tier (interpret
mode) with the statistic and thresholds of ``tests/test_gemv_accuracy.py``:
the mean absolute difference times sqrt(dim) under 5e-5 for f32 and under
the 16-bit class's 5e-3 for f16.  The port reads an f32 A exactly where the
JAX kernel splits it into bf16 hi + lo (``_dot_f32acc``), which the f32
threshold covers.  The dequantize in f16 and f32 gives the JAX kernel's
bits, and the backward takes f16 g as the JAX kernel does (rounded to bf16
after the scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional.gemm import gemm_4bit as j_gemm_4bit
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    dequantize_paired_fast as j_dequantize_paired_fast,
    gemm_4bit_paired_nt as j_gemm_4bit_paired_nt,
)
from bitsandbytes_tpu_torch.functional import gemm as tgemm
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import dequantize_paired_fast, gemm_4bit_paired_nt
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy

torch.set_num_threads(1)

DIM, BS = 512, 64  # hidden 512 keeps the JAX linears on their paired kernel
# tests/test_gemv_accuracy.py's thresholds; f16 takes the 16-bit class's
THRESHOLD = {torch.float32: 5.0e-5, torch.float16: 5.0e-3}
JDT = {torch.float32: jnp.float32, torch.float16: jnp.float16}


def _states(nested: bool):
    rng = np.random.default_rng(7)
    W = (rng.standard_normal((DIM, DIM)) / np.sqrt(DIM)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=BS, compress_statistics=nested)
    st = jq.state
    d = {"data": np.asarray(jq.data), "absmax": np.asarray(st.absmax), "shape": st.shape, "blocksize": BS,
         "quant_type": "nf4", "layout": st.layout, "code": np.asarray(st.code)}
    if nested:
        d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                 nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
    return jq, params_from_numpy(d, "cpu")


@pytest.mark.parametrize("M", [4, 40], ids=["decode_kernel", "large_m_dequant"])
@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=["f16", "f32"])
def test_gemm_4bit_f16_f32_activations_match_jax(dtype, nested, M):
    jq, tq = _states(nested)
    assert tq.state.layout == "paired" and tq.state.inline_nested == nested
    assert (M >= tgemm.LARGE_M_THRESHOLD) == (M == 40)
    A = (np.random.default_rng(8).standard_normal((M, DIM)) / np.sqrt(DIM)).astype(np.float32)
    try:
        dispatch.set_backend("pallas")
        ref = np.asarray(j_gemm_4bit(jnp.asarray(A, JDT[dtype]), jq.data, jq.state), np.float32)
    finally:
        dispatch.set_backend("auto")
    out = tgemm.gemm_4bit(torch.from_numpy(A).to(dtype), tq.data, tq.state)
    assert out.dtype == dtype and tuple(out.shape) == (M, DIM)
    err = np.abs(out.to(torch.float32).numpy() - ref).mean() * np.sqrt(DIM)
    assert err < THRESHOLD[dtype], err


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=["f16", "f32"])
def test_dequantize_paired_f16_f32_bit_identical(dtype):
    jq, tq = _states(False)
    code = get_4bit_code("nf4", BS)
    P, am_t = tq.data.reshape(DIM // 2, DIM), tq.state.absmax
    ref = j_dequantize_paired_fast(jnp.asarray(P.numpy()), jnp.asarray(am_t.numpy()),
                                   code=tuple(float(x) for x in code), blocksize=BS, dtype=JDT[dtype])
    out = dequantize_paired_fast(P, am_t, code, BS, dtype)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.numpy().view(np.uint8), np.asarray(ref).view(np.uint8))


def test_backward_takes_f16_g():
    """``g @ dequant(B)`` with f16 g: the product g * scale rounds to bf16
    as for bf16 g, the result comes back in f16."""
    _, tq = _states(False)
    code = get_4bit_code("nf4", BS)
    P, am_t = tq.data.reshape(DIM // 2, DIM), tq.state.absmax
    g = np.random.default_rng(9).standard_normal((6, DIM)).astype(np.float32)
    ref = np.asarray(j_gemm_4bit_paired_nt(jnp.asarray(g, jnp.float16), jnp.asarray(P.numpy()),
                                           jnp.asarray(am_t.numpy()), code, BS, (DIM, DIM),
                                           out_dtype=jnp.float32), np.float32)
    out = gemm_4bit_paired_nt(torch.from_numpy(g).to(torch.float16), P, am_t, code, BS, (DIM, DIM))
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref, rtol=1e-2, atol=1e-2 * np.abs(ref).max())
