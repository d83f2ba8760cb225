"""The plain versions of kernels 7 and 8 (the 4-bit matmul backward, ``g @
dequant(B)``) against the JAX package's ``gemm_4bit_paired_nt`` and
``gemm_4bit_paired_nt_dq`` in interpret mode, on the CPU: NF4 and FP4,
blocksizes 32 and 64, M 1, 5 and 16, bf16 and f32 ``g``, and the straddle
shape whose columns cross 256-block boundaries of the nested absmax.
Tolerances: rel 1e-2 for a bf16 ``g`` (as the JAX package's own test of the
kernel), rel 1e-5 for an f32 one (the JAX kernel splits an f32 ``g`` into
two bf16 terms, which keeps about 16 bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import gemm as JG
from bitsandbytes_tpu.functional.codebooks import get_4bit_code as j_code
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    gemm_4bit_paired_nt as j_nt,
    gemm_4bit_paired_nt_dq as j_nt_dq,
)
from bitsandbytes_tpu_torch.functional import gemm as TG
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import gemm_4bit_paired_nt, gemm_4bit_paired_nt_dq
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

SHAPES = {"256x512": (256, 512), "straddle_64x768": (64, 768)}


def _quantized(N, K, bs, qt, nested):
    W = (np.random.default_rng(0).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    return JQT.quantize(jnp.asarray(W), blocksize=bs, quant_type=qt, layout="paired",
                        compress_statistics=nested)


def _as_dict(jq):
    st = jq.state
    d = {"data": np.asarray(jq.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
         "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout,
         "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name}
    if st.nested:
        d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                 nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
    return d


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("nested", [False, True], ids=["kernel7", "kernel8"])
@pytest.mark.parametrize("qt,bs,shape", [("nf4", 64, "256x512"), ("fp4", 32, "256x512"),
                                          ("nf4", 32, "straddle_64x768")])
def test_nt_plain_matches_pallas_interpret(qt, bs, shape, nested, M, g_dtype):
    N, K = SHAPES[shape]
    jq = _quantized(N, K, bs, qt, nested)
    st = jq.state
    G = jnp.asarray(np.random.default_rng(M).standard_normal((M, N)), getattr(jnp, g_dtype))
    Gt = tensor_from_numpy(np.asarray(G), "cpu")
    tq = params_from_numpy(_as_dict(jq), "cpu")
    tst = tq.state
    if nested:
        ref = j_nt_dq(G, jq.data, st.absmax, st.state2.absmax, st.offset, j_code(qt, bs), bs, (N, K),
                      out_dtype=jnp.float32)
        out = gemm_4bit_paired_nt_dq(Gt, tq.data, tst.absmax, tst.state2.absmax, tst.offset.reshape(1),
                                     get_4bit_code(qt, bs), bs, (N, K), out_dtype=torch.float32)
    else:
        ref = j_nt(G, jq.data, st.absmax, j_code(qt, bs), bs, (N, K), out_dtype=jnp.float32)
        out = gemm_4bit_paired_nt(Gt, tq.data, tst.absmax, get_4bit_code(qt, bs), bs, (N, K),
                                  out_dtype=torch.float32)
    assert out.shape == (M, K) and out.dtype == torch.float32
    assert _rel(out.numpy(), np.asarray(ref)) <= (1e-2 if g_dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("M", [5, 64, 128])
@pytest.mark.parametrize("nested", [False, True])
def test_grad_A_routing_matches_jax(M, nested):
    """``gemm_4bit_grad_A`` on both routes (the ``_nt`` kernels below the
    backward threshold of 128 rows, at M 5 and 64; dequantize + matmul at or
    above it, at M 128) against the JAX package's, its Pallas kernels in
    interpret mode."""
    N, K, bs = 256, 512, 64
    jq = _quantized(N, K, bs, "nf4", nested)
    g = jnp.asarray(np.random.default_rng(7).standard_normal((M, N)), jnp.bfloat16)
    try:
        dispatch.set_backend("pallas")
        ref = np.asarray(JG.gemm_4bit_grad_A(g, jq.data, jq.state).astype(jnp.float32))
    finally:
        dispatch.set_backend("auto")
    tq = params_from_numpy(_as_dict(jq), "cpu")
    out = TG.gemm_4bit_grad_A(tensor_from_numpy(np.asarray(g), "cpu"), tq.data, tq.state)
    assert out.dtype == torch.bfloat16 and out.shape == (M, K)
    assert _rel(out.float().numpy(), ref) <= 1e-2


def test_nt_raises_on_mixed_devices_and_shapes():
    P = torch.zeros(128, 512, dtype=torch.uint8)
    am = torch.ones(8, 256)
    with pytest.raises(ValueError, match="unsupported shape"):
        gemm_4bit_paired_nt(torch.zeros(2, 255), P, am, get_4bit_code("nf4", 64), 64, (256, 512))
    with pytest.raises(ValueError, match="absmax_t"):
        gemm_4bit_paired_nt(torch.zeros(2, 256), P, am[:4], get_4bit_code("nf4", 64), 64, (256, 512))
    # the nested entry checks the shape before anything that divides by the blocksize
    codes, s2, off = torch.zeros(8, 256, dtype=torch.uint8), torch.ones(8), torch.zeros(1)
    with pytest.raises(ValueError, match="unsupported shape"):
        gemm_4bit_paired_nt_dq(torch.zeros(2, 256), P, codes, s2, off, get_4bit_code("nf4", 64), 0, (256, 512))
    with pytest.raises(ValueError, match="codes_t"):
        gemm_4bit_paired_nt_dq(torch.zeros(2, 256), P, codes[:4], s2, off, get_4bit_code("nf4", 64), 64, (256, 512))
