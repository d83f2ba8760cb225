"""The port's paired-layout GEMM and dequantize against the JAX package's
Pallas kernels (interpret mode on the CPU), and the gemm_4bit routing on
both sides of the large-M threshold.  The port runs the kernels' plain
versions here; chip_smoke.py holds the CUDA kernels against them on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_tpu as jbnb
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    dequantize_paired_fast as j_dequantize_paired_fast,
    gemm_4bit_paired as j_gemm_4bit_paired,
    pack_npaired as j_pack_npaired,
    repack_2d_to_npaired as j_repack_2d_to_npaired,
)
import bitsandbytes_tpu_torch as tbnb
from bitsandbytes_tpu_torch.functional import gemm as tgemm
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.nn import LinearNF4
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
    dequantize_paired_fast,
    gemm_4bit_paired,
    pack_npaired,
    repack_2d_to_npaired,
    repack_npaired_to_2d,
    unpack_npaired,
)
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

N, K, BS = 256, 512, 64


def _payload(seed, quant_type="nf4"):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, size=(N, K), dtype=np.uint8)
    absmax = (rng.random((N, K // BS)) * 2 + 0.1).astype(np.float32)
    P = np.array(j_pack_npaired(jnp.asarray(q)))
    return q, P, np.ascontiguousarray(absmax.T)


def test_pack_layouts_match():
    q, P, _ = _payload(0)
    np.testing.assert_array_equal(pack_npaired(torch.from_numpy(q)).numpy(), P)
    np.testing.assert_array_equal(unpack_npaired(torch.from_numpy(P)).numpy(), q)
    pairs = q.reshape(N, K // 2, 2)
    p2d = (pairs[..., 0] << 4) | pairs[..., 1]
    tp = repack_2d_to_npaired(torch.from_numpy(p2d), (N, K))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(j_repack_2d_to_npaired(jnp.asarray(p2d), (N, K))))
    np.testing.assert_array_equal(repack_npaired_to_2d(tp).numpy(), p2d)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_gemm_4bit_paired_matches_pallas(quant_type):
    _, P, am_t = _payload(1, quant_type)
    code = get_4bit_code(quant_type, BS)
    A = jnp.asarray(np.random.default_rng(2).standard_normal((4, K)), jnp.bfloat16)
    ref = np.asarray(
        j_gemm_4bit_paired(A, jnp.asarray(P), jnp.asarray(am_t), code, BS, (N, K), out_dtype=jnp.float32)
    )
    out = gemm_4bit_paired(
        tensor_from_numpy(np.asarray(A), "cpu"), torch.from_numpy(P), torch.from_numpy(am_t),
        code, BS, (N, K), out_dtype=torch.float32,
    ).numpy()
    err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 1e-5, err


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequantize_paired_fast_bit_identical(quant_type):
    """Bit-identical: in interpret mode the TPU kernel's one-hot expander
    product broadcasts the f32 scale exactly, so both sides round the same
    f32 product unit * absmax to bf16."""
    _, P, am_t = _payload(3, quant_type)
    code = get_4bit_code(quant_type, BS)
    ref = j_dequantize_paired_fast(
        jnp.asarray(P), jnp.asarray(am_t), code=tuple(float(x) for x in code), blocksize=BS
    )
    out = dequantize_paired_fast(torch.from_numpy(P), torch.from_numpy(am_t), code, BS)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.view(torch.int16).numpy(), np.asarray(ref).view(np.int16)
    )


@pytest.mark.parametrize("M", [4, 512], ids=["decode", "large_m"])
def test_gemm_4bit_routes_match_jax(M):
    """gemm_4bit on the same quantized bytes: M = 4 takes the GEMM kernel
    route on both sides, M = 512 the dequantize + matmul route."""
    rng = np.random.default_rng(4)
    W = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=BS)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    try:
        dispatch.set_backend("pallas")
        ref = np.asarray(jbnb.matmul_4bit(x, jq.data, jq.state), np.float32)
    finally:
        dispatch.set_backend("auto")
    tq = params_from_numpy(
        {
            "data": np.asarray(jq.data), "absmax": np.asarray(jq.state.absmax),
            "shape": jq.state.shape, "blocksize": BS, "quant_type": "nf4",
            "layout": jq.state.layout, "code": np.asarray(jq.state.code),
        },
        "cpu",
    )
    assert (M >= tgemm.LARGE_M_THRESHOLD) == (M == 512)
    out = tbnb.matmul_4bit(tensor_from_numpy(np.asarray(x), "cpu"), tq.data, tq.state)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref, rtol=3e-2, atol=3e-2)


def test_matmul_4bit_is_forward_only():
    """The forward matches the dequantized weight; since the backward was
    ported, a gradient flows to the input only, never to the frozen weight."""
    lin = LinearNF4(K, N, bias=False, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, K, dtype=torch.bfloat16)
    y = lin(x)
    W = lin.weight.dequantize().to(torch.bfloat16)
    np.testing.assert_allclose(
        y.float().numpy(), (x.float() @ W.float().t()).numpy(), rtol=2e-2, atol=2e-2
    )
    xg = x.clone().requires_grad_()
    lin(xg).float().sum().backward()
    ref = W.float().sum(0).expand(2, K)
    np.testing.assert_allclose(xg.grad.float().numpy(), ref.numpy(), rtol=2e-2, atol=2e-2)
    assert lin.weight.data.grad is None and not lin.weight.data.requires_grad


@pytest.mark.parametrize("bad", ["absmax_shape", "payload_dtype", "k_not_blocked", "a_width"])
def test_gemm_wrapper_rejects_bad_inputs(bad):
    _, P, am_t = _payload(5)
    P, am_t = torch.from_numpy(P), torch.from_numpy(am_t)
    A = torch.zeros(2, K, dtype=torch.bfloat16)
    shape, bs = (N, K), BS
    if bad == "absmax_shape":
        am_t = am_t[:-1]
    elif bad == "payload_dtype":
        P = P.to(torch.int16)
    elif bad == "k_not_blocked":
        bs = 96
    else:
        A = torch.zeros(2, K + 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gemm_4bit_paired(A, P, am_t, get_4bit_code("nf4", BS), bs, shape)


def test_dispatch_is_by_device():
    from bitsandbytes_tpu_torch.ops.dispatch import use_kernel

    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
