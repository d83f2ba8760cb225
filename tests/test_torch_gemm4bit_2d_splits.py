"""Kernel 9's split-order combine and the nested mode of kernels 9 and 10
(``ops/gemm4bit``), on the CPU.

The tensor-core kernel behind ``gemm_4bit_fused`` and ``gemm_4bit_fused_dq``
(bf16 and f16 A, ``_gemm2d_uses_tc``) cuts K into the splits that
``_gemm2d_plan`` chooses from the shapes and the SM count (one plan for both
instances, over 256-column stages), sums each split in
f32 over the weight rounded to A's type, and adds the splits' partials in
split order.  A nested state runs on its scales decoded in the kernel, which
are the bits of the resolved absmax (``nested_absmax``).  The CPU runs the
one-shot plain version, so these tests hold:

* the plan's properties at the K-adjacent layout's shapes;
* the plain version applied per split of K (A's columns, the payload's
  bytes, the absmax's blocks of each row) and added in split order matches
  the one-shot plain version within f32 rounding (1e-5 of the largest
  output: the reordered f32 sums over up to 32 quantization blocks);
* the same combine against the JAX package: with f32 A against its kernel
  ``gemm_4bit_fused`` (interpret mode) within the 2^-16 contract of
  ``test_torch_gemm4bit_2d.py`` (the JAX kernel rebuilds each scale as bf16
  hi + lo), with bf16 and f16 A against its default tier (the JAX kernel
  fails on bf16 A under ``jax.jit`` on the CPU) within one bf16 step of the
  largest output;
* the nested mode's plain versions bit-identical to the plain ones on the
  resolved absmax, which is the JAX package's jitted decode bit for bit,
  for kernel 9 and for kernel 10 in the 2d and flat layouts;
* kernel 10's ``_dq`` plain version bit-identical to the JAX package's
  default tier (jitted) on the same state, and within 2^-16 of its kernel
  ``dequantize_4bit_pallas`` on the JAX-decoded absmax (the hi + lo scale
  keeps about 16 bits, so the two cannot agree bit for bit);
* at M 1, 8, 17 and 32 (one to four n8 tiles of A), blocksize 32, 64, 128.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import fourbit as JF
from bitsandbytes_tpu.functional.codebooks import get_4bit_code as j_code
from bitsandbytes_tpu.functional.gemm import gemm_4bit as j_gemm_4bit
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.gemm4bit import (
    dequantize_4bit_pallas as j_dequantize_4bit_pallas,
    gemm_4bit_fused as j_gemm_4bit_fused,
)
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit import (
    _gemm2d_plan,
    _gemm2d_uses_tc,
    dequantize_4bit_2d,
    dequantize_4bit_2d_dq,
    dequantize_4bit_2d_dq_plain,
    gemm_4bit_fused,
    gemm_4bit_fused_dq,
    gemm_4bit_fused_plain,
    nested_absmax,
)
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)

N, K = 256, 2048
SMS = 8  # few SMs force 8 splits of these small shapes
REL = 2.0**-16  # the JAX kernels' hi + lo scale keeps about 16 bits of the absmax
BF16_STEP = 2.0**-7


@pytest.mark.parametrize(
    "M,N_,K_,bs,sms",
    [
        # Llama-3-8B's four decode linears on 132 SMs, at M 8 and 48
        (8, 6144, 4096, 64, 132), (8, 4096, 4096, 64, 132), (8, 28672, 4096, 64, 132),
        (8, 4096, 14336, 64, 132), (48, 4096, 14336, 64, 132), (48, 28672, 4096, 64, 132),
        # ragged: any N, K under one stage, quantization blocks wider than a stage
        (1, 3, 32, 32, 132), (5, 37, 96, 32, 132), (1, 64, 8192, 4096, 132), (33, 129, 4160, 64, 132),
        (17, 77, 14336, 512, 16), (1, 1, 1024, 128, 4), (3, 40, 384, 96, 132),
    ],
)
def test_gemm_plan_properties(M, N_, K_, bs, sms):
    k_per_split, splits = _gemm2d_plan(M, N_, K_, bs, sms)
    assert _gemm2d_plan(M, N_, K_, bs, sms) == (k_per_split, splits)
    assert 1 <= splits <= 8
    assert k_per_split % bs == 0 and k_per_split % 256 == 0  # whole 256-column stages
    assert (splits - 1) * k_per_split < K_ <= splits * k_per_split
    tiles = -(-N_ // 128) * -(-M // 32)
    if splits > 1:  # split only into blocks that stay resident, two on an SM
        assert tiles * splits <= 2 * sms
    elif K_ > math.lcm(bs, 256):  # one split: the grid already fills the resident blocks
        assert tiles * 2 > 2 * sms


def _quantized(seed, bs, nested):
    """A JAX 2d state of bf16 quant_storage, and its payload bytes, scales
    and resolved absmax as torch tensors."""
    W = (np.random.default_rng(seed).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=bs, quant_storage=jnp.bfloat16, compress_statistics=nested)
    st = jq.state
    assert st.layout == "2d" and jq.data.dtype == jnp.uint16
    B = torch.from_numpy(np.asarray(jq.data).reshape(-1).view(np.uint8).copy())
    resolved = np.asarray(jax.jit(lambda s: s.dequant_absmax())(st))  # the jitted decode: the contract
    nest = None
    if nested:
        nest = (torch.from_numpy(np.array(st.absmax)), torch.from_numpy(np.array(st.state2.absmax)),
                torch.from_numpy(np.asarray(st.offset, np.float32).reshape(1)))
        np.testing.assert_array_equal(nested_absmax(*nest).numpy().view(np.int32), resolved.view(np.int32))
    return jq, B, torch.from_numpy(resolved.copy()), nest


def _split_order_combine(A, B, absmax, code_t, bs, k_per_split, splits):
    """The plain version per split of K, its f32 partials added in split order."""
    B2, am2 = B.reshape(N, K // 2), absmax.reshape(N, K // bs)
    out = None
    for s in range(splits):
        lo, hi = s * k_per_split, min(K, (s + 1) * k_per_split)
        part = gemm_4bit_fused_plain(A[:, lo:hi].contiguous(), B2[:, lo // 2 : hi // 2].contiguous().reshape(-1),
                                     am2[:, lo // bs : hi // bs].contiguous().reshape(-1), code_t, bs, N)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("nested", [False, True], ids=["kernel9", "kernel9_dq"])
@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("M", [1, 8, 17, 32])
def test_split_partials_combine_to_the_one_shot_result(M, bs, nested, dtype):
    jq, B, absmax, nest = _quantized(M + bs, bs, nested)
    k_per_split, splits = _gemm2d_plan(M, N, K, bs, SMS)
    assert splits == 8
    a = jnp.asarray(np.random.default_rng(M * bs).standard_normal((M, K)).astype(np.float32), getattr(jnp, dtype))
    A = tensor_from_numpy(np.asarray(a), "cpu")
    code = get_4bit_code("nf4", bs)
    code_t = tuple(float(x) for x in code)
    if nested:
        one_shot_call = gemm_4bit_fused_dq(A, B, *nest, code, bs, (N, K), out_dtype=torch.float32)
    else:
        one_shot_call = gemm_4bit_fused(A, B, absmax, code, bs, (N, K), out_dtype=torch.float32)
    combined = _split_order_combine(A, B, absmax, code_t, bs, k_per_split, splits)
    one_shot = gemm_4bit_fused_plain(A, B, absmax, code_t, bs, N)
    scale = one_shot.abs().max().item()
    assert (combined - one_shot).abs().max().item() <= 1e-5 * scale
    assert torch.equal(one_shot_call, one_shot)

    if dtype == "float32":
        a_j = jnp.pad(a, ((0, -M % 16), (0, 0))) if M > 16 else a  # the JAX kernel tiles M > 16 by 8-256
        ref = j_gemm_4bit_fused(a_j, jnp.asarray(B.numpy()), jnp.asarray(absmax.numpy()), j_code("nf4", bs), bs,
                                (N, K))
        tol = REL
    else:
        ref = j_gemm_4bit(a, jq.data, jq.state)  # the default tier: the weight in A's type, f32 sums
        tol = BF16_STEP
    ref = np.asarray(ref, np.float32)[:M]
    rel = np.abs(combined.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()
    assert rel <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("M", [1, 17])
@pytest.mark.parametrize("bs", [32, 128])
def test_nested_gemm_bit_identical_on_resolved_absmax(bs, M, dtype):
    """Kernel 9's nested mode gives its plain mode's bits on the resolved
    absmax, in every activation type and output type."""
    _, B, absmax, nest = _quantized(3 * M + bs, bs, True)
    A = torch.randn(M, K, generator=torch.Generator().manual_seed(M)).to(dtype)
    code = get_4bit_code("nf4", bs)
    for out_dtype in {dtype, torch.float32}:
        assert torch.equal(gemm_4bit_fused_dq(A, B, *nest, code, bs, (N, K), out_dtype=out_dtype),
                           gemm_4bit_fused(A, B, absmax, code, bs, (N, K), out_dtype=out_dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape,bs,storage", [((N, K), 64, "bfloat16"), ((37, 96), 32, "float32"),
                                              ((7, 77), 64, "uint8"), ((1, 4099), 32, "uint8")])
def test_dequantize_dq_plain_bit_identical(shape, bs, storage, dtype):
    """Kernel 10's ``_dq`` mode on a nested state, 2d or flat (blocks across
    rows, an odd element count): the bits of kernel 10 on the resolved
    absmax and of the JAX package's default tier."""
    W = (np.random.default_rng(bs + shape[1]).standard_normal(shape) / 8).astype(np.float32)
    jp, js = JF.quantize_4bit(jnp.asarray(W), blocksize=bs, compress_statistics=True,
                              quant_storage=getattr(jnp, storage), layout="flat")
    assert js.nested and js.state2.blocksize == 256
    B = torch.from_numpy(np.asarray(jp).reshape(-1).view(np.uint8).copy())
    nest = (torch.from_numpy(np.array(js.absmax)), torch.from_numpy(np.array(js.state2.absmax)),
            torch.from_numpy(np.asarray(js.offset, np.float32).reshape(1)))
    resolved = torch.from_numpy(np.asarray(jax.jit(lambda s: s.dequant_absmax())(js)).copy())
    code = get_4bit_code("nf4", bs)
    out = dequantize_4bit_2d_dq(B, *nest, code, bs, shape, getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == shape
    assert torch.equal(out, dequantize_4bit_2d(B, resolved, code, bs, shape, getattr(torch, dtype)))
    # jitted, as the nested decode's contract is (XLA fuses its multiply-adds)
    ref = np.asarray(jax.jit(lambda p, s: JF.dequantize_4bit(p, quant_state=s).astype(getattr(jnp, dtype)))(jp, js))
    bits = np.int32 if dtype == "float32" else np.int16
    np.testing.assert_array_equal(out.numpy().view(bits) if dtype != "bfloat16" else out.view(torch.int16).numpy(),
                                  ref.view(bits))


def test_dequantize_dq_plain_against_pallas_kernel():
    _, B, absmax, nest = _quantized(11, 64, True)
    code = get_4bit_code("nf4", 64)
    ref = np.asarray(j_dequantize_4bit_pallas(jnp.asarray(B.numpy()), jnp.asarray(absmax.numpy()),
                                              code=tuple(float(x) for x in code), blocksize=64, shape=(N, K),
                                              dtype="float32"))
    out = dequantize_4bit_2d_dq_plain(B, *nest, tuple(float(x) for x in code), 64, (N, K), torch.float32).numpy()
    nz = ref != 0
    assert (np.abs(out - ref)[nz] / np.abs(ref)[nz]).max() <= REL
    assert (out[~nz] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
def test_tensor_core_route(dtype):
    """bf16 and f16 A take the tensor-core kernel at every blocksize the
    GEMM takes; f32 A (no exact tensor-core product) the CUDA-core body."""
    assert _gemm2d_uses_tc(dtype) == (dtype != torch.float32)
