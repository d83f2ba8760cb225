"""Kernels 2 and 5's split-order combine (``ops/gemm4bit_paired``), on the CPU.

The tensor-core kernel behind ``gemm_4bit_paired`` and ``gemm_4bit_paired_dq``
(bf16 and f16 A, blocksize a multiple of 32, ``_gemm_uses_tc``) cuts K into
the splits that ``gemm_plan`` chooses from the shapes and the SM count, sums
each split in f32 (one sub-dot per quantization block times its f32 scale)
and adds the splits' partials in split order.  A nested state runs on its
scales decoded in the kernel, which are the bits of the resolved absmax
(``nested_absmax_t``).  The CPU runs the one-shot plain version, so these
tests hold:

* the plan's properties: a pure function of the shapes and the SM count, at
  most 8 splits, each of whole quantization blocks and whole 128-column
  stages, covering K with none empty, and splits only where the grid leaves
  resident blocks of one wave free;
* the plain version applied per split of K (A's columns, the payload's
  columns, the absmax's rows) and added in split order matches the one-shot
  plain version within f32 rounding (1e-5 of the largest output: the
  reordered f32 sums over up to 32 quantization blocks);
* the same combine matches the JAX package's ``gemm_4bit_paired`` and
  ``gemm_4bit_paired_dq`` (interpret mode) within the 1e-5 contract of
  ``test_torch_gemm4bit.py``;
* at M 1, 8, 17 and 32 (one to four n8 tiles of A), blocksize 32, 64 and 128,
  plain and nested, bf16 and f16 A.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional.codebooks import get_4bit_code as j_code
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    gemm_4bit_paired as j_gemm,
    gemm_4bit_paired_dq as j_gemm_dq,
)
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
    _code_tuple,
    _gemm_uses_tc,
    _units,
    gemm_4bit_paired,
    gemm_4bit_paired_dq,
    gemm_4bit_paired_plain,
    gemm_plan,
    nested_absmax_t,
)
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)

N, K = 256, 1024
SMS = 8  # few SMs force 8 splits of these small shapes


@pytest.mark.parametrize(
    "M,N_,K_,bs,sms",
    [
        # Llama-3-8B's four decode linears on 132 SMs, at M 8 and 48
        (8, 6144, 4096, 64, 132), (8, 4096, 4096, 64, 132), (8, 28672, 4096, 64, 132),
        (8, 4096, 14336, 64, 132), (48, 6144, 4096, 64, 132), (48, 28672, 4096, 64, 132),
        # ragged: K under one stage, quantization blocks wider than a stage
        (3, 18, 96, 32, 132), (5, 98, 768, 256, 132), (1, 64, 8192, 4096, 132), (33, 640, 2048, 64, 132),
        (1, 2, 32, 32, 4), (17, 130, 4160, 64, 16),
    ],
)
def test_gemm_plan_properties(M, N_, K_, bs, sms):
    k_per_split, splits = gemm_plan(M, N_, K_, bs, sms)
    assert gemm_plan(M, N_, K_, bs, sms) == (k_per_split, splits)
    assert 1 <= splits <= 8
    assert k_per_split % bs == 0 and k_per_split % 128 == 0
    assert (splits - 1) * k_per_split < K_ <= splits * k_per_split
    tiles = -(-N_ // 128) * -(-M // 32)
    if splits > 1:  # split only into blocks that stay resident, two on an SM
        assert tiles * splits <= 2 * sms
    elif K_ > math.lcm(bs, 128):  # one split: the grid already fills the resident blocks
        assert tiles * 2 > 2 * sms


def _quantized(seed, bs, nested):
    W = (np.random.default_rng(seed).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    return JQT.quantize(jnp.asarray(W), blocksize=bs, quant_type="nf4", layout="paired",
                        compress_statistics=nested)


def _split_order_combine(A, P, absmax_t, units, bs, k_per_split, splits):
    """The plain version per split of K, its f32 partials added in split order."""
    out = None
    for s in range(splits):
        lo, hi = s * k_per_split, min(K, (s + 1) * k_per_split)
        part = gemm_4bit_paired_plain(A[:, lo:hi].contiguous(), P[:, lo:hi].contiguous(),
                                      absmax_t[lo // bs : hi // bs].contiguous(), units, bs)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("nested", [False, True], ids=["kernel2", "kernel5"])
@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("M", [1, 8, 17, 32])
def test_split_partials_combine_to_the_one_shot_result(M, bs, nested, dtype):
    jq = _quantized(M + bs, bs, nested)
    st = jq.state
    k_per_split, splits = gemm_plan(M, N, K, bs, SMS)
    assert splits == 8
    a = jnp.asarray(np.random.default_rng(M * bs).standard_normal((M, K)).astype(np.float32), getattr(jnp, dtype))
    A = tensor_from_numpy(np.asarray(a), "cpu")
    P = torch.from_numpy(np.array(jq.data))
    code = get_4bit_code("nf4", bs)
    units = _units(_code_tuple(code))
    a_j = jnp.pad(a, ((0, -M % 16), (0, 0))) if M > 16 else a  # the JAX kernel tiles M > 16 by 16
    if nested:
        codes_t = torch.from_numpy(np.array(st.absmax))
        s2 = torch.from_numpy(np.array(st.state2.absmax))
        offset = torch.from_numpy(np.asarray(st.offset, np.float32).reshape(1))
        absmax_t = nested_absmax_t(codes_t, s2, offset)  # the scales kernel 5 decodes in place
        one_shot_call = gemm_4bit_paired_dq(A, P, codes_t, s2, offset, code, bs, (N, K), out_dtype=torch.float32)
        ref = j_gemm_dq(a_j, jq.data, st.absmax, st.state2.absmax, st.offset, j_code("nf4", bs), bs, (N, K),
                        out_dtype=jnp.float32)
    else:
        absmax_t = torch.from_numpy(np.array(st.absmax))
        one_shot_call = gemm_4bit_paired(A, P, absmax_t, code, bs, (N, K), out_dtype=torch.float32)
        ref = j_gemm(a_j, jq.data, st.absmax, j_code("nf4", bs), bs, (N, K), out_dtype=jnp.float32)
    combined = _split_order_combine(A, P, absmax_t, units, bs, k_per_split, splits)
    one_shot = gemm_4bit_paired_plain(A, P, absmax_t, units, bs)
    scale = one_shot.abs().max().item()
    assert (combined - one_shot).abs().max().item() <= 1e-5 * scale
    assert torch.equal(one_shot_call, one_shot)

    ref = np.asarray(ref, np.float32)[:M]
    rel = np.abs(combined.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()
    assert rel <= 1e-5


@pytest.mark.parametrize("bs", [32, 40, 48, 64, 128, 256, 1024, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
def test_tensor_core_route(dtype, bs):
    """bf16 and f16 A take the tensor-core kernel at every quantization
    blocksize (32-4096); f32 A (no exact tensor-core product) and the
    blocksizes 40 and 48, which the ops-level wrappers take with scales made
    by hand, keep the CUDA-core body."""
    want = dtype != torch.float32 and bs not in (40, 48)
    assert _gemm_uses_tc(dtype, bs) == want
