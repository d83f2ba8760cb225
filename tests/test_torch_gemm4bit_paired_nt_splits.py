"""Kernels 7 and 8's split-order combine (``ops/gemm4bit_paired``), on the CPU.

The tensor-core kernel behind ``gemm_4bit_paired_nt`` and
``gemm_4bit_paired_nt_dq`` (bf16 and f16 g, blocksize a multiple of 32) cuts
N into the splits that ``nt_plan`` chooses from the shapes and the SM count
(its properties are held in ``test_torch_gemm4bit_nt_splits.py``, the plan
being shared with kernel 11), sums each split in f32 and adds the splits in
split order.  A nested state runs on its scales decoded in the kernel, which
are the bits of the resolved absmax (``nested_absmax_t``).  The CPU runs the
one-shot plain version, so these tests hold:

* the plain version applied per split of N (g's columns, the payload's row
  pairs, the absmax's columns) and added in split order matches the one-shot
  plain version within f32 rounding (1e-5 of the largest output: the
  reordered f32 sums of up to 512 products);
* the same combine matches the JAX package's ``gemm_4bit_paired_nt`` and
  ``gemm_4bit_paired_nt_dq`` (interpret mode) within the contract of
  ``test_torch_gemm4bit_nt.py``: rel 1e-2 with bf16 g, 1e-5 with f32 g;
* at blocksize 32 (a warp's 64 columns span two quantization blocks) and
  64, plain and nested, bf16 and f32 g.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional.codebooks import get_4bit_code as j_code
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    gemm_4bit_paired_nt as j_nt,
    gemm_4bit_paired_nt_dq as j_nt_dq,
)
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
    _code_tuple,
    _units,
    gemm_4bit_paired_nt,
    gemm_4bit_paired_nt_dq,
    gemm_4bit_paired_nt_plain,
    nested_absmax_t,
    nt_plan,
)
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)


def _quantized(seed, N, K, bs, nested):
    W = (np.random.default_rng(seed).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    return JQT.quantize(jnp.asarray(W), blocksize=bs, quant_type="nf4", layout="paired",
                        compress_statistics=nested)


def _split_order_combine(G, P, absmax_t, units, bs, N, rows, splits):
    """The plain version per split of N, its f32 partials added in split order."""
    out = None
    for s in range(splits):
        lo, hi = s * rows, min(N, (s + 1) * rows)
        part = gemm_4bit_paired_nt_plain(G[:, lo:hi].contiguous(), P[lo // 2 : hi // 2].contiguous(),
                                         absmax_t[:, lo:hi].contiguous(), units, bs)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nested", [False, True], ids=["kernel7", "kernel8"])
@pytest.mark.parametrize("bs", [32, 64])
@pytest.mark.parametrize("M,N,K,sms", [(16, 256, 512, 16), (3, 384, 1024, 16), (8, 512, 512, 24)])
def test_split_partials_combine_to_the_one_shot_result(M, N, K, sms, bs, nested, dtype):
    jq = _quantized(M + N + bs, N, K, bs, nested)
    st = jq.state
    rows, splits = nt_plan(M, N, K, sms)
    assert splits > 1  # the small SM count forces splits at these small shapes
    g = jnp.asarray(np.random.default_rng(M * N).standard_normal((M, N)).astype(np.float32), getattr(jnp, dtype))
    G = tensor_from_numpy(np.asarray(g), "cpu")
    P = torch.from_numpy(np.asarray(jq.data))
    code = get_4bit_code("nf4", bs)
    units = _units(_code_tuple(code))
    if nested:
        codes_t = torch.from_numpy(np.asarray(st.absmax))
        s2 = torch.from_numpy(np.asarray(st.state2.absmax))
        offset = torch.from_numpy(np.asarray(st.offset, np.float32).reshape(1))
        absmax_t = nested_absmax_t(codes_t, s2, offset)  # the scales kernel 8 decodes in place
        one_shot_call = gemm_4bit_paired_nt_dq(G, P, codes_t, s2, offset, code, bs, (N, K))
        ref = j_nt_dq(g, jq.data, st.absmax, st.state2.absmax, st.offset, j_code("nf4", bs), bs, (N, K),
                      out_dtype=jnp.float32)
    else:
        absmax_t = torch.from_numpy(np.asarray(st.absmax))
        one_shot_call = gemm_4bit_paired_nt(G, P, absmax_t, code, bs, (N, K))
        ref = j_nt(g, jq.data, st.absmax, j_code("nf4", bs), bs, (N, K), out_dtype=jnp.float32)
    combined = _split_order_combine(G, P, absmax_t, units, bs, N, rows, splits)
    one_shot = gemm_4bit_paired_nt_plain(G, P, absmax_t, units, bs)
    scale = one_shot.abs().max().item()
    assert (combined - one_shot).abs().max().item() <= 1e-5 * scale
    assert torch.equal(one_shot_call, one_shot.to(G.dtype))

    ref = np.asarray(ref, np.float32)
    rel = np.abs(combined.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()
    assert rel <= (1e-5 if dtype == "float32" else 1e-2)

