"""Kernel 11's split plan and its split-order combine (``ops/gemm4bit``), on
the CPU.

The tensor-core kernel behind ``gemm_4bit_nt_fused`` (bf16 and f16 g) cuts N
into the splits that :func:`nt_plan` chooses from the shapes and the SM
count, sums each split in f32 and adds the splits in split order.  The CPU
runs the one-shot plain version, so these tests hold:

* the plan: it covers N exactly in multiples of 64 rows, with at most 8
  splits, none empty; the grid stays within two waves of SMs (one split
  where one wave is already full), about one wave at the four Llama-3-8B
  backward shapes, and the f32 partials stay under 2 MB a linear at M 16;
* the combine: the plain version applied per split and added in split order
  matches the one-shot plain version within f32 rounding (1e-5 of the
  largest output, the reordered f32 sums of up to 512 products), and the JAX
  package's kernel (interpret mode) within the contract of
  ``test_torch_gemm4bit_2d.py``: 2^-16 with f32 g (the TPU kernel's bf16
  hi + lo scale), one bf16 step with bf16 g.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.ops.pallas.gemm4bit import gemm_4bit_nt_fused as j_gemm_4bit_nt_fused
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.gemm4bit import gemm_4bit_nt_fused, gemm_4bit_nt_fused_plain, nt_plan
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)

SMS = 132  # the H100 SXM's SM count
LLAMA_T = {"wqkv^T": (6144, 4096), "wo^T": (4096, 4096), "gate_up^T": (28672, 4096), "down^T": (4096, 14336)}
RAGGED = [(3, 32), (37, 96), (129, 4160), (513, 4096)]


def _blocks(M, K, splits):
    return -(-K // 128) * -(-M // 32) * splits


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("M", [1, 16, 31, 33, 2048])
@pytest.mark.parametrize("N,K", list(LLAMA_T.values()) + RAGGED)
def test_plan_covers_n_in_few_nonempty_splits(N, K, M, sms):
    rows, splits = nt_plan(M, N, K, sms)
    assert rows % 64 == 0 and 1 <= splits <= 8
    assert rows * (splits - 1) < N <= rows * splits  # N covered exactly, the last split non-empty
    assert splits == 1 or _blocks(M, K, splits) <= 2 * sms
    if N <= 64:
        assert splits == 1


@pytest.mark.parametrize("M", [1, 8, 16, 31, 33])
@pytest.mark.parametrize("name", list(LLAMA_T))
def test_plan_fills_about_one_wave_at_llama_shapes(name, M):
    N, K = LLAMA_T[name]
    rows, splits = nt_plan(M, N, K, SMS)
    blocks = _blocks(M, K, splits)
    assert 0.8 * SMS <= blocks <= 2 * SMS, (name, M, rows, splits, blocks)
    if M <= 16:
        assert splits == 1 or splits * M * K * 4 <= 2e6  # f32 partials, bytes


def _inputs(seed, M, N, K, bs, dtype):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, size=(N, K), dtype=np.uint8)
    B = ((q[:, 0::2] << 4) | q[:, 1::2]).astype(np.uint8)
    absmax = (rng.random(N * K // bs) * 2 + 0.1).astype(np.float32)
    g = jnp.asarray(rng.standard_normal((M, N)).astype(np.float32), getattr(jnp, dtype))
    return B, absmax, g


def _split_order_combine(G, B, absmax, code_t, bs, N, K, rows, splits):
    """The plain version per split of N, its f32 partials added in split order."""
    B2, a2 = B.reshape(N, K // 2), absmax.reshape(N, K // bs)
    out = None
    for s in range(splits):
        lo, hi = s * rows, min(N, (s + 1) * rows)
        part = gemm_4bit_nt_fused_plain(G[:, lo:hi].contiguous(), B2[lo:hi].reshape(-1), a2[lo:hi].reshape(-1),
                                        code_t, bs, K)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K,bs,sms", [(16, 256, 512, 64, 16), (3, 384, 1024, 128, 16), (24, 512, 256, 32, 24)])
def test_split_partials_combine_to_the_one_shot_result(M, N, K, bs, sms, dtype):
    B, absmax, g = _inputs(M + N, M, N, K, bs, dtype)
    rows, splits = nt_plan(M, N, K, sms)
    assert splits > 1  # the small SM count forces splits at these small shapes
    code = get_4bit_code("nf4", bs)
    code_t = tuple(float(x) for x in code)
    G, Bt, at = tensor_from_numpy(np.asarray(g), "cpu"), torch.from_numpy(B), torch.from_numpy(absmax)
    combined = _split_order_combine(G, Bt, at, code_t, bs, N, K, rows, splits)
    one_shot = gemm_4bit_nt_fused_plain(G, Bt, at, code_t, bs, K)
    scale = one_shot.abs().max().item()
    assert (combined - one_shot).abs().max().item() <= 1e-5 * scale
    assert torch.equal(gemm_4bit_nt_fused(G, Bt, at, code, bs, (N, K)), one_shot.to(G.dtype))

    ref = np.asarray(j_gemm_4bit_nt_fused(g, jnp.asarray(B), jnp.asarray(absmax), code_t, bs, (N, K)), np.float32)
    out = combined.to(G.dtype).float().numpy()
    rel = np.abs(out.astype(np.float64) - ref).max() / np.abs(ref).max()
    assert rel <= (2.0**-16 if dtype == "float32" else 2.0**-7)
