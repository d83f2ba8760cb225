"""Kernel 1's stochastic mode in the port against the JAX package.

With the same uniforms, the port's ``quantize_4bit_codes(u=)`` (the plain
version here; chip_smoke.py holds the CUDA kernel to it) gives the JAX
package's Pallas quantize kernel's mode "u" codes and absmax bit for bit
(interpret mode).  ``quantize_4bit(generator=)`` draws its own uniforms, so
it is held to rank adjacency (``PARITY.md``, the stochastic rounding
contract): every code within one value-sorted rank of the JAX package's
``quantize_4bit(stochastic_key=)`` and of the round-to-nearest code, the
absmax equal, and a moved share near the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_tpu.functional as JF
from bitsandbytes_tpu.ops.pallas.quant4bit import quantize_4bit_codes_pallas
from bitsandbytes_tpu_torch.functional import fourbit as TF
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.ops.quant4bit import quantize_4bit_codes

torch.set_num_threads(1)

N, K, BS = 32, 256, 64


def _weight(seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N, K)).astype(np.float32)
    W[3, :BS] = 0.0  # an all-zero block
    W[5, 7] = 40.0  # an outlier dominating its block
    return W


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_u_mode_bit_identical_to_pallas_interpret(quant_type):
    W = _weight(11)
    u = np.random.default_rng(12).random((N, K), dtype=np.float32)
    code_t = tuple(float(x) for x in get_4bit_code(quant_type, BS))
    jq, jam = quantize_4bit_codes_pallas(jnp.asarray(W), code_t=code_t, blocksize=BS,
                                         stochastic_u=jnp.asarray(u))
    tq, tam = quantize_4bit_codes(torch.from_numpy(W).reshape(-1), quant_type, BS, torch.from_numpy(u).reshape(-1))
    np.testing.assert_array_equal(tq.numpy().reshape(N, K), np.asarray(jq))
    np.testing.assert_array_equal(tam.numpy().view(np.uint32), np.asarray(jam).reshape(-1).view(np.uint32))
    nearest, _ = quantize_4bit_codes(torch.from_numpy(W).reshape(-1), quant_type, BS)
    assert 0.1 < (tq != nearest).float().mean().item() < 0.4  # the mode moves codes


def _ranks(packed: np.ndarray, quant_type: str) -> np.ndarray:
    """Packed flat bytes -> value-sorted ranks of the codes."""
    flat = packed.reshape(-1)
    codes = np.stack([flat >> 4, flat & 0xF], -1).reshape(-1).astype(np.int64)
    rank_of = np.argsort(np.argsort(get_4bit_code(quant_type, BS), kind="stable"), kind="stable")
    return rank_of[codes]


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_generator_rounding_within_rank_adjacency_of_jax(quant_type):
    W = _weight(13)
    jp, js = JF.quantize_4bit(jnp.asarray(W), blocksize=BS, quant_type=quant_type,
                              stochastic_key=jax.random.PRNGKey(3))
    jn, _ = JF.quantize_4bit(jnp.asarray(W), blocksize=BS, quant_type=quant_type)
    gen = torch.Generator().manual_seed(3)
    tp, ts = TF.quantize_4bit(torch.from_numpy(W), blocksize=BS, quant_type=quant_type, generator=gen)
    tn, _ = TF.quantize_4bit(torch.from_numpy(W), blocksize=BS, quant_type=quant_type)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.absmax.numpy().view(np.uint32), np.asarray(js.absmax).view(np.uint32))
    rt, rj, rn = (_ranks(np.asarray(a), quant_type) for a in (tp.numpy(), jp, tn.numpy()))
    assert np.abs(rt - rj).max() <= 1 and np.abs(rt - rn).max() <= 1
    moved_t, moved_j = (rt != rn).mean(), (rj != rn).mean()
    assert abs(moved_t - moved_j) < 0.05, (moved_t, moved_j)
    # a second draw from another seed moves other codes
    tp2, _ = TF.quantize_4bit(torch.from_numpy(W), blocksize=BS, quant_type=quant_type,
                              generator=torch.Generator().manual_seed(4))
    assert not torch.equal(tp, tp2)
