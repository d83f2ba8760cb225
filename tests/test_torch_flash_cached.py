"""The port's cached flash attention (plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode: decode with slots at
different depths, a cached prefill chunk, and a sliding window."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.ops.pallas.flash_cached import flash_attention_cached as j_flash
from bitsandbytes_tpu_torch.ops.flash_cached import flash_attention_cached
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)

B, KVH, G, HD, S = 2, 2, 3, 128, 256


def _inputs(seed, T):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G * T, HD)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    return [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]


def _both(q, k, v, lengths, T, window=None):
    ref = j_flash(q, k, v, jnp.asarray(lengths, jnp.int32), T=T, window=window)
    out = flash_attention_cached(
        *[tensor_from_numpy(np.asarray(a), "cpu") for a in (q, k, v)],
        torch.tensor(lengths, dtype=torch.int32), T=T, window=window,
    )
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    return out.to(torch.float32).numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("case", ["decode", "prefill", "window"])
def test_flash_cached_matches_pallas(case):
    if case == "decode":
        T, lengths, window = 1, [5, S - 1], None  # slots at different depths
    elif case == "prefill":
        T, lengths, window = 8, [100 + 7, 100 + 7], None
    else:
        T, lengths, window = 1, [S - 1, 64], 32
    out, ref = _both(*_inputs(["decode", "prefill", "window"].index(case), T), lengths, T, window)
    np.testing.assert_allclose(out, ref, atol=0.02, rtol=0.02)


def test_int8_kv_not_supported_yet():
    q, k, v = (torch.zeros(1, 1, 1, HD, dtype=torch.bfloat16) for _ in range(3))
    with pytest.raises(NotImplementedError):
        flash_attention_cached(q, k.to(torch.int8), v.to(torch.int8), torch.zeros(1, dtype=torch.int32), T=1)


@pytest.mark.parametrize("bad", ["rows_not_folded", "kv_shape", "lengths_shape"])
def test_flash_wrapper_rejects_bad_inputs(bad):
    q = torch.zeros(B, KVH, G * 2, HD, dtype=torch.bfloat16)
    k = v = torch.zeros(B, KVH, S, HD, dtype=torch.bfloat16)
    lengths, T = torch.zeros(B, dtype=torch.int32), 2
    if bad == "rows_not_folded":
        T = 4  # 6 rows are not a whole number of 4-token groups
    elif bad == "kv_shape":
        v = torch.zeros(B, KVH, S // 2, HD, dtype=torch.bfloat16)
    else:
        lengths = torch.zeros(B + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_attention_cached(q, k, v, lengths, T=T)
