"""The port's cached flash attention (plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode, bf16 and int8 KV: decode with
slots at different depths, a cached prefill chunk, and a sliding window."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.ops.pallas.flash_cached import flash_attention_cached as j_flash
from bitsandbytes_tpu_torch.ops.flash_cached import flash_attention_cached
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)

B, KVH, G, HD, S = 2, 2, 3, 128, 256


def _inputs(seed, T, int8=False):
    """q, k, v (and for int8 the f32 absmax/127 scales [B, KVH, S]), as JAX
    arrays: bf16, or int8 codes."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G * T, HD)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    if not int8:
        return [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [None, None]
    ks = (np.abs(k).max(-1) / np.float32(127.0)).astype(np.float32)
    vs = (np.abs(v).max(-1) / np.float32(127.0)).astype(np.float32)
    k8 = np.round(k / ks[..., None]).astype(np.int8)
    v8 = np.round(v / vs[..., None]).astype(np.int8)
    return [jnp.asarray(q, jnp.bfloat16)] + [jnp.asarray(a) for a in (k8, v8, ks, vs)]


def _both(q, k, v, ks, vs, lengths, T, window=None):
    ref = j_flash(q, k, v, jnp.asarray(lengths, jnp.int32), T=T, k_scale=ks, v_scale=vs, window=window)
    t = [None if a is None else tensor_from_numpy(np.asarray(a), "cpu") for a in (q, k, v, ks, vs)]
    out = flash_attention_cached(
        *t[:3], torch.tensor(lengths, dtype=torch.int32), T=T, k_scale=t[3], v_scale=t[4], window=window,
    )
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    return out.to(torch.float32).numpy(), np.asarray(ref, np.float32)


_CASES = {
    "decode": (1, [5, S - 1], None),  # slots at different depths
    "prefill": (8, [100 + 7, 100 + 7], None),
    "window": (1, [S - 1, 64], 32),
}


@pytest.mark.parametrize("case", ["decode", "prefill", "window"])
def test_flash_cached_matches_pallas(case):
    T, lengths, window = _CASES[case]
    out, ref = _both(*_inputs(["decode", "prefill", "window"].index(case), T), lengths, T, window)
    np.testing.assert_allclose(out, ref, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("case", ["decode", "prefill", "window"])
def test_flash_cached_int8_matches_pallas(case):
    """int8 K/V with per-position scales: the scales apply after the dot and
    before the PV rounding, in both (the JAX suite's tolerance, 0.02)."""
    T, lengths, window = _CASES[case]
    out, ref = _both(*_inputs(10 + ["decode", "prefill", "window"].index(case), T, int8=True), lengths, T, window)
    np.testing.assert_allclose(out, ref, atol=0.02, rtol=0.02)


def test_int8_kv_not_supported_yet():
    """int8 K/V are supported with their scales; without them, or with
    scales on a bf16 cache, the wrapper raises."""
    q, k, v = (torch.zeros(1, 1, 1, HD, dtype=torch.bfloat16) for _ in range(3))
    lengths = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 cache needs"):
        flash_attention_cached(q, k.to(torch.int8), v.to(torch.int8), lengths, T=1)
    scale = torch.ones(1, 1, 1)
    with pytest.raises(ValueError, match="int8 cache needs"):
        flash_attention_cached(q, k, v, lengths, T=1, k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="f32"):
        flash_attention_cached(q, k.to(torch.int8), v.to(torch.int8), lengths, T=1, k_scale=scale,
                               v_scale=torch.ones(1, 1, 2))
    out = flash_attention_cached(q, k.to(torch.int8), v.to(torch.int8), lengths, T=1, k_scale=scale, v_scale=scale)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()


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
