"""The port's paged flash attention (plain version on the CPU) against the
JAX package's Pallas kernel ``flash_attention_paged`` in interpret mode, bf16
and int8 pools, and against the port's own dense plain version on a pool
scattered from the dense cache (bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.ops.pallas.flash_cached import flash_attention_paged as j_paged
from bitsandbytes_tpu_torch.ops.flash_cached import (
    flash_attention_cached,
    flash_attention_paged,
    flash_attention_paged_plain,
)
from bitsandbytes_tpu_torch.utils.interop import tensor_from_numpy

torch.set_num_threads(1)

B, KVH, G, HD, S = 3, 2, 4, 128, 256
# slot 0 at position 0 (one live token), slot 1 on the last position of a
# block (127 closes block 7 of 16 and block 0 of 128), slot 2 mid-block
LENGTHS = [0, 127, 200]


def _dense(seed, int8):
    """q [B, KVH, G, hd] bf16 and a dense cache [B, KVH, S, hd] (bf16, or
    int8 codes with f32 absmax/127 scales [B, KVH, S])."""
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((B, KVH, G, HD)).astype(np.float32), jnp.bfloat16)
    k = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    if not int8:
        return q, np.asarray(jnp.asarray(k, jnp.bfloat16)), np.asarray(jnp.asarray(v, jnp.bfloat16)), None, None
    ks = np.abs(k).max(-1) / np.float32(127.0)
    vs = np.abs(v).max(-1) / np.float32(127.0)
    return (q, np.round(k / ks[..., None]).astype(np.int8), np.round(v / vs[..., None]).astype(np.int8),
            ks.astype(np.float32), vs.astype(np.float32))


def _scatter(BS, seed, *dense):
    """A shuffled pool of NB = B*MAXB + 3 blocks holding the dense arrays
    (spare blocks random), and the tables [B, MAXB]."""
    rng = np.random.default_rng(seed)
    MAXB = S // BS
    NB = B * MAXB + 3
    tables = rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)
    pools = []
    for a in dense:
        if a is None:
            pools.append(None)
            continue
        pool = (rng.standard_normal((NB, KVH, BS) + a.shape[3:]) * 3).astype(a.dtype)
        for b in range(B):
            for j in range(MAXB):
                pool[tables[b, j]] = a[b, :, j * BS : (j + 1) * BS]
        pools.append(pool)
    return tables, pools


def _t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("window", [None, 32], ids=["full", "window32"])
@pytest.mark.parametrize("BS", [16, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_plain_matches_pallas(int8, BS, window):
    q, k, v, ks, vs = _dense(BS + int8, int8)
    tables, (pk, pv, pks, pvs) = _scatter(BS, 1, k, v, ks, vs)
    lengths = np.asarray(LENGTHS, np.int32)
    ref = j_paged(q, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(lengths), T=1,
                  k_scale=None if pks is None else jnp.asarray(pks),
                  v_scale=None if pvs is None else jnp.asarray(pvs), window=window)
    out = flash_attention_paged(_t(q), _t(pk), _t(pv), _t(tables), _t(lengths), T=1, k_scale=_t(pks),
                                v_scale=_t(pvs), window=window)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, KVH, G, HD)
    # the JAX suite's own tolerance for its kernels (tests/test_flash_cached.py)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), np.asarray(ref, np.float32), atol=0.02, rtol=0.02)


@pytest.mark.parametrize("BS", [8, 16, 64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_plain_equals_dense_plain_bitwise(int8, BS):
    """Gathering each slot's blocks out of the pool and running the dense
    plain version is the dense plain version on the dense cache, bit for
    bit, with the window and T > 1 too."""
    q, k, v, ks, vs = _dense(7, int8)
    tables, (pk, pv, pks, pvs) = _scatter(BS, 2, k, v, ks, vs)
    for T, window, lengths in ((1, None, LENGTHS), (1, 24, LENGTHS), (2, None, [1, 130, 255])):
        qx = torch.from_numpy(np.random.default_rng(T).standard_normal((B, KVH, G * T, HD)).astype(np.float32))
        qx = qx.to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32)
        dense = flash_attention_cached(qx, _t(k), _t(v), lens, T=T, k_scale=_t(ks), v_scale=_t(vs), window=window)
        paged = flash_attention_paged(qx, _t(pk), _t(pv), _t(tables), lens, T=T, k_scale=_t(pks),
                                      v_scale=_t(pvs), window=window)
        assert torch.equal(dense.view(torch.int16), paged.view(torch.int16)), (T, window)


def test_paged_wrapper_rejects_bad_inputs():
    q = torch.zeros(B, KVH, G, HD, dtype=torch.bfloat16)
    pool = torch.zeros(4, KVH, 16, HD, dtype=torch.bfloat16)
    tables = torch.zeros(B, 2, dtype=torch.int32)
    lengths = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="pools"):
        flash_attention_paged(q, pool, pool[:, :, :8], tables, lengths)
    with pytest.raises(ValueError, match="int8 cache needs"):
        flash_attention_paged(q, pool.to(torch.int8), pool.to(torch.int8), tables, lengths)
    with pytest.raises(ValueError, match="int8 cache needs"):
        scale = torch.zeros(4, KVH, 16)
        flash_attention_paged(q, pool, pool, tables, lengths, k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="tables"):
        flash_attention_paged(q, pool, pool, tables[:1], lengths)


def test_plain_reads_through_the_tables():
    """Moving a slot's blocks to other pool blocks and its table with them
    changes nothing; pointing one table entry elsewhere does."""
    q, k, v, _, _ = _dense(3, False)
    tables, (pk, pv) = _scatter(16, 4, k, v)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    base = flash_attention_paged_plain(_t(q), _t(pk), _t(pv), _t(tables), lens, 1, None, torch.bfloat16)
    perm = np.random.default_rng(5).permutation(pk.shape[0])
    inv = np.argsort(perm)
    moved = flash_attention_paged_plain(_t(q), _t(pk[perm]), _t(pv[perm]), _t(inv[tables].astype(np.int32)),
                                        lens, 1, None, torch.bfloat16)
    assert torch.equal(base, moved)
    bad = tables.copy()
    bad[2, 3] = bad[2, 4]
    other = flash_attention_paged_plain(_t(q), _t(pk), _t(pv), _t(bad), lens, 1, None, torch.bfloat16)
    assert torch.equal(base[:2], other[:2]) and not torch.equal(base[2], other[2])
