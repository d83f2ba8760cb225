"""Head dims 64 and 256 through the port's cached attention, on the CPU.

The CUDA kernels 4 and 16 take head_dim 64, 128 and 256 (``HEAD_DIMS``);
here their plain versions run.  At hd 256 the port's plain version matches
the JAX package's Pallas kernel in interpret mode (bf16 and int8 KV), at the
JAX suite's tolerance for this op.  The port's ``prefill`` + ``decode_step``
on a 2-layer hidden-512 hd-256 config and on ``LlamaConfig.tiny()`` (hd 64)
give the JAX model's logits within ``tests/test_torch_llama.py``'s
tolerance.  The split-KV arithmetic of the kernels (``flash_splits``, the
combine of per-split partials) is checked against the one-shot plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.flash_cached import flash_attention_cached as j_flash
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.ops import flash_cached as FC
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 8], ids=["decode", "prefill"])
def test_flash_hd256_matches_pallas(T, int8):
    B, KVH, G, HD, S = 2, 2, 2, 256, 256
    rng = np.random.default_rng(21 + T)
    q = rng.standard_normal((B, KVH, G * T, HD)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, HD)).astype(np.float32)
    lengths = [130, S - 1] if T == 1 else [100, 107]
    if int8:
        ks = (np.abs(k).max(-1) / np.float32(127.0)).astype(np.float32)
        vs = (np.abs(v).max(-1) / np.float32(127.0)).astype(np.float32)
        kv = [np.round(k / ks[..., None]).astype(np.int8), np.round(v / vs[..., None]).astype(np.int8), ks, vs]
        jkv = [jnp.asarray(a) for a in kv]
    else:
        jkv = [jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), None, None]
    jq = jnp.asarray(q, jnp.bfloat16)
    ref = np.asarray(j_flash(jq, jkv[0], jkv[1], jnp.asarray(lengths, jnp.int32), T=T, k_scale=jkv[2],
                             v_scale=jkv[3]), np.float32)
    t = [None if a is None else tensor_from_numpy(np.asarray(a), "cpu") for a in [jq] + jkv]
    out = FC.flash_attention_cached(t[0], t[1], t[2], torch.tensor(lengths, dtype=torch.int32), T=T,
                                    k_scale=t[3], v_scale=t[4])
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref, atol=0.02, rtol=0.02)


def test_flash_splits_tile_the_positions():
    """Every split but the last holds whole 64-position tiles, the splits
    cover the positions exactly, and a grid short of one wave is split."""
    for BH, GT, S in ((64, 4, 1024), (128, 4, 1024), (64, 512, 1024), (8, 2048, 1024), (1, 4, 1), (2, 12, 100),
                      (16, 4, 32768)):
        split_len, nsplit = FC.flash_splits(BH, GT, S, 132)
        assert split_len % 64 == 0 and split_len <= 8192
        assert (nsplit - 1) * split_len < S <= nsplit * split_len
        rows = 1 if GT <= 16 else -(-GT // 64)
        if BH * rows >= 132:
            assert nsplit == -(-S // 8192)
    assert FC.flash_splits(64, 4, 1024, 132) == (192, 6)  # decode, B 8 KVH 8: 384 blocks


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_split_partials_combine_to_the_one_shot_result(int8):
    """Per-split (m, l, acc) with the kernel's numerics (p relative to the
    split's max, times the V scale, rounded to bf16), combined by
    ``flash_attention_combine``, against the one-shot plain version."""
    B, KVH, G, T, HD, S = 2, 2, 4, 1, 64, 320
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(B, KVH, G * T, HD, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, KVH, S, HD, generator=gen)
    v = torch.randn(B, KVH, S, HD, generator=gen)
    ks = vs = None
    if int8:
        ks, vs = k.abs().amax(-1) / 127.0, v.abs().amax(-1) / 127.0
        k, v = (k / ks[..., None]).round().to(torch.int8), (v / vs[..., None]).round().to(torch.int8)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lengths = torch.tensor([150, S - 1], dtype=torch.int32)
    split_len, nsplit = 128, 3
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if int8:
        s = s * ks[:, :, None, :]
    s = s * HD**-0.5
    pos = torch.arange(S)
    mask = (pos[None, :] <= lengths[:, None].long())[:, None, None, :]
    s = torch.where(mask, s, -1e30)
    accs, mls = [], []
    for sp in range(nsplit):
        sl = slice(sp * split_len, min(S, (sp + 1) * split_len))
        m = s[..., sl].amax(-1, keepdim=True)
        p = torch.where(mask[..., sl], torch.exp(s[..., sl] - m), 0.0)
        w = p * vs[:, :, None, sl] if int8 else p
        accs.append(torch.matmul(w.to(torch.bfloat16).float(), v[:, :, sl].float()).reshape(-1, HD))
        mls.append(torch.stack([m.reshape(-1), p.sum(-1).reshape(-1)], -1))
    out = FC.flash_attention_combine(torch.stack(accs), torch.stack(mls)).reshape(B, KVH, G * T, HD)
    ref = FC.flash_attention_cached_plain(q, k, v, lengths, T, None, torch.bfloat16, ks, vs)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=0.02, rtol=0.02)


def _np_tree(tree):
    if isinstance(tree, JQT):
        st = tree.state
        return {"data": np.asarray(tree.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
                "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout,
                "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


CONFIGS = {
    "hd256": dict(vocab_size=128, hidden_size=512, intermediate_size=512, num_layers=2, num_heads=2,
                  num_kv_heads=1, head_dim=256),
    "tiny_hd64": None,  # LlamaConfig.tiny()
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_prefill_and_decode_match_jax(config):
    kw = CONFIGS[config]
    jcfg = JL.LlamaConfig(**kw) if kw else JL.LlamaConfig.tiny()
    tcfg = TL.LlamaConfig(**kw) if kw else TL.LlamaConfig.tiny()
    assert tcfg.head_dim in FC.HEAD_DIMS and tcfg.head_dim == (256 if kw else 64)
    jq = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg), fuse=True)
    tq = params_from_numpy(_np_tree(jq), "cpu")
    B, S, T0 = 2, 128, 8
    ids = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(B, T0))
    jlog, tokens = [], []
    try:
        dispatch.set_backend("pallas")
        cache = JL.init_kv_cache(jcfg, B, S)
        lg, cache = JL.prefill(jq, jnp.asarray(ids), jcfg, cache)
        jlog.append(np.asarray(lg[:, -1], np.float32))
        tokens.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
        for pos in (T0, T0 + 1, T0 + 2):
            lg, cache = JL.decode_step(jq, jnp.asarray(tokens[-1]), jcfg, cache, pos)
            jlog.append(np.asarray(lg, np.float32))
            tokens.append(np.asarray(jnp.argmax(lg, -1)))
    finally:
        dispatch.set_backend("auto")
    tlog = []
    cache = TL.init_kv_cache(tcfg, B, S, device="cpu")
    lg, cache = TL.prefill(tq, torch.from_numpy(ids), tcfg, cache)
    tlog.append(lg[:, -1].float().numpy())
    for tok, pos in zip(tokens, (T0, T0 + 1, T0 + 2)):  # teacher-forced with the JAX tokens
        lg, cache = TL.decode_step(tq, torch.from_numpy(tok.astype(np.int64)), tcfg, cache, pos)
        tlog.append(lg.float().numpy())
    for step, (t, j) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(t, j, atol=0.1, rtol=0.05, err_msg=f"step {step}")
        top5 = np.argsort(-j, axis=-1)[:, :5]
        assert all(t[b].argmax() in top5[b] for b in range(B)), step


def test_mha_prefill_hands_the_kernel_a_contiguous_q(monkeypatch):
    """With as many kv heads as heads (G = 1, as gemma_7b), folding q for
    the cached attention is a strided view; the CUDA kernel takes a
    contiguous q, so the model passes one (the plain version takes
    either)."""
    cfg = TL.LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=512, num_layers=1, num_heads=2,
                         num_kv_heads=2, head_dim=256)
    seen = []

    def spy(q, *a, **kw):
        seen.append(q.is_contiguous())
        return FC.flash_attention_cached(q, *a, **kw)

    monkeypatch.setattr(TL, "flash_attention_cached", spy)
    params = TL.quantize_params_4bit(TL.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), fuse=True)
    cache = TL.init_kv_cache(cfg, 2, 64, device="cpu")
    logits, cache = TL.prefill(params, torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(1)),
                               cfg, cache)
    TL.decode_step(params, logits[:, -1].argmax(-1), cfg, cache, 16)
    assert seen == [True, True]
