"""The port's Llama serving path against the JAX package's, on the CPU.

Weights are drawn once by the JAX package and carried across as numpy
(``utils/interop.params_from_numpy``).  Quantizing them in the port gives the
JAX package's bytes; prefill of 8 tokens and 3 decode steps on the same
quantized bytes give the same logits, the JAX side running its Pallas
kernels in interpret mode.  The same holds with the absmax double-quantized
(``compress_statistics=True``), where both sides run their ``_dq`` kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy

torch.set_num_threads(1)

# hidden 512 keeps every JAX linear on its paired Pallas kernel (its tiles
# need (TK/64) % 8 == 0); hd 128 keeps attention on the flash kernel
CFG = dict(
    vocab_size=128, hidden_size=512, intermediate_size=512, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=128,
)
B, S, T_PROMPT = 2, 128, 8


def _np_tree(tree):
    """JAX tree -> nested dicts/lists of numpy; QuantizedTensor -> dict."""
    if isinstance(tree, JQT):
        st = tree.state
        d = {
            "data": np.asarray(tree.data), "absmax": np.asarray(st.absmax),
            "shape": tuple(st.shape), "blocksize": st.blocksize, "quant_type": st.quant_type,
            "layout": st.layout, "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name,
        }
        if st.nested:
            d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                     nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
        return d
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JL.LlamaConfig(**CFG), TL.LlamaConfig(**CFG)
    jparams = JL.init_params(jax.random.PRNGKey(0), jcfg)
    jq = JL.quantize_params_4bit(jparams, fuse=True)
    return jcfg, tcfg, jparams, jq


def test_quantize_params_bytes_equal(models):
    _, _, jparams, jq = models
    tq = TL.quantize_params_4bit(params_from_numpy(_np_tree(jparams), "cpu"), fuse=True)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        assert set(jl) == set(tl)
        for name in ("wqkv", "wo", "gate_up", "down"):
            assert tl[name].state.layout == "paired"
            np.testing.assert_array_equal(tl[name].data.numpy(), np.asarray(jl[name].data))
            np.testing.assert_array_equal(tl[name].state.absmax.numpy(), np.asarray(jl[name].state.absmax))


@pytest.fixture(scope="module")
def nested_models(models):
    jcfg, tcfg, jparams, _ = models
    return jcfg, tcfg, jparams, JL.quantize_params_4bit(jparams, fuse=True, compress_statistics=True)


def test_prefill_and_decode_match_jax(models):
    _serve_against_jax(*models)


def test_nested_prefill_and_decode_match_jax(nested_models):
    _serve_against_jax(*nested_models)


def test_nested_quantize_params_against_jax(nested_models):
    """The port quantizes the same weights to the same payload bytes and,
    within the offset contract of ``test_torch_double_quant.py``, the same
    nested absmax."""
    _, _, jparams, jq = nested_models
    tq = TL.quantize_params_4bit(params_from_numpy(_np_tree(jparams), "cpu"), fuse=True,
                                 compress_statistics=True)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for name in ("wqkv", "wo", "gate_up", "down"):
            st = tl[name].state
            assert st.inline_nested and st.absmax.dtype == torch.uint8
            np.testing.assert_array_equal(tl[name].data.numpy(), np.asarray(jl[name].data))
            jc, tc = np.asarray(jl[name].state.absmax).astype(int), st.absmax.numpy().astype(int)
            assert (jc == tc).mean() >= 0.999 and np.abs(jc - tc).max() <= 1


def _serve_against_jax(jcfg, tcfg, _, jq):
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = np.random.default_rng(1).integers(0, CFG["vocab_size"], size=(B, T_PROMPT))
    # decode positions: two scalar steps, then one per-slot vector step
    positions = [T_PROMPT, T_PROMPT + 1, np.array([T_PROMPT + 2] * B, np.int32)]

    jlog = []
    try:
        dispatch.set_backend("pallas")
        cache = JL.init_kv_cache(jcfg, B, S)
        lg, cache = JL.prefill(jq, jnp.asarray(ids), jcfg, cache)
        jlog.append(np.asarray(lg[:, -1]))
        tokens = [np.asarray(jnp.argmax(lg[:, -1], -1))]
        for pos in positions:
            p = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
            lg, cache = JL.decode_step(jq, jnp.asarray(tokens[-1]), jcfg, cache, p)
            jlog.append(np.asarray(lg))
            tokens.append(np.asarray(jnp.argmax(lg, -1)))
    finally:
        dispatch.set_backend("auto")

    # the port, teacher-forced with the JAX package's greedy tokens
    tlog = []
    cache = TL.init_kv_cache(tcfg, B, S, device="cpu")
    lg, cache = TL.prefill(tq, torch.from_numpy(ids), tcfg, cache)
    tlog.append(lg[:, -1].numpy())
    for tok, pos in zip(tokens, positions):
        p = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        lg, cache = TL.decode_step(tq, torch.from_numpy(tok.astype(np.int64)), tcfg, cache, p)
        tlog.append(lg.numpy())

    for step, (t, j) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(t, j, atol=0.1, rtol=0.05, err_msg=f"step {step}")
        # the port's greedy token is the JAX token or inside its top-5
        top5 = np.argsort(-j, axis=-1)[:, :5]
        for b in range(B):
            assert t[b].argmax() in top5[b], (step, b)


def test_no_cache_forward_matches_cached_prefill(models):
    """The dense-attention forward (no cache) and the flash route over the
    cache agree on the prompt."""
    _, tcfg, _, jq = models
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, CFG["vocab_size"], size=(B, T_PROMPT)))
    dense, _ = TL.forward(tq, ids, tcfg)
    cached, _ = TL.prefill(tq, ids, tcfg, TL.init_kv_cache(tcfg, B, S, device="cpu"))
    np.testing.assert_allclose(dense.numpy(), cached.numpy(), atol=0.1, rtol=0.05)
