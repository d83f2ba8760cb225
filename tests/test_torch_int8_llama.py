"""LLM.int8() weights through the port's Llama model and engine, against the
JAX package, on the CPU.

Weights are drawn by the JAX package and carried across as numpy: the float
tree, quantized by the port's ``quantize_params_int8``, gives the JAX
package's CB and SCB bit for bit, and the JAX package's quantized tree
(``{"CB", "SCB"}`` nodes) loads through ``params_from_numpy``.  Two layers
at hidden 512 serve (prefill and decode over a bf16 cache) and run the
no-cache forward within the logits contract of the 4-bit cases (atol 0.1 /
rtol 0.05, the port's greedy token in the JAX package's top-5); ``lm_loss``
under ``int8_threshold=6`` (a planted outlier feature, an int8 lm_head),
dense and in token chunks, gives the JAX package's loss within rel 1e-3 and
its adapter gradients within rtol 2e-2 / atol 2e-3; and the engine's greedy
streams over int8 weights keep the JAX engine test's contract
(``tests/test_serving.py::test_engine_serves_int8_weights``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.nn.modules import Int8TensorState as JInt8
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.nn import Int8TensorState
from bitsandbytes_tpu_torch.serving import ContinuousBatchingEngine
from bitsandbytes_tpu_torch.utils.interop import lora_from_numpy, params_from_numpy
from test_torch_llama import CFG
from test_torch_llama import _np_tree as _np_tree_4bit

torch.set_num_threads(1)

B, S, T_PROMPT = 2, 64, 8


def _np_tree(tree):
    """JAX tree -> numpy dicts/lists; an Int8TensorState -> {"CB", "SCB"}."""
    if isinstance(tree, JInt8):
        return {"CB": np.asarray(tree.CB), "SCB": np.asarray(tree.SCB)}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _np_tree_4bit(tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JL.LlamaConfig(**CFG), TL.LlamaConfig(**CFG)
    jparams = JL.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, JL.quantize_params_int8(jparams)


def test_quantize_params_int8_bit_identical(models):
    _, _, jparams, jq = models
    tq = TL.quantize_params_int8(params_from_numpy(_np_tree(jparams), "cpu"))
    carried = params_from_numpy(_np_tree(jq), "cpu")
    for jl, tl, cl in zip(jq["layers"], tq["layers"], carried["layers"]):
        assert set(jl) == set(tl) == set(cl)
        for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
            for w in (tl[name], cl[name]):
                assert isinstance(w, Int8TensorState) and w.CB.dtype == torch.int8 and w.SCB.dtype == torch.float32
                np.testing.assert_array_equal(w.CB.numpy(), np.asarray(jl[name].CB))
                np.testing.assert_array_equal(w.SCB.numpy().view(np.uint32), np.asarray(jl[name].SCB).view(np.uint32))
    assert not isinstance(tq["lm_head"], Int8TensorState)
    head = TL.quantize_params_int8(params_from_numpy(_np_tree(jparams), "cpu"), quantize_lm_head=True)["lm_head"]
    np.testing.assert_array_equal(head.CB.numpy(), np.asarray(JL.quantize_params_int8(
        jparams, quantize_lm_head=True)["lm_head"].CB))


@pytest.mark.parametrize("bad", [{"CB"}, {"CB", "SCB", "extra"}])
def test_params_from_numpy_checks_int8_keys(bad):
    node = {"CB": np.zeros((4, 8), np.int8), "SCB": np.ones(4, np.float32), "extra": np.zeros(1)}
    with pytest.raises(ValueError):
        params_from_numpy({"w": {k: node[k] for k in bad}}, "cpu")
    with pytest.raises(ValueError):
        params_from_numpy({"w": {"CB": np.zeros((4, 8), np.float32), "SCB": np.ones(4, np.float32)}}, "cpu")


def _check_logits(t, j, what):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t, j, atol=0.1, rtol=0.05, err_msg=what)
    top5 = np.argsort(-j, axis=-1)[..., :5]
    assert (top5 == t.argmax(-1)[..., None]).any(-1).all(), what


def test_serve_and_forward_match_jax(models):
    """Prefill of 8 tokens and 3 greedy decode steps over a bf16 cache, the
    JAX side on its flash kernel in interpret mode, then the no-cache
    forward."""
    jcfg, tcfg, _, jq = models
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = np.random.default_rng(1).integers(0, CFG["vocab_size"], size=(B, T_PROMPT))
    jlog, tokens = [], []
    try:
        dispatch.set_backend("pallas")
        cache = JL.init_kv_cache(jcfg, B, S)
        lg, cache = JL.prefill(jq, jnp.asarray(ids), jcfg, cache)
        jlog.append(np.asarray(lg[:, -1]))
        tokens.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
        for i in range(3):
            lg, cache = JL.decode_step(jq, jnp.asarray(tokens[-1]), jcfg, cache, T_PROMPT + i)
            jlog.append(np.asarray(lg))
            tokens.append(np.asarray(jnp.argmax(lg, -1)))
    finally:
        dispatch.set_backend("auto")
    cache = TL.init_kv_cache(tcfg, B, S, device="cpu")
    lg, cache = TL.prefill(tq, torch.from_numpy(ids), tcfg, cache)
    tlog = [lg[:, -1].numpy()]
    for i, tok in enumerate(tokens[:3]):
        lg, cache = TL.decode_step(tq, torch.from_numpy(tok.astype(np.int64)), tcfg, cache, T_PROMPT + i)
        tlog.append(lg.numpy())
    for step, (t, j) in enumerate(zip(tlog, jlog)):
        _check_logits(t, j, f"step {step}")

    jl, _ = JL.forward(jq, jnp.asarray(ids), jcfg)
    tl, _ = TL.forward(tq, torch.from_numpy(ids), tcfg)
    _check_logits(tl.detach().numpy(), jl, "forward")


@pytest.fixture(scope="module")
def outlier_models(models):
    """An int8 model (lm_head too) whose embeddings carry one large feature:
    after each RMSNorm it stands at about 18, an outlier at threshold 6."""
    jcfg, tcfg, jparams, _ = models
    jp = dict(jparams)
    jp["embed"] = jparams["embed"].at[:, 7].set(30.0)
    jq = JL.quantize_params_int8(jp, quantize_lm_head=True)
    # adapters on wo and down, whose inputs do not carry the planted feature
    # itself (its bf16 products would dominate their gradients); their
    # gradients flow back through the int8 q/k/v/gate/up linears under the
    # threshold
    jlora = JL.add_lora(jax.random.PRNGKey(5), jcfg, rank=4, targets=("wo", "down"))
    # nonzero b, so that the a gradients are held too
    jlora = jax.tree_util.tree_map(lambda x: x, jlora)
    for li, layer in enumerate(jlora["layers"]):
        for name, ad in layer.items():
            ad["b"] = jax.random.normal(jax.random.PRNGKey(10 * li + len(name)), ad["b"].shape) * 0.05
    return jcfg, tcfg, jq, jlora


@pytest.mark.parametrize("token_chunk", [None, 5])
def test_lm_loss_under_threshold_matches_jax(outlier_models, token_chunk):
    jcfg, tcfg, jq, jlora = outlier_models
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], size=(2, 9))
    jloss, jgrads = jax.value_and_grad(
        lambda lo: JL.lm_loss(jq, lo, jnp.asarray(ids), jcfg, token_chunk=token_chunk, int8_threshold=6.0))(jlora)
    tq = params_from_numpy(_np_tree(jq), "cpu")
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    tloss = TL.lm_loss(tq, tlora, torch.from_numpy(ids), tcfg, token_chunk=token_chunk, int8_threshold=6.0)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    for jl, tl in zip(jgrads["layers"], tlora["layers"]):
        for name, ad in tl.items():
            for k in ("a", "b"):
                np.testing.assert_allclose(ad[k].grad.numpy(), np.asarray(jl[name][k]), rtol=2e-2, atol=2e-3,
                                           err_msg=f"{name}.{k}")
    # the threshold matters here: without it the loss moves
    plain = TL.lm_loss(tq, tlora, torch.from_numpy(ids), tcfg, token_chunk=token_chunk)
    assert abs(float(plain) - float(tloss)) > 1e-4


def test_lm_loss_chunked_equals_dense_in_meaning(outlier_models):
    """Per-chunk outlier detection on the int8 lm_head: the chunked loss is
    the dense one within 1e-5 relative, not bit for bit (as in the JAX
    package)."""
    _, tcfg, jq, _ = outlier_models
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, CFG["vocab_size"], size=(2, 9)))
    with torch.no_grad():
        dense = TL.lm_loss(tq, None, ids, tcfg, int8_threshold=6.0)
        chunked = TL.lm_loss(tq, None, ids, tcfg, token_chunk=5, int8_threshold=6.0)
    np.testing.assert_allclose(float(chunked), float(dense), rtol=1e-5)


def _naive_greedy(params, cfg, prompt, n_new, pad=32):
    """The JAX engine test's reference on the port: a full causal forward per
    token, the prompt padded to one length."""
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            logits, _ = TL.forward(params, torch.tensor([ids + [0] * (pad - len(ids))]), cfg)
            ids.append(int(logits[0, len(ids) - 1].argmax()))
    return ids[len(prompt):]


def test_engine_serves_int8_weights():
    """``tests/test_serving.py::test_engine_serves_int8_weights`` on the
    port: the JAX package's tiny model, its int8 tree carried across; the
    engine's greedy streams agree with the naive forward at 4 of 5 tokens,
    and every engine token is in the JAX forward's top-5 given the engine's
    own prefix."""
    jcfg = JL.LlamaConfig.tiny()
    tcfg = TL.LlamaConfig.tiny()
    ji8 = JL.quantize_params_int8(JL.init_params(jax.random.PRNGKey(3), jcfg))
    ti8 = params_from_numpy(_np_tree(ji8), "cpu")
    prompts = [[1, 2, 3], [9, 8, 7, 6]]
    eng = ContinuousBatchingEngine(ti8, tcfg, max_batch=2, max_len=64, device="cpu")
    results = eng.generate(prompts, max_new_tokens=5)
    for r, p in zip(results, prompts):
        assert r.prompt == p and len(r.tokens) == 5
        expect = _naive_greedy(ti8, tcfg, p, 5)
        assert sum(a == b for a, b in zip(r.tokens, expect)) >= 4, (r.tokens, expect)
        ids = list(p)
        for t in r.tokens:
            logits, _ = JL.forward(ji8, jnp.asarray([ids + [0] * (32 - len(ids))], jnp.int32), jcfg)
            top5 = np.argsort(np.asarray(logits[0, len(ids) - 1], np.float32))[-5:]
            assert t in top5, (t, top5, r.tokens)
            ids.append(t)
