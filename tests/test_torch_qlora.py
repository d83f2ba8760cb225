"""The port's QLoRA training path against the JAX package's, on the CPU.

``LlamaConfig.tiny`` (hidden 512, head_dim 128, so that the JAX package
runs its paired Pallas kernels, in interpret mode) with fused NF4 weights,
plain and double-quantized, and rank-4 adapters on all seven targets
carried over from the JAX package's ``add_lora`` (their ``b`` drawn small
and non-zero, so that every adapter tensor has a gradient).

The JAX package adds a LoRA delta in f32 and keeps the activations in f32
from there on (a bf16 product times the f32 ``scale`` array promotes); the
port rounds the sum back to bf16, as the reference library's adapters do.
So the bf16 model is held to the loss (rel 1e-3), and the gradients and the
optimizer steps are compared on the same model in float32, where both run
f32 activations: gradients within rtol 2e-2 / atol 2e-3 (as
``tests/test_autograd.py``), parameters after an ``adamw8bit`` step within
1e-6, states within the 8-bit code budget.  ``ids [2, 9]`` (M = 16) takes
the ``_nt`` kernels' route in the backward, ``ids [4, 33]`` (M = 128) the
dequantize + matmul route; ``ids [4, 17]`` (M = 64, named when the
backward threshold was 32) takes the ``_nt`` kernels over two tiles of 32
rows of g.  The same model stored as the FSDP-QLoRA recipe
stores it (bf16 ``quant_storage``, the K-adjacent ``"2d"`` layout,
double-quantized) trains against the JAX package's default tier, whose
dequantize-then-matmul computes its fused kernel's function (that kernel
cannot take bf16 operands in interpret mode on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import autograd as JA
from bitsandbytes_tpu import optim as JO
from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu_torch import autograd as TA
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.interop import (
    lora_from_numpy,
    optim_state_from_numpy,
    params_from_numpy,
    tensor_from_numpy,
)

torch.set_num_threads(1)

TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
SHAPES = {"M16_nt": (2, 9), "M64_dequant": (4, 17), "M128_dequant": (4, 33)}
MIN_8BIT = 1024  # rank-4 tiny adapters: a mix of 8-bit and 32-bit tensors


@pytest.fixture(autouse=True, scope="module")
def _pallas_backend():
    dispatch.set_backend("pallas")
    yield
    dispatch.set_backend("auto")


def _np_tree(tree):
    """JAX tree -> nested dicts/lists of numpy; QuantizedTensor -> dict."""
    if isinstance(tree, JQT):
        st = tree.state
        d = {"data": np.asarray(tree.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
             "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout,
             "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name}
        if st.nested:
            d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                     nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
        return d
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _configs(dtype):
    # tiny with hidden 512 and head_dim 128: at hidden 256 the JAX package's
    # paired kernels do not tile and it dequantizes with the exact f32 codes,
    # where its kernels and the port's round them to bf16
    jcfg, tcfg = (dataclasses.replace(C.tiny(), hidden_size=512, head_dim=128) for C in (JL.LlamaConfig, TL.LlamaConfig))
    if dtype in ("float32", "float16"):
        jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
        tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    return jcfg, tcfg


_MODELS = {}


def _models(dtype, nested):
    key = (dtype, nested)
    if key not in _MODELS:
        jcfg, tcfg = _configs(dtype)
        jq = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg), fuse=True,
                                     compress_statistics=nested)
        jlora = JL.add_lora(jax.random.PRNGKey(3), jcfg, rank=4, targets=TARGETS)
        rng = np.random.default_rng(0)
        for layer in jlora["layers"]:
            for ad in layer.values():
                ad["b"] = jnp.asarray((rng.standard_normal(ad["b"].shape) * 0.02).astype(np.float32))
        _MODELS[key] = (jcfg, tcfg, jq, jlora, params_from_numpy(_np_tree(jq), "cpu"))
    return _MODELS[key]


def _ids(shape_id, vocab):
    return np.random.default_rng(1).integers(0, vocab, SHAPES[shape_id])


def _leaves(lora):
    """(layer, target, key) -> tensor/array, for any adapter-shaped tree."""
    return {(li, n, k): ad[k] for li, layer in enumerate(lora["layers"])
            for n, ad in layer.items() for k in ("a", "b", "scale")}


@pytest.mark.parametrize("token_chunk", [None, 7], ids=["dense", "chunked"])
@pytest.mark.parametrize("nested", [False, True], ids=["nf4", "nested"])
def test_lm_loss_matches_jax(nested, token_chunk):
    jcfg, tcfg, jq, jlora, tq = _models("bfloat16", nested)
    ids = _ids("M64_dequant", jcfg.vocab_size)
    ref = float(jax.jit(lambda lo, i: JL.lm_loss(jq, lo, i, jcfg, token_chunk=token_chunk))(jlora, jnp.asarray(ids)))
    with torch.no_grad():
        out = float(TL.lm_loss(tq, lora_from_numpy(_np_tree(jlora), "cpu"), torch.from_numpy(ids), tcfg,
                               token_chunk=token_chunk))
    assert abs(out - ref) <= 1e-3 * abs(ref), (out, ref)


@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("nested", [False, True], ids=["nf4", "nested"])
def test_adapter_grads_match_jax(nested, shape_id):
    jcfg, tcfg, jq, jlora, tq = _models("float32", nested)
    ids = _ids(shape_id, jcfg.vocab_size)
    jloss, jg = jax.jit(jax.value_and_grad(lambda lo, i: JL.lm_loss(jq, lo, i, jcfg)))(jlora, jnp.asarray(ids))
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    loss = TL.lm_loss(tq, tlora, torch.from_numpy(ids), tcfg, token_chunk=8)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    jleaves = _leaves(jg)
    for key, t in _leaves(tlora).items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jleaves[key]), rtol=2e-2, atol=2e-3,
                                   err_msg=str(key))


def _compare_step(tlora, topt, jlora, jst):
    """Parameters within 1e-6; 8-bit codes 99.9% equal over the step's
    states with every mismatch one step (the gradients differ in the last
    bits: the JAX package's kernels split an f32 operand into two bf16
    terms), absmax and 32-bit states within rel 1e-4."""
    jl = _leaves(jlora)
    js = _leaves(jst.leaves)
    equal = total = 0
    for key, t in _leaves(tlora).items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jl[key]), atol=1e-6, rtol=0, err_msg=str(key))
        st, ref = topt.state[t], js[key]
        assert set(st) - {"step"} == set(ref), key
        if "absmax1" in ref:
            for q in ("state1", "state2"):
                a, b = st[q].numpy().astype(int), np.asarray(ref[q]).astype(int)
                assert np.abs(a - b).max() <= 1, (key, q)
                equal += int((a == b).sum())
                total += a.size
            for am in ("absmax1", "absmax2"):
                np.testing.assert_allclose(st[am].numpy(), np.asarray(ref[am]), rtol=1e-4, err_msg=str(key))
        else:
            for q in ("state1", "state2"):
                np.testing.assert_allclose(st[q].numpy(), np.asarray(ref[q]), rtol=1e-4, atol=1e-9)
    assert total > 0 and equal / total >= 0.999, (equal, total)


def _jax_step(jcfg, jopt):
    return jax.jit(lambda p, lo, o, i: JL.lora_train_step(p, lo, o, i, jcfg, jopt))


def _jax_update(jopt, jst, jlora, tlora):
    """The JAX package's optimizer step on the port's gradients."""
    grads = jax.tree_util.tree_map(jnp.asarray, {"layers": [
        {n: {k: t.grad.numpy() for k, t in ad.items()} for n, ad in layer.items()} for layer in tlora["layers"]]})
    updates, jst = jopt.update(grads, jst, jlora)
    return jax.tree_util.tree_map(lambda p, u: p + u, jlora, updates), jst


@pytest.mark.parametrize("nested", [False, True], ids=["nf4", "nested"])
def test_train_step_matches_jax(nested):
    """One ``lora_train_step``: the loss against the JAX package's, and the
    new adapters and states against the JAX package's ``adamw8bit`` step on
    the same gradients (the gradients themselves are held to the JAX
    package's by ``test_adapter_grads_match_jax``: an element whose gradient
    is near zero may step otherwise on gradients that differ in the last
    bits)."""
    jcfg, tcfg, jq, jlora, tq = _models("float32", nested)
    ids = _ids("M16_nt", jcfg.vocab_size)
    jopt = JO.adamw8bit(1e-3, min_8bit_size=MIN_8BIT)
    jloss, _, _ = _jax_step(jcfg, jopt)(jq, jlora, jopt.init(jlora), jnp.asarray(ids))
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    topt = TO.adamw8bit(TL.lora_parameters(tlora), 1e-3, min_8bit_size=MIN_8BIT)
    loss = TL.lora_train_step(tq, tlora, topt, torch.from_numpy(ids), tcfg)
    assert not loss.requires_grad and abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    _compare_step(tlora, topt, *_jax_update(jopt, jopt.init(jlora), jlora, tlora))


def _carried_third_step(factory, kw):
    """Two steps in the JAX package, then its adapters and optimizer state
    carried over: the third step of both packages agrees."""
    jcfg, tcfg, jq, jlora, tq = _models("float32", False)
    ids = jnp.asarray(_ids("M64_dequant", jcfg.vocab_size))
    jopt = getattr(JO, factory)(1e-3, min_8bit_size=MIN_8BIT, **kw)
    jst = jopt.init(jlora)
    step = _jax_step(jcfg, jopt)
    for _ in range(2):
        _, jlora, jst = step(jq, jlora, jst, ids)
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    topt = getattr(TO, factory)(TL.lora_parameters(tlora), 1e-3, min_8bit_size=MIN_8BIT, **kw)
    optim_state_from_numpy(topt, tlora, {"step": np.asarray(jst.step), "leaves": _np_tree(jst.leaves)})
    TL.lora_train_step(tq, tlora, topt, torch.from_numpy(np.asarray(ids)), tcfg)
    assert all(topt.state[t]["step"] == 3 for t in TL.lora_parameters(tlora))
    _compare_step(tlora, topt, *_jax_update(jopt, jst, jlora, tlora))


def test_carried_optimizer_state_takes_the_same_third_step():
    _carried_third_step("adamw8bit", {})


def test_carried_ademamix_state_takes_the_same_third_step():
    """AdEMAMix's momenta carried as ``state1 [2, ...]`` with ``absmax1
    [2, nb]``, the schedules mid-warm-up."""
    _carried_third_step("ademamix8bit", {"t_alpha": 10, "t_beta3": 10})


def test_interop_rejects_unknown_keys():
    _, _, _, jlora, _ = _models("float32", False)
    tree = _np_tree(jlora)
    tree["layers"][0]["wq"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unknown keys"):
        lora_from_numpy(tree, "cpu")
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    topt = TO.adamw8bit(TL.lora_parameters(tlora))
    leaves = {"layers": [{n: {k: {"state1": np.zeros(1), "moment": np.zeros(1)} for k in ("a", "b", "scale")}
                          for n in layer} for layer in _np_tree(jlora)["layers"]]}
    with pytest.raises(ValueError, match="unknown keys"):
        optim_state_from_numpy(topt, tlora, {"step": 1, "leaves": leaves})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nested", [False, True], ids=["nf4", "nested"])
@pytest.mark.parametrize("M", [5, 48, 128])
def test_matmul_4bit_grads_match_jax(nested, M, dtype):
    """``matmul_4bit``'s gradients against ``jax.grad`` of the JAX
    package's: f32 activations within rtol 2e-2 / atol 2e-3 (the bias
    within 1e-4 / 1e-6), as ``tests/test_autograd.py``; bf16 activations,
    whose grad_A takes the ``_nt`` kernel at M 5 and 48 and the dequantize
    route at M 128, within 1e-2 of the largest value (bf16 resolution)."""
    rng = np.random.default_rng(M)
    N, K = 256, 512
    W = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=64, layout="paired", compress_statistics=nested)
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K)), getattr(jnp, dtype)))
    bias = rng.standard_normal(N).astype(np.float32)
    proj = rng.standard_normal((M, N)).astype(np.float32)

    def jf(x_, b_):
        return jnp.sum(JA.matmul_4bit(x_, jq.data, jq.state, b_).astype(jnp.float32) * proj)

    jgx, jgb = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(bias))
    tq = params_from_numpy({"w": _np_tree(jq)}, "cpu")["w"]
    tx = tensor_from_numpy(x, "cpu").requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = TA.matmul_4bit(tx, tq.data, tq.state, tb)
    assert out.dtype == tx.dtype
    (out.float() * torch.from_numpy(proj)).sum().backward()
    gx, gb = tx.grad.float().numpy(), tb.grad.numpy()
    jgx, jgb = np.asarray(jgx, np.float32), np.asarray(jgb)
    if dtype == "float32":
        np.testing.assert_allclose(gx, jgx, rtol=2e-2, atol=2e-3)
        np.testing.assert_allclose(gb, jgb, rtol=1e-4, atol=1e-6)
    else:
        assert np.abs(gx - jgx).max() <= 1e-2 * np.abs(jgx).max()
        assert np.abs(gb - jgb).max() <= 1e-2 * np.abs(jgb).max()
    assert tq.data.grad is None and not tq.data.requires_grad
    assert tq.state.absmax.grad is None


def test_qlora_training_reduces_loss():
    """The JAX package's ``test_qlora_training_reduces_loss`` in the port:
    five ``adamw8bit`` steps on one batch lower the loss."""
    jcfg, tcfg, jq, _, tq = _models("bfloat16", False)
    lora = TL.add_lora(tcfg, rank=4, generator=torch.Generator().manual_seed(3), device="cpu")
    opt = TO.adamw8bit(TL.lora_parameters(lora), 5e-3)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab_size, (4, 17)))
    losses = [TL.lora_train_step(tq, lora, opt, ids, tcfg).item() for _ in range(5)]
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_serving_refuses_gradients_through_the_cache():
    jcfg, tcfg, _, jlora, tq = _models("bfloat16", False)
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    cache = TL.init_kv_cache(tcfg, 1, 16, device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    logits, _ = TL.prefill(tq, ids, tcfg, cache, lora=tlora)  # serving runs without gradients
    assert not logits.requires_grad
    with pytest.raises(NotImplementedError, match="no backward"):
        TL.forward(tq, ids, tcfg, cache=TL.init_kv_cache(tcfg, 1, 16, device="cpu"), lora=tlora)


def _bf16_storage_2d(jq):
    """A JAX tree's fused weights requantized as bf16-storage 2d nested
    states, from their dequantized values."""
    layers = []
    for layer in jq["layers"]:
        out = dict(layer)
        for name in ("wqkv", "wo", "gate_up", "down"):
            W = layer[name].dequantize().astype(jnp.float32)
            out[name] = JQT.quantize(W, blocksize=64, compress_statistics=True, quant_storage=jnp.bfloat16)
            assert out[name].state.layout == "2d" and out[name].data.dtype == jnp.uint16
        layers.append(out)
    return dict(jq, layers=layers)


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_bf16_storage_2d_model_trains_like_jax(shape_id):
    """The loss on the bf16 model (rel 1e-3) and the adapter gradients on the
    f32 one (rtol 2e-2 / atol 2e-3), against the JAX package's default tier:
    at M 16 the port runs kernels 9 and 11's plain versions, at M 64 kernel
    10's and the matmul (bf16) or kernels 9 and 11 (f32)."""
    dispatch.set_backend("auto")
    try:
        for dtype in ("bfloat16", "float32"):
            jcfg, tcfg, jq, jlora, _ = _models(dtype, False)
            jq2 = _bf16_storage_2d(jq)
            tq2 = params_from_numpy(_np_tree(jq2), "cpu")
            ids = _ids(shape_id, jcfg.vocab_size)
            jloss, jg = jax.jit(jax.value_and_grad(lambda lo, i: JL.lm_loss(jq2, lo, i, jcfg)))(jlora, jnp.asarray(ids))
            tlora = lora_from_numpy(_np_tree(jlora), "cpu")
            loss = TL.lm_loss(tq2, tlora, torch.from_numpy(ids), tcfg, token_chunk=8)
            assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss)), (dtype, loss.item(), float(jloss))
            if dtype == "float32":
                loss.backward()
                jleaves = _leaves(jg)
                for key, t in _leaves(tlora).items():
                    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jleaves[key]), rtol=2e-2, atol=2e-3,
                                               err_msg=str(key))
    finally:
        dispatch.set_backend("pallas")
