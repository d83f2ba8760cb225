"""The port's GPT-2/OPT family against the JAX package's ``models/gpt2.py``,
on the CPU.

The JAX package draws ``GPT2Config.tiny()``'s weights; the tree is carried
across as numpy (``utils.interop.params_from_numpy``), float and already
quantized.  The port's ``quantize_params_4bit`` / ``quantize_params_int8``
of the carried float tree give the JAX package's bytes bit for bit.  The
forward in bf16, NF4 and LLM.int8() (at thresholds 0 and 6) is held to the
JAX package's logits at atol 0.1 / rtol 0.05, the port's greedy token in
the JAX package's top-5 at every position, as the Llama tests hold theirs;
at M 16 (the small-M GEMM route) and M 192 (dequantize + matmul)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.models import gpt2 as JG
from bitsandbytes_tpu.nn.modules import Int8TensorState as JInt8
from bitsandbytes_tpu_torch.functional import gemm as TGemm
from bitsandbytes_tpu_torch.models import gpt2 as TG
from bitsandbytes_tpu_torch.nn import Int8TensorState, QuantizedTensor
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy
from test_torch_llama import _np_tree as _np_tree_4bit

torch.set_num_threads(1)


def _np_tree(tree):
    if isinstance(tree, JInt8):
        return {"CB": np.asarray(tree.CB), "SCB": np.asarray(tree.SCB)}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _np_tree_4bit(tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JG.GPT2Config.tiny(), TG.GPT2Config.tiny()
    jparams = JG.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams


QUANT = {
    "bf16": (lambda p: p, lambda p: p),
    "nf4": (JG.quantize_params_4bit, TG.quantize_params_4bit),
    "int8": (JG.quantize_params_int8, TG.quantize_params_int8),
}


def test_config_matches_jax():
    for name in ("opt125m", "tiny"):
        j, t = getattr(JG.GPT2Config, name)(), getattr(TG.GPT2Config, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "max_positions",
                  "ln_eps", "head_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.dtype == torch.bfloat16
    assert (TG.GPT2Config.opt125m().vocab_size, TG.GPT2Config.opt125m().hidden_size) == (50304, 768)


def test_init_params_shapes_and_types():
    cfg = TG.GPT2Config.tiny()
    p = TG.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = JG.init_params(jax.random.PRNGKey(0), JG.GPT2Config.tiny())
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), p) == shapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree_util.tree_leaves(p))


@pytest.mark.parametrize("mode", ["nf4", "int8"])
def test_quantize_params_bit_identical(models, mode):
    _, _, jparams = models
    jq = QUANT[mode][0](jparams)
    tq = QUANT[mode][1](params_from_numpy(_np_tree(jparams), "cpu"))
    carried = params_from_numpy(_np_tree(jq), "cpu")
    for jl, tl, cl in zip(jq["layers"], tq["layers"], carried["layers"]):
        for name in ("wqkv", "wo", "fc_in", "fc_out"):
            for w in (tl[name], cl[name]):
                if mode == "nf4":
                    assert isinstance(w, QuantizedTensor) and w.state.layout == "paired"
                    np.testing.assert_array_equal(w.data.numpy(), np.asarray(jl[name].data))
                    np.testing.assert_array_equal(w.state.absmax.numpy(), np.asarray(jl[name].state.absmax))
                    assert w.state.dtype == torch.float32
                else:
                    assert isinstance(w, Int8TensorState)
                    np.testing.assert_array_equal(w.CB.numpy(), np.asarray(jl[name].CB))
                    np.testing.assert_array_equal(w.SCB.numpy(), np.asarray(jl[name].SCB))
        assert torch.equal(tl["ln1_scale"], cl["ln1_scale"])
    assert torch.equal(tq["embed"], carried["embed"])


@pytest.mark.parametrize("shape", [(2, 8), (4, 48)], ids=["M16", "M192"])
@pytest.mark.parametrize("mode,threshold", [("bf16", 0.0), ("nf4", 0.0), ("int8", 0.0), ("int8", 6.0)],
                         ids=["bf16", "nf4", "int8", "int8_t6"])
def test_forward_matches_jax(models, mode, shape, threshold):
    jcfg, tcfg, jparams = models
    jq = QUANT[mode][0](jparams)
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, shape).astype(np.int32)
    if threshold:  # an outlier feature in the embeddings, so that the decomposition runs
        jq = dict(jq, embed=jq["embed"].at[:, 7].multiply(40.0))
        tq = dict(tq, embed=tq["embed"].clone())
        tq["embed"][:, 7] *= 40.0
    jl = np.asarray(JG.forward(jq, jnp.asarray(ids), jcfg, int8_threshold=threshold))
    tl = TG.forward(tq, torch.from_numpy(ids).long(), tcfg, int8_threshold=threshold)
    assert tl.dtype == torch.float32 and tl.shape == (*shape, tcfg.vocab_size)
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), jl, atol=0.1, rtol=0.05)
    top5 = np.argsort(-jl, axis=-1)[..., :5]
    assert (top5 == tl.argmax(-1).numpy()[..., None]).any(-1).all()


def test_routes_at_both_m(models):
    """M 16 takes the small-M GEMM, M 192 dequantize + matmul."""
    assert 2 * 8 < TGemm.LARGE_M_THRESHOLD <= 4 * 48


def test_forward_tied_lm_head_and_no_window():
    """The lm_head is the embeddings (no separate leaf), and attention is
    causal over every earlier position (no sliding window)."""
    cfg = TG.GPT2Config.tiny()
    p = TG.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert "lm_head" not in p
    ids = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(2))
    full = TG.forward(p, ids, cfg)
    # causal: a later token does not change earlier logits
    ids2 = ids.clone()
    ids2[0, -1] = (ids2[0, -1] + 1) % cfg.vocab_size
    assert torch.equal(TG.forward(p, ids2, cfg)[0, :-1], full[0, :-1])
    assert TG._AttnCfg(4).sliding_window is None


def test_gelu_is_the_tanh_approximation(monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does the
    port's MLP: in float32 the logits agree within 1e-4, and the exact
    (erf) GELU moves them ten times as far."""
    jcfg = JG.GPT2Config(**{**JG.GPT2Config.tiny().__dict__, "dtype": jnp.float32})
    tcfg = TG.GPT2Config(**{**TG.GPT2Config.tiny().__dict__, "dtype": torch.float32})
    jparams = JG.init_params(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_numpy(_np_tree(jparams), "cpu")
    ids = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl = np.asarray(JG.forward(jparams, jnp.asarray(ids), jcfg))
    tl = TG.forward(tparams, torch.from_numpy(ids).long(), tcfg).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(torch.nn.functional, "gelu", lambda x, approximate="none": gelu(x))
    exact = TG.forward(tparams, torch.from_numpy(ids).long(), tcfg).numpy()
    assert np.abs(exact - jl).max() > 10 * np.abs(tl - jl).max()
