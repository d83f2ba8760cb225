"""The QLoRA training path through the causal flash attention, the port
against the JAX package, on the CPU.

``test_torch_qlora.py``'s 2-layer model (``LlamaConfig.tiny`` at hidden 512,
head_dim 128, 4 query heads over 2 KV heads, fused NF4, rank-4 adapters on
all seven targets) at T 256, with both packages' ``_flash_ok`` patched to
take the flash route (its real line is T >= 1024, too long for interpret
mode on the CPU).  The JAX package runs the upstream Pallas flash kernels
in interpret mode, the port its plain versions (``ops/flash_attention.py``).
As in ``test_torch_qlora.py``, the bf16 model is held to the loss (rel
1e-3) and the f32 model to the adapter gradients (rtol 2e-2 / atol 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.interop import lora_from_numpy
from test_torch_qlora import _leaves, _models, _np_tree

torch.set_num_threads(1)

T = 256


@pytest.fixture(autouse=True, scope="module")
def _pallas_backend():
    dispatch.set_backend("pallas")
    yield
    dispatch.set_backend("auto")


@pytest.fixture
def flash_route(monkeypatch):
    """Both packages' flash route at any T; counts the port's calls of it
    and the JAX package's traces of it."""
    calls = {"torch": 0, "jax": 0}
    monkeypatch.setattr(JL, "_flash_ok", lambda cfg, T, hd: True)
    monkeypatch.setattr(TL, "_flash_ok", lambda cfg, T, hd, device: True)
    for mod, key in ((TL, "torch"), (JL, "jax")):
        orig = mod._flash_attention_causal

        def counted(*a, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(mod, "_flash_attention_causal", counted)
    return calls


def _ids(vocab):
    return np.random.default_rng(7).integers(0, vocab, (1, T + 1))


def test_train_step_loss_matches_jax(flash_route, monkeypatch):
    """One ``lora_train_step`` of the bf16 model: its loss against the JAX
    package's ``lm_loss``, both through the flash route, and against the
    port's own dense route."""
    jcfg, tcfg, jq, jlora, tq = _models("bfloat16", False)
    ids = _ids(jcfg.vocab_size)
    with pltpu.force_tpu_interpret_mode():
        ref = float(jax.jit(lambda lo, i: JL.lm_loss(jq, lo, i, jcfg))(jlora, jnp.asarray(ids)))
    assert flash_route["jax"] == jcfg.num_layers
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    opt = TO.adamw8bit(TL.lora_parameters(tlora), 1e-3)
    loss = float(TL.lora_train_step(tq, tlora, opt, torch.from_numpy(ids), tcfg))
    assert flash_route["torch"] == tcfg.num_layers
    assert abs(loss - ref) <= 1e-3 * abs(ref), (loss, ref)
    monkeypatch.setattr(TL, "_flash_ok", lambda cfg, T, hd, device: False)
    with torch.no_grad():
        dense = float(TL.lm_loss(tq, lora_from_numpy(_np_tree(jlora), "cpu"), torch.from_numpy(ids), tcfg))
    assert flash_route["torch"] == tcfg.num_layers, "the dense route does not call the flash one"
    assert abs(loss - dense) <= 1e-3 * abs(dense), (loss, dense)


def test_adapter_grads_match_jax(flash_route):
    """The f32 model's adapter gradients through the flash backward (the
    plain dK/dV and dQ versions) against ``jax.grad`` through the Pallas
    backward kernels."""
    jcfg, tcfg, jq, jlora, tq = _models("float32", False)
    ids = _ids(jcfg.vocab_size)
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.jit(jax.value_and_grad(lambda lo, i: JL.lm_loss(jq, lo, i, jcfg)))(jlora, jnp.asarray(ids))
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    loss = TL.lm_loss(tq, tlora, torch.from_numpy(ids), tcfg)
    loss.backward()
    assert flash_route["torch"] == tcfg.num_layers and flash_route["jax"] == jcfg.num_layers
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    jleaves = _leaves(jg)
    for key, t in _leaves(tlora).items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jleaves[key]), rtol=2e-2, atol=2e-3,
                                   err_msg=str(key))
