"""The causal flash attention of the training path in f16 and f32 and at
head_dim 384 and 512, the port against the JAX package, on the CPU.

The JAX side is ``models/llama._flash_attention_causal``, the upstream Pallas
TPU flash kernel (forward, dK/dV and dQ) in interpret mode under
``pltpu.force_tpu_interpret_mode()``, in the inputs' own type; the port's
side is its plain versions (``ops/flash_attention.py``), which its wrappers
take for CPU tensors and hold the CUDA kernels of both families against on
the card.  Inputs are unit normals from ``numpy.random.default_rng``,
rounded to the case's type for both.  Tolerances, from the measured
differences (f16: at most 4.9e-4 on the output and 0.062% of a gradient's
largest magnitude; f32: 3.6e-7 and 3.3e-7; bf16 at head_dim 384: 0.0020
and 0.43%), with room for another host's rounding:

* bf16 as ``test_torch_flash_attention.py``: the output within 8e-3
  absolute, each gradient within 1.5% of its largest magnitude;
* f16: the output within 8e-3 absolute (two f16 ulps at |o| near 4, which
  the first rows, averages of few unit normals, reach), each gradient within
  5e-3 of its largest magnitude;
* f32: the output within 1e-5 absolute, each gradient within 1e-4 of its
  largest magnitude (the JAX package's f32 route is full f32 under the
  tests' "highest" default; one TF32 pass would miss both).

Also: one ``lora_train_step`` of the f16 model through the flash route
against the JAX package's ``lm_loss``, and the CUDA wrappers' checks
against the JAX package's route conditions for every type and head_dim.
"""

import dataclasses

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
from bitsandbytes_tpu_torch.ops import flash_attention as FA
from bitsandbytes_tpu_torch.utils.interop import lora_from_numpy
from test_torch_flash_attention import _jax_flash_ok
from test_torch_qlora import _models, _np_tree

torch.set_num_threads(1)

KVH = 2
# (dtype, T, hd, G): f16 and f32 at the wgmma kernels' head_dims, bf16 and
# f16 at the wide family's
CASES = [("float16", 256, 128, 2), ("float16", 256, 256, 1), ("float32", 256, 128, 2), ("float32", 384, 256, 1),
         ("bfloat16", 256, 384, 2), ("float16", 256, 512, 1)]
# (output abs, gradient relative to its largest magnitude)
TOLERANCES = {"bfloat16": (8e-3, 1.5e-2), "float16": (8e-3, 5e-3), "float32": (1e-5, 1e-4)}
TORCH_TYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}

_REF = {}


def _case(dtype, T, hd, G):
    """Inputs (numpy f32, exact in ``dtype``) and the JAX package's output
    and gradients of sum(o * g) in ``dtype``, computed once a case."""
    key = (dtype, T, hd, G)
    if key not in _REF:
        H = KVH * G
        jt = getattr(jnp, dtype)
        rng = np.random.default_rng(T + hd + G + len(dtype))
        exact = lambda a: np.array(jnp.asarray(a, jt).astype(jnp.float32))  # noqa: E731
        q, k, v = (exact(rng.standard_normal(s)) for s in ((1, T, H, hd), (1, T, KVH, hd), (1, T, KVH, hd)))
        g = exact(rng.standard_normal((1, T, H * hd)))
        cfg = dataclasses.replace(JL.LlamaConfig.tiny(), num_heads=H, num_kv_heads=KVH, head_dim=hd)
        jq, jk, jv, jg = (jnp.asarray(a, jt) for a in (q, k, v, g))
        with pltpu.force_tpu_interpret_mode():
            out = JL._flash_attention_causal(jq, jk, jv, cfg)
            grads = jax.grad(
                lambda a, b, c: jnp.sum(JL._flash_attention_causal(a, b, c, cfg).astype(jnp.float32)
                                        * jg.astype(jnp.float32)),
                argnums=(0, 1, 2))(jq, jk, jv)
        assert out.dtype == jt and all(d.dtype == jt for d in grads)
        f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
        _REF[key] = ((q, k, v, g), f32(out).reshape(1, T, H, hd), [f32(d) for d in grads])
    return _REF[key]


def _ids(cases):
    return [f"{d}-T{t}-hd{h}-G{g}" for d, t, h, g in cases]


@pytest.mark.parametrize("dtype,T,hd,G", CASES, ids=_ids(CASES))
def test_forward_matches_jax_pallas(dtype, T, hd, G):
    (q, k, v, _), ref, _ = _case(dtype, T, hd, G)
    tt = TORCH_TYPES[dtype]
    o, m, l = FA.flash_attention_causal_fwd(*(torch.from_numpy(a).to(tt) for a in (q, k, v)))
    assert o.dtype == tt and o.shape == (1, T, KVH * G, hd)
    assert m.shape == l.shape == (1, KVH * G, T) and m.dtype == l.dtype == torch.float32
    err = np.abs(o.float().numpy() - ref).max()
    assert err <= TOLERANCES[dtype][0], err
    assert bool((l >= 1.0).all()), "l sums exp(s - max s) over at least the row's own key"


@pytest.mark.parametrize("dtype,T,hd,G", CASES, ids=_ids(CASES))
def test_backward_matches_jax_pallas(dtype, T, hd, G):
    (q, k, v, g), _, grads = _case(dtype, T, hd, G)
    tt = TORCH_TYPES[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(tt).requires_grad_() for a in (q, k, v))
    FA.flash_attention_causal(tq, tk, tv).reshape(1, T, -1).backward(torch.from_numpy(g).to(tt))
    for name, got, want in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), grads):
        assert got.dtype == tt and got.shape == want.shape, name
        rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert rel <= TOLERANCES[dtype][1], (name, rel)


@pytest.fixture
def flash_route(monkeypatch):
    """Both packages' flash route at any T (its real line is T >= 1024, too
    long for interpret mode), with the JAX package's Pallas tier; counts the
    port's calls of the route and the JAX package's traces of it."""
    calls = {"torch": 0, "jax": 0}
    dispatch.set_backend("pallas")
    monkeypatch.setattr(JL, "_flash_ok", lambda cfg, T, hd: True)
    monkeypatch.setattr(TL, "_flash_ok", lambda cfg, T, hd, device: True)
    for mod, key in ((TL, "torch"), (JL, "jax")):
        def counted(*a, _orig=mod._flash_attention_causal, _key=key):
            calls[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(mod, "_flash_attention_causal", counted)
    yield calls
    dispatch.set_backend("auto")


def test_f16_train_step_loss_matches_jax(flash_route):
    """One ``lora_train_step`` of ``test_torch_qlora``'s 2-layer model in f16
    (hidden 512, head_dim 128, 4 query heads over 2 KV heads, fused NF4,
    rank-4 adapters) at T 256 through the flash route: its loss against the
    JAX package's ``lm_loss`` through its Pallas flash kernels, rel 1e-3, as
    ``test_torch_flash_train.py`` holds the bf16 model."""
    jcfg, tcfg, jq, jlora, tq = _models("float16", False)
    assert jcfg.dtype == jnp.float16 and tcfg.dtype == torch.float16
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (1, 257))
    with pltpu.force_tpu_interpret_mode():
        ref = float(jax.jit(lambda lo, i: JL.lm_loss(jq, lo, i, jcfg))(jlora, jnp.asarray(ids)))
    tlora = lora_from_numpy(_np_tree(jlora), "cpu")
    opt = TO.adamw8bit(TL.lora_parameters(tlora), 1e-3)
    loss = float(TL.lora_train_step(tq, tlora, opt, torch.from_numpy(ids), tcfg))
    assert flash_route == {"torch": tcfg.num_layers, "jax": jcfg.num_layers}, flash_route
    assert np.isfinite(loss) and abs(loss - ref) <= 1e-3 * abs(ref), (loss, ref)
    assert all(t.grad is not None and t.grad.dtype == t.dtype for t in TL.lora_parameters(tlora))


@pytest.mark.parametrize("dtype", list(TORCH_TYPES))
def test_cuda_checks_take_what_the_jax_route_takes(dtype):
    """For every type and head_dim, at T on and past the route's line (the
    kernels also take shorter T), the CUDA wrappers' checks accept exactly
    the cases the JAX package's ``_flash_ok`` conditions send to its flash
    kernel, its backend check aside; each accepted case has one family:
    the wgmma kernels for bf16 and f16 at head_dim 128 and 256, the wide
    family for the rest."""
    tt = TORCH_TYPES[dtype]
    cfg = JL.LlamaConfig.tiny()
    for T in (1024, 1088, 1152, 2048, 4096):
        for hd in (64, 96, 128, 192, 256, 320, 384, 512):
            q = torch.empty(1, T, 4, hd, dtype=tt, device="meta")
            k = torch.empty(1, T, 2, hd, dtype=tt, device="meta")
            try:
                FA._check_cuda(q, k, k, T, hd)
                FA._bwd_args(q, k, k, q, *(torch.empty(1, 4, T, device="meta"),) * 3)
                took = True
            except ValueError:
                took = False
            assert took == _jax_flash_ok(cfg, T, hd), (dtype, T, hd)
            if took:
                assert FA.uses_wgmma(tt, hd) == (tt != torch.float32 and hd in (128, 256)), (dtype, hd)
