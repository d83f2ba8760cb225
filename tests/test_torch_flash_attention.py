"""The causal flash attention of the training path (``ops/flash_attention.py``)
against the JAX package's, on the CPU.

The JAX side is ``models/llama._flash_attention_causal``, the upstream Pallas
TPU flash kernel (forward, dK/dV and dQ), run in interpret mode under
``pltpu.force_tpu_interpret_mode()``; the port's side is its plain versions,
which its wrappers take for CPU tensors.  Inputs are unit normals from
``numpy.random.default_rng``, rounded to bf16 for both.  Tolerances, from the
measured differences (at most 0.0020 on the output and 0.59% of the largest
magnitude on a gradient in these cases; 0.0039 and 0.74% on other draws),
with room for another host's rounding: the output within 8e-3 absolute (one
bf16 ulp at 2 is 1.6e-2), each gradient within 1.5% of its largest
magnitude (the JAX package rounds dk and dv per query head to bf16 before
summing the GQA group; the port sums in f32 and rounds once).

Also: the plain versions against a dense float64 autograd reference (f32
inputs, T not a multiple of the block), the route predicate against the
JAX package's ``_flash_ok`` conditions, and what the CUDA wrappers refuse.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(1)

# (T, hd, G): each value of T, hd and G (query heads a KV head) twice
CASES = [(256, 128, 1), (384, 128, 2), (256, 256, 2), (384, 256, 1)]
KVH = 2
OUT_ATOL = 8e-3
GRAD_REL = 1.5e-2

_REF = {}


def _case(T, hd, G):
    """Inputs (numpy f32, bf16-exact) and the JAX package's output and
    gradients of sum(o * g), computed once a case."""
    key = (T, hd, G)
    if key not in _REF:
        H = KVH * G
        rng = np.random.default_rng(T + hd + G)
        bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        q, k, v = (bf(rng.standard_normal(s)) for s in ((1, T, H, hd), (1, T, KVH, hd), (1, T, KVH, hd)))
        g = bf(rng.standard_normal((1, T, H * hd)))
        cfg = dataclasses.replace(JL.LlamaConfig.tiny(), num_heads=H, num_kv_heads=KVH, head_dim=hd)
        jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
        with pltpu.force_tpu_interpret_mode():
            out = JL._flash_attention_causal(jq, jk, jv, cfg)
            grads = jax.grad(
                lambda a, b, c: jnp.sum(JL._flash_attention_causal(a, b, c, cfg).astype(jnp.float32)
                                        * jg.astype(jnp.float32)),
                argnums=(0, 1, 2))(jq, jk, jv)
        f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
        _REF[key] = ((q, k, v, g), f32(out).reshape(1, T, H, hd), [f32(d) for d in grads])
    return _REF[key]


def _torch(a, requires_grad=False):
    return torch.from_numpy(a).to(torch.bfloat16).requires_grad_(requires_grad)


@pytest.mark.parametrize("T,hd,G", CASES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in CASES])
def test_forward_matches_jax_pallas(T, hd, G):
    (q, k, v, _), ref, _ = _case(T, hd, G)
    o, m, l = FA.flash_attention_causal_fwd(_torch(q), _torch(k), _torch(v))
    assert o.dtype == torch.bfloat16 and o.shape == (1, T, KVH * G, hd)
    assert m.shape == l.shape == (1, KVH * G, T) and m.dtype == l.dtype == torch.float32
    err = np.abs(o.float().numpy() - ref).max()
    assert err <= OUT_ATOL, err
    assert bool((l >= 1.0).all()), "l sums exp(s - max s) over at least the row's own key"


@pytest.mark.parametrize("T,hd,G", CASES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in CASES])
def test_backward_matches_jax_pallas(T, hd, G):
    (q, k, v, g), _, grads = _case(T, hd, G)
    tq, tk, tv = (_torch(a, True) for a in (q, k, v))
    o = FA.flash_attention_causal(tq, tk, tv)
    o.reshape(1, T, -1).backward(_torch(g))
    for name, got, want in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert rel <= GRAD_REL, (name, rel)


def _dense_reference(q, k, v, G):
    """softmax(q k^T / sqrt(hd), causal) v in float64 with autograd."""
    B, T, H, hd = q.shape
    kr, vr = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, kr) * hd**-0.5
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), vr)


@pytest.mark.parametrize("T", [64, 200], ids=["T64", "T200"])
def test_plain_versions_are_causal_attention(T):
    """f32 inputs, B 2, G 2, T below one block and not a multiple of it: the
    output, m, l and the three gradients against float64 autograd."""
    rng = np.random.default_rng(T)
    B, H, hd, G = 2, 4, 32, 2
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((B, T, H, hd), (B, T, H // G, hd), (B, T, H // G, hd), (B, T, H, hd)))
    leaves64 = [t.double().requires_grad_() for t in (q, k, v)]
    ref = _dense_reference(*leaves64, G)
    ref.backward(g.double())
    o, m, l = FA.flash_attention_causal_fwd(q, k, v)
    assert (o.double() - ref.detach()).abs().max().item() <= 1e-5
    s = torch.einsum("bthd,bshd->bhts", leaves64[0].detach(), leaves64[1].detach().repeat_interleave(G, 2))
    s = (s * hd**-0.5).masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    lse = m.double() + torch.log(l.double())
    assert (lse - torch.logsumexp(s, dim=-1)).abs().max().item() <= 1e-5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_causal(*leaves).backward(g)
    for a, b in zip(leaves, leaves64):
        assert (a.grad.double() - b.grad).abs().max().item() <= 1e-4 * b.grad.abs().max().item()


def test_backward_pieces_compose():
    """The dK/dV and dQ plain versions, called as the autograd function calls
    them, give its gradients; ``di`` is sum(o * do) over head_dim."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in ((1, 256, 4, 128), (1, 256, 2, 128), (1, 256, 2, 128), (1, 256, 4, 128)))
    o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = FA.flash_attention_causal_bwd_dkv(q, k, v, do, m, l, di)
    dq = FA.flash_attention_causal_bwd_dq(q, k, v, do, m, l, di)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_causal(*leaves).backward(do)
    for a, b in zip((dq, dk, dv), leaves):
        assert torch.equal(a, b.grad)


def _jax_flash_ok(cfg, T, hd):
    """The JAX package's predicate with its backend taken for a TPU."""
    orig = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        return JL._flash_ok(cfg, T, hd)
    finally:
        jax.default_backend = orig


@pytest.mark.parametrize("window", [None, 4096], ids=["no_window", "window"])
def test_route_predicate_matches_jax(window):
    jcfg = dataclasses.replace(JL.LlamaConfig.tiny(), sliding_window=window)
    tcfg = dataclasses.replace(TL.LlamaConfig.tiny(), sliding_window=window)
    for T in (128, 512, 896, 1000, 1024, 1088, 1152, 2048, 4096, 8192):
        for hd in (64, 96, 128, 256):
            want = _jax_flash_ok(jcfg, T, hd)
            assert TL._flash_ok(tcfg, T, hd, torch.device("cuda")) == want, (T, hd, window)
            # the CPU takes the dense oracle, as the JAX package does on its CPU backend
            assert not TL._flash_ok(tcfg, T, hd, torch.device("cpu"))
            assert not JL._flash_ok(jcfg, T, hd)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks the wrappers make before a launch (run here on CPU
    tensors): bf16 only, head_dim 128 or 256, T a multiple of 128, heads and
    head_dim packed with 16-byte aligned rows."""
    q = torch.zeros(1, 256, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 256, 2, 128, dtype=torch.bfloat16)
    FA._check_cuda(q, k, k, 256, 128)
    for bad_q, T, hd in ((q.float(), 256, 128), (q.half(), 256, 128), (q, 192, 128), (q, 256, 64), (q, 256, 96)):
        with pytest.raises(ValueError):
            FA._check_cuda(bad_q, k, k, T, hd)
    assert FA._strides("q", q) == (256 * 4 * 128, 4 * 128)
    # a view out of a fused qkv row (the model's v) keeps its token stride
    qkv = torch.zeros(1, 256, (4 + 2 + 2) * 128, dtype=torch.bfloat16)
    v = qkv[..., 6 * 128:].reshape(1, 256, 2, 128)
    assert FA._strides("v", v) == (256 * 8 * 128, 8 * 128)
    with pytest.raises(ValueError):
        FA._strides("q", q.transpose(1, 2))
    with pytest.raises(ValueError):
        FA.flash_attention_causal_fwd(q.half(), k.half(), k.half())  # the plain versions take bf16 and f32
