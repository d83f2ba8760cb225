"""The port's LLM.int8() matmul and ``Linear8bitLt`` against the JAX
package's, on the CPU: forward values and gradients (``torch.autograd.grad``
against ``jax.grad``) of the frozen and the trained weight, at thresholds 0
and 6 and where the outlier columns overflow their budget.

Contract: the forward and ``grad_A`` within float32 rounding of the JAX
package's (its suite holds ``grad_A`` to rtol/atol 2e-2 of the float
reference); ``grad_B`` within rtol 1e-4 / atol 1e-4, the outlier columns'
exact float correction within atol 1e-3 of the scale, as in
``tests/test_autograd.py``; the quantized operands of the backward
(``_colwise_quant``) bit for bit, ties in the outlier ranking to the lower
column as ``lax.top_k`` breaks them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import autograd as JA
from bitsandbytes_tpu.functional.int8 import int8_vectorwise_quant as j_quant
from bitsandbytes_tpu.nn import Linear8bitLt as JLinear8bitLt
from bitsandbytes_tpu_torch import autograd as TA
from bitsandbytes_tpu_torch.nn import Int8Params, Int8TensorState, Linear8bitLt, Params4bit, QuantizedTensor

torch.set_num_threads(1)

K, N, M = 256, 128, 8


def _inputs(seed, outlier_cols=(), scale=20.0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    A = rng.standard_normal((2, M // 2, K)).astype(np.float32)
    for c in outlier_cols:
        A[..., c] *= scale
    return A, W


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(), np.asarray(j, np.float32), rtol=rtol, atol=atol)


def test_exports():
    assert Int8Params is Int8TensorState and Params4bit is QuantizedTensor
    assert set(JA.__all__) <= set(TA.__all__)


def test_colwise_quant_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 37)).astype(np.float32)
    x[:, 5] = 0.0  # an all-zero column
    jq, js = JA._colwise_quant(jnp.asarray(x))
    tq, ts = TA._colwise_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert TA._outlier_budget(K) == JA._outlier_budget(K) and TA._outlier_budget(9000) == JA._outlier_budget(9000)


@pytest.mark.parametrize("threshold", [0.0, 6.0])
def test_frozen_forward_and_grad_match_jax(threshold):
    A, W = _inputs(1, outlier_cols=(3, 77) if threshold else ())
    CB, SCB, _ = j_quant(jnp.asarray(W))
    jstate = JA.MatmulLtState(CB=CB, SCB=SCB, threshold=threshold)
    g_out = np.random.default_rng(2).standard_normal((2, M // 2, N)).astype(np.float32)

    jout = JA.matmul(jnp.asarray(A), None, jstate)
    jga = jax.grad(lambda a: jnp.sum(JA.matmul(a, None, jstate) * jnp.asarray(g_out)))(jnp.asarray(A))

    tstate = TA.MatmulLtState(CB=_t(CB), SCB=_t(SCB), threshold=threshold)
    a = _t(A, grad=True)
    tout = TA.matmul(a, None, tstate)
    (tga,) = torch.autograd.grad(tout, a, torch.from_numpy(g_out))
    assert tout.dtype == torch.float32 and tout.shape == (2, M // 2, N)
    _close(tout, jout)
    _close(tga, jga)
    assert not tstate.CB.requires_grad and not tstate.SCB.requires_grad


def _train_grads_jax(A, W, state, g_out):
    def f(a, w):
        return jnp.sum(JA.matmul(a, w, state) * jnp.asarray(g_out))

    out = JA.matmul(jnp.asarray(A), jnp.asarray(W), state)
    ga, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(W))
    return np.asarray(out), np.asarray(ga), np.asarray(gw)


def _train_grads_port(A, W, state, g_out, dtype=torch.float32):
    a, w = _t(A, grad=True), torch.from_numpy(W.copy()).to(dtype).requires_grad_()
    out = TA.matmul(a.to(dtype), w, state)
    ga, gw = torch.autograd.grad(out, (a, w), torch.from_numpy(g_out).to(dtype))
    return out, ga, gw


@pytest.mark.parametrize("threshold", [0.0, 6.0])
def test_train_forward_and_grads_match_jax(threshold):
    cols = (7, 101) if threshold else ()
    A, W = _inputs(3, outlier_cols=cols)
    g_out = np.random.default_rng(4).standard_normal((2, M // 2, N)).astype(np.float32)
    jout, jga, jgw = _train_grads_jax(A, W, JA.MatmulLtState(has_fp16_weights=True, threshold=threshold), g_out)
    tout, tga, tgw = _train_grads_port(A, W, TA.MatmulLtState(has_fp16_weights=True, threshold=threshold), g_out)
    _close(tout, jout)
    _close(tga, jga)
    np.testing.assert_allclose(tgw.numpy(), jgw, rtol=1e-4, atol=1e-4)
    if threshold:
        # the captured outlier columns carry the exact float product
        exact = g_out.reshape(-1, N).T @ A.reshape(-1, K)
        scale = np.abs(exact).max()
        np.testing.assert_allclose(tgw.numpy()[:, list(cols)], exact[:, list(cols)], rtol=1e-4, atol=1e-3 * scale)


def test_train_budget_overflow_matches_jax():
    """Eight outlier columns: a budget of 32 captures them all, one of 4 only
    the four largest; the forward ignores the budget, and the columns past
    it keep int8 precision in ``grad_B`` (``tests/test_autograd.py``)."""
    cols = [3, 17, 50, 77, 103, 140, 200, 230]
    A, W = _inputs(5, outlier_cols=cols, scale=30.0)
    g_out = np.random.default_rng(6).standard_normal((2, M // 2, N)).astype(np.float32)
    runs = {}
    for budget in (32, 4):
        j = _train_grads_jax(A, W, JA.MatmulLtState(has_fp16_weights=True, threshold=6.0, outlier_budget=budget),
                             g_out)
        t = _train_grads_port(A, W, TA.MatmulLtState(has_fp16_weights=True, threshold=6.0, outlier_budget=budget),
                              g_out)
        _close(t[0], j[0])
        _close(t[1], j[1])
        np.testing.assert_allclose(t[2].numpy(), j[2], rtol=1e-4, atol=1e-4)
        runs[budget] = t
    assert torch.equal(runs[32][0], runs[4][0])
    exact = g_out.reshape(-1, N).T @ A.reshape(-1, K)
    scale = np.abs(exact).max()
    err = np.abs(runs[4][2].numpy()[:, cols] - exact[:, cols]).max()
    assert err / scale < 0.1


def test_train_budget_ties_go_to_the_lower_column():
    """Columns of equal absmax at the budget's edge: the port captures the
    ones ``lax.top_k`` keeps (the lower index first)."""
    A, W = _inputs(7)
    A[..., [10, 20, 30]] = 0.0
    A[0, 0, [30, 10, 20]] = 40.0  # three equal column maxima
    A[1, 1, 60] = 80.0
    g_out = np.random.default_rng(8).standard_normal((2, M // 2, N)).astype(np.float32)
    j = _train_grads_jax(A, W, JA.MatmulLtState(has_fp16_weights=True, threshold=6.0, outlier_budget=3), g_out)
    t = _train_grads_port(A, W, TA.MatmulLtState(has_fp16_weights=True, threshold=6.0, outlier_budget=3), g_out)
    np.testing.assert_allclose(t[2].numpy(), j[2], rtol=1e-4, atol=1e-4)
    exact = g_out.reshape(-1, N).T @ A.reshape(-1, K)
    # columns 60, 10 and 20 are captured exactly; 30 is past the budget
    np.testing.assert_allclose(t[2].numpy()[:, [60, 10, 20]], exact[:, [60, 10, 20]], rtol=1e-4, atol=1e-4)


def test_train_bf16_weight_gradient_type():
    A, W = _inputs(9, outlier_cols=(5,))
    g_out = np.random.default_rng(10).standard_normal((2, M // 2, N)).astype(np.float32)
    out, ga, gw = _train_grads_port(A, W, TA.MatmulLtState(has_fp16_weights=True, threshold=6.0), g_out,
                                    dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16 and ga.dtype == torch.float32
    assert torch.isfinite(gw).all() and torch.isfinite(ga).all()


def _flax_to_port(jparams, has_fp16_weights):
    p = jparams["params"]
    bias = torch.from_numpy(np.asarray(p["bias"].astype(jnp.float32))).to(torch.bfloat16)
    if has_fp16_weights:
        return torch.from_numpy(np.asarray(p["kernel"].astype(jnp.float32))).to(torch.bfloat16), bias
    k = p["kernel"]
    return Int8TensorState(CB=torch.from_numpy(np.asarray(k.CB)), SCB=torch.from_numpy(np.asarray(k.SCB))), bias


@pytest.mark.parametrize("has_fp16_weights,threshold", [(False, 0.0), (False, 6.0), (True, 0.0), (True, 6.0)])
def test_linear8bitlt_carried_across_from_flax(has_fp16_weights, threshold):
    """A flax ``Linear8bitLt``'s parameters loaded into the port's module:
    the same output and gradients (bf16 compute, as both default to)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    x[..., 9] *= 25.0
    g_out = rng.standard_normal((2, 3, N)).astype(np.float32)
    jmod = JLinear8bitLt(features=N, has_fp16_weights=has_fp16_weights, threshold=threshold)
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # a nonzero bias, so that its gradient and its add are held too
    jparams = jax.tree_util.tree_map(lambda v: v, jparams)
    jparams["params"]["bias"] = jnp.asarray(rng.standard_normal(N).astype(np.float32)).astype(jnp.bfloat16)

    def jf(params, xx):
        return jnp.sum(jmod.apply(params, xx).astype(jnp.float32) * jnp.asarray(g_out))

    jy = jmod.apply(jparams, jnp.asarray(x))
    jgp, jgx = jax.grad(jf, argnums=(0, 1), allow_int=True)(jparams, jnp.asarray(x))

    mod = Linear8bitLt(K, N, has_fp16_weights=has_fp16_weights, threshold=threshold, device="cpu")
    weight, bias = _flax_to_port(jparams, has_fp16_weights)
    mod.weight = torch.nn.Parameter(weight) if has_fp16_weights else weight
    mod.bias = torch.nn.Parameter(bias)
    xt = _t(x, grad=True)
    y = mod(xt)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, N)
    wrt = [xt, mod.bias] + ([mod.weight] if has_fp16_weights else [])
    grads = torch.autograd.grad((y.to(torch.float32) * torch.from_numpy(g_out)).sum(), wrt)
    _close(y, jy, rtol=2 ** -7, atol=1e-2)
    _close(grads[0], jgx, rtol=2e-2, atol=2e-2)
    # the bias gradient, a sum over the 6 rows of the bf16 cotangent: both
    # packages within a bf16 unit of the exact sum (each rounds partial sums
    # to bf16), so within two units of each other
    g16 = torch.from_numpy(g_out).to(torch.bfloat16).to(torch.float64).reshape(-1, N).sum(0)
    _close(grads[1], g16.numpy(), rtol=2 ** -7, atol=2 ** -6)
    _close(grads[1], jgp["params"]["bias"], rtol=2 ** -6, atol=2 ** -5)
    if has_fp16_weights:
        jgw = np.asarray(jgp["params"]["kernel"].astype(jnp.float32))
        scale = np.abs(jgw).max()
        _close(grads[2], jgw, rtol=2 ** -7, atol=1e-2 * scale)
