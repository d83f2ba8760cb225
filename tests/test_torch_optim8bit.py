"""The port's 8-bit optimizer against the JAX package, on the CPU.

The plain version of kernel 14 (``ops/optim8bit.py``) takes the same step as
the JAX package's fused Pallas kernel, run in interpret mode, and as its jnp
tier: parameters within 3e-7, state codes 99.9% equal with every mismatch
one step, absmax within rel 1e-6.  The segment requant and the sign fixup
are bit-identical to the JAX package's jitted ones; the 32-bit updates, with
``max_unorm`` too, agree to float32 rounding; and the optimizer class steps
as the JAX package's ``make_optimizer`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import optim as JO
from bitsandbytes_tpu.functional import blockwise as JB
from bitsandbytes_tpu.functional import dynamic_segments as JDS
from bitsandbytes_tpu.functional import optim_update as JU
from bitsandbytes_tpu.functional.codebooks import create_dynamic_map
from bitsandbytes_tpu.ops.pallas.optim8bit import optimizer_update_8bit_pallas
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch.functional import dynamic_segments as TDS
from bitsandbytes_tpu_torch.functional import optim_update as TU
from bitsandbytes_tpu_torch.ops.optim8bit import UpdateScalars, optimizer_update_8bit_plain

torch.set_num_threads(1)

Q1 = np.asarray(create_dynamic_map(signed=True), np.float32)
Q2 = np.asarray(create_dynamic_map(signed=False), np.float32)
Z1 = int(np.abs(Q1).argmin())
N_EL = 2048 + 100  # a partial last block
NAN_AT = 77

# rule -> hyperparameters (those of the JAX package's factories, with decay)
HYPER = {
    "adam": dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, lr=1e-3),
    "lamb": dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0, lr=1e-3),
    "momentum": dict(beta1=0.9, beta2=0.0, eps=0.0, weight_decay=1e-2, lr=1e-2),
    "lars": dict(beta1=0.9, beta2=0.0, eps=0.0, weight_decay=0.0, lr=1e-2),
    "lion": dict(beta1=0.9, beta2=0.99, eps=0.0, weight_decay=1e-2, lr=1e-4),
    "rmsprop": dict(beta1=0.99, beta2=0.0, eps=1e-8, weight_decay=0.0, lr=1e-2),
    "adagrad": dict(beta1=0.0, beta2=0.0, eps=1e-10, weight_decay=1e-2, lr=1e-2),
}


def _inputs(name, seed):
    """Gradients, parameters and states of the scales a step meets (as the
    JAX package's own kernel test draws them): m ~ N(0, 0.01), v ~ |N| 1e-4,
    quantized by the JAX package; rmsprop and adagrad keep v in state1."""
    rng = np.random.default_rng(seed)
    n = N_EL
    g = rng.standard_normal(n).astype(np.float32) * np.float32(0.01)
    g[NAN_AT] = np.nan
    g[NAN_AT + 300] = np.inf
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.01).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 1e-4).astype(np.float32)
    first = v if name in ("rmsprop", "adagrad") else m
    s1, am1 = (np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(first), jnp.asarray(Q1), 256))
    s2 = am2 = None
    if name in ("adam", "lamb"):
        s2, am2 = (np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(v), jnp.asarray(Q2), 256))
    return g, p, s1, s2, am1, am2


def _port(name, step, g, p, s1, s2, am1, am2):
    h = dict(HYPER[name])
    sc = UpdateScalars.make(name, step=step, **h)
    t = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa: E731
    out = optimizer_update_8bit_plain(sc, t(g), t(p), t(s1), t(s2), t(am1), t(am2), tuple(Q1.tolist()),
                                      tuple(Q2.tolist()) if s2 is not None else None, True)
    return [None if o is None else o.numpy() for o in out]


def _assert_codes(a, b):
    a, b = np.asarray(a).astype(int), np.asarray(b).astype(int)
    assert (a == b).mean() >= 0.999, (a != b).sum()
    assert np.abs(a - b).max() <= 1


def _compare(port, ref, exact_codes=False):
    np_, ns1, ns2, na1, na2 = port
    rp, r1, r2, ra1, ra2 = (None if x is None else np.asarray(x) for x in ref)
    np.testing.assert_allclose(np_, rp, atol=3e-7, rtol=0)
    for q, rq in ((ns1, r1), (ns2, r2)):
        if rq is None:
            assert q is None
        elif exact_codes:
            np.testing.assert_array_equal(q, rq)
        else:
            _assert_codes(q, rq)
    for a, ra in ((na1, ra1), (na2, ra2)):
        if ra is not None:
            np.testing.assert_allclose(a, ra.reshape(-1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("name", list(HYPER))
def test_plain_kernel_matches_pallas_interpret(name, step):
    g, p, s1, s2, am1, am2 = _inputs(name, seed=step)
    port = _port(name, step, g, p, s1, s2, am1, am2)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    h = dict(HYPER[name])
    ref = optimizer_update_8bit_pallas(
        name, j(g), j(p), j(s1), j(s2), Q1, Q2 if s2 is not None else None, j(am1), j(am2),
        step=step, **h)
    _compare(port, ref)
    assert port[0][NAN_AT] == p[NAN_AT] and port[0][NAN_AT + 300] == p[NAN_AT + 300]


@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("name", list(HYPER))
def test_plain_kernel_matches_jnp_tier(name, step):
    """The jnp tier searches the true table's midpoints and takes the bias
    corrections as ``beta**step``: codes within the budget, not equal."""
    g, p, s1, s2, am1, am2 = _inputs(name, seed=10 + step)
    port = _port(name, step, g, p, s1, s2, am1, am2)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = JU._optimizer_update_8bit_jnp(
        name, j(g), j(p), j(s1), j(s2), jnp.asarray(Q1), jnp.asarray(Q2) if s2 is not None else None,
        j(am1), j(am2), step=step, **HYPER[name])
    _compare(port, ref)


def test_zero_block_codes_match_jax():
    """A block whose new state is all zero: scale inf, NaN scaled values,
    state1 code zero_idx - 1 after the fixup and state2 code 0, as the JAX
    package's fused kernel gives on the CPU."""
    name, step = "adam", 1
    g, p, s1, s2, am1, am2 = _inputs(name, seed=5)
    g[256:512] = 0.0  # with zero states (step 1) the second block stays zero
    s1[:] = 0
    s2[:] = 0
    am1[:] = 0.0
    am2[:] = 0.0
    port = _port(name, step, g, p, s1, s2, am1, am2)
    j = jnp.asarray
    ref = optimizer_update_8bit_pallas(name, j(g), j(p), j(s1), j(s2), Q1, Q2, j(am1), j(am2), step=step,
                                       **HYPER[name])
    _compare(port, ref, exact_codes=True)
    assert (port[1][256:512] == Z1 - 1).all() and (port[2][256:512] == 0).all()
    assert port[3][1] == 0.0


def _requant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2048, 256)).astype(np.float32)
    x *= np.exp(rng.uniform(-20, 5, (2048, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = -0.0
    x[2, :8] = -1e-30
    return x


@pytest.mark.parametrize("signed,fixup", [(True, True), (True, False), (False, False)])
def test_segment_requant_bit_identical_to_jitted(signed, fixup):
    """The JAX package's jitted requant contracts ``x * inv + b`` into a
    fused multiply-add; the port rounds it once the same way.  (A block of
    subnormals differs: XLA on the CPU flushes them to zero.)"""
    code = Q1 if signed else Q2
    x = _requant_inputs()
    if not signed:
        x = np.abs(x)
    jt, tt = JDS.build_state_tables(code), TDS.build_state_tables(code)
    assert type(jt).__name__ == type(tt).__name__
    qj, amj = jax.jit(lambda a: JU.state_requant_blocks(a, jt, None, fixup))(jnp.asarray(x))
    qt, amt = TU.state_requant_blocks(torch.from_numpy(x), tt, fixup)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(amt.numpy(), np.asarray(amj))


def test_sign_fixup_and_decode_bit_identical():
    x = _requant_inputs()[:64]
    t1j, t1t = JDS.build_state_tables(Q1), TDS.build_state_tables(Q1)
    idx = np.random.default_rng(1).integers(1, 255, x.shape).astype(np.int32)
    fj = np.asarray(jax.jit(lambda i, v: JDS.sign_fixup(i, v, t1j))(jnp.asarray(idx), jnp.asarray(x)))
    ft = TDS.sign_fixup(torch.from_numpy(idx), torch.from_numpy(x), t1t).numpy()
    np.testing.assert_array_equal(ft, fj)
    codes = np.arange(256, dtype=np.uint8)[None, :]
    for code in (Q1, Q2):
        jt, tt = JDS.build_state_tables(code), TDS.build_state_tables(code)
        am = np.float32(0.37)
        dj = np.asarray(jax.jit(lambda c: JU.state_dequant_blocks(c, jnp.float32(am), jt, None))(jnp.asarray(codes)))
        dt = TU.state_dequant_blocks(torch.from_numpy(codes), torch.tensor(am), tt).numpy()
        np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))


@pytest.mark.parametrize("name,max_unorm", [
    (name, mu) for name in ("adam", "momentum", "lion", "rmsprop", "adagrad") for mu in (0.0, 0.02)
] + [("ademamix", 0.0)])
def test_32bit_update_matches_jax(name, max_unorm):
    rng = np.random.default_rng(3)
    n = 1000
    g = (rng.standard_normal(n) * 0.1).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    shape1 = (2, n) if name == "ademamix" else (n,)
    s1 = np.abs(rng.standard_normal(shape1)).astype(np.float32) * 0.01
    s2 = np.abs(rng.standard_normal(n)).astype(np.float32) * 1e-3 if name in ("adam", "ademamix") else None
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.9999, alpha=5.0, eps=1e-8, weight_decay=1e-2, step=4, lr=1e-2,
              gnorm_scale=0.5, max_unorm=max_unorm)
    pn = float(np.sqrt((p.astype(np.float64) ** 2).sum()))
    jr = JU.optimizer_update_32bit(name, jnp.asarray(g), jnp.asarray(p), jnp.asarray(s1),
                                   None if s2 is None else jnp.asarray(s2), param_norm=pn, **kw)
    tr = TU.optimizer_update_32bit(name, torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(s1),
                                   None if s2 is None else torch.from_numpy(s2), param_norm=pn, **kw)
    for a, b in zip(tr, jr):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("factory", ["adamw8bit", "lion8bit", "lamb8bit", "sgd8bit", "adam32bit"])
def test_optimizer_steps_like_make_optimizer(factory):
    """Three steps of the optimizer class on a 8-bit-sized and a small
    tensor against the JAX package's optax transformation."""
    rng = np.random.default_rng(4)
    ps = {"w": rng.standard_normal((96, 64)).astype(np.float32), "s": np.float32(0.5)}
    grads = [{"w": (rng.standard_normal((96, 64)) * 0.1).astype(np.float32),
              "s": np.float32(rng.standard_normal() * 0.1)} for _ in range(3)]
    jopt = getattr(JO, factory)(1e-2)
    jp = {k: jnp.asarray(v) for k, v in ps.items()}
    jst = jopt.init(jp)
    tp = {k: torch.tensor(v) for k, v in ps.items()}
    topt = getattr(TO, factory)([tp["w"], tp["s"]], 1e-2)
    for gr in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in gr.items()}, jst, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k in tp:
            tp[k].grad = torch.tensor(gr[k])
        topt.step()
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp["s"].numpy(), np.asarray(jp["s"]), atol=1e-6, rtol=0)
    st = topt.state[tp["w"]]
    jl = jst.leaves["w"]
    if "absmax1" in jl:
        _assert_codes(st["state1"].numpy(), jl["state1"])
        np.testing.assert_allclose(st["absmax1"].numpy(), np.asarray(jl["absmax1"]), rtol=1e-5)


def test_unported_options_raise():
    p = [torch.zeros(4096, requires_grad=True)]
    with pytest.raises(NotImplementedError, match="paged"):
        TO.paged_adamw8bit(p)
    with pytest.raises(NotImplementedError, match="kernel 15"):
        TO.AdEMAMix8bit(p)
    with pytest.raises(NotImplementedError, match="GlobalOptimManager"):
        TO.GlobalOptimManager.get_instance()
    assert TO.AdamW8bit is TO.adamw8bit


@pytest.mark.parametrize("name", ["adam", "lion"])
def test_functional_8bit_update_matches_jax(name):
    """``optimizer_update_8bit_blockwise`` (new tensors, inputs untouched)
    against the JAX package's default route, its jitted segment tier."""
    g, p, s1, s2, am1, am2 = _inputs(name, seed=20)
    h = dict(HYPER[name])
    t = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa: E731
    args = [t(x) for x in (g, p, s1, s2)]
    before = [a.clone() for a in args if a is not None]
    port = TU.optimizer_update_8bit_blockwise(name, *args, Q1, Q2 if s2 is not None else None, t(am1), t(am2),
                                              step=2, **h)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))  # bitwise: g holds a NaN
               for a, b in zip([a for a in args if a is not None], before))
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = JU.optimizer_update_8bit_blockwise(
        name, j(g), j(p), j(s1), j(s2), jnp.asarray(Q1), jnp.asarray(Q2) if s2 is not None else None, j(am1), j(am2),
        step=2, **h)
    _compare([None if o is None else o.numpy() for o in port], ref)
