"""The port's 8-bit optimizer against the JAX package, on the CPU.

The plain version of kernel 14 (``ops/optim8bit.py``) takes the same step as
the JAX package's fused Pallas kernel, run in interpret mode, and as its jnp
tier: parameters within 3e-7, state codes 99.9% equal with every mismatch
one step, absmax within rel 1e-6.  The segment requant and the sign fixup
are bit-identical to the JAX package's jitted ones; the 32-bit updates, with
``max_unorm`` too, agree to float32 rounding; and the optimizer class steps
as the JAX package's ``make_optimizer`` does."""

from fractions import Fraction

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
from bitsandbytes_tpu_torch.ops import optim8bit as O8
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
            np.testing.assert_allclose(np.reshape(a, -1), ra.reshape(-1), rtol=1e-6, atol=0)


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


ADEMAMIX = dict(beta1=0.9, beta2=0.999, eps=1e-8, lr=1e-3)


def _ademamix_inputs(seed):
    """Both momenta ~ N(0, 0.01) and nu ~ |N| 1e-4, quantized by the JAX
    package; a NaN and an Inf gradient, a partial last block."""
    rng = np.random.default_rng(seed)
    n = N_EL
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)
    g[NAN_AT] = np.nan
    g[NAN_AT + 300] = np.inf
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal((2, n)) * 0.01).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 1e-4).astype(np.float32)
    q = [[np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(x), jnp.asarray(Q1), 256)] for x in m]
    s2, am2 = (np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(v), jnp.asarray(Q2), 256))
    return g, p, np.stack([q[0][0], q[1][0]]), s2, np.stack([q[0][1], q[1][1]]), am2


def _round_f32(x: Fraction) -> np.float32:
    """An exact rational rounded once to the nearest float32, ties to even."""
    c = np.float32(float(x))
    if Fraction(float(c)) <= x:
        lo, hi = c, np.nextafter(c, np.float32(np.inf))
    else:
        lo, hi = np.nextafter(c, np.float32(-np.inf)), c
    below, above = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if below != above:
        return lo if below < above else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def _fma(a, b, c) -> np.float32:
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _ademamix_param_rule(sc, g, p, m1, m2, nu):
    """The port's AdEMAMix parameter rule on float32 numpy values, each
    operation rounded once: products, quotients and square roots by numpy
    (correctly rounded), each fused multiply-add exactly, as a rational."""
    f = np.float32
    out = p.copy()
    for i in np.nonzero(np.isfinite(g))[0]:
        gi = f(g[i] * f(sc.gnorm_scale))
        nm1 = _fma(f(sc.omb1), gi, f(m1[i] * f(sc.beta1)))
        nm2 = _fma(f(sc.omb3), gi, f(m2[i] * f(sc.beta3_t)))
        ns2 = _fma(f(f(sc.omb2) * gi), gi, f(nu[i] * f(sc.beta2)))
        mixed = _fma(f(sc.alpha_t), nm2, f(nm1 / f(sc.c1)))
        step = f(mixed / f(f(np.sqrt(ns2) / f(sc.c2)) + f(sc.eps)))
        if sc.decay is not None:
            out[i] = _fma(p[i], f(sc.decay), -f(f(sc.lr) * step))
        else:
            out[i] = _fma(-f(sc.lr), step, p[i])
    return out


@pytest.mark.parametrize("step,weight_decay,scheduled", [(1, 0.0, False), (1, 1e-2, True), (5, 0.0, True),
                                                         (5, 1e-2, False), (3, 1e-2, True)])
def test_ademamix_plain_kernel_bit_identical_to_pallas_interpret(step, weight_decay, scheduled, monkeypatch):
    """Kernel 15's plain version against the JAX package's fused AdEMAMix
    kernel in interpret mode: parameters, all three states' codes and their
    absmax bit for bit (an all-zero block included).  The parameter is also
    held bit for bit against a numpy evaluation of the port's own rule on
    the states it decoded, which holds on every host.

    These cases once failed on some hosts, by 1 ulp of the parameter at 1-2
    of 2148 elements, the states equal.  The cause was the port's
    ``torch.sqrt``: on float32 CPU tensors it is not correctly rounded on
    every host (1 ulp off at about 17% of inputs on one AMD EPYC build),
    where XLA's square root and the kernel's ``__fsqrt_rn`` are.  The plain
    version now takes ``dynamic_segments.sqrt_f32``; XLA's contractions were
    the same on every host tested."""
    g, p, s1, s2, am1, am2 = _ademamix_inputs(seed=30 + step)
    if step == 1:  # with zero states a zero-gradient block stays zero
        g[256:512] = 0.0
        s1[:, 256:512] = Z1
        am1[:, 1] = 0.0
        s2[256:512] = 0
        am2[1] = 0.0
    alpha_t, beta3_t = (np.float32(0.625), np.float32(0.9888780)) if scheduled else (np.float32(5.0),
                                                                                    np.float32(0.9999))
    h = dict(ADEMAMIX, weight_decay=weight_decay)
    sc = UpdateScalars.make("ademamix", step=step, beta3=float(beta3_t), alpha=float(alpha_t), **h)
    seen = {}
    rule = O8._update_plain

    def spy(sc_, g_, p_, s1_, s2_):
        seen.update(m1=s1_[0].reshape(-1).numpy().copy(), m2=s1_[1].reshape(-1).numpy().copy(),
                    nu=s2_.reshape(-1).numpy().copy())
        return rule(sc_, g_, p_, s1_, s2_)

    monkeypatch.setattr(O8, "_update_plain", spy)
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    port = optimizer_update_8bit_plain(sc, t(g), t(p), t(s1), t(s2), t(am1), t(am2), tuple(Q1.tolist()),
                                       tuple(Q2.tolist()), True)
    j = jnp.asarray
    ref = optimizer_update_8bit_pallas("ademamix", j(g), j(p), j(s1), j(s2), Q1, Q2, j(am1), j(am2), step=step,
                                       beta3=beta3_t, alpha=alpha_t, **h)
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint8), b.view(np.uint8))
    assert port[0][NAN_AT] == p[NAN_AT] and (port[1][:, NAN_AT] == Z1).all()
    n = p.size
    want = _ademamix_param_rule(sc, g, p, seen["m1"][:n], seen["m2"][:n], seen["nu"][:n])
    np.testing.assert_array_equal(port[0].numpy().view(np.uint32), want.view(np.uint32))


# (step, t_beta3) where XLA's float32 exp is not correctly rounded: the one
# step of the grid below where the port's beta3_t is 1 ulp from the JAX
# package's (0.98887807 against 0.98887801)
_SCHEDULE_RECORDED = {(8, 1000)}


@pytest.mark.parametrize("t_beta3", [8, 100, 1000])
def test_ademamix_schedules_bit_identical_to_jax(t_beta3):
    """``alpha=5, beta3=0.9999, t_alpha=8`` at every step from 1 to
    ``t_beta3 + 1``: the JAX package's float32 bits, bar the recorded step."""
    from bitsandbytes_tpu.optim.base import _ademamix_schedules as jax_schedules
    from bitsandbytes_tpu_torch.optim.base import _ademamix_schedules

    for step in range(1, t_beta3 + 2):
        ja, jb = (np.float32(x) for x in jax_schedules(jnp.asarray(step, jnp.int32), 5.0, 0.9999, 8, t_beta3))
        ta, tb = (np.float32(x) for x in _ademamix_schedules(step, 5.0, 0.9999, 8, t_beta3))
        assert ta == ja, (step, ta, ja)
        if (step, t_beta3) in _SCHEDULE_RECORDED:
            assert abs(int(tb.view(np.int32)) - int(jb.view(np.int32))) == 1, (step, tb, jb)
        else:
            assert tb == jb, (step, tb, jb)


def test_ademamix8bit_steps_like_make_optimizer():
    """Three steps of ``ademamix8bit`` with both schedules on an 8-bit-sized
    and a small tensor against the JAX package's optax transformation (its
    default tier: ``beta**step`` corrections, codes within the budget)."""
    rng = np.random.default_rng(5)
    ps = {"w": rng.standard_normal((96, 64)).astype(np.float32), "s": np.float32(0.5)}
    grads = [{"w": (rng.standard_normal((96, 64)) * 0.1).astype(np.float32),
              "s": np.float32(rng.standard_normal() * 0.1)} for _ in range(3)]
    kw = dict(t_alpha=4, t_beta3=6, weight_decay=1e-2)
    jopt = JO.ademamix8bit(1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in ps.items()}
    jst = jopt.init(jp)
    tp = {k: torch.tensor(v) for k, v in ps.items()}
    topt = TO.ademamix8bit([tp["w"], tp["s"]], 1e-2, **kw)
    for gr in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in gr.items()}, jst, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k in tp:
            tp[k].grad = torch.tensor(gr[k])
        topt.step()
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp["s"].numpy(), np.asarray(jp["s"]), atol=1e-6, rtol=0)
    st, jl = topt.state[tp["w"]], jst.leaves["w"]
    assert st["state1"].shape == (2, 96, 64) and st["absmax1"].shape == (2, 24)
    for key in ("state1", "state2"):
        _assert_codes(st[key].numpy(), jl[key])
    np.testing.assert_allclose(st["absmax1"].numpy(), np.asarray(jl["absmax1"]), rtol=1e-5)
    # nu's codes differ by one step in a few places after the first update
    # (the two tiers round its corrections differently), and nu feeds itself
    np.testing.assert_allclose(st["absmax2"].numpy(), np.asarray(jl["absmax2"]), rtol=1e-4)


def test_functional_ademamix_update_matches_jax():
    """``optimizer_update_8bit_blockwise("ademamix")`` against the JAX
    package's default route, its jitted segment tier."""
    g, p, s1, s2, am1, am2 = _ademamix_inputs(seed=40)
    h = dict(ADEMAMIX, weight_decay=1e-2, beta3=0.995, alpha=2.5)
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    port = TU.optimizer_update_8bit_blockwise("ademamix", t(g), t(p), t(s1), t(s2), Q1, Q2, t(am1), t(am2),
                                              step=2, **h)
    j = jnp.asarray
    ref = JU.optimizer_update_8bit_blockwise("ademamix", j(g), j(p), j(s1), j(s2), j(Q1), j(Q2), j(am1), j(am2),
                                             step=2, **h)
    _compare([o.numpy() for o in port], ref)



def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("beta", [0.9, 0.999])
def test_bias_corrections_within_one_ulp_of_the_jax_kernels(beta):
    """``c1 = 1 - exp(step * ln beta)`` and ``c2 = sqrt(1 - exp(...))`` as
    kernels 14 and 15 get them from the host (the correctly rounded float32
    exp) against the JAX kernels' float32 computation on the CPU, whose exp
    is a polynomial: the two exps equal or 1 ulp apart over steps 1-64, and
    c1, c2 equal at the steps the bit-identity tests run."""
    from bitsandbytes_tpu_torch.ops.optim8bit import _exp_f32

    for step in range(1, 65):
        x = np.float32(step) * np.float32(np.log(beta))
        e = jnp.exp(jnp.float32(x))
        assert _ulps(_exp_f32(x), e) <= 1, step
        if step in (1, 3, 5):
            sc = UpdateScalars.make("ademamix", beta1=beta, beta2=beta, eps=1e-8, weight_decay=0.0, step=step,
                                    lr=1e-3, beta3=0.9999, alpha=5.0)
            assert np.float32(sc.c1) == np.float32(1.0 - e) and np.float32(sc.c2) == np.float32(jnp.sqrt(1.0 - e))
