"""Paged optimizer states in the port, on the CPU: ``optim/paged.py`` and
``is_paged`` in ``optim/base.py``.

Every ``paged_*`` factory and ``Paged*`` name builds and steps.  On the CPU
a paged state is a plain CPU tensor and the step makes no copies, so three
steps of a paged optimizer give the unpaged one's parameters and states bit
for bit; ``paged_adamw8bit`` is also held against the JAX package's
``paged_adamw8bit`` within the unpaged contract of
``test_torch_optim8bit.py::test_optimizer_steps_like_make_optimizer``
(parameters atol 1e-6; codes 99.9% equal, each within one step; absmax
rtol 1e-5, the second moment's 1e-4 as in
``test_ademamix8bit_steps_like_make_optimizer``).  The card's page-in and
page-out (pinned host states, no state bytes left on the card) are checked
by ``chip_smoke.py`` (4j, 5h)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import optim as JO
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch.optim import paged as P

torch.set_num_threads(1)

PAGED = sorted(n for n in TO.__all__ if (n.startswith("paged_") and n != "paged_state_sharding")
               or n.startswith("Paged"))


def _params(seed):
    """An 8-bit-sized tensor, a small one and a 0-d scale."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((96, 64)).astype(np.float32), rng.standard_normal(40).astype(np.float32),
            np.float32(0.5)]


def _grads(seed, steps=3):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(np.shape(p)) * 0.1).astype(np.float32) for p in _params(0)] for _ in range(steps)]


def _run(factory, kw=None, steps=3):
    ps = [torch.nn.Parameter(torch.tensor(p)) for p in _params(0)]
    opt = factory(ps, 1e-2, **(kw or {}))
    for gr in _grads(1, steps):
        for p, g in zip(ps, gr):
            p.grad = torch.tensor(g)
        opt.step()
    return ps, opt


def test_every_paged_factory_builds_and_steps():
    assert len([n for n in PAGED if n.startswith("paged_")]) == 24 and len([n for n in PAGED if n[0] == "P"]) == 12
    for name in PAGED:
        ps, opt = _run(getattr(TO, name), steps=1)
        assert all(g["is_paged"] for g in opt.param_groups), name
        assert all(torch.isfinite(p).all() for p in ps), name
        assert all(t.device.type == "cpu" for st in opt.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)), name


CASES = {
    "paged_adamw8bit": ("adamw8bit", {}),
    "paged_adamw32bit": ("adamw32bit", {}),
    "paged_lion8bit": ("lion8bit", {}),
    "paged_ademamix8bit": ("ademamix8bit", {"t_alpha": 4, "t_beta3": 6}),
}


@pytest.mark.parametrize("paged", sorted(CASES))
def test_paged_steps_bit_identical_to_unpaged(paged):
    unpaged, kw = CASES[paged]
    pp, po = _run(getattr(TO, paged), kw)
    up, uo = _run(getattr(TO, unpaged), kw)
    for a, b in zip(pp, up):
        assert torch.equal(a, b)
        sa, sb = po.state[a], uo.state[b]
        assert sa.keys() == sb.keys() and sa["step"] == 3
        for k, v in sa.items():
            if isinstance(v, torch.Tensor):
                assert v.dtype == sb[k].dtype and torch.equal(v, sb[k]), k
    want = torch.float32 if "32bit" in paged else torch.uint8
    assert po.state[pp[0]]["state1"].dtype == want


def test_paged_adamw8bit_matches_jax_paged():
    """The JAX package's paged_adamw8bit (its states in pinned host memory
    on the CPU backend) and the port's, three steps from the same tensors."""
    jopt = JO.paged_adamw8bit(1e-2)
    jp = [jnp.asarray(p) for p in _params(0)]
    jst = jopt.init(jp)
    for gr in _grads(1):
        upd, jst = jopt.update([jnp.asarray(g) for g in gr], jst, jp)
        jp = [a + u for a, u in zip(jp, upd)]
    tp, topt = _run(TO.paged_adamw8bit)
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)
    st, jl = topt.state[tp[0]], jst.leaves[0]
    for key in ("state1", "state2"):
        a, b = st[key].numpy().astype(int), np.asarray(jl[key]).astype(int)
        assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1, key
    np.testing.assert_allclose(st["absmax1"].numpy(), np.asarray(jl["absmax1"]), rtol=1e-5)
    # the second moment's absmax within the AdEMAMix test's rtol 1e-4 (the
    # two tiers round its bias correction differently)
    np.testing.assert_allclose(st["absmax2"].numpy(), np.asarray(jl["absmax2"]), rtol=1e-4)


def test_paged_group_beside_an_unpaged_one():
    """``is_paged`` is a group option: an override rule may page one group."""
    m = torch.nn.Module()
    m.big = torch.nn.Parameter(torch.tensor(_params(0)[0]))
    m.small = torch.nn.Parameter(torch.tensor(_params(0)[1]))
    opt = TO.make_optimizer_with_overrides("adam", m, 1e-2, rules=[(r"^big$", {"is_paged": True})], optim_bits=8)
    assert [g["is_paged"] for g in opt.param_groups] == [False, True]
    m.big.grad, m.small.grad = torch.ones_like(m.big) * 0.1, torch.ones_like(m.small) * 0.1
    opt.step()
    assert opt.state[m.big]["state1"].dtype == torch.uint8


@pytest.mark.parametrize("factory,dtype", [("paged_adamw8bit", torch.float32), ("adamw8bit", torch.float32),
                                           ("paged_adamw8bit", torch.bfloat16)])
def test_state_dict_round_trip(factory, dtype):
    """A loaded state keeps its types (uint8 codes, float32 absmax, also
    under a bf16 parameter) and steps as the original does, bit for bit."""
    ps = [torch.nn.Parameter(torch.tensor(p).to(dtype)) for p in _params(0)]
    opt = getattr(TO, factory)(ps, 1e-2)
    for gr in _grads(1, 2):
        for p, g in zip(ps, gr):
            p.grad = torch.tensor(g).to(dtype)
        opt.step()
    sd = copy.deepcopy(opt.state_dict())  # state_dict() holds the state tensors themselves
    ps2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = getattr(TO, factory)(ps2, 1e-2)
    opt2.load_state_dict(sd)
    assert all(g["is_paged"] == factory.startswith("paged_") for g in opt2.param_groups)
    st = opt2.state[ps2[0]]
    assert st["state1"].dtype == torch.uint8 and st["absmax1"].dtype == torch.float32 and st["step"] == 2
    for p, q in zip(ps, ps2):
        p.grad = torch.full_like(p, 0.05)
        q.grad = torch.full_like(q, 0.05)
    opt.step()
    opt2.step()
    for p, q in zip(ps, ps2):
        assert torch.equal(p, q)
        for k, v in opt.state[p].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, opt2.state[q][k]), k


def test_paged_helpers_on_the_cpu():
    """The helpers' CPU contract: ``page_in`` to the CPU returns the host
    tensors themselves (no copy), and ``page_out`` copies a distinct tree
    back into the host tensors.  Paging to and from the card is covered
    only on the card (``chip_smoke.py`` 4j, 5h)."""
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4, dtype=torch.uint8), 3]}
    host = P.to_host(tree)
    assert torch.equal(host["a"], tree["a"]) and host["a"] is not tree["a"] and host["b"][1] == 3
    assert P.paged_state_sharding(tree) == {"a": torch.device("cpu"), "b": [torch.device("cpu"), 3]}

    def bump(states, by):
        states["a"].add_(by)
        states["b"][0].add_(1)
        return "done"

    paged = P.make_paged_update(bump, device="cpu")
    assert paged(host, 2.0) == "done"
    assert torch.equal(host["a"], tree["a"] + 2.0) and torch.equal(host["b"][0], torch.full((4,), 2, dtype=torch.uint8))
    dev = P.page_in(host, "cpu")
    assert dev["a"] is host["a"] and dev["b"][0] is host["b"][0] and dev["b"][1] == 3
    out = {"a": torch.zeros(2, 3), "b": [torch.full((4,), 7, dtype=torch.uint8), 3]}
    P.page_out(host, out)
    assert host["a"] is dev["a"] and out["a"] is not host["a"]
    assert torch.equal(host["a"], torch.zeros(2, 3)) and torch.equal(host["b"][0], out["b"][0])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default device without a GPU")
def test_make_paged_update_default_device_needs_a_gpu():
    """``make_paged_update`` takes its device as every entry point does: CUDA
    unless the caller names the CPU, and without a GPU the default raises."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_paged_update(lambda states: None)
