"""Per-parameter optimizer overrides and the reference's optimizer names in
the port, on the CPU: ``optim/overrides.py`` and ``optim/compat.py``
against the JAX package's.

Labels are compared with the JAX package's ``path_labels`` on the same
paths.  An override optimizer is held bit for bit against two optimizers
built apart on the same tensors and gradients, and against the JAX
package's override transformation within the contract of
``test_torch_optim8bit.py::test_optimizer_steps_like_make_optimizer``
(parameters atol 1e-6; 8-bit codes 99.9% equal, each within one step;
absmax rtol 1e-5; 32-bit states rtol 1e-5 / atol 1e-7, as
``test_32bit_update_matches_jax``)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import optim as JO
from bitsandbytes_tpu_torch import nn as TN
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch.optim.base import BnbOptimizer

torch.set_num_threads(1)

# the JAX suite's paths (tests/test_modules.py, tests/test_compat.py) and a
# few more, as dotted parameter names
PATHS = ["params.embedding", "embedding.weight", "model.embedding.norm.weight", "embed", "w",
         "decoder.embeddings.weight", "wembedding.weight", "layers.0.embedding", "embedding_norm.weight"]


def _nest(paths):
    """Dotted names -> a nested dict of small arrays (the JAX tree of the
    same paths)."""
    tree = {}
    for p in paths:
        node = tree
        *head, last = p.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.zeros(1)
    return tree


def _flat_labels(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat_labels(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.mark.parametrize("rules", [[JO.STABLE_EMBEDDING_RULE], [(r"norm", {"optim_bits": 8}), JO.STABLE_EMBEDDING_RULE],
                                   []], ids=["stable", "two_rules", "none"])
def test_path_labels_match_jax(rules):
    jl = _flat_labels(JO.path_labels(_nest(PATHS), rules))
    named = [(p, torch.zeros(1)) for p in PATHS]
    tl = TO.path_labels(named, rules)
    assert tl == jl
    assert TO.STABLE_EMBEDDING_RULE == JO.STABLE_EMBEDDING_RULE
    if rules == [JO.STABLE_EMBEDDING_RULE]:
        assert {p for p, lab in tl.items() if lab == "0"} == {
            "params.embedding", "embedding.weight", "model.embedding.norm.weight", "layers.0.embedding"}


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.embedding = TN.StableEmbedding(64, 128, device="cpu", generator=g)
        self.proj = torch.nn.Linear(128, 96)


def _grads(model, steps, seed):
    rng = np.random.default_rng(seed)
    return [{n: (rng.standard_normal(tuple(p.shape)) * 0.1).astype(np.float32) for n, p in model.named_parameters()}
            for _ in range(steps)]


def _clone(model):
    twin = _Model()
    twin.load_state_dict(model.state_dict())
    return twin


def _group_of(opt, p):
    return next(g for g in opt.param_groups if any(q is p for q in g["params"]))


def _step(opts, model, grads):
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n].copy())
    for o in opts:
        o.step()


def test_override_group_bit_identical_to_two_optimizers():
    """adam8bit with the embedding rule at 32 bits: one optimizer, two
    groups, the bits of an adam32bit over the embedding and an adam8bit over
    the rest built apart."""
    torch.manual_seed(0)
    model = _Model()
    twin = _clone(model)
    opt = TO.make_optimizer_with_overrides("adam", model, 1e-2, rules=[TO.STABLE_EMBEDDING_RULE], optim_bits=8)
    assert isinstance(opt, BnbOptimizer) and len(opt.param_groups) == 2
    emb = [p for n, p in twin.named_parameters() if n.startswith("embedding.")]
    rest = [p for n, p in twin.named_parameters() if not n.startswith("embedding.")]
    a, b = TO.adam32bit(emb, 1e-2, weight_decay=0.0), TO.adam8bit(rest, 1e-2, weight_decay=0.0)
    for gr in _grads(model, 3, 1):
        _step([opt], model, gr)
        _step([a, b], twin, gr)
    for (n, p), (_, q) in zip(model.named_parameters(), twin.named_parameters()):
        assert torch.equal(p, q), n
        st, sq = opt.state[p], (a if n.startswith("embedding.") else b).state[q]
        assert st.keys() == sq.keys() and st["step"] == 3
        for k in st:
            if k != "step":
                assert torch.equal(st[k], sq[k]), (n, k)
        want = torch.float32 if n.startswith("embedding.") or p.numel() < 4096 else torch.uint8
        assert st["state1"].dtype == want, n
    assert opt.state[model.proj.weight]["state1"].dtype == torch.uint8


def test_override_optimizer_matches_jax():
    """The same override on the JAX package's transformation: three steps,
    the same tree, within the unpaged contract."""
    torch.manual_seed(1)
    model = _Model()
    named = list(model.named_parameters())
    grads = _grads(model, 3, 2)
    jp = {n: jnp.asarray(p.detach().numpy()) for n, p in named}
    jopt = JO.make_optimizer_with_overrides("adam", 1e-2, rules=[JO.STABLE_EMBEDDING_RULE], optim_bits=8)
    jst = jopt.init(jp)
    opt = TO.make_optimizer_with_overrides("adam", named, 1e-2, rules=[TO.STABLE_EMBEDDING_RULE], optim_bits=8)
    for gr in grads:
        upd, jst = jopt.update({n: jnp.asarray(g) for n, g in gr.items()}, jst, jp)
        jp = {n: jp[n] + upd[n] for n in jp}
        _step([opt], model, gr)
    leaves = {n: lf for masked in jst.inner_states.values() for n, lf in masked.inner_state.leaves.items()
              if isinstance(lf, dict)}  # each parameter's leaf in the transformation of its label
    assert set(leaves) == {n for n, _ in named}
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), atol=1e-6, rtol=0)
        st, jl = opt.state[p], leaves[n]
        assert st["state1"].numpy().dtype == np.dtype(jl["state1"].dtype), n
        if st["state1"].dtype == torch.uint8:
            a, b = st["state1"].numpy().astype(int), np.asarray(jl["state1"]).astype(int)
            assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1, n
            np.testing.assert_allclose(st["absmax1"].numpy(), np.asarray(jl["absmax1"]), rtol=1e-5)
        else:
            np.testing.assert_allclose(st["state1"].numpy(), np.asarray(jl["state1"]), rtol=1e-5, atol=1e-7)


def test_rule_options_and_learning_rate():
    model = _Model()
    rules = [(r"^proj\.weight$", {"learning_rate": 0.5, "weight_decay": 0.1}), (r"^proj\.", {"lr": 0.25})]
    opt = TO.make_optimizer_with_overrides("lion", model, 1e-3, rules=rules, optim_bits=8)
    groups = {tuple(id(p) for p in g["params"]): g for g in opt.param_groups}
    assert groups[(id(model.proj.weight),)]["lr"] == 0.5 and groups[(id(model.proj.weight),)]["weight_decay"] == 0.1
    assert groups[(id(model.proj.bias),)]["lr"] == 0.25
    default = _group_of(opt, model.embedding.weight)
    assert default["lr"] == 1e-3 and default["optim_bits"] == 8
    with pytest.raises(TypeError, match="unknown optimizer options"):
        TO.make_optimizer_with_overrides("adam", model, rules=[("proj", {"momentum": 0.9})])
    with pytest.raises(ValueError, match="optim_bits"):
        TO.make_optimizer_with_overrides("adam", model, rules=[("proj", {"optim_bits": 16})])
    with pytest.raises(TypeError, match="nn.Module"):
        TO.make_optimizer_with_overrides("adam", [model.proj.weight])


@pytest.fixture
def manager():
    mgr = TO.GlobalOptimManager.get_instance()
    mgr.initialize()
    yield mgr
    mgr.initialize()


def test_register_module_override_is_honoured(manager):
    """The reference's call: one module's parameter at 32 bits, the rest of
    an 8-bit optimizer 8-bit; a path rule beside it."""
    assert TO.GlobalOptimManager.get_instance() is manager
    model = _Model()
    manager.register_parameters(model.parameters())
    manager.register_module_override(model.embedding, "weight", {"optim_bits": 32})
    manager.override_config(r"^proj\.bias$", "lr", 0.5)
    opt = manager.build("adam", model, 1e-3, optim_bits=8, min_8bit_size=64)
    for gr in _grads(model, 1, 3):
        _step([opt], model, gr)
    dtypes = {n: opt.state[p]["state1"].dtype for n, p in model.named_parameters()}
    assert dtypes == {"embedding.weight": torch.float32, "embedding.norm.weight": torch.uint8,
                      "embedding.norm.bias": torch.uint8, "proj.weight": torch.uint8, "proj.bias": torch.uint8}
    bias_group = _group_of(opt, model.proj.bias)
    assert bias_group["lr"] == 0.5
    # the identity override wins over a path rule that also matches
    manager.override_config(r"embedding", key_value_dict={"optim_bits": 8, "lr": 0.125})
    opt2 = manager.build("adam", model, 1e-3, optim_bits=8, min_8bit_size=64)
    g = _group_of(opt2, model.embedding.weight)
    assert g["optim_bits"] == 32 and len(g["params"]) == 1
    assert _group_of(opt2, model.embedding.norm.weight)["lr"] == 0.125


@pytest.mark.parametrize("args", [
    (r"embed", {"optim_bits": 32}, None),  # the former alias: a regex and a dict
    ("embedding", "weight", {"optim_bits": 32}),  # a name, not the module
    (None, "weight", {"optim_bits": 32}),
], ids=["regex_alias", "module_name", "none"])
def test_register_module_override_wrong_shape_raises(manager, args):
    with pytest.raises(TypeError):
        manager.register_module_override(*args)


def test_register_module_override_checks_its_parameter(manager):
    model = _Model()
    with pytest.raises(TypeError, match="no tensor"):
        manager.register_module_override(model.embedding, "kernel", {"optim_bits": 32})
    with pytest.raises(TypeError):
        manager.register_module_override(model.embedding, "weight", 32)
    with pytest.raises(TypeError, match="regex"):
        manager.override_config(model.embedding.weight, "optim_bits", 32)
    assert manager.param_overrides == [] and manager.rules == []


def test_compat_names():
    """MockArgs and the Optimizer1State / Optimizer2State / Optimizer8bit /
    PytorchLARS factories, as the JAX package's compat test uses them; each
    builds the rule it names and steps."""
    assert TO.MockArgs({"optim_bits": 8, "lr": 0.1}).optim_bits == 8
    cases = [
        (lambda ps: TO.Optimizer1State("momentum", ps, 1e-3), "momentum", torch.float32),
        (lambda ps: TO.Optimizer2State("adam", ps, 1e-3), "adam", torch.float32),
        (lambda ps: TO.Optimizer2State("adam", ps, 1e-3, optim_bits=8), "adam", torch.uint8),
        (lambda ps: TO.Optimizer8bit("adam", ps), "adam", torch.uint8),
        (lambda ps: TO.PytorchLARS(ps), "lars", torch.float32),
    ]
    for make, name, dtype in cases:
        p = torch.nn.Parameter(torch.ones(128, 128))
        opt = make([p])
        assert isinstance(opt, BnbOptimizer) and opt.name == name
        p.grad = torch.full_like(p, 0.1)
        opt.step()
        assert opt.state[p]["state1"].dtype == dtype and torch.isfinite(p).all() and not torch.equal(p, torch.ones_like(p))
    for name in ("GlobalOptimManager", "make_optimizer_with_overrides", "STABLE_EMBEDDING_RULE", "path_labels",
                 "MockArgs", "Optimizer1State", "Optimizer2State", "Optimizer8bit", "PytorchLARS", "to_host",
                 "make_paged_update", "paged_state_sharding"):
        assert name in TO.__all__ and hasattr(TO, name), name
    assert set(JO.__all__) - set(TO.__all__) <= {"BnbOptimizerState"}
    assert re.search(TO.STABLE_EMBEDDING_RULE[0], "embedding.weight")
