"""The grouped 8-bit optimizer update (kernels 14 and 15 over a table of
tensors) and the optimizer's grouping, on the CPU.

* ``optimizer_update_8bit_multi_`` over ragged leaves (n = 1, 255, 256, 257,
  4099 and a ``[2, 129]`` parameter), f32, bf16 and f16, AdamW, Lion and
  AdEMAMix at steps 1 and 5, with an all-zero block and non-finite
  gradients: every output bit for bit that of the single-tensor entry.
* Over two leaves against the JAX package's fused Pallas kernel in
  interpret mode, leaf by leaf: AdEMAMix (f32, bf16) and AdamW (bf16) bit for
  bit, AdamW in f32 within ``tests/test_torch_optim8bit.py``'s contract.
* ``BnbOptimizer.step`` over a 2-layer LoRA set (adapters 8-bit, the 0-d
  scales 32-bit): ``adamw8bit`` and ``ademamix8bit`` against one optimizer a
  tensor, bit for bit, with a tensor whose gradient is None, one that joins
  at a later step and two param groups of different lr; one grouped call a
  param group and step count.
* ``leaf_blocks``, the table's block layout: each block of the concatenation
  belongs to exactly one non-empty leaf.  There are no chunks: one launch
  takes a whole table.
* ``leaf_table``, the kernel's descriptor rows, on CPU tensors: each row's
  pointers are those of its tensors (AdEMAMix's second momentum and its
  absmax rows too), empty leaves have none, and a tensor whose storage was
  replaced is read and checked again.
* The optimizer follows a state tensor that was replaced.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import blockwise as JB
from bitsandbytes_tpu.functional.codebooks import create_dynamic_map
from bitsandbytes_tpu.ops.pallas.optim8bit import optimizer_update_8bit_pallas
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.optim import base as TB
from bitsandbytes_tpu_torch.ops.optim8bit import (
    RULES,
    StateCodes,
    StateLeaf,
    UpdateScalars,
    leaf_blocks,
    leaf_table,
    optimizer_update_8bit_,
    optimizer_update_8bit_multi_,
)

torch.set_num_threads(1)

Q1 = np.asarray(create_dynamic_map(signed=True), np.float32)
Q2 = np.asarray(create_dynamic_map(signed=False), np.float32)
Z1 = int(np.abs(Q1).argmin())
SHAPES = [(1,), (255,), (256,), (257,), (4099,), (2, 129)]
HYPER = {
    "adam": dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, lr=1e-3),  # AdamW
    "lion": dict(beta1=0.9, beta2=0.99, eps=0.0, weight_decay=1e-2, lr=1e-4),
    "ademamix": dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, lr=1e-3, beta3=0.9999, alpha=5.0),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _scalars(name, step):
    return UpdateScalars.make(name, step=step, **HYPER[name])


def _codes(name):
    return StateCodes(Q1, Q2 if name in ("adam", "ademamix") else None)


def _leaf(name, shape, dtype, rng, zero_block):
    """(g, p, s1, s2, am1, am2) of one parameter: random codes and absmax,
    a NaN and an Inf gradient, and with ``zero_block`` an all-zero second
    block (zero gradients, the codes of 0.0, absmax 0)."""
    n = int(np.prod(shape))
    nb = -(-n // 256)
    lead = (2,) if name == "ademamix" else ()
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)
    g[min(7, n - 1)] = np.nan
    if n > 300:
        g[300] = np.inf
    p = rng.standard_normal(n).astype(np.float32)
    s1 = rng.integers(0, 256, lead + (n,), dtype=np.uint8)
    am1 = (rng.random(lead + (nb,)) * 0.01).astype(np.float32)
    s2 = rng.integers(0, 256, n, dtype=np.uint8)
    am2 = (rng.random(nb) * 1e-4).astype(np.float32)
    if zero_block and n > 512:
        g[256:512] = 0.0
        s1[..., 256:512] = Z1
        am1[..., 1] = 0.0
        s2[256:512] = 0
        am2[1] = 0.0
    t = torch.from_numpy
    two = name in ("adam", "ademamix")
    return (t(g).to(dtype).reshape(shape), t(p).to(dtype).reshape(shape), t(s1).reshape(lead + shape),
            t(s2).reshape(shape) if two else None, t(am1), t(am2) if two else None)


def _clone(leaf):
    return tuple(None if x is None else x.clone() for x in leaf)


def _bits(t) -> np.ndarray:
    return t.reshape(-1).contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("name", list(HYPER))
def test_grouped_entry_matches_per_leaf(name, step, dtype):
    rng = np.random.default_rng(7)
    leaves = [_leaf(name, shape, DTYPES[dtype], rng, zero_block=step == 1) for shape in SHAPES]
    sc, codes = _scalars(name, step), _codes(name)
    grouped = [_clone(lf) for lf in leaves]
    optimizer_update_8bit_multi_(sc, grouped, codes)
    for lf, gl in zip(leaves, grouped):
        ref = _clone(lf)
        optimizer_update_8bit_(sc, *ref, codes)
        for a, b in zip(gl[1:], ref[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(_bits(a), _bits(b))
        assert gl[1].dtype == DTYPES[dtype] and gl[1].shape == lf[1].shape
        # a non-finite gradient keeps its parameter and zeroes its states
        i = min(7, lf[1].numel() - 1)
        assert _bits(gl[1].reshape(-1)[i:i + 1]).tolist() == _bits(lf[1].reshape(-1)[i:i + 1]).tolist()


def test_grouped_entry_rejects_a_mismatched_leaf():
    rng = np.random.default_rng(8)
    g, p, s1, s2, am1, am2 = _leaf("adam", (300,), torch.float32, rng, False)
    ok = _leaf("adam", (300,), torch.float32, rng, False)
    with pytest.raises(ValueError):
        optimizer_update_8bit_multi_(_scalars("adam", 1), [ok, (g[:299], p, s1, s2, am1, am2)], _codes("adam"))
    with pytest.raises(ValueError):  # AdEMAMix's state1 holds both momenta
        optimizer_update_8bit_multi_(_scalars("ademamix", 1), [(g, p, s1, s2, am1, am2)], _codes("ademamix"))


@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("name,dtype", [("ademamix", "f32"), ("ademamix", "bf16"), ("adam", "bf16"),
                                        ("adam", "f32")])
def test_grouped_entry_matches_pallas_interpret(name, dtype, step):
    """Two leaves (2148 and 513 elements) through one grouped call against
    the JAX package's fused kernel on each; states quantized by the JAX
    package from normal moments."""
    rng = np.random.default_rng(20 + step)
    dt = DTYPES[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    leaves, jax_in = [], []
    for n in (2148, 513):
        g = (rng.standard_normal(n) * 0.01).astype(np.float32)
        g[77] = np.nan
        p = rng.standard_normal(n).astype(np.float32)
        m = (rng.standard_normal((2, n) if name == "ademamix" else n) * 0.01).astype(np.float32)
        v = (np.abs(rng.standard_normal(n)) * 1e-4).astype(np.float32)
        q = [JB.quantize_blockwise_with_code(jnp.asarray(x), jnp.asarray(Q1), 256) for x in np.atleast_2d(m)]
        s1 = np.stack([np.array(a) for a, _ in q]).reshape(m.shape)
        am1 = np.stack([np.array(b) for _, b in q]).reshape((2, -1) if name == "ademamix" else -1)
        s2, am2 = (np.array(a) for a in JB.quantize_blockwise_with_code(jnp.asarray(v), jnp.asarray(Q2), 256))
        gj, pj = jnp.asarray(g, jdt), jnp.asarray(p, jdt)
        # the same rounded values on both sides, copied: the port updates its own in place
        gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(dt)
        pt = torch.from_numpy(np.array(pj.astype(jnp.float32))).to(dt)
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        leaves.append((gt, pt, t(s1), t(s2), t(am1), t(am2)))
        jax_in.append((gj, pj, s1, s2, am1, am2))
    optimizer_update_8bit_multi_(_scalars(name, step), leaves, _codes(name))
    h = dict(HYPER[name])
    for port, (gj, pj, s1, s2, am1, am2) in zip(leaves, jax_in):
        j = jnp.asarray
        ref = optimizer_update_8bit_pallas(name, gj, pj, j(s1), j(s2), Q1, Q2, j(am1), j(am2), step=step, **h)
        if name == "adam" and dtype == "f32":  # f32 AdamW: the contract of test_torch_optim8bit.py
            np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[0]), atol=3e-7, rtol=0)
            for a, b in ((port[2], ref[1]), (port[3], ref[2])):
                a, b = a.numpy().astype(int), np.asarray(b).astype(int)
                assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1
            for a, b in ((port[4], ref[3]), (port[5], ref[4])):
                np.testing.assert_allclose(a.numpy().reshape(-1), np.asarray(b).reshape(-1), rtol=1e-6, atol=0)
            continue
        for a, b in zip(port[1:], ref):
            b = np.asarray(b)
            np.testing.assert_array_equal(_bits(a.reshape(b.shape)), b.view(np.uint8).reshape(-1))


def _lora_params(seed):
    cfg = dataclasses.replace(TL.LlamaConfig.tiny(), hidden_size=64, intermediate_size=96, head_dim=16)
    lora = TL.add_lora(cfg, rank=4, targets=("wq", "wk", "wv", "wo", "gate", "up", "down"),
                       generator=torch.Generator().manual_seed(seed), device="cpu")
    return TL.lora_parameters(lora)


def _grads(params, rng):
    return [torch.from_numpy(np.asarray(rng.standard_normal(tuple(p.shape)) * 0.05, dtype=np.float32))
            for p in params]


@pytest.mark.parametrize("min_8bit", [100, 256])
@pytest.mark.parametrize("factory", ["adamw8bit", "ademamix8bit"])
def test_optimizer_groups_match_one_optimizer_a_tensor(factory, min_8bit, monkeypatch):
    """Three steps of a grouped optimizer over a 2-layer LoRA set, in two
    param groups of different lr, against one optimizer per tensor: at
    ``min_8bit_size`` 100 every adapter is 8-bit and the 32-bit tensors are
    the 0-d scales, at 256 the 128-element ones are 32-bit too: one 32-bit
    update a param group and shape.  One 8-bit tensor has no gradient at step
    1 and joins at step 2 (a step count of its own); the last scale never
    has one."""
    kw = dict(min_8bit_size=min_8bit, **({"t_alpha": 4, "t_beta3": 6} if factory == "ademamix8bit" else {}))
    fac = getattr(TO, factory)
    ps, qs = _lora_params(1), _lora_params(1)
    half = len(ps) // 2
    lrs = [1e-2 if i < half else 3e-3 for i in range(len(ps))]
    opt = fac([{"params": ps[:half], "lr": 1e-2}, {"params": ps[half:], "lr": 3e-3}], 1e-2, **kw)
    singles = [fac([q], lr, **kw) for q, lr in zip(qs, lrs)]
    late, never = 3, len(ps) - 1  # layer 0 wk's a (8-bit), the last scale
    calls, flat_calls = [], []
    real, real32 = TB.optimizer_update_leaves_, TB.optimizer_update_32bit
    monkeypatch.setattr(TB, "optimizer_update_leaves_",
                        lambda sc, gs, lvs, codes: (calls.append(len(lvs)), real(sc, gs, lvs, codes))[1])
    monkeypatch.setattr(TB, "optimizer_update_32bit",
                        lambda *a, **k: (flat_calls.append(tuple(a[1].shape)), real32(*a, **k))[1])
    rng = np.random.default_rng(3)
    for step in range(3):
        grads = _grads(ps, rng)
        for i, (p, q, g) in enumerate(zip(ps, qs, grads)):
            has = i != never and not (i == late and step == 0)
            p.grad = g.clone() if has else None
            q.grad = g.clone() if has else None
        calls.clear()
        flat_calls.clear()
        opt.step()
        groups = (range(half), range(half, len(ps)))
        n8 = [sum(1 for i in idx if ps[i].numel() >= min_8bit and ps[i].grad is not None and i != late)
              for idx in groups]
        # one grouped 8-bit call a param group, and from step 2 the late tensor's own (a step behind)
        assert sorted(calls) == sorted(n8 + ([1] if step else [])), (step, calls)
        # one 32-bit call a param group and shape, over the stack of its tensors
        n32 = sorted(tuple(shp) + (sum(1 for i in idx if ps[i].shape == shp and ps[i].grad is not None),)
                     for idx in groups for shp in {ps[i].shape for i in idx
                                                   if ps[i].numel() < min_8bit and ps[i].grad is not None})
        assert sorted(flat_calls) == n32, (step, flat_calls)
        for s in singles:
            s.step()
    assert not opt.state[ps[never]]
    for i, (p, q) in enumerate(zip(ps, qs)):
        np.testing.assert_array_equal(_bits(p.detach()), _bits(q.detach()))
        if i == never:
            continue
        a, b = opt.state[p], singles[i].state[q]
        assert a["step"] == b["step"] == (2 if i == late else 3)
        assert a["state1"].dtype == (torch.uint8 if p.numel() >= min_8bit else torch.float32)
        for key in b:
            if isinstance(b[key], torch.Tensor):
                np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]))


@pytest.mark.parametrize("ns", [[5], [256], [257, 0, 1], [0, 0, 4099, 256, 3], [1] * 7, [0]])
def test_leaf_blocks_cover_every_block_once(ns):
    keep, first, total = leaf_blocks(ns)
    assert keep == [i for i, n in enumerate(ns) if n > 0]
    assert total == sum(-(-n // 256) for n in ns)
    owner = np.full(total, -1)
    for i, f in zip(keep, first):
        nb = -(-ns[i] // 256)
        assert (owner[f:f + nb] == -1).all()
        owner[f:f + nb] = i
    assert (owner >= 0).all()
    assert first == sorted(first)


def _empty_leaf(name):
    lead = (2,) if name == "ademamix" else ()
    two = name in ("adam", "ademamix")
    e = torch.zeros(0)
    return (e, e.clone(), torch.zeros(lead + (0,), dtype=torch.uint8), torch.zeros(0, dtype=torch.uint8) if two else None,
            torch.zeros(lead + (0,)), torch.zeros(0) if two else None)


def _table_leaves(name, shapes):
    rng = np.random.default_rng(11)
    leaves = [_leaf(name, shape, torch.float32, rng, False) if np.prod(shape) else _empty_leaf(name)
              for shape in shapes]
    return [lf[0] for lf in leaves], [StateLeaf(RULES[name], *lf[1:]) for lf in leaves]


@pytest.mark.parametrize("name", ["adam", "lion", "ademamix"])
def test_leaf_table_rows_point_at_their_tensors(name):
    shapes = [(300,), (0,), (2, 129), (1,)]
    grads, leaves = _table_leaves(name, shapes)
    rows, total = leaf_table(_scalars(name, 1), grads, leaves)
    keep = [i for i, shp in enumerate(shapes) if np.prod(shp) > 0]
    assert rows.dtype == np.int64 and rows.shape == (len(keep), 10)
    assert total == sum(-(-int(np.prod(shp)) // 256) for shp in shapes)
    first = 0
    for row, i in zip(rows, keep):
        g, lf = grads[i], leaves[i]
        n = lf.p.numel()
        if name == "ademamix":  # the momenta are the rows of state1 and absmax1
            states = (lf.s1[0], lf.s1[1], lf.s2)
            absmax = (lf.am1[0], lf.am1[1], lf.am2)
        else:
            states = (lf.s1, lf.s2, None)
            absmax = (lf.am1, lf.am2, None)
        want = [g.data_ptr(), lf.p.data_ptr()] + [0 if t is None else t.data_ptr() for t in states + absmax]
        assert row.tolist() == want + [n, first]
        first += -(-n // 256)


def test_leaf_table_reads_a_moved_tensor_again():
    grads, leaves = _table_leaves("adam", [(300,), (513,)])
    sc = _scalars("adam", 1)
    p = leaves[1].p
    p.data = p.data.clone()  # the same values in new storage
    rows, _ = leaf_table(sc, grads, leaves)
    assert rows[1, 1] == p.data_ptr()
    p.data = torch.zeros(512)  # a size the states do not fit: checked again, refused
    with pytest.raises(ValueError):
        leaf_table(sc, grads, leaves)
    with pytest.raises(ValueError):  # a gradient of another size
        leaf_table(sc, [grads[0][:299], grads[1]], leaves[:1] + leaves[:1])


@pytest.mark.parametrize("key", ["state1", "state2", "absmax1", "absmax2"])
@pytest.mark.parametrize("factory", ["adamw8bit", "ademamix8bit"])
def test_optimizer_follows_a_replaced_state_tensor(factory, key):
    """A state tensor replaced between steps (as ``load_state_dict`` does)
    is the one the next step updates: the same bits as an optimizer whose
    tensor was never replaced."""
    fac = getattr(TO, factory)
    rng = np.random.default_rng(5)
    ps, qs = _lora_params(2), _lora_params(2)
    opt, ref = fac(ps, 1e-2, min_8bit_size=100), fac(qs, 1e-2, min_8bit_size=100)
    big = [i for i, p in enumerate(ps) if p.numel() >= 100]
    for step in range(2):
        for p, q, g in zip(ps, qs, _grads(ps, rng)):
            p.grad, q.grad = g.clone(), g.clone()
        if step:
            for i in big:
                opt.state[ps[i]][key] = opt.state[ps[i]][key].clone()
        opt.step()
        ref.step()
    for i in big:
        for k in ("state1", "state2", "absmax1", "absmax2"):
            np.testing.assert_array_equal(_bits(opt.state[ps[i]][k]), _bits(ref.state[qs[i]][k]))
        np.testing.assert_array_equal(_bits(ps[i].detach()), _bits(qs[i].detach()))
