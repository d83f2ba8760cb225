"""Training over a mesh in the port against the JAX package, on the CPU:
ring attention, the GPipe schedule and a QLoRA step over data, seq and
model axes.

The ranks run over gloo with a ``FileStore``, 2 and 4 of them, each world
size spawned once by a fixture; its ranks run every check of
``_rank_main`` and write their results, and the tests read them.  A world
has a time limit of its own (``WORLD_LIMIT_S``): a backward exchange that
one rank never runs would leave its neighbour waiting, and the fixture then
kills the ranks and fails instead of holding the suite's clock.  The ranks
import neither JAX nor the JAX package; the JAX side runs here, in the test
functions, on the conftest's CPU devices."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bitsandbytes_tpu_torch import autograd as TA
from bitsandbytes_tpu_torch import optim as TO
from bitsandbytes_tpu_torch import parallel as TP
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.interop import lora_from_numpy, params_from_numpy
from torch_ranks import spawn_world

torch.set_num_threads(1)

WORLD_LIMIT_S = 120
RING = dict(B=2, T=32, H=4, d=64)  # tests/test_parallel.py's ring attention case
QLORA_MESHES = {2: ({"data": 2}, {"seq": 2}, {"model": 2}), 4: ({"data": 2, "model": 2}, {"seq": 2, "model": 2})}
TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
IDS_SHAPE = (4, 17)  # B 4 over data, T 16 over seq
GPIPE_D = 512


def _mesh_id(axes):
    return "_".join(f"{a}{s}" for a, s in axes.items())


def _np_tree(tree):
    """A JAX tree -> nested dicts/lists of numpy (``params_from_numpy``'s input)."""
    import jax.numpy as jnp
    from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT

    if isinstance(tree, JQT):
        st = tree.state
        d = {"data": np.asarray(tree.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
             "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout,
             "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name}
        if st.nested:
            d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                     nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
        return d
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _t(a) -> torch.Tensor:
    """A JAX array (f32 or bf16) as a CPU tensor of the same type."""
    import jax.numpy as jnp

    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _gelu_layer(p, a):
    """The JAX gpipe tests' layer: residual gelu of a 4-bit matmul."""
    h = TA.matmul_4bit(a, p["w"].data, p["w"].state)
    return (a + torch.nn.functional.gelu(h.to(torch.float32), approximate="tanh")).to(a.dtype)


def _tanh_layer(p, a):
    return torch.tanh(a @ p["w"])


# -- the JAX side ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    """Every input of the ranks, made by the JAX package from its keys, and
    what the JAX package computes on them."""
    import jax
    import jax.numpy as jnp
    from bitsandbytes_tpu import parallel as JP
    from bitsandbytes_tpu.models import llama as JL
    from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
    from bitsandbytes_tpu.ops import dispatch

    out = {}
    # ring attention: q, k, v as tests/test_parallel.py draws them, a cotangent w
    B, T, H, d = RING["B"], RING["T"], RING["H"], RING["d"]
    key = jax.random.PRNGKey(0)
    q, k, v = (jax.random.normal(jax.random.fold_in(key, i), (B, T, H, d), jnp.float32) for i in range(3))
    w = jax.random.normal(jax.random.PRNGKey(7), (B, T, H, d), jnp.float32)
    out["ring"] = {"qkv": [_t(a) for a in (q, k, v)], "w": _t(w)}
    seq4 = JP.make_mesh({"seq": 4})
    for causal in (True, False):
        f = lambda q, k, v: JP.ring_attention(q, k, v, seq4, axis="seq", causal=causal)  # noqa: E731
        o = f(q, k, v)
        grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w), argnums=(0, 1, 2))(q, k, v)
        out["ring"][f"jax_{causal}"] = [np.asarray(o)] + [np.asarray(g) for g in grads]

    # gpipe, 4 stages: 8 NF4 layers, bf16 x [8, D] (test_gpipe_matches_sequential), at D 512 under the
    # JAX package's "pallas" tier: at its D 256 the JAX package's kernels do not tile and it dequantizes
    # with the exact f32 codes, where its kernels and the port's round them to bf16 (test_torch_qlora.py),
    # and through 8 residual layers that difference alone grows past the 0.05 tolerance
    D = GPIPE_D
    layers = [{"w": JQT.quantize(jax.random.normal(jax.random.fold_in(key, i), (D, D), jnp.float32) * D**-0.5,
                                 blocksize=64)} for i in range(8)]

    def jlayer(p, a):
        from bitsandbytes_tpu import autograd as JA

        h = JA.matmul_4bit(a, p["w"].data, p["w"].state)
        return (a + jax.nn.gelu(h.astype(jnp.float32))).astype(a.dtype)

    x = jax.random.normal(jax.random.PRNGKey(1), (8, D), jnp.float32).astype(jnp.bfloat16)
    stacked = JP.stack_stage_params(layers, 4)
    dispatch.set_backend("pallas")
    try:
        jout = JP.gpipe(jlayer, stacked, x, JP.make_mesh({"pipe": 4}), axis="pipe")
    finally:
        dispatch.set_backend("auto")
    out["gpipe_nf4"] = {"layers": params_from_numpy(_np_tree(layers), "cpu"), "x": _t(x),
                        "jax_out": np.asarray(jout.astype(jnp.float32)), "jax_stacked": stacked}

    # gpipe, 2 stages: 4 float layers of D 64, tanh, the gradient of sum(out ** 2) (test_gpipe_differentiable)
    flayers = [{"w": jax.random.normal(jax.random.PRNGKey(i), (64, 64), jnp.float32) * 0.05} for i in range(4)]
    fstacked = JP.stack_stage_params(flayers, 2)
    fx = jax.random.normal(jax.random.PRNGKey(9), (4, 64), jnp.float32)
    pipe2 = JP.make_mesh({"pipe": 2})
    g = jax.grad(lambda s, x: jnp.sum(JP.gpipe(lambda p, a: jnp.tanh(a @ p["w"]), s, x, pipe2, axis="pipe") ** 2),
                 argnums=(0, 1))(fstacked, fx)
    out["gpipe_float"] = {"layers": [{"w": _t(l["w"])} for l in flayers], "x": _t(fx),
                          "jax_grad_w": np.asarray(g[0]["w"]), "jax_grad_x": np.asarray(g[1])}

    # the QLoRA step: the tiny Llama, unfused NF4, rank-4 adapters on all seven
    # targets with b drawn small (every adapter tensor gets a gradient); the
    # loss on the bf16 model, the gradients on the f32 one, as test_torch_qlora.py
    jcfg = JL.LlamaConfig.tiny()
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    jlora = JL.add_lora(jax.random.PRNGKey(3), jcfg, rank=4, targets=TARGETS)
    rng = np.random.default_rng(0)
    for layer in jlora["layers"]:
        for ad in layer.values():
            ad["b"] = jnp.asarray((rng.standard_normal(ad["b"].shape) * 0.02).astype(np.float32))
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, IDS_SHAPE)
    dispatch.set_backend("pallas")
    try:
        q16 = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg))
        q32 = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg32))
        loss16 = float(jax.jit(lambda lo, i: JL.lm_loss(q16, lo, i, jcfg))(jlora, jnp.asarray(ids)))
        loss32, grads = jax.jit(jax.value_and_grad(lambda lo, i: JL.lm_loss(q32, lo, i, jcfg32)))(jlora,
                                                                                                  jnp.asarray(ids))
    finally:
        dispatch.set_backend("auto")
    out["qlora"] = {"params16": params_from_numpy(_np_tree(q16), "cpu"),
                    "params32": params_from_numpy(_np_tree(q32), "cpu"),
                    "lora": _np_tree(jlora), "ids": torch.from_numpy(ids), "cfg": TL.LlamaConfig.tiny(),
                    "jax_loss16": loss16, "jax_loss32": float(loss32), "jax_grads": _np_tree(grads)}
    return out


# -- the ranks --------------------------------------------------------------------


def _lora_grads(lora) -> list:
    return [t.grad.clone() for t in TL.lora_parameters(lora)]


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every check of this world size, written to ``out{rank}.pt``."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {}
        # ring attention over every rank
        mesh = TP.make_mesh({"seq": world})
        Tl = RING["T"] // world
        sl = slice(rank * Tl, (rank + 1) * Tl)
        for causal in (True, False):
            q, k, v = (t[:, sl].clone().requires_grad_() for t in inp["ring"]["qkv"])
            o = TP.ring_attention(q, k, v, mesh, axis="seq", causal=causal)
            (o * inp["ring"]["w"][:, sl]).sum().backward()
            out[f"ring_{causal}"] = [o.detach(), q.grad, k.grad, v.grad]

        # gpipe over every rank
        pmesh = TP.make_mesh({"pipe": world})
        if world == 4:
            case = inp["gpipe_nf4"]
            x = case["x"].clone().requires_grad_()
            y = TP.gpipe(_gelu_layer, TP.stack_stage_params(case["layers"], 4), x, pmesh)
            y.float().pow(2).sum().backward()
            out["gpipe_nf4"] = [y.detach(), x.grad]
        else:
            case = inp["gpipe_float"]
            stacked = TP.stack_stage_params(case["layers"], 2)
            stacked["w"].requires_grad_()
            x = case["x"].clone().requires_grad_()
            TP.gpipe(_tanh_layer, stacked, x, pmesh).pow(2).sum().backward()
            out["gpipe_float"] = [stacked["w"].grad, x.grad]

        # the QLoRA step over each mesh of this world size
        qc = inp["qlora"]
        cfg = qc["cfg"]
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        for axes in QLORA_MESHES[world]:
            mesh = TP.make_mesh(axes)

            def tree(params):
                return TP.llama_param_specs(mesh, params) if "model" in axes else params

            res = {}
            lora = lora_from_numpy(qc["lora"], "cpu")
            with torch.no_grad():
                res["loss16"] = TL.lm_loss(tree(qc["params16"]), lora, qc["ids"], cfg, mesh=mesh)
            p32 = tree(qc["params32"])
            for chunk in (None, 8):
                lora = lora_from_numpy(qc["lora"], "cpu")
                loss = TL.lm_loss(p32, lora, qc["ids"], cfg32, token_chunk=chunk, mesh=mesh)
                loss.backward()
                res[f"loss32_{chunk}"] = loss.detach()
                res[f"grads_{chunk}"] = _lora_grads(lora)  # this rank's share before the sum
            lora = lora_from_numpy(qc["lora"], "cpu")
            opt = TO.adamw8bit(TL.lora_parameters(lora), 1e-3, min_8bit_size=1024)
            res["step_loss"] = TL.lora_train_step(p32, lora, opt, qc["ids"], cfg32, token_chunk=8, mesh=mesh)
            res["summed_grads"] = _lora_grads(lora)
            res["adapters"] = [t.detach().clone() for t in TL.lora_parameters(lora)]
            res["states"] = [{k: v.clone() for k, v in opt.state[t].items() if isinstance(v, torch.Tensor)}
                             for t in TL.lora_parameters(lora)]
            if "seq" in axes:
                try:
                    TL.lm_loss(p32, lora, qc["ids"][:, :-1], cfg32, mesh=mesh)
                except ValueError as e:
                    res["seq_error"] = str(e)
            out[_mesh_id(axes)] = res
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, cases, tmp_path_factory):
    """Spawn ``world`` gloo ranks once; returns (world, outputs by rank)."""
    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"train{world}"))
    inp = {k: {kk: vv for kk, vv in v.items() if not kk.startswith("jax")} for k, v in cases.items()}
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    spawn_world(_rank_main, world, tmp, WORLD_LIMIT_S)
    return world, [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(world)]


# -- the checks -------------------------------------------------------------------


def _ring_full(outs, causal):
    """The ranks' shards of (out, dq, dk, dv) put together along T."""
    return [torch.cat([o[f"ring_{causal}"][i] for o in outs], dim=1).numpy() for i in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax_and_plain(ranks, cases, causal):
    """Ring attention's output (rtol/atol 2e-5) and the gradients of
    ``sum(out * w)`` (rtol 1e-4, atol 1e-5): at 4 ranks against the JAX
    package's ``ring_attention`` and ``jax.grad`` on a 4-way sequence mesh,
    at 2 ranks against the port's dense attention oracle and autograd.  The
    causal case's first rank sees every later block fully masked: its
    gradients stay finite."""
    world, outs = ranks
    got = _ring_full(outs, causal)
    if world == 4:
        ref = cases["ring"][f"jax_{causal}"]
    else:
        B, T, H, d = RING["B"], RING["T"], RING["H"], RING["d"]
        q, k, v = (t.clone().requires_grad_() for t in cases["ring"]["qkv"])
        cfg = TL.LlamaConfig(num_heads=H, num_kv_heads=H, head_dim=d)
        pos = torch.arange(T)[None].expand(B, T) if causal else torch.full((B, T), T - 1)
        o = TL._attention(q, k, v, pos, torch.ones(B, T, dtype=torch.bool), cfg).reshape(B, T, H, d)
        (o * cases["ring"]["w"]).sum().backward()
        ref = [o.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()]
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5, atol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_gpipe_matches_jax_and_sequential(ranks, cases):
    """GPipe's output on every rank: at 4 stages of 8 NF4 layers against the
    JAX package's ``gpipe`` (atol/rtol 0.05, its own test's) and, with the
    gradient of ``x``, bit for bit the port's layers applied in sequence
    (microbatches of 2 rows against one of 8 rows); at 2 stages of 4 float
    layers, the gradients of ``sum(out ** 2)`` against ``jax.grad`` (rtol
    1e-3, atol 1e-4)."""
    world, outs = ranks
    if world == 4:
        case = cases["gpipe_nf4"]
        x = case["x"].clone().requires_grad_()
        ref = x
        for p in case["layers"]:
            ref = _gelu_layer(p, ref)
        ref.float().pow(2).sum().backward()
        for o in outs:
            y, gx = o["gpipe_nf4"]
            np.testing.assert_allclose(y.float().numpy(), case["jax_out"], atol=0.05, rtol=0.05)
            assert torch.equal(y, ref.detach()) and torch.equal(gx, x.grad)
    else:
        case = cases["gpipe_float"]
        for o in outs:
            gw, gx = o["gpipe_float"]
            np.testing.assert_allclose(gw.numpy(), case["jax_grad_w"], rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(gx.numpy(), case["jax_grad_x"], rtol=1e-3, atol=1e-4)


def test_stack_stage_params_matches_jax(cases):
    """Every leaf of the stacked NF4 layers (payload, absmax, codebook) equals
    the JAX package's, ``[4, 2, ...]``; the static fields are the layers'."""
    import jax

    st = TP.stack_stage_params(cases["gpipe_nf4"]["layers"], 4)
    jst = cases["gpipe_nf4"]["jax_stacked"]["w"]
    assert tuple(st["w"].state.shape) == (GPIPE_D, GPIPE_D) and st["w"].state.layout == jst.state.layout
    for name, t, j in (("data", st["w"].data, jst.data), ("absmax", st["w"].state.absmax, jst.state.absmax),
                       ("code", st["w"].state.code, jst.state.code)):
        assert tuple(t.shape) == tuple(j.shape) and t.shape[:2] == (4, 2), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(jax.device_get(j)), err_msg=name)
    with pytest.raises(ValueError, match="do not split"):
        TP.stack_stage_params(cases["gpipe_nf4"]["layers"], 3)


def _jax_grads(cases) -> list:
    g = cases["qlora"]["jax_grads"]  # a JAX tree: its dicts come back in sorted key order
    return [np.asarray(layer[n][k]) for layer in g["layers"] for n in TARGETS for k in ("a", "b", "scale")]


def _meshless(cases):
    """The port's meshless loss (bf16 model) and gradients (f32 model)."""
    qc = cases["qlora"]
    if "meshless" not in qc:
        cfg32 = dataclasses.replace(qc["cfg"], dtype=torch.float32)
        with torch.no_grad():
            loss16 = TL.lm_loss(qc["params16"], lora_from_numpy(qc["lora"], "cpu"), qc["ids"], qc["cfg"])
        lora = lora_from_numpy(qc["lora"], "cpu")
        loss32 = TL.lm_loss(qc["params32"], lora, qc["ids"], cfg32)
        loss32.backward()
        qc["meshless"] = (loss16.item(), loss32.item(), [t.grad.numpy() for t in TL.lora_parameters(lora)])
    return qc["meshless"]


def test_meshed_qlora_matches_jax_and_meshless(ranks, cases):
    """On every mesh, every rank's loss is the same bits and within rel 1e-3
    of the JAX package's unsharded ``lm_loss`` and of the port's meshless
    one (bf16 model; f32 too); the adapter gradients summed over data and
    seq (chunked and not) within rtol 2e-2 / atol 2e-3 of ``jax.grad`` and
    of the meshless port's (f32 model): test_torch_qlora.py's tolerances."""
    world, outs = ranks
    qc = cases["qlora"]
    ml16, ml32, mgrads = _meshless(cases)
    jgrads = _jax_grads(cases)
    for axes in QLORA_MESHES[world]:
        mid = _mesh_id(axes)
        for key in ("loss16", "loss32_None", "loss32_8"):
            for o in outs[1:]:
                assert torch.equal(o[mid][key], outs[0][mid][key]), (mid, key)
        loss16 = float(outs[0][mid]["loss16"])
        for ref in (qc["jax_loss16"], ml16):
            assert abs(loss16 - ref) <= 1e-3 * abs(ref), (mid, loss16, ref)
        for key in ("loss32_None", "loss32_8"):
            loss32 = float(outs[0][mid][key])
            for ref in (qc["jax_loss32"], ml32):
                assert abs(loss32 - ref) <= 1e-3 * abs(ref), (mid, key, loss32, ref)
        # each rank's share before the sum: the same over "model" (every rank of
        # a model line computes the whole of its tokens' gradient), and the
        # shares of one model coordinate add up to the gradient
        coords = [TP.make_mesh(axes, coord=r).coord for r in range(world)]
        model0 = {tuple(v for a, v in c.items() if a != "model"): r for r, c in enumerate(coords)
                  if c.get("model", 0) == 0}
        for chunk in (None, 8):
            key = f"grads_{chunk}"
            for r, c in enumerate(coords):
                partner = outs[model0[tuple(v for a, v in c.items() if a != "model")]][mid][key]
                assert all(torch.equal(a, b) for a, b in zip(outs[r][mid][key], partner)), (mid, r)
            shares = [outs[r][mid][key] for r in model0.values()]
            for i, (j, m) in enumerate(zip(jgrads, mgrads)):
                total = sum(g[i] for g in shares).numpy()
                np.testing.assert_allclose(total, j, rtol=2e-2, atol=2e-3, err_msg=f"{mid} {key} leaf {i}")
                np.testing.assert_allclose(total, m, rtol=2e-2, atol=2e-3, err_msg=f"{mid} {key} leaf {i}")


def test_meshed_qlora_step_keeps_replicas_equal(ranks, cases):
    """After one ``adamw8bit`` step over each mesh, the summed gradients,
    the adapters and every 8-bit state are the same bits on every rank; the
    summed gradients match ``jax.grad`` (rtol 2e-2 / atol 2e-3).  T % seq
    raises a ``ValueError`` that names the axis."""
    world, outs = ranks
    jgrads = _jax_grads(cases)
    for axes in QLORA_MESHES[world]:
        mid = _mesh_id(axes)
        first = outs[0][mid]
        assert any(st.get("state1") is not None and st["state1"].dtype == torch.uint8 for st in first["states"])
        for o in outs[1:]:
            res = o[mid]
            assert torch.equal(res["step_loss"], first["step_loss"]), mid
            for a, b in zip(res["summed_grads"], first["summed_grads"]):
                assert torch.equal(a, b), mid
            for a, b in zip(res["adapters"], first["adapters"]):
                assert torch.equal(a, b), mid
            for sa, sb in zip(res["states"], first["states"]):
                assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), mid
        for i, (t, j) in enumerate(zip(first["summed_grads"], jgrads)):
            np.testing.assert_allclose(t.numpy(), j, rtol=2e-2, atol=2e-3, err_msg=f"{mid} leaf {i}")
        if "seq" in axes:
            assert "'seq' axis" in first["seq_error"], first.get("seq_error")
