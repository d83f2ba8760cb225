"""The port's sharding, packed collectives and sharded serving against the
JAX package's, on the CPU.

Specs and shards run in one process on virtual meshes (a coordinate, no
process groups): every leaf's spec and every rank's local tensors against
what the JAX package's ``llama_param_specs`` / ``kv_cache_specs`` give on
a ``{"data": 2, "model": 2}`` mesh of 4 of its 8 virtual devices.  The
collectives run in 2 and 4 ranks spawned over gloo with a ``FileStore``:
each world size spawns once, its ranks run every check of
``_rank_main`` and write their results, and the tests read them.  The
ranks import neither JAX nor the JAX package; the JAX side runs here, in
the test functions."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bitsandbytes_tpu_torch import parallel as TP
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.models import moe as TM
from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
from bitsandbytes_tpu_torch.serving import ContinuousBatchingEngine
from bitsandbytes_tpu_torch.utils.interop import kv_cache_from_numpy, moe_params_from_numpy, params_from_numpy
from torch_ranks import spawn_world

torch.set_num_threads(1)

AXES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}
WORLD_LIMIT_S = 240  # a world takes a few seconds
PROMPTS = [[1, 2, 3, 4], [5, 6], [7, 8, 9], [10, 11, 12, 13, 14]]


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


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.fixture(scope="module")
def trees():
    """The tiny Llama from the JAX package, quantized there (fused, unfused,
    nested), carried across."""
    import jax
    from bitsandbytes_tpu.models import llama as JL

    jcfg = JL.LlamaConfig.tiny()
    jparams = JL.init_params(jax.random.PRNGKey(0), jcfg)
    jtrees = {
        "unfused": JL.quantize_params_4bit(jparams),
        "fused": JL.quantize_params_4bit(jparams, fuse=True),
        "nested": JL.quantize_params_4bit(jparams, compress_statistics=True),
        "lm_head": JL.quantize_params_4bit(jparams, quantize_lm_head=True),
    }
    ttrees = {k: params_from_numpy(_np_tree(v), "cpu") for k, v in jtrees.items()}
    return jcfg, TL.LlamaConfig.tiny(), jtrees, ttrees


# -- specs and shards, one process ----------------------------------------------


def _norm(spec):
    """A spec as a tuple without trailing Nones (``P(x, None) == P(x)``)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _jax_leaves(jleaf):
    """(name, array or spec) pieces of a JAX leaf, in the port's field order."""
    from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT

    if isinstance(jleaf, JQT):
        st = jleaf.state
        out = [("data", jleaf.data), ("absmax", st.absmax), ("code", st.code)]
        if st.offset is not None:
            out.append(("offset", st.offset))
        if st.state2 is not None:
            out += [("state2.absmax", st.state2.absmax), ("state2.code", st.state2.code)]
        return out
    return [("tensor", jleaf)]


def _port_leaves(tleaf):
    if isinstance(tleaf, QuantizedTensor):
        st = tleaf.state
        out = [("data", tleaf.data), ("absmax", st.absmax), ("code", st.code)]
        if st.offset is not None:
            out.append(("offset", st.offset))
        if st.state2 is not None:
            out += [("state2.absmax", st.state2.absmax), ("state2.code", st.state2.code)]
        return out
    return [("tensor", tleaf)]


def _walk(jtree, ttree, path=()):
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _walk(jtree[k], ttree[k], path + (k,))
    elif isinstance(ttree, list):
        for i, (j, t) in enumerate(zip(jtree, ttree)):
            yield from _walk(j, t, path + (i,))
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("kind", ["unfused", "fused", "nested", "lm_head"])
def test_param_specs_and_local_shards_match_jax(trees, kind):
    """Every leaf's spec equals the JAX package's on a data 2 x model 2
    mesh, and every rank's local pieces are its addressable shards, bit for
    bit.  The fused wqkv / gate_up replicate (their names are not in the
    rules), as there."""
    import jax
    from bitsandbytes_tpu import parallel as JP

    _, _, jtrees, ttrees = trees
    jmesh = JP.make_mesh({"data": 2, "model": 2})
    jsharded = JP.llama_param_specs(jmesh, jtrees[kind])
    devices = list(jmesh.devices.reshape(-1))
    rules = TP.llama_tp_rules()
    for rank in range(4):
        tmesh = TP.make_mesh({"data": 2, "model": 2}, coord=rank)
        local = TP.llama_param_specs(tmesh, ttrees[kind])
        for path, jleaf, tleaf in _walk(jtrees[kind], ttrees[kind]):
            jspec = JP.leaf_sharding(jleaf, jax.sharding.PartitionSpec(*rules(path, tleaf)), jmesh)
            tspec = TP.leaf_sharding(tleaf, rules(path, tleaf), tmesh)
            for (name, js), (_, ts) in zip(_jax_leaves(jspec), _port_leaves(tspec)):
                assert _norm(js) == _norm(ts), (kind, path, name, js, ts)
            node = local
            jnode = jsharded
            for p in path:
                node, jnode = node[p], jnode[p]
            tl = node.local if isinstance(node, TP.Sharded) else node
            for (name, ja), (_, ta) in zip(_jax_leaves(jnode), _port_leaves(tl)):
                shard = next(s for s in ja.addressable_shards if s.device == devices[rank])
                np.testing.assert_array_equal(_bits(ta), np.asarray(shard.data).view(_bits(ta).dtype),
                                              err_msg=f"{kind} {path} {name} rank {rank}")
    if kind == "fused":
        assert not isinstance(local["layers"][0]["wqkv"], TP.Sharded)
        assert not isinstance(local["layers"][0]["gate_up"], TP.Sharded)
        assert isinstance(local["layers"][0]["wo"], TP.Sharded)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kv_cache_specs_and_shards_match_jax(trees, kv_dtype, layout):
    import jax.numpy as jnp
    from bitsandbytes_tpu import parallel as JP
    from bitsandbytes_tpu.models import llama as JL

    jcfg = trees[0]
    if layout == "paged":
        jc = JL.init_paged_kv_cache(jcfg, 2, 64, 8, 16, kv_dtype)
    else:
        jc = JL.init_kv_cache(jcfg, 2, 32, kv_dtype=kv_dtype)
    rng = np.random.default_rng(0)
    jc = type(jc)(*(None if a is None else jnp.asarray(rng.integers(0, 7, a.shape).astype(np.asarray(a).dtype))
                    for a in jc))
    tc = kv_cache_from_numpy({k: None if a is None else np.asarray(a) for k, a in jc._asdict().items()}, "cpu")
    for axes in ({"data": 2, "model": 2}, {"data": 2, "model": 4}):
        jmesh = JP.make_mesh(axes)
        jspecs = JP.kv_cache_specs(jc, mesh=jmesh)
        tspecs = TP.kv_cache_specs(tc, mesh=TP.make_mesh(axes, coord=0))
        for js, ts in zip(jspecs, tspecs):
            assert (js is None) == (ts is None) and (js is None or _norm(js) == _norm(ts)), (axes, js, ts)
        if axes["model"] != 2:
            continue
        jsh = JP.shard_kv_cache(jc, jmesh)
        devices = list(jmesh.devices.reshape(-1))
        for rank in range(4):
            local = TP.shard_kv_cache(tc, TP.make_mesh(axes, coord=rank))
            for ja, ta in zip(jsh, local):
                if ja is None:
                    continue
                shard = next(s for s in ja.addressable_shards if s.device == devices[rank])
                np.testing.assert_array_equal(ta.float().numpy(), np.asarray(shard.data, np.float32))


def test_non_divisible_kshard_and_blocks_must_divide():
    """The JAX package's rule cases: 6 rows do not split over 4; K-sharding
    a paired weight in whole blocks; K-shards that would cut a block
    replicate; K-sharding a flat weight raises."""
    mesh = TP.make_mesh({"data": 2, "model": 4}, coord=0)
    g = torch.Generator().manual_seed(0)
    qt = QuantizedTensor.quantize(torch.randn(6, 64, generator=g), blocksize=32)
    assert TP.leaf_sharding(qt, ("model", None), mesh).data[0] is None
    qt = QuantizedTensor.quantize(torch.randn(64, 512, generator=g), blocksize=64, layout="paired")
    specs = TP.leaf_sharding(qt, (None, "model"), mesh)
    assert specs.data == (None, "model") and specs.state.absmax == ("model", None)
    qt = QuantizedTensor.quantize(torch.randn(64, 256, generator=g), blocksize=128, layout="paired")
    assert TP.leaf_sharding(qt, (None, "model"), mesh).data == (None, None)
    qt = QuantizedTensor.quantize(torch.randn(64, 256, generator=g), blocksize=64, layout="flat")
    with pytest.raises(NotImplementedError, match="paired"):
        TP.leaf_sharding(qt, (None, "model"), mesh)
    with pytest.raises(RuntimeError, match="virtual"):
        mesh.all_gather(torch.ones(2), "model")


def test_kshard_local_pieces_compute_the_unsharded_product():
    """A K-split paired weight's compute leaves, summed in f32 over the
    virtual ranks, give the unsharded product within f32 reassociation; a
    nested N-split shard's compute leaf is its own nested state (kernels 5
    and 6 decode it in place) with the resolved absmax's values."""
    g = torch.Generator().manual_seed(1)
    W = torch.randn(64, 512, generator=g)
    A = torch.randn(4, 512, generator=g)
    qt = QuantizedTensor.quantize(W, blocksize=64, layout="paired")
    ref = torch.matmul(A, qt.dequantize().t())
    parts = []
    for rank in range(4):
        sh = TP.shard_quantized_tree({"w": qt}, TP.make_mesh({"model": 4}, coord=rank), lambda p, l: (None, "model"))
        k0 = rank * 128
        parts.append(torch.matmul(A[:, k0 : k0 + 128], sh["w"].compute.dequantize().t()))
    torch.testing.assert_close(sum(parts), ref, atol=1e-4, rtol=1e-5)
    nq = QuantizedTensor.quantize(torch.randn(512, 256, generator=g), blocksize=64, compress_statistics=True)
    for rank in range(4):
        sh = TP.shard_quantized_tree({"w": nq}, TP.make_mesh({"model": 4}, coord=rank), lambda p, l: ("model", None))
        c = sh["w"].compute
        assert c.state.inline_nested and tuple(c.state.shape) == (128, 256)
        full = nq.state.dequant_absmax_t()[:, rank * 128 : (rank + 1) * 128]
        assert torch.equal(c.state.dequant_absmax_t(), full)
        assert torch.equal(c.dequantize(), nq.dequantize()[rank * 128 : (rank + 1) * 128])


# -- the ranks --------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every sharded check, written to ``out{rank}.pt``."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        cfg, trees = inp["cfg"], inp["trees"]
        mesh = TP.make_mesh(AXES[world])
        out = {"coord": mesh.coord}
        with torch.no_grad():
            for name in ("unfused", "nested"):
                sh = TP.llama_param_specs(mesh, trees[name])["layers"][0]["wq"]
                w = sh.local
                out[f"allgather_{name}"] = TP.tp_gemm_4bit_allgather(inp["A"], w.data, w.state, mesh)
                out[f"ring_{name}"] = TP.tp_gemm_4bit_ring(inp["A"], w.data, w.state, mesh)
            for name, qt in inp["kadjacent"].items():
                w = TP.shard_quantized_tree({"w": qt}, mesh, lambda p, l: ("model", None))["w"].local
                out[f"allgather_{name}"] = TP.tp_gemm_4bit_allgather(inp["A"], w.data, w.state, mesh)
            for name, tree in trees.items():
                out[f"forward_{name}"] = TL.forward(TP.llama_param_specs(mesh, tree), inp["ids"], cfg, mesh=mesh)[0]
            sparams = TP.llama_param_specs(mesh, trees["unfused"])
            for kv, cache in inp["caches"].items():
                local = TP.shard_kv_cache(cache, mesh)
                out[f"decode_{kv}"] = TL.decode_step(sparams, inp["tok"], cfg, local, 16, mesh=mesh)[0]
            for kv, layout in (("bf16", "dense"), ("int8", "paged")):
                eng = ContinuousBatchingEngine(trees["unfused"], cfg, max_batch=4, max_len=64, steps_per_sync=2,
                                               kv_dtype=kv, kv_layout=layout, kv_block_size=16, mesh=mesh,
                                               device="cpu")
                out[f"engine_{kv}_{layout}"] = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=6)]
            eng = ContinuousBatchingEngine(trees["unfused"], cfg, max_batch=4, max_len=64, steps_per_sync=2,
                                           mesh=mesh, seed=3, device="cpu")
            out["engine_sampled"] = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=6, temperature=1.0,
                                                                    top_p=0.9)]
            emesh = TP.make_mesh({"expert": world})
            moe_params, moe_meta = inp["moe"]
            out["moe_ep"] = TM.moe_ffn_expert_parallel(moe_params, moe_meta, inp["moe_x"], emesh, top_k=2)
            e = moe_params["router"].shape[0] // world
            mine = {k: (v if k == "router" else v[rank * e : (rank + 1) * e].clone()) for k, v in moe_params.items()}
            out["moe_ep_local"] = TM.moe_ffn_expert_parallel(mine, moe_meta, inp["moe_x"], emesh, top_k=2)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def moe_case():
    import jax
    import jax.numpy as jnp
    from bitsandbytes_tpu.models import moe as JM

    jp, jmeta = JM.init_moe_params(jax.random.PRNGKey(0), hidden=256, ffn=256, n_experts=8)
    params, meta = moe_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, jmeta, "cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 256), jnp.float32).astype(jnp.bfloat16))
    return params, meta, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, trees, moe_case, tmp_path_factory):
    """Spawn ``world`` gloo ranks once; returns (world, inputs, outputs by rank)."""
    world = request.param
    _, tcfg, _, ttrees = trees
    tmp = str(tmp_path_factory.mktemp(f"ranks{world}"))
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, tcfg.vocab_size, (2, 16), generator=g)
    caches = {}
    with torch.no_grad():
        for kv in ("bf16", "int8"):
            cache = TL.init_kv_cache(tcfg, 2, 32, kv_dtype=kv, device="cpu")
            logits, cache = TL.prefill(ttrees["unfused"], ids, tcfg, cache)
            caches[kv] = cache
    W = torch.randn(256, tcfg.hidden_size, generator=g)
    kadjacent = {"flat": QuantizedTensor.quantize(W, layout="flat"), "2d": QuantizedTensor.quantize(W, layout="2d"),
                 "flat_nested": QuantizedTensor.quantize(W, layout="flat", compress_statistics=True)}
    inp = {"cfg": tcfg, "trees": ttrees, "A": torch.randn(4, tcfg.hidden_size, generator=g).to(torch.bfloat16),
           "kadjacent": kadjacent,
           "ids": ids, "caches": caches, "tok": logits[:, -1].argmax(-1), "moe": moe_case[:2], "moe_x": moe_case[2]}
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    spawn_world(_rank_main, world, tmp, WORLD_LIMIT_S)
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(world)]
    return world, inp, outs


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        a, b = outs[0][key], o[key]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), key
        else:
            assert a == b, key


def test_tp_gemms_bit_for_bit(ranks, trees):
    """The all-gather and ring GEMMs give the unsharded call's bits on every
    rank, plain and double-quantized; the all-gather also on the flat and 2d
    (K-adjacent) layouts."""
    _, inp, outs = ranks
    for name in ("unfused", "nested"):
        w = trees[3][name]["layers"][0]["wq"]
        ref = TL.autograd.matmul_4bit(inp["A"], w.data, w.state)
        for o in outs:
            assert torch.equal(o[f"allgather_{name}"], ref), name
            assert torch.equal(o[f"ring_{name}"], ref), name
    for name, w in inp["kadjacent"].items():
        ref = TL.autograd.matmul_4bit(inp["A"], w.data, w.state)
        for o in outs:
            assert torch.equal(o[f"allgather_{name}"], ref), name


def test_sharded_forward_matches_unsharded_and_jax(ranks, trees):
    """The sharded forward equals the unsharded port's within the JAX
    package's sharded-forward tolerance (atol 0.06 / rtol 0.05), is the
    same on every rank, and agrees with the JAX package's GSPMD run on a
    data 2 x model 2 mesh."""
    import jax
    import jax.numpy as jnp
    from bitsandbytes_tpu import parallel as JP
    from bitsandbytes_tpu.models import llama as JL

    world, inp, outs = ranks
    jcfg, tcfg, jtrees, ttrees = trees
    jmesh = JP.make_mesh({"data": 2, "model": 2})
    for name in ttrees:
        key = f"forward_{name}"
        _same_on_every_rank(outs, key)
        with torch.no_grad():
            ref = TL.forward(ttrees[name], inp["ids"], tcfg)[0]
        np.testing.assert_allclose(outs[0][key].numpy(), ref.numpy(), atol=0.06, rtol=0.05, err_msg=name)
        if world == 4:
            sj = JP.llama_param_specs(jmesh, jtrees[name])
            jl, _ = jax.jit(lambda p, i: JL.forward(p, i, jcfg))(sj, jnp.asarray(inp["ids"].numpy()))
            np.testing.assert_allclose(outs[0][key].numpy(), np.asarray(jl, np.float32), atol=0.06, rtol=0.05,
                                       err_msg=name)


def test_sharded_kv_decode_matches_unsharded_and_jax(ranks, trees):
    """Decode on a cache split over data and model (slots and KV heads)
    against the unsharded port, and (bf16 KV) against the JAX package's
    sharded decode on the same prefilled cache, atol 0.05 / rtol 0.05."""
    import jax
    import jax.numpy as jnp
    from bitsandbytes_tpu import parallel as JP
    from bitsandbytes_tpu.models import llama as JL

    world, inp, outs = ranks
    jcfg, tcfg, jtrees, ttrees = trees
    for kv, cache in inp["caches"].items():
        key = f"decode_{kv}"
        _same_on_every_rank(outs, key)
        with torch.no_grad():
            ref = TL.decode_step(ttrees["unfused"], inp["tok"], tcfg, type(cache)(*(t.clone() for t in cache)), 16)[0]
        np.testing.assert_allclose(outs[0][key].numpy(), ref.numpy(), atol=0.05, rtol=0.05)
        if world == 4 and kv == "bf16":
            jmesh = JP.make_mesh({"data": 2, "model": 2})
            jc = JL.KVCache(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in cache))
            jl, _ = jax.jit(lambda p, t, c: JL.decode_step(p, t, jcfg, c, jnp.asarray(16)))(
                JP.llama_param_specs(jmesh, jtrees["unfused"]), jnp.asarray(inp["tok"].numpy()),
                JP.shard_kv_cache(jc, jmesh))
            np.testing.assert_allclose(outs[0][key].numpy(), np.asarray(jl), atol=0.05, rtol=0.05)


def test_sharded_engine_streams_match_unsharded(ranks, trees):
    """The engine with ``mesh=`` gives the unsharded engine's greedy streams
    on every rank, dense bf16 and paged int8 KV."""
    _, inp, outs = ranks
    tcfg, ttrees = trees[1], trees[3]
    for kv, layout in (("bf16", "dense"), ("int8", "paged")):
        key = f"engine_{kv}_{layout}"
        eng = ContinuousBatchingEngine(ttrees["unfused"], tcfg, max_batch=4, max_len=64, steps_per_sync=2,
                                       kv_dtype=kv, kv_layout=layout, kv_block_size=16, device="cpu")
        ref = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=6)]
        for o in outs:
            assert o[key] == ref, (key, o["coord"])


def test_sampled_streams_equal_on_every_rank(ranks):
    """Every rank draws from the same seeds on the same logits, so sampled
    streams are the same on every rank."""
    _, _, outs = ranks
    _same_on_every_rank(outs, "engine_sampled")
    assert all(len(t) == 6 for t in outs[0]["engine_sampled"])


def test_expert_parallel_matches_dense(ranks, moe_case):
    """Experts split over 2 and 4 ranks give the dense MoE within the JAX
    package's MoE tolerance, the same on every rank, from the whole tree or
    from each rank's own experts."""
    _, _, outs = ranks
    params, meta, x = moe_case
    ref = TM.moe_ffn(params, meta, x, top_k=2)
    for o in outs:
        assert torch.equal(o["moe_ep"], outs[0]["moe_ep"]) and torch.equal(o["moe_ep_local"], o["moe_ep"])
    np.testing.assert_allclose(outs[0]["moe_ep"].float().numpy(), ref.float().numpy(), atol=0.03, rtol=0.05)
