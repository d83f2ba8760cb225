"""The port's continuous-batching engine on the CPU (plain kernel versions),
mirroring the JAX package's ``tests/test_serving.py`` but for the mesh
cases, and held against the JAX engine itself.

The model is the geometry of ``test_torch_llama.py`` (hidden 512, 2 layers,
4/2 heads, head_dim 128), where the JAX package runs its Pallas kernels in
interpret mode.  Weights are drawn and quantized by the JAX package and
carried across as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.serving import ContinuousBatchingEngine as JEngine
from bitsandbytes_tpu.serving.engine import _sample_tokens as j_sample
from bitsandbytes_tpu_torch.functional import gemm as tgemm
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.serving import ContinuousBatchingEngine
from bitsandbytes_tpu_torch.serving.engine import _bucket, _nucleus, _sample_tokens
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy
from test_torch_llama import CFG, _np_tree

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [42]]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JL.LlamaConfig(**CFG), TL.LlamaConfig(**CFG)
    jq = JL.quantize_params_4bit(JL.init_params(jax.random.PRNGKey(0), jcfg), fuse=True)
    return jcfg, tcfg, jq, params_from_numpy(_np_tree(jq), "cpu")


def _engine(setup, **kw):
    _, tcfg, _, tq = setup
    kw.setdefault("max_len", 64)
    return ContinuousBatchingEngine(tq, tcfg, device="cpu", **kw)


def _streams(results):
    return {r.request_id: r.tokens for r in results}


def _loop(setup, prompt, n_new, kv_dtype, max_len=64):
    """Greedy tokens from the port's own prefill/decode_step on one slot, the
    prompt padded to the engine's bucket."""
    _, tcfg, _, tq = setup
    pad = _bucket(len(prompt))
    cache = TL.init_kv_cache(tcfg, 1, max_len, kv_dtype=kv_dtype, device="cpu")
    lg, cache = TL.prefill(tq, torch.tensor([prompt + [0] * (pad - len(prompt))]), tcfg, cache)
    tok = lg[0, len(prompt) - 1].argmax()
    out = [int(tok)]
    for i in range(n_new - 1):
        lg, cache = TL.decode_step(tq, tok[None], tcfg, cache, len(prompt) + i)
        tok = lg[0].argmax()
        out.append(int(tok))
    return out


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_matches_prefill_decode_loop(setup, kv_dtype):
    results = _engine(setup, max_batch=4, kv_dtype=kv_dtype).generate(PROMPTS, max_new_tokens=6)
    assert [r.request_id for r in results] == [0, 1, 2]
    for r, p in zip(results, PROMPTS):
        assert r.prompt == p and r.finished_reason == "length"
        assert r.tokens == _loop(setup, p, 6, kv_dtype), (kv_dtype, p)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_paged_matches_dense(setup, kv_dtype):
    """The block-pool engine gives the dense engine's tokens exactly: the
    paged plain version is the dense one on the gathered cache."""
    dense = _engine(setup, max_batch=4, kv_dtype=kv_dtype).generate(PROMPTS, max_new_tokens=6)
    paged = _engine(setup, max_batch=4, kv_dtype=kv_dtype, kv_layout="paged", kv_block_size=16)
    assert isinstance(paged.cache, TL.PagedKVCache)
    assert (paged.cache.k.dtype == torch.int8) == (kv_dtype == "int8")
    assert _streams(paged.generate(PROMPTS, max_new_tokens=6)) == _streams(dense)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_request_runs_to_max_len(setup, layout, kv_dtype):
    """A request that reaches max_len finishes on "length" with max_len -
    prompt tokens.  Its decode chunks (8 steps, two in flight) run past the
    cache's end; those writes are dropped, and the slot beside it keeps the
    tokens of its own prefill/decode loop."""
    rng = np.random.default_rng(5)
    long_prompt = rng.integers(1, CFG["vocab_size"], size=60).tolist()
    eng = _engine(setup, max_batch=2, kv_dtype=kv_dtype, kv_layout=layout, kv_block_size=16, steps_per_sync=8,
                  pipeline_depth=2)
    near, short = eng.generate([long_prompt, [1, 2, 3]], max_new_tokens=20)
    assert near.finished_reason == "length" and len(near.tokens) == 64 - 60
    assert near.tokens == _loop(setup, long_prompt, 4, kv_dtype)
    assert short.finished_reason == "length" and short.tokens == _loop(setup, [1, 2, 3], 20, kv_dtype)
    if layout == "paged":
        assert sorted(eng._free_blocks) == list(range(eng.num_kv_blocks)) and not eng._slot_blocks


def test_continuous_admission(setup):
    """More requests than slots: the queue drains as slots free."""
    results = _engine(setup, max_batch=2).generate([[i + 1] for i in range(5)], max_new_tokens=3)
    assert [r.request_id for r in results] == list(range(5))
    assert all(len(r.tokens) == 3 for r in results)


def test_eos_stops(setup):
    [r0] = _engine(setup, max_batch=1).generate([[5, 6]], max_new_tokens=4)
    eos = r0.tokens[1]  # the second generated token stands for EOS
    assert eos not in r0.tokens[:1]
    [r] = _engine(setup, max_batch=1, eos_id=eos).generate([[5, 6]], max_new_tokens=10)
    assert r.finished_reason == "eos" and r.tokens == r0.tokens[:2]


def test_eos_on_first_generated_token(setup):
    """EOS from the prefill itself finishes the request with that token."""
    [r0] = _engine(setup, max_batch=1).generate([[5, 6]], max_new_tokens=4)
    [r] = _engine(setup, max_batch=1, eos_id=r0.tokens[0]).generate([[5, 6]], max_new_tokens=10)
    assert r.finished_reason == "eos" and r.tokens == [r0.tokens[0]]


def test_max_new_tokens_one(setup):
    results = _engine(setup, max_batch=2).generate([[1, 2, 3], [9]], max_new_tokens=1)
    full = _engine(setup, max_batch=2).generate([[1, 2, 3], [9]], max_new_tokens=4)
    assert [r.tokens for r in results] == [f.tokens[:1] for f in full]


def test_engine_reuse_across_generate_calls(setup):
    """A second generate() on the same engine (slots retired, stale chained
    tokens) gives a fresh engine's tokens."""
    prompts = [[1, 2, 3], [9, 8]]
    eng = _engine(setup, max_batch=2)
    first = eng.generate(prompts, max_new_tokens=4)
    second = eng.generate(prompts, max_new_tokens=4)
    ref = _engine(setup, max_batch=2).generate(prompts, max_new_tokens=4)
    assert [r.tokens for r in first] == [r.tokens for r in second] == [r.tokens for r in ref]
    assert [r.request_id for r in second] == [2, 3]


def test_latency_metrics(setup):
    for r in _engine(setup, max_batch=2).generate([[1, 2, 3], [9, 8]], max_new_tokens=4):
        assert 0 < r.ttft_s <= r.total_s, (r.ttft_s, r.total_s)


def test_grouped_prefill_matches_single(setup):
    """A burst of same-bucket admissions prefills as one batch; the greedy
    streams equal one-by-one admissions, dense and paged.  Two sets of
    prompts, one on each side of ``LARGE_M_THRESHOLD``, so that one prompt
    alone and the burst take the same route of the 4-bit linears: the JAX
    test's own prompts pad to 16 tokens (M = 16 alone, 64 as the burst: the
    decode GEMM, kernel 2's plain version), and prompts of 67-100 tokens pad
    to 256 (M = 256 alone: the dequantize and the matmul)."""
    rng = np.random.default_rng(2)
    small = [[1, 2, 3], [7, 8, 9], [4], [11, 12]]
    large = [rng.integers(1, 100, size=n).tolist() for n in (67, 80, 100, 75)]
    assert 4 * 16 < tgemm.LARGE_M_THRESHOLD <= 256
    for prompts, max_len in ((small, 64), (large, 272)):
        for kw in ({}, {"kv_layout": "paged", "kv_block_size": 8}, {"kv_dtype": "int8"}):
            burst = _engine(setup, max_batch=4, max_len=max_len, **kw).generate(prompts, max_new_tokens=5)
            trickle = _engine(setup, max_batch=1, max_len=max_len, **kw).generate(prompts, max_new_tokens=5)
            assert [r.tokens for r in burst] == [r.tokens for r in trickle], (len(prompts[0]), kw)


def test_grouped_sampled_admission_deterministic(setup):
    prompts = [[1, 2, 3], [7, 8, 9], [4, 5]]
    outs = []
    for _ in range(2):
        rs = _engine(setup, max_batch=4, seed=3).generate(prompts, max_new_tokens=5, temperature=0.9, top_p=0.9)
        assert all(0 <= t < CFG["vocab_size"] for r in rs for t in r.tokens)
        outs.append([r.tokens for r in rs])
    assert outs[0] == outs[1]


def test_pipeline_depths_identical(setup):
    """Greedy streams are the same at every pipeline depth."""
    prompts = [[1, 2, 3], [7, 8], [42, 5, 6, 9]]
    outs = [
        [r.tokens for r in _engine(setup, max_batch=2, kv_layout="paged", kv_block_size=8, pipeline_depth=d,
                                   steps_per_sync=2).generate(prompts, max_new_tokens=5)]
        for d in (1, 2, 3)
    ]
    assert outs[0] == outs[1] == outs[2]


def test_sampling_modes(setup):
    """temperature 0 is greedy whatever the seed; a seed reproduces a
    sampled stream; seeds differ; a tiny nucleus is greedy."""

    def run(seed, temperature, top_p):
        eng = _engine(setup, max_batch=2, steps_per_sync=2, seed=seed)
        (r,) = eng.generate([[1, 2, 3]], max_new_tokens=8, temperature=temperature, top_p=top_p)
        return r.tokens

    greedy = run(0, 0.0, 1.0)
    assert run(7, 0.0, 1.0) == greedy
    s1 = run(0, 1.5, 0.9)
    assert s1 == run(0, 1.5, 0.9) and all(0 <= t < CFG["vocab_size"] for t in s1)
    assert len({tuple(run(seed, 1.5, 0.9)) for seed in range(5)}) > 1
    assert run(3, 0.7, 1e-6) == greedy


def test_paged_fragmentation_churn(setup):
    """Admit/retire churn on an undersized pool recycles blocks in any
    order; the tokens equal a roomy pool's, and every block comes back."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50, size=int(n)).tolist() for n in rng.integers(1, 12, size=9)]
    lens = rng.integers(2, 7, size=9).tolist()

    def run(num_blocks):
        eng = _engine(setup, max_batch=3, kv_layout="paged", kv_block_size=16, num_kv_blocks=num_blocks)
        for p, n in zip(prompts, lens):
            eng.add_request(p, max_new_tokens=int(n))
        done = []
        for _ in range(500):
            done.extend(eng.step())
            if len(done) == len(prompts):
                break
        assert len(done) == len(prompts)
        assert sorted(eng._free_blocks) == list(range(eng.num_kv_blocks)) and not eng._slot_blocks
        assert (eng._tables == eng._trash_block).all()
        return _streams(done)

    assert run(6) == run(3 * (64 // 16))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_kv_memory_scales_with_blocks(setup, kv_dtype):
    """KV bytes follow num_kv_blocks: a quarter-size pool holds about a
    quarter of the dense bytes (plus the trash block)."""

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for t in cache[:4] if t is not None and t.dim() > 2)

    nb_full = 8 * (128 // 16)
    dense = _engine(setup, max_batch=8, max_len=128, kv_dtype=kv_dtype)
    paged = _engine(setup, max_batch=8, max_len=128, kv_dtype=kv_dtype, kv_layout="paged", kv_block_size=16,
                    num_kv_blocks=nb_full // 4)
    assert nbytes(paged.cache) == nbytes(dense.cache) // 4 * (nb_full // 4 + 1) // (nb_full // 4)


def test_constructor_validation(setup):
    _, tcfg, jq, tq = setup
    with pytest.raises(ValueError, match="multiple of kv_block_size"):
        _engine(setup, max_batch=2, max_len=200, kv_layout="paged", kv_block_size=128)
    with pytest.raises(ValueError, match="power of two"):
        _engine(setup, max_batch=2, max_len=192, kv_layout="paged", kv_block_size=96)
    with pytest.raises(ValueError, match="kv_layout"):
        _engine(setup, kv_layout="ring")
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(setup, kv_dtype="fp8")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        _engine(setup, mesh=object())
    with pytest.raises(ValueError, match="params lie on"):
        ContinuousBatchingEngine(tq, tcfg, max_len=64, device="meta")


def test_paged_admission_reserves_first_decode_chunk(setup):
    """A prompt that fits the pool but whose first decode chunk does not
    waits; decode never exhausts the pool; a request that can never fit
    raises at once."""
    eng = _engine(setup, max_batch=2, kv_layout="paged", kv_block_size=16, num_kv_blocks=2, steps_per_sync=8)
    eng.add_request([1] * 15, max_new_tokens=4)
    eng._admit()
    assert 0 in eng.slots
    eng.add_request([2] * 15, max_new_tokens=4)
    eng._admit()
    assert len(eng.slots) == 1 and len(eng._pending) == 1
    done = []
    for _ in range(40):
        done += eng.step()
        if len(done) == 2:
            break
    assert len(done) == 2
    with pytest.raises(ValueError, match="KV blocks"):
        eng.add_request([3] * 31, max_new_tokens=4)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_preemption_completes_with_identical_tokens(setup, kv_dtype):
    """A pool that runs dry mid-decode preempts the youngest slot, which
    resumes by recomputing its prefix: every request completes with the
    tokens of an unconstrained run, and every block comes back."""
    prompts = [[i + 1, i + 2, i + 3] for i in range(3)]
    n_new = 40  # each slot grows to 43 tokens = 3 blocks of 16; 9 in all

    def run(num_blocks):
        eng = _engine(setup, max_batch=3, kv_layout="paged", kv_block_size=16, num_kv_blocks=num_blocks,
                      steps_per_sync=4, kv_dtype=kv_dtype)
        for p in prompts:
            eng.add_request(p, max_new_tokens=n_new)
        done = []
        for _ in range(500):
            done.extend(eng.step())
            if len(done) == len(prompts):
                break
        assert len(done) == len(prompts)
        assert sorted(eng._free_blocks) == list(range(eng.num_kv_blocks))
        return eng.preempt_count, _streams(done)

    n_constrained, constrained = run(6)
    n_roomy, roomy = run(3 * (64 // 16))
    assert n_roomy == 0 and n_constrained > 0
    assert all(len(t) == n_new for t in roomy.values())
    if kv_dtype == "bf16":
        assert constrained == roomy
    else:
        # a resumed int8 request re-quantizes its prefix from the prefill's
        # K/V, not the decode steps', so its codes may move by one step; the
        # requests never preempted keep their tokens exactly
        assert all(len(t) == n_new for t in constrained.values())
        assert sum(constrained[k] != roomy[k] for k in roomy) <= n_constrained


def test_paged_single_request_exceeding_pool_raises(setup):
    eng = _engine(setup, max_batch=2, kv_layout="paged", kv_block_size=16, num_kv_blocks=2, steps_per_sync=4)
    eng.add_request([1, 2, 3], max_new_tokens=40)  # fits with its first chunk, outgrows the pool later
    with pytest.raises(RuntimeError, match="KV blocks"):
        for _ in range(200):
            eng.step()


def test_sliding_window_paged_matches_dense(setup):
    """A window of 8 (Mistral-style) through the paged walk gives the dense
    engine's tokens, which differ from a run without the window."""
    _, _, _, tq = setup
    wcfg = TL.LlamaConfig(**CFG, sliding_window=8)

    def run(cfg, layout, **kw):
        eng = ContinuousBatchingEngine(tq, cfg, max_batch=3, max_len=64, kv_layout=layout, device="cpu", **kw)
        return _streams(eng.generate(PROMPTS, max_new_tokens=16))

    dense = run(wcfg, "dense")
    assert run(wcfg, "paged", kv_block_size=16, num_kv_blocks=12) == dense
    assert run(TL.LlamaConfig(**CFG), "dense") != dense, "the window never bound: the test is vacuous"


# -- sampling ------------------------------------------------------------------


def _exact_nucleus_probs(logits, temp, top_p):
    """numpy: the exact temperature + nucleus distribution."""
    z = np.asarray(logits, np.float64) / temp
    p = np.exp(z - z.max())
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    ps = p[order]
    keep = (np.cumsum(ps) - ps) < top_p
    keep[0] = True
    out = np.zeros_like(p)
    out[order[keep]] = p[order[keep]] / p[order[keep]].sum()
    return out


def _empirical(logits, temp, top_p, pool, n_rounds=8, B=512):
    V = len(logits)
    lg = torch.tensor(np.asarray(logits, np.float32)).expand(B, V)
    temps, tops = torch.full((B,), float(temp)), torch.full((B,), float(top_p))
    counts = np.zeros(V)
    for r in range(n_rounds):
        toks = _sample_tokens(lg, temps, tops, torch.Generator().manual_seed(r), pool=pool)
        counts += np.bincount(toks.numpy(), minlength=V)
    return counts / counts.sum()


def test_nucleus_set_matches_jax():
    """The kept candidates equal the support of the JAX package's
    ``_sample_tokens`` on the same logits (every member has >= 2% mass, so
    4096 JAX draws see them all)."""
    V, pool = 128, 64
    logits = np.full(V, -6.0, np.float32) + np.random.default_rng(0).standard_normal(V).astype(np.float32) * 0.1
    logits[[5, 17, 40, 3, 99, 64]] = [3.0, 2.6, 2.2, 1.8, 1.4, 1.0]
    for temp, top_p in ((1.0, 0.8), (0.7, 0.95), (1.3, 0.5)):
        idxs, _, keep = _nucleus(torch.tensor(logits)[None], torch.tensor([temp]), torch.tensor([top_p]), pool)
        port = set(idxs[0][keep[0]].tolist())
        exact = _exact_nucleus_probs(logits, temp, top_p)
        assert port == set(np.nonzero(exact)[0].tolist()) and exact[list(port)].min() >= 0.02
        lg = jnp.broadcast_to(jnp.asarray(logits), (512, V))
        support = set()
        for r in range(8):
            toks = j_sample(lg, jnp.full((512,), temp, jnp.float32), jnp.full((512,), top_p, jnp.float32),
                            jax.random.PRNGKey(r), pool=pool)
            support |= set(np.asarray(toks).tolist())
        assert support == port, (temp, top_p)


def test_temperature_zero_is_argmax():
    lg = torch.tensor(np.random.default_rng(1).standard_normal((16, 128)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0] * 8)
    out = _sample_tokens(lg, temps, torch.full((16,), 0.9), torch.Generator().manual_seed(0))
    greedy = lg.argmax(-1)
    assert torch.equal(out[temps == 0], greedy[temps == 0])


@pytest.mark.parametrize("pool,vshape", [(64, "small_vocab"), (8, "peaked")])
def test_topp_sampling_statistically_exact(pool, vshape):
    """Exact nucleus sampling whenever the nucleus lies in the pool: a
    vocabulary smaller than the pool, and a peaked distribution."""
    rng = np.random.default_rng(0)
    if vshape == "small_vocab":
        V, temp, top_p = 40, 1.5, 0.95
        logits = rng.normal(size=V) * 2.0
    else:
        V, temp, top_p = 256, 1.0, 0.9
        logits = rng.normal(size=V)
        logits[:6] += 8.0
    exact = _exact_nucleus_probs(logits, temp, top_p)
    emp = _empirical(logits, temp, top_p, pool)
    assert set(np.nonzero(emp)[0]) <= set(np.nonzero(exact)[0])
    assert 0.5 * np.abs(emp - exact).sum() < 0.1


def test_topp_sampling_pool_truncation():
    """A flat distribution whose nucleus exceeds the pool draws from the
    pool, renormalized; a pool of the whole vocabulary is exact."""
    V, pool, temp, top_p = 128, 8, 1.0, 0.99
    logits = np.random.default_rng(1).normal(size=V) * 0.1
    emp = _empirical(logits, temp, top_p, pool)
    top8 = np.argsort(-logits)[:pool]
    assert set(np.nonzero(emp)[0]) <= set(top8.tolist())
    p = np.exp(logits - logits.max())
    ref = np.zeros(V)
    ref[top8] = p[top8] / p[top8].sum()
    assert 0.5 * np.abs(emp - ref).sum() < 0.1
    exact = _exact_nucleus_probs(logits, temp, top_p)
    assert 0.5 * np.abs(_empirical(logits, temp, top_p, V) - exact).sum() < 0.1


# -- against the JAX engine ----------------------------------------------------


def _port_top5_along(setup, prompt, tokens, kv_dtype, layout, max_len, bs):
    """Teacher-force ``tokens`` through the port (prefill of the prompt
    padded as the engine pads it, then decode steps through a dense cache or
    a pool packed from the prefill) and assert each is in the port's top-5
    at its step."""
    _, tcfg, _, tq = setup
    pad = min(max(_bucket(len(prompt)), bs if layout == "paged" else 0), max_len)
    dense = TL.init_kv_cache(tcfg, 1, pad if layout == "paged" else max_len, kv_dtype=kv_dtype, device="cpu")
    lg, dense = TL.prefill(tq, torch.tensor([prompt + [0] * (pad - len(prompt))]), tcfg, dense)
    steps = [lg[0, len(prompt) - 1]]
    if layout == "paged":
        nb = max_len // bs
        cache = TL.init_paged_kv_cache(tcfg, 1, max_len, nb + 1, bs, kv_dtype, device="cpu")
        perm = torch.from_numpy(np.random.default_rng(0).permutation(nb + 1)[:nb].astype(np.int32))
        cache = cache._replace(tables=perm[None].clone())
        used = -(-pad // bs)
        for pool, one in zip((cache.k, cache.v, cache.k_scale, cache.v_scale), dense):
            blocks = one[:, 0, :, : used * bs].reshape(one.shape[0], one.shape[2], used, bs, *one.shape[4:])
            pool[:, perm[:used].long()] = blocks.transpose(1, 2)
    else:
        cache = dense
    for i, tok in enumerate(tokens[:-1]):
        pos = torch.tensor([len(prompt) + i])
        lg, cache = TL.decode_step(tq, torch.tensor([tok]), tcfg, cache, pos if layout == "paged" else int(pos))
        steps.append(lg[0])
    for i, (tok, lg) in enumerate(zip(tokens, steps)):
        assert tok in lg.topk(5).indices.tolist(), (prompt, i, tok)


@pytest.mark.parametrize("kv_dtype,layout", [("int8", "paged"), ("bf16", "dense")])
def test_greedy_streams_against_jax_engine(setup, kv_dtype, layout):
    """The JAX engine (Pallas kernels in interpret mode) serves 3 prompts, 6
    new tokens each; every token it picks is in the port's top-5 when its
    stream is fed through the port, and the port's own engine agrees with
    most of it.  (The JAX paged prefill of 16 tokens takes its dense oracle,
    which dequantizes K/V before the dot: hence top-5, not equality.)"""
    jcfg, _, jq, _ = setup
    kw = dict(max_batch=4, max_len=128, kv_dtype=kv_dtype, kv_layout=layout, kv_block_size=16)
    try:
        dispatch.set_backend("pallas")
        jres = JEngine(jq, jcfg, **kw).generate(PROMPTS, max_new_tokens=6)
    finally:
        dispatch.set_backend("auto")
    tres = _engine(setup, **kw).generate(PROMPTS, max_new_tokens=6)
    agree = 0
    for jr, tr, p in zip(jres, tres, PROMPTS):
        assert len(jr.tokens) == len(tr.tokens) == 6
        _port_top5_along(setup, p, [int(t) for t in jr.tokens], kv_dtype, layout, 128, 16)
        agree += sum(a == b for a, b in zip(jr.tokens, tr.tokens))
    assert agree >= 12, (jres, tres)
