"""The port's Llama serving path against the JAX package's, on the CPU.

Weights are drawn once by the JAX package and carried across as numpy
(``utils/interop.params_from_numpy``).  Quantizing them in the port gives the
JAX package's bytes; prefill of 8 tokens and 3 decode steps on the same
quantized bytes give the same logits, the JAX side running its Pallas
kernels in interpret mode.  The same holds with the absmax double-quantized
(``compress_statistics=True``), where both sides run their ``_dq`` kernels,
and with an int8 KV cache, dense and paged: both sides scatter their own
prefilled dense cache into the same shuffled block pool.  ``_quantize_kv``
gives the JAX package's codes and scales bit for bit.  A model stored as the
FSDP-QLoRA recipe stores it (bf16 ``quant_storage``, so the K-adjacent
``"2d"`` layout, double-quantized) serves against the JAX package's default
tier: its fused kernel cannot take bf16 operands in interpret mode on the
CPU, and its default tier computes the same function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.utils.interop import kv_cache_from_numpy, params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

# hidden 512 keeps every JAX linear on its paired Pallas kernel (its tiles
# need (TK/64) % 8 == 0); hd 128 keeps attention on the flash kernel
CFG = dict(
    vocab_size=128, hidden_size=512, intermediate_size=512, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=128,
)
B, S, T_PROMPT = 2, 128, 8
HD = CFG["head_dim"]


def _np_tree(tree):
    """JAX tree -> nested dicts/lists of numpy; QuantizedTensor -> dict."""
    if isinstance(tree, JQT):
        st = tree.state
        d = {
            "data": np.asarray(tree.data), "absmax": np.asarray(st.absmax),
            "shape": tuple(st.shape), "blocksize": st.blocksize, "quant_type": st.quant_type,
            "layout": st.layout, "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name,
        }
        if st.nested:
            d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                     nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
        return d
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JL.LlamaConfig(**CFG), TL.LlamaConfig(**CFG)
    jparams = JL.init_params(jax.random.PRNGKey(0), jcfg)
    jq = JL.quantize_params_4bit(jparams, fuse=True)
    return jcfg, tcfg, jparams, jq


def test_quantize_params_bytes_equal(models):
    _, _, jparams, jq = models
    tq = TL.quantize_params_4bit(params_from_numpy(_np_tree(jparams), "cpu"), fuse=True)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        assert set(jl) == set(tl)
        for name in ("wqkv", "wo", "gate_up", "down"):
            assert tl[name].state.layout == "paired"
            np.testing.assert_array_equal(tl[name].data.numpy(), np.asarray(jl[name].data))
            np.testing.assert_array_equal(tl[name].state.absmax.numpy(), np.asarray(jl[name].state.absmax))


@pytest.fixture(scope="module")
def nested_models(models):
    jcfg, tcfg, jparams, _ = models
    return jcfg, tcfg, jparams, JL.quantize_params_4bit(jparams, fuse=True, compress_statistics=True)


def test_prefill_and_decode_match_jax(models):
    _serve_against_jax(*models)


def test_nested_prefill_and_decode_match_jax(nested_models):
    _serve_against_jax(*nested_models)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_kv_prefill_and_decode_match_jax(models, layout):
    _serve_against_jax(*models, kv_dtype="int8", layout=layout)


@pytest.mark.parametrize("S", [16, 128], ids=["jax_oracle_S16", "jax_kernel_S128"])
def test_int8_kv_prefill_against_jax_below_kernel_shapes(models, S):
    """Below S = 128 the JAX package prefills an int8 cache through its dense
    oracle, which dequantizes K/V to bf16 before the dot; at S = 128 through
    its kernel, which scales after the dot.  The port follows the kernel at
    every S, and stays within the logits contract of both (atol 0.1 / rtol
    0.05, the greedy token of the port in the JAX package's top-5)."""
    jcfg, tcfg, _, jq = models
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = np.random.default_rng(1).integers(1, 100, size=(3, 16))
    try:
        dispatch.set_backend("pallas")
        jl, _ = JL.prefill(jq, jnp.asarray(ids), jcfg, JL.init_kv_cache(jcfg, 3, S, kv_dtype="int8"))
    finally:
        dispatch.set_backend("auto")
    tl, _ = TL.prefill(tq, torch.from_numpy(ids), tcfg, TL.init_kv_cache(tcfg, 3, S, kv_dtype="int8", device="cpu"))
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.numpy(), jl, atol=0.1, rtol=0.05)
    top5 = np.argsort(-jl, axis=-1)[..., :5]
    assert (top5 == tl.numpy().argmax(-1)[..., None]).any(-1).all()


def test_paged_bf16_decode_matches_jax(models):
    _serve_against_jax(*models, layout="paged")


def test_nested_quantize_params_against_jax(nested_models):
    """The port quantizes the same weights to the same payload bytes and,
    within the offset contract of ``test_torch_double_quant.py``, the same
    nested absmax."""
    _, _, jparams, jq = nested_models
    tq = TL.quantize_params_4bit(params_from_numpy(_np_tree(jparams), "cpu"), fuse=True,
                                 compress_statistics=True)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for name in ("wqkv", "wo", "gate_up", "down"):
            st = tl[name].state
            assert st.inline_nested and st.absmax.dtype == torch.uint8
            np.testing.assert_array_equal(tl[name].data.numpy(), np.asarray(jl[name].data))
            jc, tc = np.asarray(jl[name].state.absmax).astype(int), st.absmax.numpy().astype(int)
            assert (jc == tc).mean() >= 0.999 and np.abs(jc - tc).max() <= 1


BS = 16  # pool block size of the paged cases


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _np_cache(cache):
    return {k: None if a is None else np.asarray(a) for k, a in cache._asdict().items()}


def _scatter_pool(dense: dict, tables):
    """A dense cache ``{k, v[, k_scale, v_scale]}`` of numpy arrays [L, B,
    KVH, S(, hd)] -> the pool dict [L, NB, KVH, BS(, hd)] holding it at
    ``tables`` (one spare block), tables included."""
    out = {"tables": tables, "k_scale": None, "v_scale": None}
    NB = tables.size + 1
    for name, a in dense.items():
        if a is None:
            out[name] = None
            continue
        L_, _, KVH = a.shape[:3]
        pool = np.zeros((L_, NB, KVH, BS) + a.shape[4:], a.dtype)
        for b in range(tables.shape[0]):
            for j in range(tables.shape[1]):
                pool[:, tables[b, j]] = a[:, b, :, j * BS : (j + 1) * BS]
        out[name] = pool
    return out


def _serve_against_jax(jcfg, tcfg, _, jq, kv_dtype="bf16", layout="dense", backend="pallas"):
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = np.random.default_rng(1).integers(0, CFG["vocab_size"], size=(B, T_PROMPT))
    paged = layout == "paged"
    # decode positions: two scalar steps, then one per-slot vector step (a
    # paged cache takes per-slot steps only)
    positions = [T_PROMPT, T_PROMPT + 1, T_PROMPT + 2]
    positions = [np.array([p] * B, np.int32) if paged or i == 2 else p for i, p in enumerate(positions)]
    tables = np.random.default_rng(3).permutation(B * (S // BS) + 1)[: B * (S // BS)].reshape(B, S // BS)
    tables = tables.astype(np.int32)

    jlog = []
    try:
        dispatch.set_backend(backend)
        cache = JL.init_kv_cache(jcfg, B, S, kv_dtype=kv_dtype)
        lg, cache = JL.prefill(jq, jnp.asarray(ids), jcfg, cache)
        if paged:
            pool = _scatter_pool(_np_cache(cache), tables)
            cache = JL.PagedKVCache(**{k: None if a is None else jnp.asarray(a) for k, a in pool.items()})
        jlog.append(np.asarray(lg[:, -1]))
        tokens = [np.asarray(jnp.argmax(lg[:, -1], -1))]
        for pos in positions:
            p = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
            lg, cache = JL.decode_step(jq, jnp.asarray(tokens[-1]), jcfg, cache, p)
            jlog.append(np.asarray(lg))
            tokens.append(np.asarray(jnp.argmax(lg, -1)))
    finally:
        dispatch.set_backend("auto")

    # the port, teacher-forced with the JAX package's greedy tokens
    tlog = []
    cache = TL.init_kv_cache(tcfg, B, S, kv_dtype=kv_dtype, device="cpu")
    assert isinstance(cache, TL.Int8KVCache if kv_dtype == "int8" else TL.KVCache)
    lg, cache = TL.prefill(tq, torch.from_numpy(ids), tcfg, cache)
    if paged:
        dense = {k: None if t is None else _np(t) for k, t in cache._asdict().items()}
        cache = kv_cache_from_numpy(_scatter_pool(dense, tables), "cpu")
        assert isinstance(cache, TL.PagedKVCache) and (cache.k_scale is not None) == (kv_dtype == "int8")
    tlog.append(lg[:, -1].numpy())
    for tok, pos in zip(tokens, positions):
        p = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        lg, cache = TL.decode_step(tq, torch.from_numpy(tok.astype(np.int64)), tcfg, cache, p)
        tlog.append(lg.numpy())

    for step, (t, j) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(t, j, atol=0.1, rtol=0.05, err_msg=f"step {step}")
        # the port's greedy token is the JAX token or inside its top-5
        top5 = np.argsort(-j, axis=-1)[:, :5]
        for b in range(B):
            assert t[b].argmax() in top5[b], (step, b)


def test_paged_forward_refuses_prefill(models):
    _, tcfg, _, jq = models
    tq = params_from_numpy(_np_tree(jq), "cpu")
    cache = TL.init_paged_kv_cache(tcfg, B, S, num_blocks=4, block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="per-slot decode"):
        TL.prefill(tq, torch.zeros(B, 4, dtype=torch.int64), tcfg, cache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(dtype):
    """Codes and scales of ``_quantize_kv`` equal the JAX package's bit for
    bit: random rows, an all-zero row, and rows of exact .5 ties (absmax
    127, so the scale is 1 and x / scale is x), which round half to even."""
    x = np.random.default_rng(4).standard_normal((2, 3, 5, HD)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    x[1, 0, :2] = np.resize(ties, HD)
    x[1, 0, :2, -1] = 127.0
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jq_, js = JL._quantize_kv(jx)
    tq_, ts = TL._quantize_kv(tensor_from_numpy(np.asarray(jx), "cpu"))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    assert (tq_[0, 1, 2] == 0).all() and ts[0, 1, 2] == 0
    assert tq_[1, 0, 0, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def test_no_cache_forward_matches_cached_prefill(models):
    """The dense-attention forward (no cache) and the flash route over the
    cache agree on the prompt."""
    _, tcfg, _, jq = models
    tq = params_from_numpy(_np_tree(jq), "cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, CFG["vocab_size"], size=(B, T_PROMPT)))
    dense, _ = TL.forward(tq, ids, tcfg)
    cached, _ = TL.prefill(tq, ids, tcfg, TL.init_kv_cache(tcfg, B, S, device="cpu"))
    np.testing.assert_allclose(dense.numpy(), cached.numpy(), atol=0.1, rtol=0.05)


def _quantize_2d(params, quantize):
    """The fused tree over bf16 storage: ``quantize(W)`` of wqkv, wo,
    gate_up and down, concatenated as ``quantize_params_4bit(fuse=True)``
    concatenates them (neither package's ``quantize_params_4bit`` takes a
    storage type)."""
    layers = []
    for layer in params["layers"]:
        cat = (lambda *ws: jnp.concatenate(ws, axis=0)) if isinstance(layer["wq"], jax.Array) else \
            (lambda *ws: torch.cat(ws, dim=0))
        layers.append({"attn_norm": layer["attn_norm"], "mlp_norm": layer["mlp_norm"],
                       "wqkv": quantize(cat(layer["wq"], layer["wk"], layer["wv"])), "wo": quantize(layer["wo"]),
                       "gate_up": quantize(cat(layer["gate"], layer["up"])), "down": quantize(layer["down"])})
    return dict(params, layers=layers)


def test_bf16_storage_2d_nested_model_serves_like_jax(models):
    jcfg, tcfg, jparams, _ = models
    jq = _quantize_2d(jparams, lambda W: JQT.quantize(jnp.asarray(W, jnp.float32), blocksize=64,
                                                      compress_statistics=True, quant_storage=jnp.bfloat16))
    tq = _quantize_2d(params_from_numpy(_np_tree(jparams), "cpu"),
                      lambda W: TL.QuantizedTensor.quantize(W.to(torch.float32), blocksize=64, compress_statistics=True,
                                                            quant_storage=torch.bfloat16))
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for name in ("wqkv", "wo", "gate_up", "down"):
            st = tl[name].state
            assert st.layout == "2d" and st.nested and tl[name].data.dtype == torch.uint16
            np.testing.assert_array_equal(tl[name].data.numpy(), np.asarray(jl[name].data))
    _serve_against_jax(jcfg, tcfg, jparams, jq, backend="auto")
