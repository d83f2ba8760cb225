"""The port's embeddings and OutlierAwareLinear against the JAX package's
flax modules, on the CPU.

Each JAX module is built with ``init`` and its params carried into the
port's module with ``utils.interop.module_from_numpy``; both then look up
the same ids (numpy, from a seed).  Tolerances are the JAX suite's for the
same modules (``tests/test_modules.py``): rtol 1e-5 / atol 1e-5 for the
4-bit lookups and the float tables, rtol 1e-5 / atol 1e-6 for the int8
table; the LayerNorm of StableEmbedding (eps 1e-6, where torch defaults to
1e-5) within 1e-5; OutlierAwareLinear within the int8 linear's contract of
``test_torch_int8_autograd.py`` (rtol 2^-7, atol 1e-2 in bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import nn as JN
from bitsandbytes_tpu.nn.modules import Int8TensorState as JInt8
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.utils.outliers import find_outlier_dims as j_find_outlier_dims
from bitsandbytes_tpu_torch import nn as TN
from bitsandbytes_tpu_torch.utils.interop import module_from_numpy
from bitsandbytes_tpu_torch.utils.outliers import find_outlier_dims
from test_torch_llama import _np_tree as _np_tree_4bit

torch.set_num_threads(1)

V = 96
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    """JAX params -> numpy dicts; an Int8TensorState -> {"CB", "SCB"}, a
    QuantizedTensor -> its dict."""
    if isinstance(tree, JInt8):
        return {"CB": np.asarray(tree.CB), "SCB": np.asarray(tree.SCB)}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np_tree_4bit(tree)


def _ids(shape, seed, high=V):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


def _run(jmod, tmod, ids, variables=None, seed=0):
    """Both modules over ``ids``: the JAX module's params (``variables``, or
    its ``init``) carried into the port's."""
    if variables is None:
        variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ids))
    jout = np.asarray(jmod.apply(variables, jnp.asarray(ids)).astype(jnp.float32))
    module_from_numpy(tmod, _np_tree(variables), "cpu")
    tout = tmod(torch.from_numpy(ids).long())
    return jout, tout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features,layout", [(128, "2d"), (48, "flat"), (33, "flat")],
                         ids=["2d_rows", "flat_whole_table", "odd_whole_table"])
@pytest.mark.parametrize("jcls,tcls", [(JN.EmbeddingNF4, TN.EmbeddingNF4), (JN.EmbeddingFP4, TN.EmbeddingFP4)],
                         ids=["nf4", "fp4"])
def test_embedding4bit_matches_jax(jcls, tcls, features, layout, dtype):
    jd, td = DTYPES[dtype]
    jmod = jcls(num_embeddings=V, features=features, dtype=jd)
    tmod = tcls(V, features, dtype=td, device="cpu")
    assert tmod.weight.state.layout == layout and tmod.weight.data.dtype == torch.uint8
    ids = _ids((3, 5), 1)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    assert variables["params"]["embedding"].state.layout == layout
    jout, tout = _run(jmod, tmod, ids, variables)
    assert tout.dtype == td and tout.shape == (3, 5, features)
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-5)
    # the rows are the carried table's, dequantized whole
    whole = tmod.weight.dequantize().to(td)[torch.from_numpy(ids).long()]
    np.testing.assert_allclose(_f32(tout), _f32(whole), rtol=1e-5, atol=1e-5)


def test_paired_table_relaid_per_lookup():
    """A paired table (quantized for the GEMM) is relaid to 2d at each
    lookup, on both sides: the lookup helper on the same bytes."""
    from bitsandbytes_tpu.nn.modules import _partial_dequant_rows as j_rows
    from bitsandbytes_tpu_torch.nn.modules import _partial_dequant_rows as t_rows
    from bitsandbytes_tpu_torch.utils.interop import params_from_numpy

    W = np.random.default_rng(2).standard_normal((V, 128)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), layout="paired")
    tq = params_from_numpy({"t": _np_tree(jq)}, "cpu")["t"]
    assert tq.state.layout == "paired"
    ids = _ids((4, 3), 3)
    jout = np.asarray(j_rows(jq, jnp.asarray(ids)))
    tout = t_rows(tq, torch.from_numpy(ids).long())
    assert tout.shape == (4, 3, 128)
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-5)


def test_nested_table_matches_jax():
    """A double-quantized table (carried across, not quantized twice)."""
    W = np.random.default_rng(4).standard_normal((V, 256)).astype(np.float32)
    jmod = JN.EmbeddingNF4(num_embeddings=V, features=256)
    ids = _ids((2, 7), 5)
    variables = {"params": {"embedding": JQT.quantize(jnp.asarray(W), layout="2d", compress_statistics=True)}}
    jout, tout = _run(jmod, TN.EmbeddingNF4(V, 256, device="cpu"), ids, variables)
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding8bit_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    ids = _ids((5,), 6)
    jout, tout = _run(JN.Embedding8bit(num_embeddings=V, features=32, dtype=jd),
                      TN.Embedding8bit(V, 32, dtype=td, device="cpu"), ids)
    assert tout.dtype == td and tout.shape == (5, 32)
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("jcls,tcls", [(JN.Embedding, TN.Embedding), (JN.StableEmbedding, TN.StableEmbedding)],
                         ids=["embedding", "stable"])
def test_float_embeddings_match_jax(jcls, tcls):
    ids = _ids((3, 4), 7)
    jout, tout = _run(jcls(num_embeddings=V, features=64), tcls(V, 64, device="cpu"), ids)
    assert tout.dtype == torch.float32 and tout.shape == (3, 4, 64)
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-5)


def test_stable_embedding_layernorm_eps():
    """Rows of variance about 1e-6, where the eps decides the scale: the
    port's LayerNorm at eps 1e-6 holds the JAX module's output within 1e-5;
    torch's default eps 1e-5 would miss it by far more."""
    rng = np.random.default_rng(8)
    table = (rng.standard_normal((V, 64)) * 1e-3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    variables = {"params": {"embedding": jnp.asarray(table),
                            "LayerNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}}
    ids = _ids((6,), 9)
    tmod = TN.StableEmbedding(V, 64, device="cpu")
    jout, tout = _run(JN.StableEmbedding(num_embeddings=V, features=64), tmod, ids, variables)
    assert tmod.norm.eps == 1e-6
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        wrong = torch.nn.functional.layer_norm(tmod.weight[torch.from_numpy(ids).long()], (64,), tmod.norm.weight,
                                               tmod.norm.bias, eps=1e-5)
    assert np.abs(_f32(wrong) - jout).max() > 0.1


CASES = [
    ("embedding4bit", lambda **kw: JN.Embedding4bit(num_embeddings=12, features=64, **kw),
     lambda **kw: TN.Embedding4bit(12, 64, device="cpu", **kw)),
    ("embedding8bit", lambda **kw: JN.Embedding8bit(num_embeddings=12, features=32, **kw),
     lambda **kw: TN.Embedding8bit(12, 32, device="cpu", **kw)),
    ("embedding", lambda **kw: JN.Embedding(num_embeddings=12, features=32, **kw),
     lambda **kw: TN.Embedding(12, 32, device="cpu", **kw)),
    ("stable", lambda **kw: JN.StableEmbedding(num_embeddings=12, features=32, **kw),
     lambda **kw: TN.StableEmbedding(12, 32, device="cpu", **kw)),
]


@pytest.mark.parametrize("norm_type", [2.0, float("inf")], ids=["l2", "inf"])
@pytest.mark.parametrize("name,jmake,tmake", CASES, ids=[c[0] for c in CASES])
def test_lookup_options_match_jax(name, jmake, tmake, norm_type):
    """padding_idx, and max_norm with norm_type 2 and inf, on the gathered
    rows; the stored table is left as it is."""
    kw = dict(padding_idx=0, max_norm=0.5, norm_type=norm_type)
    ids = np.array([[0, 3], [7, 9], [0, 11]], np.int32)
    tmod = tmake(**kw)
    jvars = jmake(**kw).init(jax.random.PRNGKey(0), jnp.asarray(ids))
    module_from_numpy(tmod, _np_tree(jvars), "cpu")
    before = tmod.weight.detach().clone() if isinstance(tmod.weight, torch.Tensor) else None
    jout, tout = _run(jmake(**kw), tmod, ids, jvars)
    np.testing.assert_allclose(_f32(tout), jout, rtol=1e-5, atol=1e-5)
    if name != "stable":  # the LayerNorm runs after the options
        out = _f32(tout).reshape(-1, tout.shape[-1])
        assert np.all(out[0] == 0.0) and np.all(out[4] == 0.0)
        norms = np.linalg.norm(out, ord=norm_type, axis=-1)
        assert np.all(norms <= 0.5 * (1 + 1e-5)), norms
    if before is not None:  # the float table was not renormed in place
        assert torch.equal(tmod.weight.detach(), before)
    # max_norm did something: the lookup without it differs
    plain = _run(jmake(), tmake(), ids, jvars)[1]
    assert not np.allclose(_f32(plain), _f32(tout))


@pytest.mark.parametrize("cls", [TN.EmbeddingNF4, TN.Embedding8bit])
def test_no_gradient_reaches_a_quantized_table(cls):
    mod = cls(32, 128, device="cpu")
    assert list(mod.parameters()) == []
    out = mod(torch.tensor([[1, 2, 3]]))
    assert not out.requires_grad
    tensors = ([mod.weight.data, mod.weight.state.absmax] if cls is TN.EmbeddingNF4
               else [mod.weight.CB, mod.weight.SCB])
    assert all(not t.requires_grad and t.grad is None for t in tensors)


def test_float_tables_train():
    mod = TN.StableEmbedding(32, 16, device="cpu")
    (mod(torch.tensor([1, 2, 2])) ** 2).sum().backward()
    assert mod.weight.grad is not None and mod.weight.grad[[1, 2]].abs().sum() > 0
    assert mod.weight.grad[0].abs().sum() == 0
    assert mod.norm.weight.grad is not None and mod.norm.bias.grad is not None
    assert [n for n, _ in mod.named_parameters()] == ["weight", "norm.weight", "norm.bias"]


def test_module_from_numpy_checks_shapes_and_kinds():
    ids = _ids((2,), 10, high=12)
    jvars = _np_tree(JN.Embedding8bit(num_embeddings=12, features=32).init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    with pytest.raises(ValueError):
        module_from_numpy(TN.Embedding8bit(13, 32, device="cpu"), jvars, "cpu")
    with pytest.raises(ValueError):
        module_from_numpy(TN.Embedding(12, 32, device="cpu"), jvars, "cpu")
    with pytest.raises(ValueError):
        module_from_numpy(TN.Embedding8bit(12, 32, device="cpu"), {"embedding": jvars["params"]["embedding"],
                                                                  "extra": np.zeros(1)}, "cpu")
    with pytest.raises(TypeError):
        module_from_numpy(TN.Linear8bitLt(32, 32, device="cpu"), jvars, "cpu")


@pytest.mark.parametrize("topk", [4, 16])
def test_outlier_aware_linear_matches_jax(topk):
    """The same weight on both sides: the same outlier columns and int8
    codes, and the output within the int8 linear's tolerance."""
    N, K = 96, 256
    rng = np.random.default_rng(12)
    W = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    W[:, [5, 77, 130]] *= 30.0  # planted outlier columns
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    x[..., 77] *= 20.0
    bias = rng.standard_normal(N).astype(np.float32)

    jmod = JN.OutlierAwareLinear(features=N, outlier_topk=topk, kernel_init=lambda *_: jnp.asarray(W))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables["params"]["bias"] = jnp.asarray(bias).astype(jnp.bfloat16)
    jy = np.asarray(jmod.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    jk = variables["params"]["kernel"]

    built = TN.OutlierAwareLinear(K, N, outlier_topk=topk, device="cpu", weight=torch.from_numpy(W))
    idx = built.outlier_idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(jk["outlier_idx"]))
    np.testing.assert_array_equal(idx, np.asarray(j_find_outlier_dims(jnp.asarray(W), reduction_dim=0, topk=topk)))
    assert {5, 77, 130} <= set(idx.tolist())
    np.testing.assert_array_equal(built.weight.CB.numpy(), np.asarray(jk["q"].CB))
    np.testing.assert_array_equal(built.weight.SCB.numpy().view(np.uint32), np.asarray(jk["q"].SCB).view(np.uint32))
    np.testing.assert_array_equal(built.outlier_w.numpy(), np.asarray(jk["outlier_w"]))

    carried = module_from_numpy(TN.OutlierAwareLinear(K, N, outlier_topk=topk, device="cpu"), _np_tree(variables),
                                "cpu")
    np.testing.assert_array_equal(carried.outlier_idx.numpy(), idx)
    for mod in (built, carried):
        mod.bias = torch.nn.Parameter(torch.from_numpy(bias).to(torch.bfloat16))
        y = mod(torch.from_numpy(x))
        assert y.dtype == torch.bfloat16 and y.shape == (2, 3, N)
        np.testing.assert_allclose(_f32(y), jy, rtol=2 ** -7, atol=1e-2)
    # the outlier columns matter: without them the output moves well past the tolerance
    built.outlier_w = torch.zeros_like(built.outlier_w)
    assert np.abs(_f32(built(torch.from_numpy(x))) - jy).max() > 0.5
    assert find_outlier_dims(torch.from_numpy(W), reduction_dim=0, topk=topk).tolist() == idx.tolist()


def test_exports():
    for name in ("Embedding4bit", "EmbeddingNF4", "EmbeddingFP4", "Embedding8bit", "Embedding", "StableEmbedding",
                 "OutlierAwareLinear"):
        assert name in TN.__all__ and getattr(TN, name) is not None
    assert issubclass(TN.EmbeddingNF4, TN.Embedding4bit)
    assert TN.EmbeddingFP4(8, 64, device="cpu").weight.state.quant_type == "fp4"
