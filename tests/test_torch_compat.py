"""The port's reference-named utilities against the JAX package's, on the CPU:
``utils/compat`` (``pack_dict_to_tensor``, ``unpack_tensor_to_dict``,
``replace_linear``, ``OutlierTracer``), ``utils/outliers``
(``find_outlier_dims``, ``OutlierPool``), ``nn/parametrize``
(``quantize_tree``, ``dequantize_tree``, ``mask_quantized``) and the names
the packages export.  Inputs are drawn with numpy from a seed; quantized
leaves and outlier indices are compared bit for bit, norms within float32
rounding (rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_tpu.functional as JFn
import bitsandbytes_tpu.nn as JN
import bitsandbytes_tpu.utils as JU
import bitsandbytes_tpu_torch.functional as TFn
import bitsandbytes_tpu_torch.nn as TN
import bitsandbytes_tpu_torch.utils as TU
from bitsandbytes_tpu.utils.outliers import find_outlier_dims as j_find
from bitsandbytes_tpu_torch.utils.outliers import find_outlier_dims as t_find
from test_torch_serialization import _assert_tree_equal, _same

torch.set_num_threads(1)


def _tree(seed=0):
    """A small tree with leaves on both sides of every selection rule."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "layers": [{"wq": f32(64, 128), "small": f32(32, 64), "bias": f32(64)}, {"wq": f32(128, 64)}],
        "lm_head": f32(64, 128),
        "ids": np.arange(64 * 128, dtype=np.int32).reshape(64, 128),
        "moe": {"experts": f32(4, 64, 64)},
    }


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree):
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_pack_unpack_dict_tensor_matches_jax():
    d = {"quant_type": "nf4", "blocksize": 64, "shape": [4, 8], "dtype": "bfloat16"}
    t = TU.pack_dict_to_tensor(d)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8 and t.device.type == "cpu"
    assert t.numpy().tobytes() == np.asarray(JU.pack_dict_to_tensor(d)).tobytes()
    assert TU.unpack_tensor_to_dict(t) == d
    assert TU.unpack_tensor_to_dict(JU.pack_dict_to_tensor(d)) == d  # a numpy array too
    assert JU.unpack_tensor_to_dict(t.numpy()) == d


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("skip", [None, ["layers/0"]], ids=["default_skip", "skip_layer0"])
def test_replace_linear_matches_jax(skip, compress):
    """Plain: bit for bit.  Nested: the same leaves quantized, the payloads
    bit for bit, the offset within 1 ulp of the JAX package's ``jnp.mean``
    (the contract of ``test_torch_double_quant.py``); each leaf the port's
    own ``QuantizedTensor.quantize``."""
    tree = _tree()
    jout = JU.replace_linear(_jax(tree), skip=skip, compress_statistics=compress)
    tout = TU.replace_linear(_port(tree), skip=skip, compress_statistics=compress)
    if not compress:
        _assert_tree_equal(tout, jout)
    tl = jax.tree_util.tree_leaves(tout, is_leaf=lambda x: isinstance(x, TN.QuantizedTensor))
    jl = jax.tree_util.tree_leaves(jout, is_leaf=lambda x: isinstance(x, JN.QuantizedTensor))
    assert [isinstance(x, TN.QuantizedTensor) for x in tl] == [isinstance(x, JN.QuantizedTensor) for x in jl]
    for t, j, src in zip(tl, jl, jax.tree_util.tree_leaves(_port(tree))):
        if isinstance(t, TN.QuantizedTensor):
            _same(t.data, j.data)
            own = TN.QuantizedTensor.quantize(src, compress_statistics=compress)
            assert torch.equal(t.data, own.data) and torch.equal(t.state.absmax, own.state.absmax)
            if compress:
                ulps = abs(int(t.state.offset.numpy().view(np.int32)) - int(np.asarray(j.state.offset).view(np.int32)))
                assert ulps <= 1
    assert isinstance(tout["moe"]["experts"], TN.QuantizedTensor)  # 3-D, quantized flat
    assert not isinstance(tout["lm_head"], TN.QuantizedTensor) if skip is None else isinstance(
        tout["lm_head"], TN.QuantizedTensor)
    assert isinstance(tout["layers"][0]["wq"], TN.QuantizedTensor) == (skip is None)
    assert not isinstance(tout["layers"][0]["small"], TN.QuantizedTensor)  # 2048 elements
    assert tout["ids"].dtype == torch.int32  # not a float


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_quantize_tree_matches_jax(quant_type):
    tree = _tree(1)
    jout = JN.quantize_tree(_jax(tree), quant_type=quant_type, blocksize=128, min_size=2048)
    tout = TN.quantize_tree(_port(tree), quant_type=quant_type, blocksize=128, min_size=2048)
    _assert_tree_equal(tout, jout)
    assert isinstance(tout["layers"][0]["small"], TN.QuantizedTensor)
    # a predicate over the path; already-quantized leaves pass through
    pred = lambda path, leaf: path[-1] == "wq"  # noqa: E731
    jpred = lambda path, leaf: getattr(path[-1], "key", None) == "wq"  # noqa: E731
    tq = TN.quantize_tree(_port(tree), predicate=pred)
    _assert_tree_equal(tq, JN.quantize_tree(_jax(tree), predicate=jpred))
    again = TN.quantize_tree(tq)
    assert again["layers"][0]["wq"] is tq["layers"][0]["wq"]


def test_dequantize_tree_and_mask_match_jax():
    tree = _tree(2)
    jq = JN.quantize_tree(_jax(tree))
    tq = TN.quantize_tree(_port(tree))
    jd = jax.jit(JN.dequantize_tree)(jq)
    td = TN.dequantize_tree(tq)
    for path in (("layers", 0, "wq"), ("lm_head",), ("moe", "experts")):
        j, t = jd, td
        for p in path:
            j, t = j[p], t[p]
        assert t.dtype == torch.float32 and t.shape == j.shape
        _same(t, j, str(path))
    assert td["layers"][0]["bias"] is tq["layers"][0]["bias"]
    for trainable in (False, True):
        jm = JN.mask_quantized(jq, trainable=trainable)
        tm = TN.mask_quantized(tq, trainable=trainable)
        assert jax.tree_util.tree_leaves(tm) == jax.tree_util.tree_leaves(jm)
        assert tm["layers"][0]["wq"] is trainable and tm["layers"][0]["bias"] is (not trainable)


def _planted(seed, shape, cols, scale=100.0):
    W = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    W[:, cols] *= scale
    return W


@pytest.mark.parametrize("reduction_dim", [0, 1])
def test_find_outlier_dims_matches_jax(reduction_dim):
    W = _planted(3, (96, 96), [3, 40, 77])
    if reduction_dim == 1:
        W = W.T.copy()
    tm = t_find(torch.from_numpy(W), reduction_dim=reduction_dim)
    jm = np.asarray(j_find(jnp.asarray(W), reduction_dim=reduction_dim))
    assert tm.dtype == torch.bool and np.array_equal(tm.numpy(), jm)
    assert tm.nonzero().reshape(-1).tolist() == [3, 40, 77]
    ti = t_find(torch.from_numpy(W), reduction_dim=reduction_dim, topk=5)
    ji = np.asarray(j_find(jnp.asarray(W), reduction_dim=reduction_dim, topk=5))
    assert ti.tolist() == ji.tolist() and set(ti[:3].tolist()) == {3, 40, 77}
    # the norms the mask is drawn from agree within float32 rounding
    tn = torch.linalg.vector_norm(torch.from_numpy(W), dim=reduction_dim).numpy()
    np.testing.assert_allclose(tn, np.asarray(jnp.linalg.norm(jnp.asarray(W), axis=reduction_dim)), rtol=1e-6)


def test_find_outlier_dims_bf16_and_none():
    W = _planted(4, (64, 128), [9], scale=50.0)
    tm = t_find(torch.from_numpy(W).to(torch.bfloat16))
    jm = np.asarray(j_find(jnp.asarray(W, jnp.bfloat16)))
    assert np.array_equal(tm.numpy(), jm) and tm.nonzero().reshape(-1).tolist() == [9]
    flat = np.ones((16, 32), np.float32)
    assert not t_find(torch.from_numpy(flat)).any() and not np.asarray(j_find(jnp.asarray(flat))).any()


def test_outlier_tracer_finds_planted_outliers_as_jax():
    W = _planted(5, (64, 64), [3], scale=100.0)
    tw = torch.from_numpy(W)
    tr = TU.OutlierTracer.get_instance()
    assert tr is TU.OutlierTracer.get_instance() and tr.is_initialized() and tr.initialize(None) is None
    mask = tr.get_outliers(tw)
    jmask = np.asarray(JU.OutlierTracer.get_instance().get_outliers(jnp.asarray(W)))
    assert np.array_equal(mask.numpy(), jmask) and mask.nonzero().reshape(-1).tolist() == [3]
    assert tr.get_outliers(tw) is mask  # memoized by identity


def test_outlier_pool_matches_jax():
    tp, jp = TU.OutlierPool(), JU.OutlierPool()
    feeds = [([5, 1], 64), (torch.tensor([[7], [1]]), 64), (np.array([2]), 32), (torch.tensor([63]), 64)]
    for idx, dim in feeds:
        tp.add_outliers(idx, dim)
        jp.add_outliers(np.asarray(idx), dim)
    got = tp.get_current_outlier_idx()
    assert got.dtype == torch.int64 and got.tolist() == np.asarray(jp.get_current_outlier_idx()).tolist()
    assert got.tolist() == [1, 5, 7, 63] and tp.model_dim == 64


def test_exports_cover_the_jax_names():
    """The names the JAX package's ``utils``, ``nn.parametrize`` and
    ``functional`` export for this slice resolve in the port."""
    jax_utils = set(JU.__all__) - {"native", "device_loop_time", "sol_fraction"}
    assert jax_utils <= set(TU.__all__)
    assert {"quantize_tree", "dequantize_tree", "mask_quantized", "Params4bit", "Int8Params"} <= set(TN.__all__)
    for name in ("create_linear_map", "create_normal_map", "create_fp8_map", "optimizer_update_32bit",
                 "optimizer_update_8bit_blockwise"):
        assert name in TFn.__all__ and name in dir(JFn), name
        assert callable(getattr(TFn, name))
    assert TN.Params4bit is TN.QuantizedTensor and TN.Int8Params is TN.Int8TensorState
