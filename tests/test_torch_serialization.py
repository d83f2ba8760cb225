"""The port's checkpoint interop against the JAX package's, on the CPU.

Weights are drawn and quantized by the JAX package and carried into the port
as numpy (``utils/interop.params_from_numpy``), so that both packages hold
the same quantized tree.  Then, bit for bit:

* ``QuantState.as_dict`` (packed and not; nf4 and fp4; flat, 2d and paired;
  plain and nested) gives the JAX package's arrays and metadata bytes, and
  ``QuantState.from_dict`` of the JAX package's dict dequantizes to the JAX
  package's weight;
* ``state_dict_from_params`` gives the JAX package's key set and arrays on
  ``LlamaConfig.tiny()``: unfused and fused NF4, nested, FP4, LLM.int8(), and
  bf16 ``quant_storage``;
* checkpoints cross between the packages in both directions, npz and
  safetensors, with and without a template; the logits of a reloaded tree
  equal the original's in the package that reloaded it, and the port's stay
  within ``test_torch_llama.py``'s contract of the JAX package's (atol 0.1,
  rtol 0.05);
* the port's safetensors files load with ``safetensors.torch.load_file``, and
  the port reads files that ``safetensors.torch.save_file`` wrote;
* ``import_hf_llama`` with ``quantize=None``, a callable, ``"nf4"``,
  ``"fp4"`` and ``"int8"``, q/k/v biases and tied embeddings, from numpy and
  from torch bf16 state dicts, gives the JAX package's tree.
"""

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from bitsandbytes_tpu.functional import fourbit as JF
from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu.nn.modules import Int8TensorState as JInt8
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.utils import serialization as JS
from bitsandbytes_tpu_torch.functional import fourbit as TF
from bitsandbytes_tpu_torch.functional.quant_state import QuantState, host_array
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.nn import Int8TensorState, QuantizedTensor
from bitsandbytes_tpu_torch.utils import serialization as TS
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy
from test_torch_int8_llama import _np_tree

torch.set_num_threads(1)

JCFG, TCFG = JL.LlamaConfig.tiny(), TL.LlamaConfig.tiny()


def _bytes(x):
    """Any array or tensor (bf16 included) as ``(shape, raw bytes)``."""
    a = np.ascontiguousarray(host_array(x) if isinstance(x, torch.Tensor) else np.asarray(x))
    return a.shape, a.view(np.uint8).tobytes()


def _same(t, j, what=""):
    assert _bytes(t) == _bytes(j), what


def _jax_2d_storage(params):
    """The FSDP-QLoRA form: bf16 quant_storage (layout "2d", uint16 payload),
    double-quantized, unfused."""
    out = dict(params)
    out["layers"] = [
        {k: (JQT.quantize(jnp.asarray(v, jnp.float32), blocksize=64, compress_statistics=True,
                          quant_storage=jnp.bfloat16) if k in JL._LINEAR_NAMES else v) for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


VARIANTS = {
    "nf4": lambda p: JL.quantize_params_4bit(p),
    "nf4_fused": lambda p: JL.quantize_params_4bit(p, fuse=True),
    "nested_fused": lambda p: JL.quantize_params_4bit(p, fuse=True, compress_statistics=True),
    "fp4": lambda p: JL.quantize_params_4bit(p, quant_type="fp4"),
    "int8": lambda p: JL.quantize_params_int8(p),
    "bf16_storage": _jax_2d_storage,
}


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def trees(jparams):
    """{variant: (JAX tree, the port's copy of it)}."""
    out = {}
    for name, fn in VARIANTS.items():
        jq = fn(jparams)
        out[name] = (jq, params_from_numpy(_np_tree(jq), "cpu"))
    return out


def _assert_state_equal(ts, js, what):
    assert (ts.blocksize, ts.quant_type, ts.layout, tuple(ts.shape)) == (
        js.blocksize, js.quant_type, js.layout, tuple(js.shape)), what
    assert str(ts.dtype).removeprefix("torch.") == jnp.dtype(js.dtype).name, what
    _same(ts.absmax, js.absmax, what + " absmax")
    _same(ts.code, js.code, what + " code")
    assert ts.nested == js.nested, what
    if js.nested:
        assert float(ts.offset) == float(js.offset) and ts.offset.dtype == torch.float32, what
        _same(ts.state2.absmax, js.state2.absmax, what + " state2.absmax")
        _same(ts.state2.code, js.state2.code, what + " state2.code")
        assert ts.state2.blocksize == js.state2.blocksize and ts.state2.dynamic_code, what


def _assert_tree_equal(t, j, path=""):
    """The port's tree against the JAX package's, bit for bit.  A payload is
    compared as bytes when the JAX package gives another storage type."""
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _assert_tree_equal(t[k], j[k], f"{path}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_tree_equal(a, b, f"{path}.{i}")
    elif isinstance(j, JQT):
        assert isinstance(t, QuantizedTensor), path
        if t.data.dtype == torch.uint8 or np.asarray(j.data).dtype != np.uint8:
            _same(t.data, j.data, path + " payload")
        else:
            assert TF.payload_bytes(t.data.contiguous()).numpy().tobytes() == np.asarray(j.data).tobytes(), path
        _assert_state_equal(t.state, j.state, path)
    elif isinstance(j, JInt8):
        assert isinstance(t, Int8TensorState), path
        _same(t.CB, j.CB, path + " CB")
        _same(t.SCB, j.SCB, path + " SCB")
    else:
        assert isinstance(t, torch.Tensor) and str(t.dtype).removeprefix("torch.") == np.asarray(j).dtype.name, path
        _same(t, j, path)


# -- QuantState dicts ---------------------------------------------------------

def _quantized_pair(quant_type, layout, nested, dtype=np.float32, seed=0):
    W = np.random.default_rng(seed).standard_normal((64, 256)).astype(np.float32)
    jW = jnp.asarray(W, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    data, state = JF.quantize_4bit(jW, blocksize=64, quant_type=quant_type, compress_statistics=nested,
                                   layout=layout)
    jq = JQT(data=data, state=state)
    return jq, params_from_numpy(_np_tree(jq), "cpu")


def _assert_dicts_equal(td, jd):
    assert set(td) == set(jd)
    for k, jv in jd.items():
        tv = td[k]
        if isinstance(jv, (np.ndarray, jax.Array)):
            assert isinstance(tv, np.ndarray), k
            assert tv.dtype == np.asarray(jv).dtype, k
            _same(tv, jv, k)
        else:
            assert type(tv) is type(jv) and tv == jv, k


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("layout", ["flat", "2d", "paired"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_quant_state_as_dict_matches_jax(quant_type, layout, nested, packed, recwarn):
    jq, tq = _quantized_pair(quant_type, layout, nested)
    jd = jq.state.as_dict(packed=packed)
    td = tq.state.as_dict(packed=packed)
    _assert_dicts_equal(td, jd)
    if packed:
        meta = td[f"quant_state.bitsandbytes__{quant_type}"]
        assert meta.dtype == np.uint8 and json.loads(meta.tobytes())["dtype"] == "float32"
    # a paired state warns, as the JAX package's does
    assert any("paired" in str(w.message) for w in recwarn.list) == (layout == "paired")


def test_quant_state_as_dict_names_bf16():
    jq, tq = _quantized_pair("nf4", "flat", True, dtype="bf16")
    assert jq.state.dtype == jnp.bfloat16 and tq.state.dtype == torch.bfloat16
    _assert_dicts_equal(tq.state.as_dict(packed=True), jq.state.as_dict(packed=True))
    assert tq.state.as_dict()["dtype"] == "bfloat16" and isinstance(tq.state.as_dict()["shape"], tuple)


@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_quant_state_from_jax_dict_dequantizes_as_jax(quant_type, nested):
    """Against the JAX package's jitted dequantize: its eager nested decode
    rounds each product apart (``test_torch_double_quant.py``)."""
    jq, _ = _quantized_pair(quant_type, "flat", nested, seed=1)
    ref = jax.jit(lambda d, s: JF.dequantize_4bit(d, quant_state=s))(jq.data, jq.state)
    for packed in (False, True):
        st = QuantState.from_dict(jq.state.as_dict(packed=packed), device="cpu")
        _assert_state_equal(st, jq.state, f"packed={packed}")
        out = TF.dequantize_4bit(torch.from_numpy(np.array(jq.data)), quant_state=st)
        _same(out, ref)


def test_quant_state_from_dict_rejects_unknown_quant_type():
    jq, tq = _quantized_pair("nf4", "flat", False)
    d = tq.state.as_dict()
    d["quant_type"] = "nf5"
    with pytest.raises(ValueError, match="quant_type"):
        QuantState.from_dict(d, device="cpu")


# -- state dicts --------------------------------------------------------------

@pytest.mark.parametrize("widen", [True, False], ids=["widened", "narrow"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_matches_jax(trees, variant, widen, recwarn):
    jq, tq = trees[variant]
    jsd = JS.state_dict_from_params(jq, widen_ml_dtypes=widen)
    tsd = TS.state_dict_from_params(tq, widen_ml_dtypes=widen)
    assert set(tsd) == set(jsd)
    for k, jv in jsd.items():
        tv = tsd[k]
        assert isinstance(tv, torch.Tensor) and tv.device.type == "cpu", k
        assert str(tv.dtype).removeprefix("torch.") == jv.dtype.name, k
        _same(tv, jv, k)
    if variant == "bf16_storage":
        assert tsd["layers.0.wq"].dtype == torch.uint16 and tsd["layers.0.wq"].shape[1] == 1
    if variant == "int8":
        assert tsd["layers.0.wq"].dtype == torch.int8 and tsd["layers.0.wq.SCB"].dtype == torch.float32
    if variant == "nested_fused":
        for comp in ("absmax", "quant_map", "nested_absmax", "nested_quant_map", "quant_state.bitsandbytes__nf4"):
            assert f"layers.1.wqkv.{comp}" in tsd
    assert not [w for w in recwarn.list if "paired" in str(w.message)], "serialization relays paired payloads first"


# -- checkpoints across the packages -----------------------------------------

IDS = np.random.default_rng(1).integers(0, JCFG.vocab_size, size=(1, 8))


def _port_logits(tree):
    return TL.forward(tree, torch.from_numpy(IDS), TCFG)[0].detach().to(torch.float32).numpy()


def _jax_logits(tree):
    return np.asarray(JL.forward(tree, jnp.asarray(IDS), JCFG)[0], np.float32)


def _jax_save(fmt, path, tree):
    if fmt == "npz":
        JS.save_checkpoint(path, tree)
    else:
        JS.save_checkpoint_safetensors(path, tree, metadata={"format": "pt"})


def _jax_load(fmt, path, template):
    return (JS.load_checkpoint if fmt == "npz" else JS.load_checkpoint_safetensors)(path, template)


def _port_save(fmt, path, tree):
    if fmt == "npz":
        TS.save_checkpoint(path, tree)
    else:
        TS.save_checkpoint_safetensors(path, tree, metadata={"format": "pt"})


def _port_load(fmt, path, template=None):
    return (TS.load_checkpoint if fmt == "npz" else TS.load_checkpoint_safetensors)(path, template, device="cpu")


@pytest.fixture(scope="module")
def jax_logits(trees):
    return {name: _jax_logits(jq) for name, (jq, _) in trees.items()}


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
@pytest.mark.parametrize("variant", ["nf4_fused", "nested_fused", "int8", "bf16_storage"])
def test_jax_writes_port_reads(tmp_path, trees, jax_logits, variant, fmt):
    jq, tq = trees[variant]
    path = str(tmp_path / f"ckpt.{fmt}")
    _jax_save(fmt, path, jq)
    loaded = _port_load(fmt, path, template=tq)
    _assert_tree_equal(loaded, jq)  # every leaf as the template holds it, payload type included
    lt = _port_logits(loaded)
    np.testing.assert_array_equal(lt, _port_logits(tq))
    np.testing.assert_allclose(lt, jax_logits[variant], atol=0.1, rtol=0.05)
    # without a template: the folded flat dict, as the JAX package folds it
    flat_t = _port_load(fmt, path)
    flat_j = _jax_load(fmt, path, None)
    assert set(flat_t) == set(flat_j)
    for k, jv in flat_j.items():
        _assert_tree_equal(flat_t[k], jv, k)


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
@pytest.mark.parametrize("variant", ["nf4_fused", "nested_fused", "int8", "bf16_storage"])
def test_port_writes_jax_reads(tmp_path, trees, jax_logits, variant, fmt):
    jq, tq = trees[variant]
    path = str(tmp_path / f"ckpt.{fmt}")
    _port_save(fmt, path, tq)
    loaded = _jax_load(fmt, path, jq)
    if variant == "bf16_storage":
        # the JAX package hands a wider storage back as uint8 bytes
        for layer in loaded["layers"]:
            assert all(np.asarray(layer[k].data).dtype == np.uint8 for k in JL._LINEAR_NAMES)
    _assert_tree_equal(tq, loaded)
    np.testing.assert_array_equal(_jax_logits(loaded), jax_logits[variant])
    # and the port reads its own file back to the same tree
    again = _port_load(fmt, path, template=tq)
    _assert_tree_equal(again, jq)
    np.testing.assert_array_equal(_port_logits(again), _port_logits(tq))


def test_port_and_jax_write_the_same_npz_members(tmp_path, trees):
    jq, tq = trees["nested_fused"]
    _port_save("npz", str(tmp_path / "t.npz"), tq)
    _jax_save("npz", str(tmp_path / "j.npz"), jq)
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert set(zt.files) == set(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].tobytes() == zj[k].tobytes(), k


def test_bf16_storage_template_keeps_uint16(tmp_path, trees):
    """The port hands a bf16-storage payload back in the template's uint16
    [N, K/4]; the JAX package, in uint8 [N, K/2] (the same bytes)."""
    jq, tq = trees["bf16_storage"]
    path = str(tmp_path / "c.safetensors")
    TS.save_checkpoint_safetensors(path, tq)
    t = TS.load_checkpoint_safetensors(path, tq, device="cpu")["layers"][0]["wq"]
    j = JS.load_checkpoint_safetensors(path, jq)["layers"][0]["wq"]
    ref = tq["layers"][0]["wq"]
    assert t.data.dtype == torch.uint16 and t.data.shape == ref.data.shape and torch.equal(t.data, ref.data)
    assert np.asarray(j.data).dtype == np.uint8 and np.asarray(j.data).shape == (ref.data.shape[0], ref.data.shape[1] * 2)
    assert TF.payload_bytes(t.data).numpy().tobytes() == np.asarray(j.data).tobytes()


def test_missing_key_and_wrong_leaf_raise(tmp_path, trees):
    _, tq = trees["nf4_fused"]
    sd = TS.state_dict_from_params(tq)
    with pytest.raises(KeyError, match="final_norm"):
        TS.params_from_state_dict({k: v for k, v in sd.items() if k != "final_norm"}, tq, device="cpu")
    _, t8 = trees["int8"]
    with pytest.raises(TypeError, match="expected int8 leaf"):
        TS.params_from_state_dict(TS.state_dict_from_params(trees["nf4"][1]), t8, device="cpu")
    with pytest.raises(TypeError, match="expected quantized leaf"):
        TS.params_from_state_dict(TS.state_dict_from_params(t8), trees["nf4"][1], device="cpu")


# -- the safetensors format ---------------------------------------------------

def test_port_file_loads_with_safetensors(tmp_path, trees):
    _, tq = trees["nested_fused"]
    path = str(tmp_path / "p.safetensors")
    size = TS.save_checkpoint_safetensors(path, tq, metadata={"format": "pt", "note": "x"})
    assert size == os.path.getsize(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = f.read(n)
    assert n % 8 == 0 and json.loads(header)["__metadata__"] == {"format": "pt", "note": "x"}
    ref = TS.state_dict_from_params(tq, widen_ml_dtypes=False)
    got = st_load_file(path)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and _bytes(got[k]) == _bytes(v), k
    assert got["embed"].dtype == torch.bfloat16


def test_port_reads_safetensors_files(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=g),
        "u8": torch.randint(0, 256, (9,), generator=g, dtype=torch.uint8),
        "i8": torch.randint(-128, 128, (4, 4), generator=g, dtype=torch.int8),
        "u16": torch.randint(0, 1 << 15, (6,), generator=g, dtype=torch.int32).to(torch.uint16),
        "i32": torch.randint(-1000, 1000, (3,), generator=g, dtype=torch.int32),
        "u32": torch.randint(0, 1 << 30, (5,), generator=g, dtype=torch.int64).to(torch.uint32),
        "i64": torch.randint(-1000, 1000, (2, 2), generator=g, dtype=torch.int64),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "s.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt"})
    got, meta = TS.read_safetensors(path)
    assert meta == {"format": "pt"} and set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert _bytes(got[k]) == _bytes(v), k
    # and the port's writer round-trips the same dict through the package's reader
    path2 = str(tmp_path / "w.safetensors")
    TS.write_safetensors(path2, tensors)
    back = st_load_file(path2)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and _bytes(back[k]) == _bytes(v), k


def test_write_safetensors_refuses_what_it_cannot_store(tmp_path):
    with pytest.raises(ValueError, match="no type"):
        TS.write_safetensors(str(tmp_path / "x.safetensors"), {"c": torch.zeros(2, dtype=torch.float64)})
    with pytest.raises(TypeError, match="str to str"):
        TS.write_safetensors(str(tmp_path / "x.safetensors"), {"a": torch.zeros(2)}, metadata={"a": 1})


# -- import_hf_llama ----------------------------------------------------------

def _hf_state_dict(cfg, seed, torch_bf16=False, bias=False, tied=True, prefix="model."):
    rng = np.random.default_rng(seed)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"self_attn.q_proj": (H * hd, D), "self_attn.k_proj": (KVH * hd, D), "self_attn.v_proj": (KVH * hd, D),
              "self_attn.o_proj": (D, H * hd), "mlp.gate_proj": (F, D), "mlp.up_proj": (F, D),
              "mlp.down_proj": (D, F)}
    sd = {}
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}."
        for name, shape in shapes.items():
            sd[p + name + ".weight"] = (rng.standard_normal(shape) * shape[1] ** -0.5).astype(np.float32)
            if bias and name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
                sd[p + name + ".bias"] = (0.1 * rng.standard_normal(shape[0])).astype(np.float32)
        sd[p + "input_layernorm.weight"] = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
        sd[p + "post_attention_layernorm.weight"] = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    sd[prefix + "embed_tokens.weight"] = (rng.standard_normal((V, D)) * D**-0.5).astype(np.float32)
    sd[prefix + "norm.weight"] = np.ones(D, np.float32)
    if not tied:
        sd["lm_head.weight"] = (rng.standard_normal((V, D)) * D**-0.5).astype(np.float32)
    if torch_bf16:
        sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    return sd


def _jax_fp4_callable(W):
    return JQT.quantize(W, quant_type="fp4", blocksize=128)


def _port_fp4_callable(W):
    assert W.dtype == torch.float32
    return QuantizedTensor.quantize(W, quant_type="fp4", blocksize=128)


@pytest.mark.parametrize("source", ["numpy_f32", "torch_bf16"])
@pytest.mark.parametrize("mode", [None, "callable", "nf4", "fp4", "int8"])
def test_import_hf_llama_matches_jax(mode, source):
    sd = _hf_state_dict(JCFG, seed=3, torch_bf16=source == "torch_bf16")
    jq = {"callable": _jax_fp4_callable}.get(mode, mode)
    tqz = {"callable": _port_fp4_callable}.get(mode, mode)
    jt = JS.import_hf_llama(sd, JCFG, quantize=jq)
    tt = TS.import_hf_llama(sd, TCFG, quantize=tqz, device="cpu")
    _assert_tree_equal(tt, jt)
    assert tt["lm_head"] is tt["embed"]  # tied
    leaf = tt["layers"][0]["wq"]
    if mode in ("nf4", "fp4"):
        assert leaf.state.layout == "paired" and leaf.state.dtype == torch.float32
    if mode == "int8":
        assert isinstance(leaf, Int8TensorState)
    if source == "torch_bf16" and mode in ("nf4", "fp4"):
        # a bf16 weight quantizes uncast: the codes of its float32 cast
        ref = QuantizedTensor.quantize(sd["model.layers.0.self_attn.q_proj.weight"].to(torch.float32),
                                       quant_type=mode)
        assert torch.equal(leaf.data, ref.data) and torch.equal(leaf.state.absmax, ref.state.absmax)


def test_import_hf_llama_biases_untied_and_unprefixed():
    cfg_j = dataclasses.replace(JCFG, attn_bias=True)
    cfg_t = dataclasses.replace(TCFG, attn_bias=True)
    sd = _hf_state_dict(JCFG, seed=4, bias=True, tied=False, prefix="")
    jt = JS.import_hf_llama(sd, cfg_j, quantize="nf4")
    tt = TS.import_hf_llama(sd, cfg_t, quantize="nf4", device="cpu")
    _assert_tree_equal(tt, jt)
    assert {"wq_b", "wk_b", "wv_b"} <= set(tt["layers"][1]) and tt["lm_head"] is not tt["embed"]
    ids = np.random.default_rng(5).integers(0, JCFG.vocab_size, size=(1, 8))
    lt = TL.forward(tt, torch.from_numpy(ids), cfg_t)[0].to(torch.float32).numpy()
    lj = np.asarray(JL.forward(jt, jnp.asarray(ids), cfg_j)[0], np.float32)
    np.testing.assert_allclose(lt, lj, atol=0.1, rtol=0.05)


def test_import_hf_llama_rejects_unknown_mode_and_missing_keys():
    sd = _hf_state_dict(JCFG, seed=6)
    with pytest.raises(ValueError, match="nf4"):
        TS.import_hf_llama(sd, TCFG, quantize="int4", device="cpu")
    del sd["model.norm.weight"]
    with pytest.raises(KeyError, match="norm.weight"):
        TS.import_hf_llama(sd, TCFG, device="cpu")
