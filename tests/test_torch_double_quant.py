"""The port's double-quantized absmax (``compress_statistics``) against the
JAX package: the nested decode, ``quantize_4bit``, the ``_dq`` kernels' plain
versions against the JAX package's Pallas ``_dq`` kernels (interpret mode),
the routing of ``matmul_4bit``, relayout and interop.

The nested decode is held bit for bit to the JAX package's *jitted*
``dequant_absmax``: XLA contracts ``(idx - start) * step + first`` and
``v * s2 + offset`` into fused multiply-adds when it compiles, and its eager
call rounds each product apart, which differs in the last bit on a few
percent of the scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_tpu as jbnb
import bitsandbytes_tpu.functional as JF
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.gemm4bit_paired import (
    dequantize_paired_fast_dq as j_dequantize_paired_fast_dq,
    gemm_4bit_paired_dq as j_gemm_4bit_paired_dq,
)
import bitsandbytes_tpu_torch as tbnb
from bitsandbytes_tpu_torch.functional import fourbit as TF
from bitsandbytes_tpu_torch.functional import gemm as tgemm
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.functional.dynamic_segments import fma_f32
from bitsandbytes_tpu_torch.nn import LinearNF4
from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor as TQT
from bitsandbytes_tpu_torch.ops.gemm4bit_paired import (
    dequantize_paired_fast,
    dequantize_paired_fast_dq,
    gemm_4bit_paired,
    gemm_4bit_paired_dq,
)
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

# [512, 1024] bs 64, and the straddle shape: KB = 24 does not divide 256,
# so a column's first-level blocks cross second-level boundaries
SHAPES = {"512x1024_bs64": (512, 1024, 64), "straddle_64x768_bs32": (64, 768, 32)}


def _nested(shape_id, seed=0):
    N, K, bs = SHAPES[shape_id]
    W = (np.random.default_rng(seed).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=bs, layout="paired", compress_statistics=True)
    assert jq.state.nested and jq.state.layout == "paired"
    return W, jq


def _as_dict(jq):
    st = jq.state
    d = {
        "data": np.asarray(jq.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
        "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout,
        "code": np.asarray(st.code), "dtype": jnp.dtype(st.dtype).name,
    }
    if st.nested:
        d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                 nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
    return d


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_dequant_absmax_bit_identical_to_jitted(shape_id):
    _, jq = _nested(shape_id)
    tq = params_from_numpy(_as_dict(jq), "cpu")
    assert tq.state.absmax.dtype == torch.uint8 and tq.state.inline_nested
    ref = np.asarray(jax.jit(lambda s: s.dequant_absmax())(jq.state))
    np.testing.assert_array_equal(_bits(tq.state.dequant_absmax().numpy()), _bits(ref))
    # the eager JAX decode rounds each product apart: not the contract
    assert (np.asarray(jq.state.dequant_absmax()) != ref).any()
    rs_ref = jax.jit(lambda s: s.resolve_nested())(jq.state)
    rs = tq.resolve_nested().state
    assert not rs.nested and rs.absmax.dtype == torch.float32 and rs.absmax.is_contiguous()
    np.testing.assert_array_equal(_bits(rs.absmax.numpy()), _bits(rs_ref.absmax))


@pytest.mark.parametrize("layout", ["paired", "flat"])
def test_quantize_4bit_compress_statistics_contract(layout):
    """Against the JAX package's ``quantize_4bit(compress_statistics=True)``:
    the 4-bit payload is bit-identical; the offset is the correctly rounded
    mean of the absmax, and within 1 ulp of the JAX package's (a float32
    ``jnp.mean``, which may land a few ulp from the exact mean on other
    inputs: see ``test_torch_blockwise.test_nested_matches_jax``); the second-level
    scales within rel 1e-6; the uint8 absmax codes equal on at least 99.9% of
    the entries, each mismatch one step (a last-bit offset moves a value
    that sits on a rounding midpoint)."""
    W = (np.random.default_rng(1).standard_normal((256, 1024)) / 32).astype(np.float32)
    jp, js = JF.quantize_4bit(jnp.asarray(W), blocksize=64, layout=layout, compress_statistics=True)
    tp, ts = TF.quantize_4bit(torch.from_numpy(W), blocksize=64, layout=layout, compress_statistics=True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert ts.nested and ts.layout == layout and ts.absmax.dtype == torch.uint8
    assert tuple(ts.absmax.shape) == tuple(js.absmax.shape)
    am = np.abs(W.reshape(-1, 64)).max(axis=1).astype(np.float64)
    assert ts.offset.numpy() == np.float32(am.sum() / am.size)
    ulps = abs(int(np.asarray(js.offset, np.float32).view(np.int32)) - int(ts.offset.numpy().view(np.int32)))
    assert ulps <= 1
    np.testing.assert_allclose(ts.state2.absmax.numpy(), np.asarray(js.state2.absmax), rtol=1e-6)
    jc, tc = np.asarray(js.absmax).astype(int), ts.absmax.numpy().astype(int)
    assert (jc == tc).mean() >= 0.999 and np.abs(jc - tc).max() <= 1
    # dequantize goes through the nested decode
    np.testing.assert_allclose(
        TF.dequantize_4bit(tp, quant_state=ts).numpy(),
        np.asarray(JF.dequantize_4bit(jp, quant_state=js)), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_gemm_dq_plain_matches_pallas_and_resolved(shape_id):
    N, K, bs = SHAPES[shape_id]
    _, jq = _nested(shape_id, seed=2)
    st = jq.state
    code = get_4bit_code("nf4", bs)
    A = jnp.asarray(np.random.default_rng(3).standard_normal((4, K)), jnp.bfloat16)
    ref = np.asarray(j_gemm_4bit_paired_dq(
        A, jq.data, st.absmax, st.state2.absmax, st.offset, code=code, blocksize=bs,
        shapeB=(N, K), out_dtype=jnp.float32,
    ))
    tq = params_from_numpy(_as_dict(jq), "cpu")
    ts = tq.state
    tA = tensor_from_numpy(np.asarray(A), "cpu")
    out = gemm_4bit_paired_dq(tA, tq.data, ts.absmax, ts.state2.absmax, ts.offset, code, bs, (N, K),
                              out_dtype=torch.float32).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    res = gemm_4bit_paired(tA, tq.data, ts.dequant_absmax_t(), code, bs, (N, K), out_dtype=torch.float32)
    np.testing.assert_array_equal(_bits(out), _bits(res.numpy()))


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_dequantize_dq_bit_identical(shape_id):
    N, K, bs = SHAPES[shape_id]
    _, jq = _nested(shape_id, seed=4)
    st = jq.state
    code = get_4bit_code("nf4", bs)
    ref = j_dequantize_paired_fast_dq(
        jq.data, st.absmax, st.state2.absmax, st.offset, code=tuple(float(x) for x in code),
        blocksize=bs,
    )
    tq = params_from_numpy(_as_dict(jq), "cpu")
    ts = tq.state
    out = dequantize_paired_fast_dq(tq.data, ts.absmax, ts.state2.absmax, ts.offset, code, bs)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (N, K)
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    res = dequantize_paired_fast(tq.data, ts.dequant_absmax_t(), code, bs)
    assert torch.equal(out.view(torch.int16), res.view(torch.int16))


@pytest.mark.parametrize("M", [4, 512], ids=["decode", "large_m"])
def test_matmul_4bit_nested_routes_match_jax(M, monkeypatch):
    """M = 4 runs the ``_dq`` GEMM on both sides, M = 512 the ``_dq``
    dequantize + matmul; the port never decodes the absmax ahead of them."""
    N, K, bs = 256, 512, 64
    W = (np.random.default_rng(5).standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=bs, compress_statistics=True)
    x = jnp.asarray(np.random.default_rng(6).standard_normal((M, K)), jnp.bfloat16)
    try:
        dispatch.set_backend("pallas")
        ref = np.asarray(jbnb.matmul_4bit(x, jq.data, jq.state), np.float32)
    finally:
        dispatch.set_backend("auto")
    tq = params_from_numpy(_as_dict(jq), "cpu")
    assert (M >= tgemm.LARGE_M_THRESHOLD) == (M == 512)

    def no_decode(self):
        raise AssertionError("the nested absmax was decoded ahead of the kernel")

    monkeypatch.setattr(type(tq.state), "dequant_absmax_t", no_decode)
    out = tbnb.matmul_4bit(tensor_from_numpy(np.asarray(x), "cpu"), tq.data, tq.state)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref, rtol=3e-2, atol=3e-2)


def test_non_canonical_nested_map_takes_the_resolved_route():
    """A nested state over another map decodes its absmax by table lookup
    and runs the plain-absmax kernels."""
    N, K, bs = 64, 256, 64
    W = torch.from_numpy((np.random.default_rng(7).standard_normal((N, K)) / 16).astype(np.float32))
    tq = TQT.quantize(W, blocksize=bs, compress_statistics=True)
    st = tq.state
    st.state2.code = st.state2.code.clone()
    st.state2.dynamic_code = False  # as if the map were another one
    assert not st.inline_nested
    x = torch.randn(3, K, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = tbnb.matmul_4bit(x, tq.data, st)
    absmax_t = st.dequant_absmax_t()
    ref = gemm_4bit_paired(x, tq.data, absmax_t, get_4bit_code("nf4", bs), bs, (N, K))
    assert torch.equal(out, ref)
    exp = (st.state2.code[st.absmax.t().reshape(-1).long()] * st.state2.absmax.repeat_interleave(256)[: N * K // bs]
           + st.offset)
    assert torch.equal(absmax_t.t().reshape(-1), exp)


def test_to_layout_round_trip_nested():
    W = (np.random.default_rng(8).standard_normal((128, 512)) / 22).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=64, compress_statistics=True)
    tq = TQT.quantize(torch.from_numpy(W), blocksize=64, compress_statistics=True)
    assert tq.state.layout == "paired" and tuple(tq.state.absmax.shape) == (512 // 64, 128)
    tf, jf = tq.to_layout("flat"), jq.to_layout("flat")
    assert tf.state.absmax.dtype == torch.uint8 and tuple(tf.state.absmax.shape) == (128 * 512 // 64,)
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    back = tf.to_layout("paired")
    assert torch.equal(back.data, tq.data) and torch.equal(back.state.absmax, tq.state.absmax)
    assert back.state.absmax.is_contiguous()
    assert torch.equal(tf.state.dequant_absmax(), tq.state.dequant_absmax())
    assert torch.equal(tf.dequantize(), tq.dequantize())


def test_interop_nested_tree_and_unknown_keys():
    _, jq = _nested("straddle_64x768_bs32", seed=9)
    d = _as_dict(jq)
    tree = params_from_numpy({"layers": [{"w": d, "norm": np.ones(4, np.float32)}]}, "cpu")
    tw = tree["layers"][0]["w"]
    assert isinstance(tw, TQT) and tw.state.inline_nested
    assert tw.state.absmax.dtype == torch.uint8
    np.testing.assert_array_equal(tw.state.absmax.numpy(), np.asarray(jq.state.absmax))
    np.testing.assert_array_equal(tw.state.state2.absmax.numpy(), np.asarray(jq.state.state2.absmax))
    assert tw.state.offset.dtype == torch.float32 and tw.state.offset.numel() == 1
    with pytest.raises(ValueError, match="unknown keys"):
        params_from_numpy({**d, "quant_storage": "uint8"}, "cpu")
    with pytest.raises(ValueError, match="nested state needs"):
        params_from_numpy({k: v for k, v in d.items() if k != "offset"}, "cpu")


def test_linear4bit_compress_statistics():
    lin = LinearNF4(256, 128, bias=False, compress_statistics=True, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert lin.weight.state.inline_nested and "compress_statistics=True" in lin.extra_repr()
    x = torch.randn(2, 256, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    W = lin.weight.dequantize().to(torch.bfloat16)
    np.testing.assert_allclose(lin(x).float().numpy(), (x.float() @ W.float().t()).numpy(),
                               rtol=2e-2, atol=2e-2)
    plain = lin.weight.resolve_nested()
    assert torch.equal(tbnb.matmul_4bit(x, plain.data, plain.state), lin(x))


def test_fma_f32_rounds_once():
    """One rounding of the exact ``a * b + c``, also where the float64 sum
    lands on a float32 midpoint and only its rounding error decides (ties
    to even would pick the other side in the first two cases)."""
    from fractions import Fraction

    cases = [  # (a, b, c), each a float32 value
        (1 + 2**-23, 1 - 2**-24, 2**-47 * (1 + 2**-23)),  # just above 1 + 2**-24
        (1 + 2**-22, 1 - 2**-24, 2**-46 * (1 - 2**-24)),  # just below 1 + 1.5 * 2**-23
        (1.0, 1.0, 2**-24),  # exactly on the midpoint: ties to even
    ]
    want = [1 + 2**-23, 1 + 2**-23, 1.0]
    a, b, c = (torch.tensor(col, dtype=torch.float32) for col in zip(*cases))
    got = fma_f32(a, b, c)
    assert got.tolist() == want
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(300).astype(np.float32) for _ in range(2))
    c = (rng.standard_normal(300) * 1e-3).astype(np.float32)
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(g)) - exact)
        for nb in (np.nextafter(g, np.float32(-np.inf)), np.nextafter(g, np.float32(np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact)
