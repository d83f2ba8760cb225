"""The port's LLM.int8() functional ops (``functional/int8.py``) against the
JAX package's, on the CPU.

Contract: the int8 codes, the row and column statistics, the outlier mask
and the int32 product bit for bit; the float epilogues within float32
rounding (the JAX suite holds them to its own error budgets,
``tests/test_functional.py``).  Inputs are ragged (K and N off multiples
of 8), have leading dimensions, an all-zero row, a column of outliers only
and planted outliers, at thresholds 0 and 6.  The padding that
``torch._int_mm`` needs on CUDA (more than 16 rows, K and N multiples of 8)
runs on the CPU too (``int_mm_padded``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu.functional import int8 as JI
from bitsandbytes_tpu_torch import functional as TF
from bitsandbytes_tpu_torch.functional import int8 as TI

torch.set_num_threads(1)

SHAPES = [(48, 128), (3, 5, 37), (1, 64), (7, 200)]


def _a(shape, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape).astype(np.float32)
    A2 = A.reshape(-1, shape[-1])
    A2[min(1, A2.shape[0] - 1)] = 0.0  # an all-zero row
    A2[:, 3] = 9.0 * np.sign(rng.standard_normal(A2.shape[0]) + 0.5)  # a column of outliers only
    A2[0, shape[-1] - 2] = -50.0  # a planted outlier
    return A


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_exports_match_the_jax_package():
    for name in JI.__all__:
        assert callable(getattr(TF, name)), name


@pytest.mark.parametrize("threshold", [0.0, 6.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vectorwise_quant_bit_identical(shape, threshold):
    A = _a(shape, 1)
    jq, js, jm = JI.int8_vectorwise_quant(jnp.asarray(A), threshold=threshold)
    tq, ts, tm = TI.int8_vectorwise_quant(torch.from_numpy(A), threshold=threshold)
    assert tq.dtype == torch.int8 and tq.shape == A.shape and ts.shape == A.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    if threshold == 0.0:
        assert tm is None and jm is None
    else:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert tm[3] and (tq.reshape(-1, shape[-1])[:, 3] == 0).all()
    # the all-zero row: codes 0 (NaN before the cast in both packages)
    assert (tq.reshape(-1, shape[-1])[min(1, tq.reshape(-1, shape[-1]).shape[0] - 1)][4:-2] == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vectorwise_quant_bf16_input(shape):
    A = jnp.asarray(_a(shape, 2)).astype(jnp.bfloat16)
    jq, js, _ = JI.int8_vectorwise_quant(A)
    tA = torch.from_numpy(np.asarray(A.astype(jnp.float32))).to(torch.bfloat16)
    tq, ts, _ = TI.int8_vectorwise_quant(tA)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vectorwise_dequant_bit_identical(shape):
    A = _a(shape, 3)
    jq, js, _ = JI.int8_vectorwise_quant(jnp.asarray(A))
    ref = JI.int8_vectorwise_dequant(jq, js)
    out = TI.int8_vectorwise_dequant(torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(js)))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("threshold", [0.0, 6.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_double_quant_bit_identical(shape, threshold):
    A = _a(shape, 4)
    ref = JI.int8_double_quant(jnp.asarray(A), threshold=threshold)
    out = TI.int8_double_quant(torch.from_numpy(A), threshold=threshold)
    assert len(out) == 5
    for i, (t, j) in enumerate(zip(out, ref)):
        if j is None:
            assert t is None
            continue
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, i
        if t.dtype == np.float32:
            np.testing.assert_array_equal(_bits(t), _bits(j))
        else:
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (8, 37, 19), (17, 16, 8), (33, 200, 70), (5, 3, 2)])
def test_linear_matmul_bit_identical(M, K, N):
    rng = np.random.default_rng(M * K + N)
    A = rng.integers(-127, 128, (M, K), dtype=np.int8)
    B = rng.integers(-127, 128, (N, K), dtype=np.int8)
    ref = np.asarray(JI.int8_linear_matmul(jnp.asarray(A), jnp.asarray(B)))
    out = TI.int8_linear_matmul(torch.from_numpy(A), torch.from_numpy(B))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # leading dimensions, and transposed (non-contiguous) operands
    A3 = A.reshape(1, M, K)
    np.testing.assert_array_equal(TI.int8_linear_matmul(torch.from_numpy(A3), torch.from_numpy(B)).numpy(),
                                  ref.reshape(1, M, N))
    Bt = torch.from_numpy(np.ascontiguousarray(B.T)).t()
    np.testing.assert_array_equal(TI.int8_linear_matmul(torch.from_numpy(A), Bt).numpy(), ref)
    np.testing.assert_array_equal(TI.int_mm_padded(torch.from_numpy(A), Bt).numpy(), ref)


def test_linear_matmul_rejects_other_types():
    with pytest.raises(ValueError):
        TI.int8_linear_matmul(torch.zeros(2, 8), torch.zeros(4, 8, dtype=torch.int8))
    with pytest.raises(ValueError):
        TI.int8_linear_matmul(torch.zeros(2, 8, dtype=torch.int8), torch.zeros(4, 9, dtype=torch.int8))


_DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]


def _close(t: torch.Tensor, j, tdt):
    """Float32 rounding of the epilogue: equal after the cast but for values
    within one unit of the output type."""
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.to(torch.float32).numpy()
    rtol = {torch.float32: 1e-6, torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11}[tdt]
    np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtypes", _DTYPES, ids=["f32", "bf16", "f16"])
def test_scaled_mm_and_mm_dequant_match(dtypes, bias):
    jdt, tdt = dtypes
    rng = np.random.default_rng(6)
    A = rng.standard_normal((3, 4, 40)).astype(np.float32)
    W = rng.standard_normal((19, 40)).astype(np.float32)
    b = rng.standard_normal(19).astype(np.float32) if bias else None
    qa, sa, _ = JI.int8_vectorwise_quant(jnp.asarray(A))
    qb, sb, _ = JI.int8_vectorwise_quant(jnp.asarray(W))
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    jb, tb = (None, None) if b is None else (jnp.asarray(b), torch.from_numpy(b))
    ref = JI.int8_scaled_mm(qa, qb, sa, sb, bias=jb, dtype=jdt)
    out = TI.int8_scaled_mm(t(qa), t(qb), t(sa), t(sb), bias=tb, dtype=tdt)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    _close(out, ref, tdt)
    i32 = JI.int8_linear_matmul(qa, qb)
    ref = JI.int8_mm_dequant(i32, sa, sb, dtype=jdt, bias=jb)
    _close(TI.int8_mm_dequant(t(i32), t(sa), t(sb), dtype=tdt, bias=tb), ref, tdt)
    if not bias:  # the epilogue's float32 order is the JAX package's
        ref32 = JI.int8_mm_dequant(i32, sa, sb, dtype=jnp.float32)
        np.testing.assert_array_equal(_bits(TI.int8_mm_dequant(t(i32), t(sa), t(sb), dtype=torch.float32)),
                                      _bits(ref32))


@pytest.mark.parametrize("dtypes", _DTYPES, ids=["f32", "bf16", "f16"])
def test_mixed_scaled_mm_matches(dtypes):
    """The outlier columns in floats: the JAX test's planted column, and the
    budget of the JAX suite (``test_int8_mixed_scaled_mm_outliers``) against
    the float product."""
    jdt, tdt = dtypes
    rng = np.random.RandomState(1)
    A = rng.randn(16, 64).astype(np.float32)
    A[:, 5] *= 30.0
    A[2, 40] = -20.0
    B = rng.randn(32, 64).astype(np.float32)
    qa, sa, mask = JI.int8_vectorwise_quant(jnp.asarray(A), threshold=6.0)
    qb, sb, _ = JI.int8_vectorwise_quant(jnp.asarray(B))
    ref = JI.int8_mixed_scaled_mm(qa, jnp.asarray(A), qb, sa, sb, outlier_cols=mask, dtype=jdt)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    out = TI.int8_mixed_scaled_mm(t(qa), torch.from_numpy(A), t(qb), t(sa), t(sb), outlier_cols=t(mask), dtype=tdt)
    assert out.dtype == tdt
    j = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    o = out.to(torch.float32).numpy()
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}[tdt]
    np.testing.assert_allclose(o, j, rtol=rtol, atol=rtol * np.abs(j).max())
    exact = A @ B.T
    assert np.abs(o - exact).mean() / np.abs(exact).mean() < 0.02
    none = TI.int8_mixed_scaled_mm(t(qa), torch.from_numpy(A), t(qb), t(sa), t(sb), dtype=tdt)
    assert torch.equal(none, TI.int8_scaled_mm(t(qa), t(qb), t(sa), t(sb), dtype=tdt))
