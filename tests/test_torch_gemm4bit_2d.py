"""The port's K-adjacent 4-bit layout (``"flat"``/``"2d"``, kernels 9, 10 and
11 of ``ops/gemm4bit.py``) and ``quant_storage`` against the JAX package, on
the CPU, where the port runs the kernels' plain versions.

Contracts (the port dequantizes with the exact f32 product ``code * absmax``,
as the reference library and the JAX package's default tier do):

* kernel 10's plain version gives the JAX package's default tier bit for
  bit, and the JAX kernel (interpret mode) within 2^-16 relative: the TPU
  kernels rebuild each scale as bf16 hi + lo;
* kernel 9's plain version with f32 A is within 2^-16 of the JAX kernel
  (interpret mode) relative to the largest output; with bf16 A it is held to
  the JAX package's default tier (dequantize, then an f32-accumulated
  product), since the JAX kernel cannot run bf16 operands in interpret mode
  on the CPU; bf16 outputs within one bf16 step of the largest;
* kernel 11's plain version is within 2^-16 of the JAX kernel with f32 g,
  within one bf16 step with bf16 g;
* every ``quant_storage`` gives the JAX package's payload bytes and shape;
  ``to_layout`` round-trips from a wider storage; ``matmul_4bit`` forward
  and ``grad_A`` on 2d states, plain and nested, match the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitsandbytes_tpu import autograd as JA
from bitsandbytes_tpu.functional import fourbit as JF
from bitsandbytes_tpu.functional import gemm as JG
from bitsandbytes_tpu.nn.modules import QuantizedTensor as JQT
from bitsandbytes_tpu.ops import dispatch
from bitsandbytes_tpu.ops.pallas.gemm4bit import (
    dequantize_4bit_pallas as j_dequantize_4bit_pallas,
    gemm_4bit_fused as j_gemm_4bit_fused,
    gemm_4bit_nt_fused as j_gemm_4bit_nt_fused,
)
from bitsandbytes_tpu_torch import autograd as TA
from bitsandbytes_tpu_torch.functional import fourbit as TF
from bitsandbytes_tpu_torch.functional import gemm as TG
from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
from bitsandbytes_tpu_torch.nn import Linear4bit, QuantizedTensor
from bitsandbytes_tpu_torch.ops.gemm4bit import (
    dequantize_4bit_2d,
    gemm_2d_supported,
    gemm_4bit_fused,
    gemm_4bit_nt_fused,
)
from bitsandbytes_tpu_torch.utils.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

N, K, BS = 256, 512, 64
REL = 2.0**-16  # the JAX kernels' hi + lo scale keeps about 16 bits of the absmax
BF16_STEP = 2.0**-7


def _payload(seed, n=N, k=K, bs=BS):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    B = ((q[:, 0::2] << 4) | q[:, 1::2]).astype(np.uint8)
    absmax = (rng.random(n * k // bs) * 2 + 0.1).astype(np.float32)
    return B, absmax


def _code(quant_type, bs=BS):
    return tuple(float(x) for x in get_4bit_code(quant_type, bs))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16).numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequantize_plain_bit_identical_to_jax_default_tier(quant_type, dtype):
    B, absmax = _payload(1)
    ref = JF.dequantize_4bit(jnp.asarray(B), absmax=jnp.asarray(absmax), blocksize=BS, quant_type=quant_type,
                             shape=(N, K), dtype=getattr(jnp, dtype))
    out = dequantize_4bit_2d(torch.from_numpy(B), torch.from_numpy(absmax), get_4bit_code(quant_type, BS), BS,
                             (N, K), getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == (N, K)
    np.testing.assert_array_equal(_bits(out), np.asarray(ref).view(np.int32 if dtype == "float32" else np.int16))


@pytest.mark.parametrize("shape,bs", [((37, 96), 32), ((3, 4096), 4096), ((7, 77), 64)])
def test_dequantize_plain_ragged_shapes(shape, bs):
    """Ragged N, one block per row, and an odd element count whose blocks
    straddle rows (the flat layout): still the JAX package's bits."""
    rng = np.random.default_rng(2)
    W = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    packed, st = JF.quantize_4bit(W, blocksize=bs)
    ref = JF.dequantize_4bit(packed, quant_state=st)
    out = dequantize_4bit_2d(torch.from_numpy(np.array(packed)).reshape(-1), torch.from_numpy(np.array(st.absmax)),
                             get_4bit_code("nf4", bs), bs, shape, torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_dequantize_plain_against_pallas_kernel():
    B, absmax = _payload(3)
    ref = j_dequantize_4bit_pallas(jnp.asarray(B).reshape(-1), jnp.asarray(absmax), code=_code("nf4"), blocksize=BS,
                                   shape=(N, K), dtype="float32")
    out = dequantize_4bit_2d(torch.from_numpy(B), torch.from_numpy(absmax), get_4bit_code("nf4", BS), BS, (N, K),
                             torch.float32).numpy()
    nz = np.asarray(ref) != 0
    assert (np.abs(out - np.asarray(ref))[nz] / np.abs(np.asarray(ref))[nz]).max() <= REL
    assert (out[~nz] == 0).all()


@pytest.mark.parametrize("M", [1, 5, 16])
def test_gemm_plain_f32_against_pallas_kernel(M):
    B, absmax = _payload(4)
    A = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    ref = np.asarray(j_gemm_4bit_fused(jnp.asarray(A), jnp.asarray(B), jnp.asarray(absmax), _code("nf4"), BS, (N, K)))
    out = gemm_4bit_fused(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(absmax),
                          get_4bit_code("nf4", BS), BS, (N, K))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    assert _rel(out.numpy(), ref) <= REL


@pytest.mark.parametrize("M,dtype", [(1, "bfloat16"), (13, "bfloat16"), (6, "float16")])
def test_gemm_plain_against_jax_default_tier(M, dtype):
    """16-bit A: the JAX package's default tier (the weight dequantized and
    rounded to A's type, an f32-accumulated product), which computes the same
    function as its kernel; the sums run in another order."""
    B, absmax = _payload(5)
    A = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    jA = jnp.asarray(A, getattr(jnp, dtype))
    W = JF.dequantize_4bit(jnp.asarray(B), absmax=jnp.asarray(absmax), blocksize=BS, shape=(N, K)).astype(jA.dtype)
    ref = np.asarray(jnp.dot(jA, W.T, preferred_element_type=jnp.float32).astype(jA.dtype), np.float32)
    out = gemm_4bit_fused(tensor_from_numpy(np.asarray(jA), "cpu"), torch.from_numpy(B), torch.from_numpy(absmax),
                          get_4bit_code("nf4", BS), BS, (N, K))
    assert out.dtype == getattr(torch, dtype)
    assert _rel(out.float().numpy(), ref) <= BF16_STEP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [3, 16])
def test_gemm_nt_plain_against_pallas_kernel(M, dtype):
    B, absmax = _payload(6)
    g = jnp.asarray(np.random.default_rng(M).standard_normal((M, N)).astype(np.float32), getattr(jnp, dtype))
    ref = np.asarray(j_gemm_4bit_nt_fused(g, jnp.asarray(B), jnp.asarray(absmax), _code("nf4"), BS, (N, K)),
                     np.float32)
    out = gemm_4bit_nt_fused(tensor_from_numpy(np.asarray(g), "cpu"), torch.from_numpy(B), torch.from_numpy(absmax),
                             get_4bit_code("nf4", BS), BS, (N, K))
    assert out.dtype == getattr(torch, dtype) and out.shape == (M, K)
    assert _rel(out.float().numpy(), ref) <= (REL if dtype == "float32" else BF16_STEP)


@pytest.mark.parametrize("N_,K_,bs,ok", [(3, 96, 32, True), (4096, 14336, 64, True), (5, 100, 32, False),
                                         (8, 64, 16, False), (0, 64, 64, False)])
def test_gemm_shape_predicate(N_, K_, bs, ok):
    """Any N, and any K of whole blocks: the TPU's tile predicates do not apply."""
    assert gemm_2d_supported(N_, K_, bs) is ok
    if not ok and N_:
        with pytest.raises(ValueError):
            gemm_4bit_fused(torch.zeros(1, K_), torch.zeros(N_ * K_ // 2, dtype=torch.uint8),
                            torch.zeros(-(-N_ * K_ // bs)), get_4bit_code("nf4", 64), bs, (N_, K_))


STORAGES = ["uint8", "int8", "uint16", "bfloat16", "float32"]


@pytest.mark.parametrize("layout", ["flat", "2d"])
@pytest.mark.parametrize("storage", STORAGES)
def test_quant_storage_payload_equals_jax(storage, layout):
    """The payload's type, shape and bytes are the JAX package's; the float
    storages are the unsigned integer of their width; the dequantized weight
    is the uint8 payload's."""
    W = np.random.default_rng(7).standard_normal((64, 128)).astype(np.float32)
    jp, _ = JF.quantize_4bit(jnp.asarray(W), blocksize=64, quant_storage=getattr(jnp, storage), layout=layout)
    tp, ts = TF.quantize_4bit(torch.from_numpy(W), blocksize=64, quant_storage=getattr(torch, storage), layout=layout)
    assert str(tp.dtype).removeprefix("torch.") == np.asarray(jp).dtype.name
    assert tuple(tp.shape) == tuple(jp.shape)
    np.testing.assert_array_equal(TF.payload_bytes(tp).reshape(-1).numpy(), np.asarray(jp).reshape(-1).view(np.uint8))
    p8, s8 = TF.quantize_4bit(torch.from_numpy(W), blocksize=64, layout=layout)
    assert torch.equal(TF.dequantize_4bit(tp, ts), TF.dequantize_4bit(p8, s8))


def test_quant_storage_rules():
    W = torch.randn(64, 128, generator=torch.Generator().manual_seed(8))
    with pytest.raises(ValueError, match="paired"):
        TF.quantize_4bit(W, blocksize=64, layout="paired", quant_storage=torch.bfloat16)
    with pytest.raises(ValueError, match="quant_storage"):
        TF.quantize_4bit(W, blocksize=64, quant_storage=torch.int32)
    qt = QuantizedTensor.quantize(W, blocksize=64, quant_storage=torch.bfloat16, compress_statistics=True)
    assert qt.state.layout == "2d" and qt.data.dtype == torch.uint16 and tuple(qt.data.shape) == (64, 32)
    assert QuantizedTensor.quantize(W, blocksize=64).state.layout == "paired"
    lin = Linear4bit(128, 64, quant_storage=torch.float32, device="cpu", generator=torch.Generator().manual_seed(0))
    assert lin.weight.state.layout == "2d" and lin.weight.data.dtype == torch.uint32


@pytest.mark.parametrize("storage", ["uint16", "bfloat16", "float32", "int8"])
@pytest.mark.parametrize("nested", [False, True])
def test_to_layout_round_trip_from_wider_storage(storage, nested):
    W = torch.randn(64, 256, generator=torch.Generator().manual_seed(9))
    qt = QuantizedTensor.quantize(W, blocksize=64, quant_storage=getattr(torch, storage),
                                  compress_statistics=nested)
    raw = TF.payload_bytes(qt.data).clone()
    paired = qt.to_layout("paired")
    assert paired.data.dtype == torch.uint8 and tuple(paired.data.shape) == (32, 256)
    assert torch.equal(paired.dequantize(), qt.dequantize())
    back = paired.to_layout("2d")
    assert torch.equal(back.data.reshape(-1), raw) and torch.equal(back.state.absmax, qt.state.absmax)
    flat = qt.to_layout("flat")
    assert flat.data.dtype == torch.uint8 and torch.equal(flat.data.reshape(-1), raw)


def _np_qt(jq):
    st = jq.state
    d = {"data": np.asarray(jq.data), "absmax": np.asarray(st.absmax), "shape": tuple(st.shape),
         "blocksize": st.blocksize, "quant_type": st.quant_type, "layout": st.layout, "code": np.asarray(st.code),
         "dtype": jnp.dtype(st.dtype).name}
    if st.nested:
        d.update(offset=np.asarray(st.offset), nested_absmax=np.asarray(st.state2.absmax),
                 nested_blocksize=st.state2.blocksize, nested_code=np.asarray(st.state2.code))
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nested", [False, True], ids=["nf4", "nested"])
@pytest.mark.parametrize("M", [5, 48, 129])
def test_matmul_4bit_2d_matches_jax(nested, M, dtype):
    """``matmul_4bit`` forward and gradients on a bf16-storage 2d state,
    carried across from the JAX package, against its default tier: kernels
    9 and 11's plain versions at M 5 and 48 with bf16 activations, kernel 10
    and the matmul forward and backward at M 129 (and the forward from M 9
    with f32 activations).  f32 within rtol 1e-5 (forward) and 2e-2 / 2e-3
    (gradients, as ``tests/test_autograd.py``); bf16 within one bf16 step of
    the largest value."""
    rng = np.random.default_rng(M)
    W = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=64, quant_storage=jnp.bfloat16, compress_statistics=nested)
    assert jq.state.layout == "2d" and jq.data.dtype == jnp.uint16
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K)), getattr(jnp, dtype)))
    proj = rng.standard_normal((M, N)).astype(np.float32)

    def jf(x_):
        out = JA.matmul_4bit(x_, jq.data, jq.state)
        return jnp.sum(out.astype(jnp.float32) * proj), out

    (_, jout), jgx = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    tq = params_from_numpy({"w": _np_qt(jq)}, "cpu")["w"]
    assert tq.data.dtype == torch.uint16 and tq.state.layout == "2d" and tq.state.nested == nested
    tx = tensor_from_numpy(x, "cpu").requires_grad_()
    out = TA.matmul_4bit(tx, tq.data, tq.state)
    assert out.dtype == tx.dtype
    (out.float() * torch.from_numpy(proj)).sum().backward()
    jout, jgx = np.asarray(jout, np.float32), np.asarray(jgx, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=2e-2, atol=2e-3)
    else:
        assert _rel(out.detach().float().numpy(), jout) <= BF16_STEP
        assert _rel(tx.grad.float().numpy(), jgx) <= BF16_STEP
    assert not tq.data.requires_grad


@pytest.mark.parametrize("side", ["kernel9", "dequantize_matmul"])
@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_gemm_4bit_f16_f32_routes_match_jax(dtype, nested, side, monkeypatch):
    """f16 and f32 activations on a bf16-storage 2d state, plain and nested,
    one row below and at the dtype's threshold (kernel 9, or kernel 10 in
    A's type and the matmul; the ``_dq`` instances on a nested state, with
    no decode before the call), against the JAX package's ``gemm_4bit`` on
    the same state: f32 within rtol 1e-5, f16 within one bf16 step of the
    largest output."""
    threshold = TG.KADJACENT_F32_LARGE_M_THRESHOLD if dtype == "float32" else TG.KADJACENT_LARGE_M_THRESHOLD
    M = threshold - 1 if side == "kernel9" else threshold
    rng = np.random.default_rng(21)
    W = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    jq = JQT.quantize(jnp.asarray(W), blocksize=64, quant_storage=jnp.bfloat16, compress_statistics=nested)
    tq = params_from_numpy({"w": _np_qt(jq)}, "cpu")["w"]
    assert tq.state.layout == "2d" and tq.state.inline_nested == nested
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K)), getattr(jnp, dtype)))
    ref = np.asarray(JG.gemm_4bit(jnp.asarray(x), jq.data, jq.state), np.float32)

    called = []
    for name in ("gemm_4bit_fused", "gemm_4bit_fused_dq", "dequantize_4bit_2d", "dequantize_4bit_2d_dq"):
        monkeypatch.setattr(TG, name, lambda *a, _f=getattr(TG, name), _n=name, **k: called.append(_n) or _f(*a, **k))
    monkeypatch.setattr(type(tq.state), "dequant_absmax",
                        lambda self: pytest.fail("the nested absmax was decoded before the call") if self.nested
                        else self.absmax.reshape(-1))
    out = TG.gemm_4bit(tensor_from_numpy(x, "cpu"), tq.data, tq.state)
    kernel = ("gemm_4bit_fused" if side == "kernel9" else "dequantize_4bit_2d") + ("_dq" if nested else "")
    assert called == [kernel]
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (M, N)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(out.float().numpy(), ref) <= BF16_STEP


_BACKWARD_KERNELS = {  # layout -> (small-M kernel, dequantize kernel), the nested names with "_dq"
    "2d": ("gemm_4bit_nt_fused", "dequantize_4bit_2d"),
    "paired": ("gemm_4bit_paired_nt", "dequantize_paired_fast"),
}


@pytest.mark.parametrize("side", ["nt_kernel", "dequantize_matmul"])
@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("layout", ["2d", "paired"])
def test_grad_A_routes_match_jax(layout, nested, side, monkeypatch):
    """``gemm_4bit_grad_A`` with bf16 g one row below and at
    ``BACKWARD_LARGE_M_THRESHOLD``, on both layouts: the ``_nt`` kernel
    (kernel 11, or 7 and 8) below it, the dequantize kernel (``_dq`` on a nested state, with no
    decode before the call) and the matmul at it; within one bf16 step of the
    largest value of the JAX package's ``gemm_4bit_grad_A`` on the same state.
    Kernel 11 takes an f32 absmax, so the K-adjacent nested small-M route
    decodes it first."""
    M = TG.BACKWARD_LARGE_M_THRESHOLD - (side == "nt_kernel")
    rng = np.random.default_rng(31)
    W = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    kw = {"quant_storage": jnp.bfloat16} if layout == "2d" else {"layout": "paired"}
    jq = JQT.quantize(jnp.asarray(W), blocksize=64, compress_statistics=nested, **kw)
    tq = params_from_numpy({"w": _np_qt(jq)}, "cpu")["w"]
    assert tq.state.layout == layout and tq.state.inline_nested == nested
    g = np.asarray(jnp.asarray(rng.standard_normal((M, N)), jnp.bfloat16))
    ref = np.asarray(JG.gemm_4bit_grad_A(jnp.asarray(g), jq.data, jq.state), np.float32)

    called = []
    for name in (*_BACKWARD_KERNELS["2d"], *_BACKWARD_KERNELS["paired"]):
        for nm in (name, name + "_dq"):
            if hasattr(TG, nm):
                monkeypatch.setattr(TG, nm, lambda *a, _f=getattr(TG, nm), _n=nm, **k: called.append(_n) or _f(*a, **k))
    small, large = _BACKWARD_KERNELS[layout]
    if side == "dequantize_matmul" or layout == "paired":
        decode = type(tq.state).dequant_absmax
        monkeypatch.setattr(type(tq.state), "dequant_absmax",
                            lambda self: pytest.fail("the nested absmax was decoded before the call") if self.nested
                            else decode(self))
    out = TG.gemm_4bit_grad_A(tensor_from_numpy(g, "cpu"), tq.data, tq.state)
    kernel = small if side == "nt_kernel" else large
    if nested and not (layout == "2d" and side == "nt_kernel"):
        kernel += "_dq"
    assert called == [kernel]
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, K)
    assert _rel(out.float().numpy(), ref) <= BF16_STEP


@pytest.mark.parametrize("side", ["nt_kernel", "dequantize_matmul"])
@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("layout", ["2d", "paired"])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_grad_A_f16_f32_routes_match_jax(dtype, layout, nested, side, monkeypatch):
    """``gemm_4bit_grad_A`` with f16 and f32 g on both sides of the dtype's
    own threshold on the layout (``backward_threshold``: one row below it, and the first multiple of 8 at or
    above it), on both layouts: the ``_nt`` kernel below it, the dequantize
    kernel in g's type (``_dq`` on a nested state) and the matmul from it,
    against the JAX package's ``gemm_4bit_grad_A`` on the same state: the
    paired layout on its Pallas tier (its tiles take M up to 16 and
    multiples of 8), whose kernels decode the port's codebook units, the 2d
    layout on its default tier, the exact f32 dequantize; f32 within rtol
    1e-5, f16 within one bf16 step of the largest value."""
    threshold = TG.backward_threshold(getattr(torch, dtype), layout)
    M = threshold - 1 if side == "nt_kernel" else -(-threshold // 8) * 8
    rng = np.random.default_rng(32)
    W = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    kw = {"quant_storage": jnp.bfloat16} if layout == "2d" else {"layout": "paired"}
    jq = JQT.quantize(jnp.asarray(W), blocksize=64, compress_statistics=nested, **kw)
    tq = params_from_numpy({"w": _np_qt(jq)}, "cpu")["w"]
    assert tq.state.layout == layout and tq.state.inline_nested == nested
    g = np.asarray(jnp.asarray(rng.standard_normal((M, N)), getattr(jnp, dtype)))
    dispatch.set_backend("pallas" if layout == "paired" else "auto")
    try:
        ref = np.asarray(JG.gemm_4bit_grad_A(jnp.asarray(g), jq.data, jq.state), np.float32)
    finally:
        dispatch.set_backend("auto")

    called = []
    for name in (*_BACKWARD_KERNELS["2d"], *_BACKWARD_KERNELS["paired"]):
        for nm in (name, name + "_dq"):
            if hasattr(TG, nm):
                monkeypatch.setattr(TG, nm, lambda *a, _f=getattr(TG, nm), _n=nm, **k: called.append(_n) or _f(*a, **k))
    out = TG.gemm_4bit_grad_A(tensor_from_numpy(g, "cpu"), tq.data, tq.state)
    kernel = _BACKWARD_KERNELS[layout][side == "dequantize_matmul"]
    if nested and not (layout == "2d" and side == "nt_kernel"):
        kernel += "_dq"
    assert called == [kernel]
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (M, K)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(out.float().numpy(), ref) <= BF16_STEP


@pytest.mark.parametrize("M", [3, 40])
def test_gemm_4bit_routes_flat_layout(M):
    """A flat state whose rows do not hold whole blocks (K = 100, blocksize
    32) takes kernel 10 and the matmul at every M; gemm_4bit equals the
    dequantized weight's product."""
    W = torch.randn(6, 100, generator=torch.Generator().manual_seed(10))
    qt = QuantizedTensor.quantize(W, blocksize=32)
    assert qt.state.layout == "flat"
    A = torch.randn(M, 100, generator=torch.Generator().manual_seed(11))
    ref = A @ qt.dequantize().t()
    torch.testing.assert_close(TG.gemm_4bit(A, qt.data, qt.state), ref, rtol=0, atol=0)
    g = torch.randn(M, 6, generator=torch.Generator().manual_seed(12))
    torch.testing.assert_close(TG.gemm_4bit_grad_A(g, qt.data, qt.state), g @ qt.dequantize(), rtol=0, atol=0)
