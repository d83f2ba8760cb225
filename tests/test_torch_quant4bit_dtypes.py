"""Kernel 1 on bf16 and f16 weights, and the host-built tables of kernels 1
and 13.

The quantize kernel reads a bf16 or f16 weight in its type and upcasts it in
registers, as the JAX package's Pallas kernel upcasts in VMEM.  On the CPU
the port runs the kernel's plain version (the card's kernel is held to it by
``chip_smoke.py``): its codes and absmax on a 16-bit weight equal those of
the weight's f32 copy and those of the JAX Pallas kernel in interpret mode
on the same 16-bit weight, bit for bit, for nf4, fp4 and int4 at every
blocksize the Pallas kernel takes (and af4 at 64), in both rounding modes;
``quantize_4bit`` and ``quantize_params_4bit`` give the f32 route's bytes on
every layout, plain and nested.  The tables the kernels read are built in
Python, so their lookups are checked here against the plain count on a dense
sweep of floats: every bf16 value, each midpoint and its neighbours, +-0,
+-1, subnormals and NaN.  Weights from numpy seeds 21-23, uniforms from seed
24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitsandbytes_tpu.functional as JF
from bitsandbytes_tpu.ops.pallas.quant4bit import pallas_quant4bit_supported, quantize_4bit_codes_pallas
from bitsandbytes_tpu_torch.functional import fourbit as TF
from bitsandbytes_tpu_torch.functional.codebooks import create_dynamic_map, get_4bit_code, quantize_tables
from bitsandbytes_tpu_torch.models import llama as L
from bitsandbytes_tpu_torch.ops import blockwise8 as B8
from bitsandbytes_tpu_torch.ops.quant4bit import QUANTIZE_DTYPES, order_word, quantize_4bit_codes

torch.set_num_threads(1)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}


def _shape(bs):
    return (16, 256) if bs <= 256 else (8, 4096)


BLOCKSIZES = [bs for bs in TF.VALID_4BIT_BLOCKSIZES if pallas_quant4bit_supported(*_shape(bs), bs)]


def _weight(seed, shape, bs, dtype):
    """A 16-bit weight with an all-zero block and an outlier, and its f32 copy."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(shape).astype(np.float32)
    W.reshape(-1)[bs : 2 * bs] = 0.0
    W.reshape(-1)[3 * bs + 5] = 40.0
    W16 = torch.from_numpy(W).to(dtype)
    return W16, W16.to(torch.float32)


def _codes_case(tdt, jdt, quant_type, bs, stochastic):
    shape = _shape(bs)
    W16, W32 = _weight(21, shape, bs, tdt)
    u = np.random.default_rng(24).random(shape, dtype=np.float32) if stochastic else None
    tu = None if u is None else torch.from_numpy(u).reshape(-1)
    tq, tam = quantize_4bit_codes(W16.reshape(-1), quant_type, bs, tu)
    fq, fam = quantize_4bit_codes(W32.reshape(-1), quant_type, bs, tu)
    assert torch.equal(tq, fq) and torch.equal(tam.view(torch.int32), fam.view(torch.int32))
    code_t = tuple(float(x) for x in get_4bit_code(quant_type, bs))
    jW = jnp.asarray(W32.numpy()).astype(jdt)  # exact: the values are the 16-bit type's
    jq, jam = quantize_4bit_codes_pallas(jW, code_t=code_t, blocksize=bs,
                                         stochastic_u=None if u is None else jnp.asarray(u))
    np.testing.assert_array_equal(tq.numpy().reshape(shape), np.asarray(jq))
    np.testing.assert_array_equal(tam.numpy().view(np.uint32), np.asarray(jam).reshape(-1).view(np.uint32))
    if stochastic:
        nearest, _ = quantize_4bit_codes(W16.reshape(-1), quant_type, bs)
        assert (tq != nearest).any()


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bs", BLOCKSIZES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "int4"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_codes_16bit_equal_f32_route_and_pallas(dtype, quant_type, bs, stochastic):
    _codes_case(*DTYPES[dtype], quant_type, bs, stochastic)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_codes_16bit_af4(dtype, stochastic):
    _codes_case(*DTYPES[dtype], "af4", 64, stochastic)


def test_codes_wrapper_takes_the_kernel_types():
    assert set(QUANTIZE_DTYPES) == {torch.float32, torch.bfloat16, torch.float16}
    for bad in (torch.float64, torch.int32):
        with pytest.raises(ValueError):
            quantize_4bit_codes(torch.zeros(64, dtype=bad), "nf4", 64)
    with pytest.raises(ValueError):  # a blocksize the kernel does not take
        quantize_4bit_codes(torch.zeros(96), "nf4", 48)


def _same_state(a, b):
    assert torch.equal(a.absmax.view(torch.uint8), b.absmax.view(torch.uint8)) and a.layout == b.layout
    assert (a.offset is None) == (b.offset is None)
    if a.offset is not None:
        assert torch.equal(a.offset.view(torch.int32), b.offset.view(torch.int32))
        assert torch.equal(a.state2.absmax.view(torch.int32), b.state2.absmax.view(torch.int32))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("layout", ["flat", "2d", "paired"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_4bit_16bit_equals_f32_route(dtype, layout, compress):
    W16, W32 = _weight(22, (32, 512), 64, DTYPES[dtype][0])
    if layout == "flat":  # a partial last block and an odd count
        W16, W32 = W16.reshape(-1)[: 5 * 64 + 3], W32.reshape(-1)[: 5 * 64 + 3]
    tp, ts = TF.quantize_4bit(W16, blocksize=64, layout=layout, compress_statistics=compress)
    fp, fs = TF.quantize_4bit(W32, blocksize=64, layout=layout, compress_statistics=compress)
    assert torch.equal(tp, fp) and ts.dtype == W16.dtype
    _same_state(ts, fs)


@pytest.mark.parametrize("layout", ["flat", "2d", "paired"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_4bit_16bit_matches_jax(dtype, layout):
    tdt, jdt = DTYPES[dtype]
    W16, W32 = _weight(23, (32, 256), 64, tdt)
    jp, js = JF.quantize_4bit(jnp.asarray(W32.numpy()).astype(jdt), blocksize=64, layout=layout)
    tp, ts = TF.quantize_4bit(W16, blocksize=64, layout=layout)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.absmax.numpy().view(np.uint32), np.asarray(js.absmax).view(np.uint32))


@pytest.mark.parametrize("compress", [False, True])
def test_quantize_params_4bit_takes_bf16_as_the_f32_route(compress):
    """The loader quantizes bf16 weights in their type: the same bytes and
    states as after its former f32 cast, the state's type f32 as before."""
    cfg = L.LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_layers=1,
                        num_heads=4, num_kv_heads=2, head_dim=32)
    params = L.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    qp = L.quantize_params_4bit(params, fuse=True, compress_statistics=compress)
    f32 = {**params, "layers": [{k: v.to(torch.float32) for k, v in params["layers"][0].items()}]}
    fp = L.quantize_params_4bit(f32, fuse=True, compress_statistics=compress)
    for name in ("wqkv", "wo", "gate_up", "down"):
        a, b = qp["layers"][0][name], fp["layers"][0][name]
        assert torch.equal(a.data, b.data) and a.state.dtype == torch.float32 == b.state.dtype
        _same_state(a.state, b.state)


# --- the host-built tables ---------------------------------------------------


def _sweep(mid):
    """Every bf16 value (NaN, inf and subnormals among them) and its float32
    neighbours (so both edges of every bucket of up to 16 mantissa bits),
    each midpoint and its neighbours, +-0, +-1 and their neighbours, the
    extreme subnormals and normals, and NaN, as float32."""
    f = np.float32
    bf16 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    with np.errstate(invalid="ignore"):
        bf16 = np.concatenate([bf16, np.nextafter(bf16, f(np.inf)), np.nextafter(bf16, f(-np.inf))])
    mid = np.asarray(mid, f)
    tiny, sub = np.finfo(f).tiny, np.finfo(f).smallest_subnormal
    edges = np.array([0.0, -0.0, 1.0, -1.0, np.nan, sub, -sub, tiny, -tiny, np.nextafter(tiny, f(0)),
                      -np.nextafter(tiny, f(0))], f)
    near = [mid, np.nextafter(mid, f(np.inf)), np.nextafter(mid, f(-np.inf))]
    for e in (f(1), f(-1)):
        near += [np.array([np.nextafter(e, f(0)), np.nextafter(e, 2 * e)], f)]
    return np.concatenate([bf16, edges, *near]).astype(np.float32)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "int4", "af4"])
def test_order_word_and_unclipped_rank(quant_type):
    """Kernel 1's rank -> bit-pattern word gives ``order``, and its round-to-
    nearest rank, which skips the clip, counts what the clipped value counts:
    every midpoint lies in [-1, 1)."""
    mid, order, _ = quantize_tables(quant_type, 64)
    word = order_word(order)
    assert [(word >> (4 * r)) & 15 for r in range(16)] == list(order)
    assert ((mid >= -1) & (mid < 1)).all()
    s = _sweep(mid)
    clipped = np.clip(s, -1, 1)  # keeps NaN, as torch's clamp in the plain version
    unclipped = (s[:, None] > mid[None, :]).sum(1)
    np.testing.assert_array_equal(unclipped, (clipped[:, None] > mid[None, :]).sum(1))


def _kernel_rank8(s, mid):
    """csrc/blockwise8.cu's rank_bucket (with its NaN rule) in numpy: the
    bucket of the clipped value, its count, and one compare with the
    bucket's midpoint."""
    table, nh, shift, lo = B8._buckets(mid)
    c = np.where(np.isnan(s), np.float32(-1), np.clip(s, -1, 1)).astype(np.float32)  # fminf(fmaxf(.))
    b = c.view(np.uint32).astype(np.int64)
    mag = np.maximum((((b << 1) & 0xFFFFFFFF) >> shift) - lo, 0)
    idx = nh + np.where((b >> 31) == 1, -1 - mag, mag)
    assert ((idx >= 0) & (idx < 2 * nh)).all()
    r = table.view(np.int32)[idx, 0].astype(np.int64) + (c > table[idx, 1])
    r[np.isnan(s)] = 0
    return r


def _kernel_search8(s, mid):
    """csrc/blockwise8.cu's rank_search in numpy: the branch-free binary
    search over the midpoints padded to 256 with +inf."""
    padded = np.concatenate([mid, np.full(256 - len(mid), np.inf, np.float32)])
    c = np.where(np.isnan(s), np.float32(-1), np.clip(s, -1, 1)).astype(np.float32)
    r = np.zeros(len(c), np.int64)
    for step in (128, 64, 32, 16, 8, 4, 2, 1):
        r += np.where(padded[r + step - 1] < c, step, 0)
    r[np.isnan(s)] = 0
    return r


def _codebooks():
    lin = np.linspace(-1, 1, 256, dtype=np.float32)  # dense midpoints: a finer table
    tiny = np.sort(np.concatenate([create_dynamic_map()[::2], [1e-30, -1e-30, 3e-42]])).astype(np.float32)
    return {"dynamic": create_dynamic_map(), "dynamic_unsigned": create_dynamic_map(signed=False),
            "linear": lin, "nf4": get_4bit_code("nf4", 64), "tiny_entries": tiny}


def _plain_rank8(s, mid):
    return B8._rank(torch.from_numpy(np.clip(s, -1, 1)), tuple(float(m) for m in mid)).numpy()


@pytest.mark.parametrize("name", list(_codebooks()))
def test_bucket_table_gives_the_plain_count(name):
    """Every sorted codebook ranks by the buckets or, where no table within
    the kernel's shared memory resolves it (the unsigned dynamic map), by
    the binary search; both give the plain count."""
    code_t = B8.code_tuple(_codebooks()[name])
    mid = np.asarray(B8._tables(code_t)[1], np.float32)
    assert (mid[1:] >= mid[:-1]).all()
    s = _sweep(mid)
    want = _plain_rank8(s, mid)
    np.testing.assert_array_equal(_kernel_search8(s, mid), want)
    rank = B8._device_tables(code_t, "cpu")[1]
    if name == "dynamic_unsigned":
        assert B8._buckets(mid) is None and rank == B8.RANK_SEARCH
        return
    table, nh, shift, lo = B8._buckets(mid)
    assert rank == B8.RANK_BUCKET and 2 * nh <= B8.BUCKET_MAX_ENTRIES
    assert B8.bucket_table(mid, 24 - shift)[4] <= 1  # no bucket counts past its one midpoint
    if name == "dynamic":
        assert shift == 18  # six mantissa bits resolve the dynamic map
    np.testing.assert_array_equal(_kernel_rank8(s, mid), want)


def test_unresolved_codebook_takes_the_search():
    """Midpoints packed closer than any table within the kernel's shared
    memory resolves: no buckets, the binary search, which gives the count."""
    code = np.sort(np.float32(0.5) + np.arange(256, dtype=np.float32) * np.float32(2.0**-23)).astype(np.float32)
    code_t = B8.code_tuple(code)
    mid = np.asarray(B8._tables(code_t)[1], np.float32)
    assert B8._buckets(mid) is None and B8._device_tables(code_t, "cpu")[1] == B8.RANK_SEARCH
    s = _sweep(mid)
    np.testing.assert_array_equal(_kernel_search8(s, mid), _plain_rank8(s, mid))


def test_device_tables_layout():
    """The quantize kernel's table: the codebook, the midpoints padded with
    +inf, then the buckets of sorted midpoints; an unsorted codebook has none
    and takes the linear count."""
    code_t = B8.code_tuple(create_dynamic_map())
    buf, rank, nh, shift, lo = B8._device_tables(code_t, "cpu")
    code, mid = B8._tables(code_t)
    table, nh2, shift2, lo2 = B8._buckets(np.asarray(mid, np.float32))
    buf = buf.numpy()
    assert rank == B8.RANK_BUCKET and (nh, shift, lo) == (nh2, shift2, lo2) and 2 * nh <= B8.BUCKET_MAX_ENTRIES
    np.testing.assert_array_equal(buf[:256], np.asarray(code, np.float32))
    np.testing.assert_array_equal(buf[256:511], np.asarray(mid, np.float32))
    assert buf[511] == np.inf
    np.testing.assert_array_equal(buf[512:].view(np.uint32), table.reshape(-1).view(np.uint32))
    unsorted = B8.code_tuple(get_4bit_code("fp4", 64))
    ubuf, urank, _, _, _ = B8._device_tables(unsorted, "cpu")
    assert urank == B8.RANK_LINEAR and ubuf.numel() == 512 and (ubuf[256 + 15 :] == np.inf).all()
