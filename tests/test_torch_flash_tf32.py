"""Kernels 17, 18 and 19's f32 instances at head_dim 128 and 256 (the causal
flash forward, dK/dV and dQ on three-pass TF32 ``wgmma``,
``csrc/flash_attention.cu``'s ``flash_tf32_fwd_kernel``,
``flash_tf32_dkv_kernel`` and ``flash_tf32_dq_kernel``), on the CPU.

The kernels run only on the card; here their arithmetic is emulated in torch
and held against the JAX package's f32 o, dK/dV and dQ (the upstream Pallas
TPU flash kernels in interpret mode, ``test_torch_flash_dtypes._case``'s
inputs and reference).  The forward's emulation takes that kernel's two
products, S = Q K^T and O^T = V^T P^T, the dK/dV emulation its four, S^T
= K Q^T, dP^T = V dO^T, dV^T = dO^T P and dK^T = Q^T dS, the dQ emulation
its three, S = Q K^T, dP = dO V^T and dQ^T = K^T dS^T, each as three TF32 passes
(big * big + big * small + small * big, every operand split as the kernel's
``tf32_split`` does: ``big`` x with its low 13 bits zeroed, ``small = x -
big`` rounded to 10 mantissa bits with ties away from zero, as
``cvt.rna.tf32.f32``; rounding or truncating both halves passes too), and
the plain version's p and ds from those scores.  Products of TF32
values are exact in f32, so an f32 matmul of them sums as the tensor
cores' f32 accumulation does, in another order.  The gate is the card's
(``chip_smoke.FLASH_TOLERANCES["float32"]``): o within 1e-5 abs, m within
1e-4 abs and l within 1e-5 of its largest; dk, dv and dq within 1e-4 of
their largest magnitude.  A single TF32 pass on the same inputs misses it,
so the gate tells the two apart.

Also the route (the f32 forward, dK/dV and dQ at 128 and 256 count and
launch as ``..._tf32``; 384 and up stay on the wide family) and that a
failing launch of any of the three instances, or of the 16-bit forward's
streamed instance (head_dim 640 and up), raises instead of falling back to
the wide kernel.
"""

import numpy as np
import pytest
import torch

from bitsandbytes_tpu_torch.ops import _lib
from bitsandbytes_tpu_torch.ops import flash_attention as FA
from test_torch_flash_dtypes import KVH, _case

torch.set_num_threads(1)

GATE = 1e-4  # dk, dv, dq relative to their largest magnitude
# the forward's: o abs, m abs, l relative to its largest
O_GATE, M_GATE, L_GATE = 1e-5, 1e-4, 1e-5
# (T, hd, G) of the JAX reference: 4 query heads over 2 KV heads at hd 128,
# one each at hd 256
SHAPES = [(256, 128, 2), (384, 256, 1)]


def _tf32(x: torch.Tensor, mode: str = "rna") -> torch.Tensor:
    """f32 ``x`` as TF32 values: ``rna`` rounds to 10 mantissa bits, ties
    away from zero (``cvt.rna.tf32.f32``); ``trunc`` zeroes the low 13 bits."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if mode == "rna":
        u = u + 0x1000
    u = u & 0xFFFFE000
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


# (big, small) of the kernel's split, and of the two others the card timed
SPLITS = {"kernel": ("trunc", "rna"), "rna": ("rna", "rna"), "trunc": ("trunc", "trunc")}


def _split(x: torch.Tensor, split: str = "kernel"):
    big_mode, small_mode = SPLITS[split]
    big = _tf32(x, big_mode)
    return big, _tf32(x - big, small_mode)


def _mm3(a: torch.Tensor, b: torch.Tensor, split: str = "kernel") -> torch.Tensor:
    """``a @ b`` as the kernel's three TF32 passes, f32 sums."""
    ab, as_ = _split(a, split)
    bb, bs = _split(b, split)
    return ab @ bb + ab @ bs + as_ @ bb


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass."""
    return _tf32(a) @ _tf32(b)


def _fwd_emulated(q, k, v, mm):
    """The forward kernel's o [B, T, H, hd], m and l [B, H, T] with both
    products through ``mm``: S = Q K^T, the masked softmax (keys after their
    query get p = 0), O^T = V^T P^T, then o = O / l; m is the row max of the
    scaled scores, l = sum exp(s - m)."""
    B, T, H, hd = q.shape
    G, scale = H // k.shape[2], hd**-0.5
    qh = q.transpose(1, 2)  # [B, H, T, hd]
    kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    keep = torch.arange(T)[:, None] >= torch.arange(T)[None, :]  # key <= row
    s = torch.where(keep, mm(qh, kh.transpose(-1, -2)) * scale, float("-inf"))  # S: [B, H, rows, keys]
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(-1)
    ot = mm(vh.transpose(-1, -2), pr.transpose(-1, -2))  # O^T = V^T P^T: [B, H, hd, rows]
    return ot.permute(0, 3, 1, 2) / l.transpose(1, 2)[..., None], m, l


def _dkv_emulated(q, k, v, do, m, l, di, mm):
    """The kernel's dk, dv with every product through ``mm``: [B, T, KVH,
    hd] f32.  Keys after their query get p = 0, as the kernel masks them."""
    B, T, H, hd = q.shape
    kvh = k.shape[2]
    G, scale = H // kvh, hd**-0.5
    qh, doh = q.transpose(1, 2), do.transpose(1, 2)  # [B, H, T, hd]
    kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    st = mm(kh, qh.transpose(-1, -2)) * scale  # S^T: [B, H, keys, rows]
    keep = torch.arange(T)[:, None] <= torch.arange(T)[None, :]  # key <= row
    pt = torch.where(keep, torch.exp(st - m[:, :, None, :]) * (1.0 / l[:, :, None, :]), 0.0)
    dpt = mm(vh, doh.transpose(-1, -2))
    dst = (dpt - di[:, :, None, :]) * pt * scale
    dvt = mm(doh.transpose(-1, -2), pt.transpose(-1, -2))  # dV^T = dO^T P: [B, H, hd, keys]
    dkt = mm(qh.transpose(-1, -2), dst.transpose(-1, -2))  # dK^T = Q^T dS

    def fold(t):  # [B, H, hd, T] -> [B, T, KVH, hd], the group summed
        return t.permute(0, 3, 1, 2).reshape(B, T, kvh, G, hd).sum(dim=3)

    return fold(dkt), fold(dvt)


def _dq_emulated(q, k, v, do, m, l, di, mm):
    """The dQ kernel's dq with every product through ``mm``: [B, T, H, hd]
    f32.  Keys after their query get p = 0, as the kernel masks them; p is
    exact f32 (no product reads it), ds = (dp - di) p scale."""
    B, T, H, hd = q.shape
    G, scale = H // k.shape[2], hd**-0.5
    qh, doh = q.transpose(1, 2), do.transpose(1, 2)  # [B, H, T, hd]
    kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    s = mm(qh, kh.transpose(-1, -2)) * scale  # S: [B, H, rows, keys]
    keep = torch.arange(T)[:, None] >= torch.arange(T)[None, :]  # key <= row
    pr = torch.where(keep, torch.exp(s - m[..., None]) * (1.0 / l[..., None]), 0.0)
    dp = mm(doh, vh.transpose(-1, -2))
    ds = (dp - di[..., None]) * pr * scale
    dqt = mm(kh.transpose(-1, -2), ds.transpose(-1, -2))  # dQ^T = K^T dS^T: [B, H, hd, rows]
    return dqt.permute(0, 3, 1, 2)


_INPUTS = {}


def _inputs(T, hd, G):
    """The JAX package's f32 case: torch inputs, m, l and di from the plain
    forward, and the JAX dk, dv and dq."""
    key = (T, hd, G)
    if key not in _INPUTS:
        (q, k, v, g), _, grads = _case("float32", T, hd, G)
        q, k, v = (torch.from_numpy(a) for a in (q, k, v))
        do = torch.from_numpy(g).reshape(1, T, KVH * G, hd)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        _INPUTS[key] = ((q, k, v, do, m, l, di), grads[1], grads[2], grads[0])
    return _INPUTS[key]


_FWD = {}


def _fwd_inputs(T, hd, G):
    """The JAX package's f32 case for the forward: torch q, k, v, the JAX o,
    and the plain version's o, m and l."""
    key = (T, hd, G)
    if key not in _FWD:
        (q, k, v, _), o_ref, _ = _case("float32", T, hd, G)
        q, k, v = (torch.from_numpy(a) for a in (q, k, v))
        _FWD[key] = ((q, k, v), o_ref, FA.flash_attention_causal_fwd_plain(q, k, v))
    return _FWD[key]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _fwd_errs(got, o_ref, plain):
    """(o abs against the JAX o, m abs and l relative to its largest against
    the plain version), as the card's gate measures them."""
    (o, m, l), (_, mp, lp) = got, plain
    return (float(np.abs(o.numpy() - o_ref).max()), float((m - mp).abs().max()),
            float((l - lp).abs().max() / lp.abs().max()))


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_three_pass_tf32_fwd_meets_the_f32_gate(T, hd, G):
    """The forward's two products (S = Q K^T, O^T = V^T P^T), three TF32
    passes each as the kernel runs them, give o within 1e-5 abs of the JAX
    package's f32 o, m within 1e-4 abs and l within 1e-5 of the plain
    version's; rounding or truncating both halves does too."""
    qkv, o_ref, plain = _fwd_inputs(T, hd, G)
    for split in SPLITS:
        errs = _fwd_errs(_fwd_emulated(*qkv, lambda a, b, split=split: _mm3(a, b, split)), o_ref, plain)
        assert errs[0] <= O_GATE and errs[1] <= M_GATE and errs[2] <= L_GATE, (split, errs)


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_one_tf32_pass_fwd_misses_the_f32_gate(T, hd, G):
    """One TF32 pass per product of the forward puts o outside 1e-5 abs of
    the JAX package's o: the card's gate would catch a forward that dropped
    the small halves."""
    qkv, o_ref, plain = _fwd_inputs(T, hd, G)
    assert _fwd_errs(_fwd_emulated(*qkv, _mm1), o_ref, plain)[0] > O_GATE


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_fwd_emulation_of_full_f32_matches_the_plain_version(T, hd, G):
    """The forward's emulation with exact f32 products is the plain
    version's function (which the card holds the kernel against; the plain
    version renormalizes at every 128-key block, the kernel divides by l
    once): o within 1e-6 abs, m within 1e-6 abs, l within 1e-6 of its
    largest."""
    qkv, _, plain = _fwd_inputs(T, hd, G)
    o, m, l = _fwd_emulated(*qkv, torch.matmul)
    op, mp, lp = plain
    errs = (float((o - op).abs().max()), float((m - mp).abs().max()), float((l - lp).abs().max() / lp.abs().max()))
    assert max(errs) <= 1e-6, errs


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_three_pass_tf32_meets_the_f32_gate(T, hd, G):
    """Three TF32 passes per product, as the kernel runs them, give dk and
    dv within 1e-4 of the JAX package's f32 ones (about 1e-6); rounding or
    truncating both halves does too."""
    bwd, dk_ref, dv_ref, _ = _inputs(T, hd, G)
    for split in SPLITS:
        dk, dv = _dkv_emulated(*bwd, lambda a, b, split=split: _mm3(a, b, split))
        errs = (_rel(dk, dk_ref), _rel(dv, dv_ref))
        assert max(errs) <= GATE, (split, errs)


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_one_tf32_pass_misses_the_f32_gate(T, hd, G):
    """One TF32 pass per product on the same inputs falls outside 1e-4:
    the gate the card holds the kernel to would catch a kernel that dropped
    the small halves."""
    bwd, dk_ref, dv_ref, _ = _inputs(T, hd, G)
    dk, dv = _dkv_emulated(*bwd, _mm1)
    assert max(_rel(dk, dk_ref), _rel(dv, dv_ref)) > GATE


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_emulation_of_full_f32_matches_the_plain_version(T, hd, G):
    """The emulation with exact f32 products is the plain version's
    function (which the card holds the kernel against): within 1e-5 of
    its dk and dv."""
    bwd = _inputs(T, hd, G)[0]
    dk, dv = _dkv_emulated(*bwd, torch.matmul)
    dkp, dvp = FA.flash_attention_causal_bwd_dkv_plain(*bwd)
    for got, want in ((dk, dkp), (dv, dvp)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_three_pass_tf32_dq_meets_the_f32_gate(T, hd, G):
    """The dQ kernel's three products (S = Q K^T, dP = dO V^T, dQ^T = K^T
    dS^T), three TF32 passes each as the kernel runs them, give dq within
    1e-4 of the JAX package's f32 dq; rounding or truncating both halves
    does too."""
    bwd, _, _, dq_ref = _inputs(T, hd, G)
    for split in SPLITS:
        dq = _dq_emulated(*bwd, lambda a, b, split=split: _mm3(a, b, split))
        assert _rel(dq, dq_ref) <= GATE, (split, _rel(dq, dq_ref))


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_one_tf32_pass_dq_misses_the_f32_gate(T, hd, G):
    """One TF32 pass per product of the dQ kernel falls outside 1e-4 of the
    JAX package's dq: the card's gate would catch a dQ kernel that dropped
    the small halves."""
    bwd, _, _, dq_ref = _inputs(T, hd, G)
    assert _rel(_dq_emulated(*bwd, _mm1), dq_ref) > GATE


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_dq_emulation_of_full_f32_matches_the_plain_version(T, hd, G):
    """The dQ emulation with exact f32 products is the plain version's
    function (which the card holds the kernel against): within 1e-5 of its
    dq."""
    bwd = _inputs(T, hd, G)[0]
    dq = _dq_emulated(*bwd, torch.matmul)
    dqp = FA.flash_attention_causal_bwd_dq_plain(*bwd)
    assert float((dq - dqp).abs().max() / dqp.abs().max()) <= 1e-5


@pytest.mark.parametrize("hd", [128, 256, 384, 512, 640])
def test_f32_dkv_route(hd):
    """f32 dK/dV at head_dim 128 and 256 counts and launches as ``_tf32``
    through a C entry the library binds; from 384 it stays on the wide
    family, and so does the f32 forward (which takes its own TF32 instance
    at 128 and 256)."""
    f32 = torch.float32
    name, entry = FA.launch_name("dkv", f32, hd), FA.c_entry(FA.launch_name("dkv", f32, hd))
    tf32 = hd in (128, 256)
    assert FA.uses_tf32("dkv", f32, hd) == tf32 and not FA.uses_wgmma("dkv", f32, hd)
    assert name == "flash_attention_causal_bwd_dkv" + ("_tf32" if tf32 else "_wide"), name
    assert name in _lib.LAUNCHES and entry == "bnb_" + name and entry in _lib._SIGNATURES
    assert FA.launch_name("fwd", f32, hd) == FA._BASE_NAMES["fwd"] + ("_tf32" if tf32 else "_wide")
    assert FA.uses_tf32("fwd", f32, hd) == tf32
    for dt in (torch.bfloat16, torch.float16):  # the 16-bit route is untouched
        assert not FA.uses_tf32("dkv", dt, hd)
        assert not FA.launch_name("dkv", dt, hd).endswith("_tf32")


@pytest.mark.parametrize("hd", [128, 256, 384, 512, 640])
def test_f32_dq_route(hd):
    """f32 dQ at head_dim 128 and 256 counts and launches as ``_tf32``
    through a C entry the library binds; from 384 it stays on the wide
    family; the 16-bit dQ never takes the TF32 instance."""
    f32 = torch.float32
    name = FA.launch_name("dq", f32, hd)
    entry = FA.c_entry(name)
    tf32 = hd in (128, 256)
    assert FA.uses_tf32("dq", f32, hd) == tf32 and not FA.uses_wgmma("dq", f32, hd)
    assert name == "flash_attention_causal_bwd_dq" + ("_tf32" if tf32 else "_wide"), name
    assert name in _lib.LAUNCHES and entry == "bnb_" + name and entry in _lib._SIGNATURES
    for dt in (torch.bfloat16, torch.float16):
        assert not FA.uses_tf32("dq", dt, hd)
        assert not FA.launch_name("dq", dt, hd).endswith("_tf32")


@pytest.mark.parametrize("hd", [128, 256, 384, 512, 640])
def test_f32_fwd_route(hd):
    """The f32 forward at head_dim 128 and 256 counts and launches as
    ``_tf32`` through a C entry the library binds; from 384 it stays on the
    wide family; the 16-bit forward never takes the TF32 instance, and at
    640 takes its streamed ``wgmma`` instance, not the wide family."""
    f32 = torch.float32
    name = FA.launch_name("fwd", f32, hd)
    entry = FA.c_entry(name)
    tf32 = hd in (128, 256)
    assert FA.uses_tf32("fwd", f32, hd) == tf32 and not FA.uses_wgmma("fwd", f32, hd)
    assert name == "flash_attention_causal_fwd" + ("_tf32" if tf32 else "_wide"), name
    assert name in _lib.LAUNCHES and entry == "bnb_" + name and entry in _lib._SIGNATURES
    for dt in (torch.bfloat16, torch.float16):
        assert not FA.uses_tf32("fwd", dt, hd)
        assert not FA.launch_name("fwd", dt, hd).endswith("_tf32")
        assert FA.uses_wgmma("fwd", dt, hd)
        assert FA.launch_name("fwd", dt, hd).endswith("_streamed") == (hd == 640)


class _FailingLib:
    """Stands in for the kernel library: the C entry ``failing`` fails its
    launch, and any other entry records that it was called."""

    def __init__(self, failing: str):
        self.failing = failing
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append("tf32" if name == self.failing else name)
            return 1 if name == self.failing else 0  # cudaErrorInvalidValue

        return entry


@pytest.mark.parametrize("hd", [128, 256])
def test_failed_tf32_launch_raises_without_fallback(monkeypatch, hd):
    """A launch error of the TF32 instance raises from the wrapper: the call
    never goes on to the wide kernel or the plain version, and counts no
    launch."""
    lib = _FailingLib("bnb_flash_attention_causal_bwd_dkv_tf32")
    B, T, H = 1, 128, 2
    q, k, v, do = (torch.randn(B, T, n, hd) for n in (H, 1, 1, H))
    m, l, di = torch.zeros(B, H, T), torch.ones(B, H, T), torch.zeros(B, H, T)
    plan = FA.dkv_plan(B, T, H, 1, hd, 132)
    tables = (plan, torch.tensor(plan.items, dtype=torch.int32), torch.zeros(0, 8, dtype=torch.int32))
    monkeypatch.setattr(FA, "use_kernel", lambda *t: True)
    monkeypatch.setattr(FA, "_dkv_tables", lambda *a: tables)
    monkeypatch.setattr(FA._lib, "lib", lambda: lib)
    monkeypatch.setattr(FA._lib, "stream", lambda t: 0)
    monkeypatch.setattr(FA, "flash_attention_causal_bwd_dkv_plain", lambda *a: pytest.fail("fell back"))
    _lib.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention_causal_bwd_dkv_tf32"):
        FA.flash_attention_causal_bwd_dkv(q, k, v, do, m, l, di)
    assert lib.called == ["tf32"]
    assert not any(_lib.launch_counts().values())


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_failed_tf32_dq_launch_raises_without_fallback(monkeypatch, T, hd, G):
    """A launch error of the TF32 dQ raises from the wrapper: the call never
    goes on to the wide kernel or the plain version, and counts no launch."""
    lib = _FailingLib("bnb_flash_attention_causal_bwd_dq_tf32")
    H = KVH * G
    q, k, v, do = (torch.randn(1, T, n, hd) for n in (H, KVH, KVH, H))
    m, l, di = torch.zeros(1, H, T), torch.ones(1, H, T), torch.zeros(1, H, T)
    monkeypatch.setattr(FA, "use_kernel", lambda *t: True)
    monkeypatch.setattr(FA._lib, "lib", lambda: lib)
    monkeypatch.setattr(FA._lib, "stream", lambda t: 0)
    monkeypatch.setattr(FA, "flash_attention_causal_bwd_dq_plain", lambda *a: pytest.fail("fell back"))
    _lib.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention_causal_bwd_dq_tf32"):
        FA.flash_attention_causal_bwd_dq(q, k, v, do, m, l, di)
    assert lib.called == ["tf32"]
    assert not any(_lib.launch_counts().values())


@pytest.mark.parametrize("T,hd,G", SHAPES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in SHAPES])
def test_failed_tf32_fwd_launch_raises_without_fallback(monkeypatch, T, hd, G):
    """A launch error of the TF32 forward raises from the wrapper: the call
    never goes on to the wide kernel or the plain version, and counts no
    launch."""
    lib = _FailingLib("bnb_flash_attention_causal_fwd_tf32")
    q, k, v = (torch.randn(1, T, n, hd) for n in (KVH * G, KVH, KVH))
    monkeypatch.setattr(FA, "use_kernel", lambda *t: True)
    monkeypatch.setattr(FA._lib, "lib", lambda: lib)
    monkeypatch.setattr(FA._lib, "stream", lambda t: 0)
    monkeypatch.setattr(FA, "flash_attention_causal_fwd_plain", lambda *a: pytest.fail("fell back"))
    _lib.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention_causal_fwd_tf32"):
        FA.flash_attention_causal_fwd(q, k, v)
    assert lib.called == ["tf32"]
    assert not any(_lib.launch_counts().values())


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 640), (torch.float16, 1024)])
def test_failed_streamed_fwd_launch_raises_without_fallback(monkeypatch, dtype, hd):
    """A launch error of the 16-bit forward's streamed instance raises from
    the wrapper: the call never goes on to the wide kernel or the plain
    version, and counts no launch."""
    lib = _FailingLib("bnb_flash_attention_causal_fwd_streamed")
    q, k, v = (torch.randn(1, 128, n, hd).to(dtype) for n in (2, 1, 1))
    monkeypatch.setattr(FA, "use_kernel", lambda *t: True)
    monkeypatch.setattr(FA._lib, "lib", lambda: lib)
    monkeypatch.setattr(FA._lib, "stream", lambda t: 0)
    monkeypatch.setattr(FA, "flash_attention_causal_fwd_plain", lambda *a: pytest.fail("fell back"))
    _lib.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention_causal_fwd_streamed"):
        FA.flash_attention_causal_fwd(q, k, v)
    assert lib.called == ["tf32"]  # the failing entry, and no other
    assert not any(_lib.launch_counts().values())
