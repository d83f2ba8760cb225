"""The causal flash attention of the training path (``ops/flash_attention.py``)
against the JAX package's, on the CPU.

The JAX side is ``models/llama._flash_attention_causal``, the upstream Pallas
TPU flash kernel (forward, dK/dV and dQ), run in interpret mode under
``pltpu.force_tpu_interpret_mode()``; the port's side is its plain versions,
which its wrappers take for CPU tensors.  Inputs are unit normals from
``numpy.random.default_rng``, rounded to bf16 for both.  Tolerances, from the
measured differences (at most 0.0020 on the output and 0.59% of the largest
magnitude on a gradient in these cases; 0.0039 and 0.74% on other draws),
with room for another host's rounding: the output within 8e-3 absolute (one
bf16 ulp at 2 is 1.6e-2), each gradient within 1.5% of its largest
magnitude (the JAX package rounds dk and dv per query head to bf16 before
summing the GQA group; the port sums in f32 and rounds once).

Also: the plain versions against a dense float64 autograd reference (f32
inputs, T not a multiple of the block), the route predicate against the
JAX package's ``_flash_ok`` conditions, what the CUDA wrappers refuse, and
the dK/dV kernel's work plan (``dkv_plan``) and its combine.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bitsandbytes_tpu.models import llama as JL
from bitsandbytes_tpu_torch.models import llama as TL
from bitsandbytes_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(1)

# (T, hd, G): each value of T, hd and G (query heads a KV head) twice
CASES = [(256, 128, 1), (384, 128, 2), (256, 256, 2), (384, 256, 1)]
KVH = 2
OUT_ATOL = 8e-3
GRAD_REL = 1.5e-2

_REF = {}


def _case(T, hd, G):
    """Inputs (numpy f32, bf16-exact) and the JAX package's output and
    gradients of sum(o * g), computed once a case."""
    key = (T, hd, G)
    if key not in _REF:
        H = KVH * G
        rng = np.random.default_rng(T + hd + G)
        bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        q, k, v = (bf(rng.standard_normal(s)) for s in ((1, T, H, hd), (1, T, KVH, hd), (1, T, KVH, hd)))
        g = bf(rng.standard_normal((1, T, H * hd)))
        cfg = dataclasses.replace(JL.LlamaConfig.tiny(), num_heads=H, num_kv_heads=KVH, head_dim=hd)
        jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
        with pltpu.force_tpu_interpret_mode():
            out = JL._flash_attention_causal(jq, jk, jv, cfg)
            grads = jax.grad(
                lambda a, b, c: jnp.sum(JL._flash_attention_causal(a, b, c, cfg).astype(jnp.float32)
                                        * jg.astype(jnp.float32)),
                argnums=(0, 1, 2))(jq, jk, jv)
        f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
        _REF[key] = ((q, k, v, g), f32(out).reshape(1, T, H, hd), [f32(d) for d in grads])
    return _REF[key]


def _torch(a, requires_grad=False):
    return torch.from_numpy(a).to(torch.bfloat16).requires_grad_(requires_grad)


@pytest.mark.parametrize("T,hd,G", CASES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in CASES])
def test_forward_matches_jax_pallas(T, hd, G):
    (q, k, v, _), ref, _ = _case(T, hd, G)
    o, m, l = FA.flash_attention_causal_fwd(_torch(q), _torch(k), _torch(v))
    assert o.dtype == torch.bfloat16 and o.shape == (1, T, KVH * G, hd)
    assert m.shape == l.shape == (1, KVH * G, T) and m.dtype == l.dtype == torch.float32
    err = np.abs(o.float().numpy() - ref).max()
    assert err <= OUT_ATOL, err
    assert bool((l >= 1.0).all()), "l sums exp(s - max s) over at least the row's own key"


@pytest.mark.parametrize("T,hd,G", CASES, ids=[f"T{t}-hd{h}-G{g}" for t, h, g in CASES])
def test_backward_matches_jax_pallas(T, hd, G):
    (q, k, v, g), _, grads = _case(T, hd, G)
    tq, tk, tv = (_torch(a, True) for a in (q, k, v))
    o = FA.flash_attention_causal(tq, tk, tv)
    o.reshape(1, T, -1).backward(_torch(g))
    for name, got, want in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert rel <= GRAD_REL, (name, rel)


def _dense_reference(q, k, v, G):
    """softmax(q k^T / sqrt(hd), causal) v in float64 with autograd."""
    B, T, H, hd = q.shape
    kr, vr = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, kr) * hd**-0.5
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), vr)


@pytest.mark.parametrize("T", [64, 200], ids=["T64", "T200"])
def test_plain_versions_are_causal_attention(T):
    """f32 inputs, B 2, G 2, T below one block and not a multiple of it: the
    output, m, l and the three gradients against float64 autograd."""
    rng = np.random.default_rng(T)
    B, H, hd, G = 2, 4, 32, 2
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((B, T, H, hd), (B, T, H // G, hd), (B, T, H // G, hd), (B, T, H, hd)))
    leaves64 = [t.double().requires_grad_() for t in (q, k, v)]
    ref = _dense_reference(*leaves64, G)
    ref.backward(g.double())
    o, m, l = FA.flash_attention_causal_fwd(q, k, v)
    assert (o.double() - ref.detach()).abs().max().item() <= 1e-5
    s = torch.einsum("bthd,bshd->bhts", leaves64[0].detach(), leaves64[1].detach().repeat_interleave(G, 2))
    s = (s * hd**-0.5).masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    lse = m.double() + torch.log(l.double())
    assert (lse - torch.logsumexp(s, dim=-1)).abs().max().item() <= 1e-5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_causal(*leaves).backward(g)
    for a, b in zip(leaves, leaves64):
        assert (a.grad.double() - b.grad).abs().max().item() <= 1e-4 * b.grad.abs().max().item()


def test_backward_pieces_compose():
    """The dK/dV and dQ plain versions, called as the autograd function calls
    them, give its gradients; ``di`` is sum(o * do) over head_dim."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in ((1, 256, 4, 128), (1, 256, 2, 128), (1, 256, 2, 128), (1, 256, 4, 128)))
    o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = FA.flash_attention_causal_bwd_dkv(q, k, v, do, m, l, di)
    dq = FA.flash_attention_causal_bwd_dq(q, k, v, do, m, l, di)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_causal(*leaves).backward(do)
    for a, b in zip((dq, dk, dv), leaves):
        assert torch.equal(a, b.grad)


def _jax_flash_ok(cfg, T, hd):
    """The JAX package's predicate with its backend taken for a TPU."""
    orig = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        return JL._flash_ok(cfg, T, hd)
    finally:
        jax.default_backend = orig


@pytest.mark.parametrize("window", [None, 4096], ids=["no_window", "window"])
def test_route_predicate_matches_jax(window):
    jcfg = dataclasses.replace(JL.LlamaConfig.tiny(), sliding_window=window)
    tcfg = dataclasses.replace(TL.LlamaConfig.tiny(), sliding_window=window)
    for T in (128, 512, 896, 1000, 1024, 1088, 1152, 2048, 4096, 8192):
        for hd in (64, 96, 128, 256):
            want = _jax_flash_ok(jcfg, T, hd)
            assert TL._flash_ok(tcfg, T, hd, torch.device("cuda")) == want, (T, hd, window)
            # the CPU takes the dense oracle, as the JAX package does on its CPU backend
            assert not TL._flash_ok(tcfg, T, hd, torch.device("cpu"))
            assert not JL._flash_ok(jcfg, T, hd)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks the wrappers make before a launch (run here on CPU
    tensors): bf16, f16 or f32 (the wgmma kernels or the wide family),
    head_dim and T multiples of 128, heads and head_dim packed with 16-byte
    aligned rows; and what the TMA tensor maps of the three wgmma kernels
    need: a base on 16 bytes, every stride a multiple of 16 bytes, at most
    2^32 elements a dimension and strides under 2^40 bytes."""
    q = torch.zeros(1, 256, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 256, 2, 128, dtype=torch.bfloat16)
    FA._check_cuda(q, k, k, 256, 128)
    for ok_q, T, hd in ((q.float(), 256, 128), (q.half(), 256, 128), (q, 256, 384), (q.half(), 256, 512)):
        FA._check_cuda(ok_q, k, k, T, hd)
    for bad_q, T, hd in ((q, 192, 128), (q, 256, 64), (q, 256, 96)):
        with pytest.raises(ValueError):
            FA._check_cuda(bad_q, k, k, T, hd)
    assert FA._strides("q", q) == (256 * 4 * 128, 4 * 128)
    # a view out of a fused qkv row (the model's v) keeps its token stride
    qkv = torch.zeros(1, 256, (4 + 2 + 2) * 128, dtype=torch.bfloat16)
    v = qkv[..., 6 * 128:].reshape(1, 256, 2, 128)
    assert FA._strides("v", v) == (256 * 8 * 128, 8 * 128)
    with pytest.raises(ValueError):
        FA._strides("q", q.transpose(1, 2))
    o, m, l = FA.flash_attention_causal_fwd(q.half(), k.half(), k.half())  # the plain versions take f16 too
    assert o.dtype == torch.float16 and m.dtype == l.dtype == torch.float32
    with pytest.raises(ValueError):
        FA.flash_attention_causal_fwd(q.double(), k.double(), k.double())
    # TMA: a base off 16 bytes, a token stride off 16 bytes (a fused row 4 values wider)
    flat = torch.zeros(256 * 4 * 128 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FA._strides("q", flat[1:1 + 256 * 4 * 128].view(1, 256, 4, 128))
    wide = torch.zeros(1, 256, (4 + 2 + 2) * 128 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FA._strides("v", wide[..., 6 * 128:8 * 128].reshape(1, 256, 2, 128))
    # dimensions and strides, on meta tensors (no storage)
    FA._tma_ok("q", q)
    FA._tma_ok("v", v)
    FA._tma_ok("q", torch.empty(1, 1 << 31, 1, 128, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="dimension"):
        FA._tma_ok("q", torch.empty(FA.TMA_MAX_DIM + 1, 128, 1, 128, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="stride"):
        FA._tma_ok("q", torch.empty(2, FA.TMA_MAX_DIM, 1, 128, dtype=torch.bfloat16, device="meta"))
    # the dK/dV kernel reads q, k, v and do through TMA and copies the rows' m,
    # l and di in bulk from bases on 16 bytes
    rows = torch.zeros(1, 4, 256)
    FA._dkv_checks(q, k, k, q, rows, rows, rows)
    FA._dkv_checks(*(t.to("meta") for t in (q, k, k, q, rows, rows, rows)))
    off = torch.zeros(4 * 256 + 1)[1:].view(1, 4, 256)
    for i in range(3):
        bad = [rows, rows, rows]
        bad[i] = off
        with pytest.raises(ValueError, match="aligned"):
            FA._dkv_checks(q, k, k, q, *bad)
    huge = torch.empty(FA.TMA_MAX_DIM + 1, 128, 1, 128, dtype=torch.bfloat16, device="meta")
    wide = torch.empty(2, FA.TMA_MAX_DIM, 1, 128, dtype=torch.bfloat16, device="meta")
    for i in range(4):
        for bad_t, what in ((huge, "dimension"), (wide, "stride")):
            args = [q, k, k, q]
            args[i] = bad_t
            with pytest.raises(ValueError, match=what):
                FA._dkv_checks(*args, rows, rows, rows)
    # the dQ kernel reads q, k, v and do through TMA too: everything its
    # wrapper checks before a launch, on CPU and meta tensors
    FA._dq_args(q, k, k, q, rows, rows, rows)
    FA._dq_args(*(t.to("meta") for t in (q, k, k, q, rows, rows, rows)))
    for i in range(4):
        heads = 4 if i in (0, 3) else 2
        n = 256 * heads * 128
        off_base = torch.zeros(n + 8, dtype=torch.bfloat16)[1:1 + n].view(1, 256, heads, 128)
        off_stride = torch.zeros(1, 256, heads * 128 + 4, dtype=torch.bfloat16)[..., :heads * 128]
        off_stride = off_stride.reshape(1, 256, heads, 128)
        assert off_base.data_ptr() % 16 and off_stride.stride(1) * 2 % 16
        for bad_t in (off_base, off_stride):
            args = [q, k, k, q]
            args[i] = bad_t
            with pytest.raises(ValueError, match="aligned"):
                FA._dq_args(*args, rows, rows, rows)
        for bad_t, what in ((huge, "dimension"), (wide, "stride")):
            args = [q, k, k, q]
            args[i] = bad_t
            with pytest.raises(ValueError, match=what):
                FA._dq_checks(*args)
    big = FA.TMA_MAX_DIM + 1
    with pytest.raises(ValueError, match="dimension"):
        FA._dq_args(*(torch.empty(big, 128, n, 128, dtype=torch.bfloat16, device="meta") for n in (4, 2, 2, 4)),
                    *(torch.empty(big, 4, 128, device="meta"),) * 3)


# chip_smoke.py's 3p shapes (B, T, H, KVH, hd) and its batched ones, on an
# H100's 132 SMs, one block an SM: hd 384 and 512 cut a key tile into 3 and
# 4 column slices
PLAN_SHAPES = [(1, t, 32, 8, 128) for t in (1024, 2048, 4096, 8192)] + [(1, 4096, 16, 16, 256), (2, 1152, 8, 2, 128),
                                                                      (3, 640, 2, 1, 256)]
PLAN_SHAPES += [(1, 2048, 8, 8, 384), (1, 2048, 8, 8, 512), (2, 640, 4, 2, 384), (2, 640, 4, 2, 512)]
SMS = 132


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=["B{}-T{}-H{}-KVH{}-hd{}".format(*s) for s in PLAN_SHAPES])
def test_dkv_plan_covers_each_tile_once_in_a_fixed_order(shape):
    """Each key tile's (query head, query tile) pairs from the diagonal down
    are covered exactly once; a split key tile's pieces hold consecutive
    slots in iteration order and are combined in that order; no item
    carries more iterations than the target, the mean work of a slot
    rounded up; items go longest first; the plan is the same every call."""
    B, T, H, KVH, hd = shape
    G, ntiles, halves = H // KVH, T // FA.DKV_KEYS, hd // FA.DKV_COLS
    plan = FA.dkv_plan(B, T, H, KVH, hd, SMS)
    assert plan == FA.dkv_plan(B, T, H, KVH, hd, SMS)
    total = B * KVH * halves * G * ntiles * (ntiles + 1) // 2
    sizes = [it[5] - it[4] for it in plan.items]
    assert sum(sizes) == total and sizes == sorted(sizes, reverse=True)
    assert plan.target == max(-(-total // SMS), FA.DKV_MIN_PIECE) and max(sizes) <= plan.target
    seen = collections.Counter()
    for b, kvh, kj, half, i0, i1, slot, pad in plan.items:
        nq = ntiles - kj
        assert 0 <= i0 < i1 <= G * nq and pad == 0 and slot >= -1
        for i in range(i0, i1):
            seen[(b, kvh, kj, half, kvh * G + i // nq, kj + i % nq)] += 1
    want = {(b, kvh, kj, half, h, t) for b in range(B) for kvh in range(KVH) for kj in range(ntiles)
            for half in range(halves) for h in range(kvh * G, (kvh + 1) * G) for t in range(kj, ntiles)}
    assert set(seen) == want and set(seen.values()) == {1}
    by_slot = {it[6]: it for it in plan.items if it[6] >= 0}
    assert sorted(by_slot) == list(range(plan.slots))
    split = set()
    for b, kvh, kj, half, s0, pieces, *pad in plan.combine:
        assert pieces >= 2 and pad == [0, 0]
        cuts = [by_slot[s0 + p][4:6] for p in range(pieces)]
        assert all(by_slot[s0 + p][:4] == (b, kvh, kj, half) for p in range(pieces))
        assert cuts[0][0] == 0 and cuts[-1][1] == G * (ntiles - kj)
        assert all(a[1] == c[0] for a, c in zip(cuts, cuts[1:]))
        assert max(c[1] - c[0] for c in cuts) - min(c[1] - c[0] for c in cuts) <= 1
        split.add((b, kvh, kj, half))
    whole = [it[:4] for it in plan.items if it[6] < 0]
    assert len(whole) == len(set(whole)) and not split & set(whole)
    assert len(whole) + len(split) == B * KVH * ntiles * halves
    # the plan splits only where a key tile's work exceeds a slot's mean
    assert bool(plan.combine) == (G * ntiles > plan.target)


def _dkv_by_plan(q, k, v, do, m, l, di, plan):
    """dK and dV as the kernel computes them under ``plan``, in PyTorch: each
    item sums p^T do and ds^T q over its iterations in order in f32 (p and ds
    rounded to bf16), stores its key tile in bf16 or writes f32 partials,
    which the plain combine adds."""
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    G, ntiles, C = H // KVH, T // FA.DKV_KEYS, FA.DKV_COLS
    p, ds, *_ = FA._probs_and_ds(q, k, v, do, m, l, di, 0, T)  # [B, H, T, T]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part_k = torch.empty(plan.slots, FA.DKV_KEYS, C)
    part_v = torch.empty_like(part_k)
    for b, kvh, kj, half, i0, i1, slot, _ in plan.items:
        keys, cols = slice(kj * 64, kj * 64 + 64), slice(half * C, half * C + C)
        ak, av = torch.zeros(64, C), torch.zeros(64, C)
        for i in range(i0, i1):
            h, t = kvh * G + i // (ntiles - kj), kj + i % (ntiles - kj)
            rows = slice(t * 64, t * 64 + 64)
            pt = p[b, h, rows, keys].to(torch.bfloat16).float().T
            st = ds[b, h, rows, keys].to(torch.bfloat16).float().T
            av += pt @ do[b, rows, h, cols].float()
            ak += st @ q[b, rows, h, cols].float()
        if slot < 0:
            dk[b, keys, kvh, cols], dv[b, keys, kvh, cols] = ak.to(k.dtype), av.to(v.dtype)
        else:
            part_k[slot], part_v[slot] = ak, av
    table = torch.tensor(plan.combine, dtype=torch.int32).reshape(-1, 8)
    return FA.flash_attention_causal_bwd_dkv_combine(part_k, part_v, table, dk, dv)


@pytest.mark.parametrize("hd,slots,T", [(128, 30, 512), (256, 60, 512), (384, 48, 384)],
                         ids=["hd128-split", "hd256-split", "hd384-split"])
def test_dkv_plan_computes_the_plain_gradients(hd, slots, T):
    """A plan that splits key tiles (few slots), computed item by item as the
    kernel computes it, gives the plain version's dk and dv (bf16 inputs;
    within 1e-2 of the largest magnitude, the card's gate: the sums run in
    another order and round once).  At hd 384 the combine writes split key
    tiles in every column slice, the second and third included."""
    rng = np.random.default_rng(hd + slots)
    B, H, KVH = 2, 4, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in ((B, T, H, hd), (B, T, KVH, hd), (B, T, KVH, hd), (B, T, H, hd)))
    o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    plan = FA.dkv_plan(B, T, H, KVH, hd, slots)
    assert plan.combine and any(it[6] < 0 for it in plan.items)
    assert {row[3] for row in plan.combine} == set(range(hd // FA.DKV_COLS))
    dk, dv = _dkv_by_plan(q, k, v, do, m, l, di, plan)
    dkp, dvp = FA.flash_attention_causal_bwd_dkv_plain(q, k, v, do, m, l, di)
    for got, want in ((dk, dkp), (dv, dvp)):
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        assert rel <= 1e-2, rel


def test_dkv_combine_adds_pieces_in_order():
    """The plain combine (the kernel's reference on the card): each split key
    tile's partials added in piece order in f32, rounded once to bf16, into
    its own rows and columns; every other element untouched."""
    rng = np.random.default_rng(3)
    B, T, KVH, hd = 2, 384, 2, 256
    plan = FA.dkv_plan(B, T, 4, KVH, hd, 40)
    table = torch.tensor(plan.combine, dtype=torch.int32).reshape(-1, 8)
    part_k, part_v = (torch.from_numpy(rng.standard_normal((plan.slots, 64, 128)).astype(np.float32) * 1e3)
                      for _ in range(2))
    dk, dv = torch.full((B, T, KVH, hd), 7.0, dtype=torch.bfloat16), torch.full((B, T, KVH, hd), 7.0,
                                                                                   dtype=torch.bfloat16)
    out = FA.flash_attention_causal_bwd_dkv_combine(part_k, part_v, table, dk, dv)
    assert out[0] is dk and out[1] is dv
    touched = torch.zeros(B, T, KVH, hd, dtype=torch.bool)
    for b, kvh, kj, half, s0, pieces, _, _ in plan.combine:
        for part, got in ((part_k, dk), (part_v, dv)):
            acc = part[s0].numpy().copy()
            for i in range(1, pieces):
                acc = (acc + part[s0 + i].numpy()).astype(np.float32)
            want = torch.from_numpy(acc).to(torch.bfloat16)
            assert torch.equal(got[b, kj * 64:kj * 64 + 64, kvh, half * 128:half * 128 + 128], want)
        touched[b, kj * 64:kj * 64 + 64, kvh, half * 128:half * 128 + 128] = True
    assert touched.any() and not touched.all()
    assert (dk[~touched] == 7.0).all() and (dv[~touched] == 7.0).all()
