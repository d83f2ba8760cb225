#!/usr/bin/env python3
"""Kernel 17's f32 instance at head_dim 128 and 256 (the causal flash forward
on three-pass TF32 ``wgmma``, ``csrc/flash_attention.cu``'s
``flash_tf32_fwd_kernel``) on one NVIDIA GPU, in one process.

    python3 experiments/ab_flash_fwd_tf32_torch.py [--parent ROOT] [--variants NAME ...] [--quick] [--untrapped]

1. Builds: ``csrc/flash_attention.cu`` alone, each with ``nvcc -Xptxas -v``
   into its own library under ``_probe/fwd_tf32/`` (git-ignored), all at
   once: each design variant of this source (a text-edited copy; trapped
   unless ``--untrapped``: its ``mbar_wait`` traps after 2^24 tries, so a
   deadlock fails its launch instead of hanging the card); with ``--parent
   ROOT`` (an earlier commit unpacked with ``git archive``) this source and
   the parent's, untrapped.  Printed: ptxas's registers, spills and C75xx
   notes (``wgmma`` serialized) of the TF32 forward's instances, and the
   ``HGMMA`` (``.TF32`` among them), ``UTMALDG`` and ``STL`` counts of their
   SASS.
2. With ``--parent``: every 16-bit ``wgmma`` instance, TF32 dK/dV and dQ
   instance and wide-family kernel the parent has, this source's SASS
   against the parent's, instruction by instruction (addresses and
   encodings stripped).
3. Each variant through the port's wrapper on f32 q, k, v: B 1, T 2048, H 32
   over 8, hd 128 (``chip_smoke.py`` 4r's attention) and H 16 over 16, hd
   256 (Gemma-7B's), two batched GQA shapes (B 2, T 1152, H 8 over 2, hd
   128; B 2, T 640, H 4 over 2, hd 256) and the shortest T (128): o within
   1e-5 abs, m within 1e-4 abs and l within 1e-5 of its largest of the plain
   version (``chip_smoke.FLASH_TOLERANCES["float32"]``), o, m and l bit for
   bit on a second call, one launch of ``..._fwd_tf32``; then device ms
   (``cuda_time(flush_l2=True, hold=True)``, median of 20) at the timed
   shapes, the variants in turns and again in reverse.
4. With ``--parent``, the A/B: parent, change, change, parent on the same
   tensors, each through its own library's C entry (the parent's f32
   forward is the wide family's ``_wide`` entry), at f32 hd 128 (H 32 over
   8) and hd 256 (H 16 over 16), T 1024, 2048 and 4096; SDPA's f32 forward
   at each shape.  Then the kernels the change leaves as they were, in
   eight turns (parent, change, change, parent, twice), each through its
   own library's C entry: bf16 forward, dK/dV and dQ at hd 128 (T 2048, H
   32 over 8) and at hd 512 (H 8 over 8), the f32 TF32 dK/dV and dQ and the
   f32 wide forward at hd 128; their outputs bit for bit the parent's.

``--quick`` builds the trapped source alone (with ``--parent``, also the
change and the parent for step 2) and runs step 3 once, untimed but for one
pass: a new kernel's first call on the card.

The variants:

* ``source``: as committed (four ring stages at hd 128, three at 256; S's
  first chunk peeled, so that its chains start with a scale_d of 0 known at
  compile time);
* ``one_acc``: S's three passes chained in one accumulator (the source
  chains its big * big passes apart from its two small ones);
* ``no_peel``: S's chunk loop not peeled, its first ``wgmma`` taking a
  scale_d known only at run time;
* ``stages3``: three ring stages at hd 128, two at 256;
* ``stages5``: five ring stages at hd 128;
* ``rna``: big rounded by ``cvt.rna.tf32.f32`` too (every split, the
  TF32 dK/dV's and dQ's included).

Prints one JSON line per build, check and timing, then the times side by
side.
"""

from __future__ import annotations

import os
import sys

from _ab_flash import ROOT, build_all, emit, parser, sub

OUT = os.path.join(ROOT, "_probe", "fwd_tf32")
O_GATE, M_GATE, L_GATE = 1e-5, 1e-4, 1e-5  # chip_smoke.FLASH_TOLERANCES["float32"]'s forward gates
NEW = "flash_tf32_fwd_kernel"
# (B, T, H, KVH, hd), f32: the timed shapes first
TIMED = [(1, 2048, 32, 8, 128), (1, 2048, 16, 16, 256)]
CHECKED = TIMED + [(2, 1152, 8, 2, 128), (2, 640, 4, 2, 256), (1, 128, 2, 1, 128)]
AB = [(1, T, 32, 8, 128) for T in (1024, 2048, 4096)] + [(1, T, 16, 16, 256) for T in (1024, 2048, 4096)]

CFG = "    static constexpr int kStages = HD == 128 ? 4 : 3;"
BIG = "    big = __float_as_uint(x) & 0xFFFFE000u;"

# S in one accumulator chain (tf32x3), the two small passes not apart
ACC2 = """                wgmma_rs_tf32_n64(acc, f[0], f[1], f[2], f[3], db, sd);
                wgmma_rs_tf32_n64(acc2, f[0], f[1], f[2], f[3], ds, sd);
                wgmma_rs_tf32_n64(acc2, f[4], f[5], f[6], f[7], db, 1);"""
ACC2_SUM = "            for (int i = 0; i < 32; ++i) acc[i] += acc2[i];"
# S's first chunk not peeled: scale_d known only at run time
SD = "                const int sd = decltype(first)::value && kk == 0 ? 0 : 1;"
PEEL = """            s_chunk(a, 0, std::true_type{});
#pragma unroll 1
            for (int c = 1; c < C::kChunks; ++c) s_chunk(a, c, std::false_type{});"""


def one_acc(s: str) -> str:
    s = sub(s, ACC2, "                tf32x3(acc, f, db, ds, sd);")
    return sub(s, ACC2_SUM, "            for (int i = 0; i < 32; ++i) acc2[i] = 0.0f;")


def no_peel(s: str) -> str:
    s = sub(s, SD, "                const int sd = c > 0 || kk > 0;")
    return sub(s, PEEL, """#pragma unroll 1
            for (int c = 0; c < C::kChunks; ++c) s_chunk(a, c, std::false_type{});""")


VARIANTS = {
    "source": (lambda s: s, lambda s: s),
    "one_acc": (one_acc, lambda s: s),
    "no_peel": (no_peel, lambda s: s),
    "stages3": (lambda s: sub(s, CFG, CFG.replace("? 4 : 3", "? 3 : 2")), lambda s: s),
    "stages5": (lambda s: sub(s, CFG, CFG.replace("? 4 : 3", "? 5 : 3")), lambda s: s),
    "rna": (lambda s: s, lambda s: sub(s, BIG, '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));')),
}


def main(argv) -> int:
    args = parser(VARIANTS).parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    variants, prefix, libs, same_sass = build_all(args, VARIANTS, OUT, NEW)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)

    def inputs(B, T, H, KVH, hd):
        q = torch.randn(B, T, H, hd, generator=gen, device=dev)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)  # a view of a fused projection, as the model's
        return q, k, v

    def dev_ms(fn):
        return cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]

    def errs(got, plain):
        (o, m, l), (op, mp, lp) = got, plain
        return {"o_abs": (o - op).abs().max().item(), "m_abs": (m - mp).abs().max().item(),
                "l_rel": ((l - lp).abs().max() / lp.abs().max()).item()}

    # 3. the variants through the port's wrapper
    data = {}
    for case in CHECKED:
        qkv = inputs(*case)
        data[case] = (qkv, FA.flash_attention_causal_fwd_plain(*qkv))
    all_ok = True
    for n in variants:
        _lib._lib = libs[prefix + n]
        rows = []
        for case in CHECKED:
            qkv, plain = data[case]
            _lib.reset_launch_counts()
            got = FA.flash_attention_causal_fwd(*qkv)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES["flash_attention_causal_fwd_tf32"] == 1
            e = errs(got, plain)
            same = all(torch.equal(a, b) for a, b in zip(FA.flash_attention_causal_fwd(*qkv), got))
            ok = e["o_abs"] <= O_GATE and e["m_abs"] <= M_GATE and e["l_rel"] <= L_GATE and same and launched
            all_ok &= ok
            rows.append({"case": case, "ok": ok, "same_bits": same, **e})
        emit("check", variant=n, all_ok=all(r["ok"] for r in rows), rows=rows)
    timed = {}
    for order in (variants, variants[::-1]):
        for n in order:
            _lib._lib = libs[prefix + n]
            for case in TIMED:
                qkv = data[case][0]
                timed.setdefault(str(case), {}).setdefault(n, []).append(
                    dev_ms(lambda: FA.flash_attention_causal_fwd(*qkv)))
        if args.quick:
            break
    emit("variants_device_ms", **timed)
    if not args.parent or args.quick:
        return 0 if all_ok and same_sass else 1

    # 4. parent, change, change, parent through each library's C entries
    def fwd(lib, entry, q, k, v, *_):
        B, T, H, hd = q.shape
        o = torch.empty_like(q)
        m, l = (torch.empty(B, H, T, device=dev) for _ in range(2))
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
                                  l.data_ptr(), B, T, H, k.shape[2], hd, q.stride(0), q.stride(1), k.stride(0),
                                  k.stride(1), v.stride(0), v.stride(1), hd**-0.5, FA._KIND[q.dtype], _lib.stream(q))
        _lib.check(err, entry)
        return o, m, l

    def dq(lib, entry, q, k, v, do, m, l, di):
        B, T, H, hd = q.shape
        out = torch.empty_like(q)
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            out.data_ptr(), B, T, H, k.shape[2], hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1), hd**-0.5, FA._KIND[q.dtype], _lib.stream(q))
        _lib.check(err, entry)
        return (out,)

    def dkv(lib, entry, q, k, v, do, m, l, di):
        B, T, H, hd = q.shape
        KVH = k.shape[2]
        plan, items, table = FA._dkv_tables(B, T, H, KVH, hd, dev)
        dk, dv = torch.empty_like(k), torch.empty_like(k)
        part_k = part_v = None
        if plan.slots:
            part_k = torch.empty(plan.slots, FA.DKV_KEYS, FA.DKV_COLS, dtype=torch.float32, device=dev)
            part_v = torch.empty_like(part_k)
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), None if part_k is None else part_k.data_ptr(),
            None if part_v is None else part_v.data_ptr(), items.data_ptr(), len(plan.items), B, T, H, KVH, hd,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            hd**-0.5, FA._KIND[q.dtype], _lib.stream(q))
        _lib.check(err, entry)
        if plan.slots:
            err = lib.bnb_flash_attention_causal_bwd_dkv_combine(
                part_k.data_ptr(), part_v.data_ptr(), table.data_ptr(), table.shape[0], dk.data_ptr(),
                dv.data_ptr(), T, KVH, hd, FA._KIND[q.dtype], _lib.stream(q))
            _lib.check(err, "combine")
        return dk, dv

    for case in AB:
        if case not in data:
            data[case] = (inputs(*case), None)
    sdpa = {}
    for case in AB:
        q, k, v = data[case][0]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa[str(case)] = dev_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                                           enable_gqa=True))
        del qt, kt, vt
    emit("sdpa_f32_fwd_device_ms", **sdpa)
    runs, outs = {}, {}
    for side in ("parent", "change", "change", "parent"):
        lib = libs[side]
        entry = "bnb_flash_attention_causal_fwd_" + ("tf32" if side == "change" else "wide")
        for case in AB:
            qkv = data[case][0]
            got = fwd(lib, entry, *qkv)
            ms = dev_ms(lambda: fwd(lib, entry, *qkv))
            prev = outs.setdefault((side, case), got)
            if not all(torch.equal(a, b) for a, b in zip(prev, got)):
                emit("differs_from_run_to_run", side=side, case=case)
                return 1
            runs.setdefault(f"f32 B{case[0]} T{case[1]} H{case[2]} KVH{case[3]} hd{case[4]} fwd", []).append(
                (side, entry, ms))
    diffs = {}
    for case in AB:
        (o0, m0, l0), (o1, m1, l1) = outs[("parent", case)], outs[("change", case)]
        diffs[str(case)] = {"o_abs_change_vs_parent": (o1 - o0).abs().max().item(),
                            "m_abs": (m1 - m0).abs().max().item(),
                            "l_rel": ((l1 - l0).abs().max() / l0.abs().max()).item()}
    emit("ab_device_ms", order=["parent", "change", "change", "parent"],
         **{k: {"entries": [e for _, e, _ in v], "ms": [ms for _, _, ms in v]} for k, v in runs.items()})
    emit("ab_outputs", **diffs)

    # the unchanged kernels, eight turns
    def bwd_inputs(dt, *case):
        q, k, v = inputs(*case)
        do = torch.randn_like(q)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        return tuple(t.to(dt) for t in (q, k, v, do)) + (m, l, di)

    same = {}
    for hd, H, KVH in ((128, 32, 8), (512, 8, 8)):
        bwd = bwd_inputs(torch.bfloat16, 1, 2048, H, KVH, hd)
        for key, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
            same[(f"bf16 hd{hd} {key}", fn, "bnb_flash_attention_causal_" + {"fwd": "fwd", "dkv": "bwd_dkv",
                                                                            "dq": "bwd_dq"}[key])] = bwd
    bwd32 = bwd_inputs(torch.float32, 1, 2048, 32, 8, 128)
    same[("f32 tf32 hd128 dkv", dkv, "bnb_flash_attention_causal_bwd_dkv_tf32")] = bwd32
    same[("f32 tf32 hd128 dq", dq, "bnb_flash_attention_causal_bwd_dq_tf32")] = bwd32
    same[("f32 wide hd128 fwd", fwd, "bnb_flash_attention_causal_fwd_wide")] = bwd32
    turns, ref_out = {}, {}
    for side in ("parent", "change", "change", "parent") * 2:
        for (label, fn, entry), bwd in same.items():
            got = fn(libs[side], entry, *bwd)
            if not all(torch.equal(a, b) for a, b in zip(ref_out.setdefault(label, got), got)):
                emit("unchanged_kernel_differs", kernel=label, side=side)
                return 1
            turns.setdefault(label, {}).setdefault(side, []).append(dev_ms(lambda: fn(libs[side], entry, *bwd)))

    def mid(xs):  # the mean of the middle two of four
        return sum(sorted(xs)[1:3]) / 2

    emit("unchanged_device_ms", order=["parent", "change", "change", "parent"] * 2,
         **{k: {**v, "change_over_parent": mid(v["change"]) / mid(v["parent"])} for k, v in turns.items()})
    return 0 if all_ok and same_sass else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
