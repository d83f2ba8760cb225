#!/usr/bin/env python3
"""Kernel 18's f32 instance at head_dim 128 and 256 (the causal flash dK/dV
on three-pass TF32 ``wgmma``, ``csrc/flash_attention.cu``'s
``flash_tf32_dkv_kernel``) on one NVIDIA GPU, in one process.

    python3 experiments/ab_flash_dkv_tf32_torch.py [--parent ROOT] [--variants NAME ...] [--quick] [--untrapped]

1. Builds: ``csrc/flash_attention.cu`` alone, each with ``nvcc -Xptxas -v``
   into its own library under ``_probe/dkv_tf32/`` (git-ignored), all at
   once: each design variant of this source (a text-edited copy; trapped
   unless ``--untrapped``: its ``mbar_wait`` traps after 2^24 tries, so a
   deadlock fails its launch instead of hanging the card); with ``--parent
   ROOT`` (an earlier commit unpacked with ``git archive``) this source and
   the parent's, untrapped.  Printed: ptxas's registers, spills and C75xx
   notes (``wgmma`` serialized) of the TF32 instances, and the ``HGMMA``
   (``.TF32`` among them), ``UTMALDG`` and ``STL`` counts of their SASS.
2. With ``--parent``: every 16-bit ``wgmma`` instance and wide-family
   kernel the parent has, this source's SASS against the parent's,
   instruction by instruction (addresses and encodings stripped).
3. Each variant through the port's wrapper on f32 q, k, v: B 1, T 2048, H 32
   over 8, hd 128 (``chip_smoke.py`` 4r's attention) and H 16 over 16, hd
   256 (Gemma-7B's), the batched GQA shape whose plan splits key tiles (B
   2, T 1152, H 8 over 2), B 2, T 640, H 4 over 2 at hd 256, and the
   shortest T (128): dk and dv against the plain version within
   ``FLASH_TOLERANCES["float32"]``'s 1e-4 of their largest magnitude, bit
   for bit on a second call, one launch of ``..._bwd_dkv_tf32``; then
   device ms (``cuda_time(flush_l2=True, hold=True)``, median of 20) at
   the timed shapes, the variants in turns and again in reverse.
4. With ``--parent``, the A/B: parent, change, change, parent on the same
   tensors, each through its own library's C entry (the parent's f32 dK/dV
   is the wide family's ``_wide`` entry), at f32 hd 128, T 1024, 2048 and
   4096 (H 32 over 8) and hd 256, T 2048 (H 16 over 16); the wide dQ on
   both sides at hd 128, T 2048 (unchanged code: its bits and time must
   not move); SDPA's f32 backward (dq, dk and dv in one call) at each
   shape.  Then the kernels the change leaves as they were, in eight turns
   (parent, change, change, parent, twice), each through its own library's
   C entry: bf16 forward, dK/dV and dQ at hd 128 (T 2048, H 32 over 8) and
   at hd 512 (H 8 over 8), the f32 wide forward and dQ at hd 128; their
   outputs bit for bit the parent's.

``--quick`` builds the trapped source alone (with ``--parent``, also the
change and the parent for step 2) and runs step 3 once, untimed but for one
pass: a new kernel's first call on the card.

The variants:

* ``source``: as committed (four ring stages at hd 128, two at 256; big
  by zeroing x's low 13 bits, small by ``cvt.rna.tf32.f32``);
* ``stages3``: three ring stages at hd 128;
* ``rna``: big rounded by ``cvt.rna.tf32.f32`` too;
* ``trunc2``: small truncated too.

Prints one JSON line per build, check and timing, then the times side by
side.
"""

from __future__ import annotations

import os
import sys

from _ab_flash import ROOT, build_all, emit, parser, sub

OUT = os.path.join(ROOT, "_probe", "dkv_tf32")
GATE = 1e-4  # chip_smoke.FLASH_TOLERANCES["float32"]'s gradient gate
# (B, T, H, KVH, hd), f32: the timed shapes first
TIMED = [(1, 2048, 32, 8, 128), (1, 2048, 16, 16, 256)]
CHECKED = TIMED + [(2, 1152, 8, 2, 128), (2, 640, 4, 2, 256), (1, 128, 2, 1, 128)]
AB = [(1, 1024, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 2048, 16, 16, 256)]

CFG = "    static constexpr int kStages = HD == 128 ? 4 : 2;"
BIG = "    big = __float_as_uint(x) & 0xFFFFE000u;"
SMALL = '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(__fsub_rn(x, __uint_as_float(big))));'

VARIANTS = {
    "source": (lambda s: s, lambda s: s),
    "stages3": (lambda s: sub(s, CFG, CFG.replace("? 4 : 2", "? 3 : 2")), lambda s: s),
    "rna": (lambda s: s, lambda s: sub(s, BIG, '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));')),
    "trunc2": (lambda s: s, lambda s: sub(s, SMALL, "    small = __float_as_uint(__fsub_rn(x, __uint_as_float(big))) & "
                                                    "0xFFFFE000u;")),
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
    variants, prefix, libs, _ = build_all(args, VARIANTS, OUT, "flash_tf32_dkv_kernel")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)

    def inputs(B, T, H, KVH, hd):
        q = torch.randn(B, T, H, hd, generator=gen, device=dev)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)  # a view of a fused projection, as the model's
        do = torch.randn(B, T, H, hd, generator=gen, device=dev)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, m, l, di

    def dev_ms(fn):
        return cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    # 3. the variants through the port's wrapper
    data = {}
    for case in CHECKED:
        bwd = inputs(*case)
        data[case] = (bwd, FA.flash_attention_causal_bwd_dkv_plain(*bwd))
    for n in variants:
        _lib._lib = libs[prefix + n]
        rows = []
        for case in CHECKED:
            bwd, (dkp, dvp) = data[case]
            _lib.reset_launch_counts()
            dk, dv = FA.flash_attention_causal_bwd_dkv(*bwd)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES["flash_attention_causal_bwd_dkv_tf32"] == 1
            errs = {"dk_rel": rel(dk, dkp), "dv_rel": rel(dv, dvp)}
            same = all(torch.equal(a, b) for a, b in zip(FA.flash_attention_causal_bwd_dkv(*bwd), (dk, dv)))
            splits = len(FA._dkv_tables(*case, dev)[0].combine)
            ok = max(errs.values()) <= GATE and same and launched
            rows.append({"case": case, "ok": ok, "same_bits": same, "split_key_tiles": splits, "errs": errs})
        emit("check", variant=n, all_ok=all(r["ok"] for r in rows), rows=rows)
    timed = {}
    for order in (variants, variants[::-1]):
        for n in order:
            _lib._lib = libs[prefix + n]
            for case in TIMED:
                bwd = data[case][0]
                timed.setdefault(str(case), {}).setdefault(n, []).append(
                    dev_ms(lambda: FA.flash_attention_causal_bwd_dkv(*bwd)))
        if args.quick:
            break
    emit("variants_device_ms", **timed)
    if not args.parent or args.quick:
        return 0

    # 4. parent, change, change, parent through each library's C entries
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

    def dq(lib, entry, q, k, v, do, m, l, di):
        B, T, H, hd = q.shape
        out = torch.empty_like(q)
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            out.data_ptr(), B, T, H, k.shape[2], hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1), hd**-0.5, FA._KIND[q.dtype], _lib.stream(q))
        _lib.check(err, entry)
        return (out,)

    for case in AB:
        if case not in data:
            data[case] = (inputs(*case), None)
    sdpa = {}
    for case in AB:
        q, k, v, do = data[case][0][:4]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        sdpa[str(case)] = dev_ms(lambda: torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, so
    emit("sdpa_f32_bwd_device_ms", **sdpa)
    work = [(case, "dkv") for case in AB] + [(AB[1], "dq")]
    runs, outs = {}, {}
    for turn, side in enumerate(("parent", "change", "change", "parent")):
        lib = libs[side]
        for case, key in work:
            bwd = data[case][0]
            fn = dkv if key == "dkv" else dq
            entry = ("bnb_flash_attention_causal_bwd_dkv_tf32" if side == "change"
                     else "bnb_flash_attention_causal_bwd_dkv_wide") if key == "dkv" \
                else "bnb_flash_attention_causal_bwd_dq_wide"
            got = fn(lib, entry, *bwd)
            ms = dev_ms(lambda: fn(lib, entry, *bwd))
            prev = outs.setdefault((side, case, key), got)
            if not all(torch.equal(a, b) for a, b in zip(prev, got)):
                emit("differs_from_run_to_run", side=side, case=case, kernel=key)
                return 1
            runs.setdefault(f"f32 B{case[0]} T{case[1]} H{case[2]} KVH{case[3]} hd{case[4]} {key}", []).append(
                (side, entry, ms))
    errs = {}
    for case, key in work:
        a, b = outs[("parent", case, key)], outs[("change", case, key)]
        errs[f"{case} {key}"] = {"same_bits": all(torch.equal(x, y) for x, y in zip(a, b)),
                                 "max_rel_change_vs_parent": max(rel(y, x) for x, y in zip(a, b))}
    emit("ab_device_ms", order=["parent", "change", "change", "parent"],
         **{k: {"entries": [e for _, e, _ in v], "ms": [ms for _, _, ms in v]} for k, v in runs.items()})
    emit("ab_outputs", **errs)

    def fwd(lib, entry, q, k, v, do, m, l, di):
        B, T, H, hd = q.shape
        o, mo, lo = torch.empty_like(q), torch.empty_like(m), torch.empty_like(l)
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), mo.data_ptr(),
                                  lo.data_ptr(), B, T, H, k.shape[2], hd, q.stride(0), q.stride(1), k.stride(0),
                                  k.stride(1), v.stride(0), v.stride(1), hd**-0.5, FA._KIND[q.dtype], _lib.stream(q))
        _lib.check(err, entry)
        return o, mo, lo

    # the unchanged kernels, eight turns
    same = {}
    for case in ((torch.bfloat16, 1, 2048, 32, 8, 128), (torch.bfloat16, 1, 2048, 8, 8, 512)):
        bwd = tuple(t.to(case[0]) if i < 4 else t for i, t in enumerate(inputs(*case[1:])))
        for key, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
            same[(f"bf16 hd{case[5]} {key}", key, fn)] = bwd
    for key, fn in (("fwd", fwd), ("dq", dq)):
        same[(f"f32 wide hd128 {key}", key, fn)] = data[AB[1]][0]
    turns, ref_out = {}, {}
    for side in ("parent", "change", "change", "parent") * 2:
        for (label, key, fn), bwd in same.items():
            entry = {"fwd": "bnb_flash_attention_causal_fwd", "dkv": "bnb_flash_attention_causal_bwd_dkv",
                     "dq": "bnb_flash_attention_causal_bwd_dq"}[key] + ("_wide" if "wide" in label else "")
            got = fn(libs[side], entry, *bwd)
            if not all(torch.equal(a, b) for a, b in zip(ref_out.setdefault(label, got), got)):
                emit("unchanged_kernel_differs", kernel=label, side=side)
                return 1
            turns.setdefault(label, {}).setdefault(side, []).append(dev_ms(lambda: fn(libs[side], entry, *bwd)))
    def mid(xs):  # the mean of the middle two of four
        return sum(sorted(xs)[1:3]) / 2

    emit("unchanged_device_ms", order=["parent", "change", "change", "parent"] * 2,
         **{k: {**v, "change_over_parent": mid(v["change"]) / mid(v["parent"])} for k, v in turns.items()})
    # the wide dQ is the same code on both sides: its bits must not move
    return 0 if errs[f"{AB[1]} dq"]["same_bits"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
