#!/usr/bin/env python3
"""Kernel 17's 16-bit instance from head_dim 640 (the causal flash forward
with head_dim streamed in chunks, ``csrc/flash_attention.cu``'s
``flash_streamed_fwd_kernel``) on one NVIDIA GPU, in one process.

    python3 experiments/ab_flash_fwd_streamed_torch.py [--parent ROOT] [--variants NAME ...] [--quick] [--untrapped]

1. Builds: ``csrc/flash_attention.cu`` alone, each with ``nvcc -Xptxas -v``
   into its own library under ``_probe/fwd_streamed/`` (git-ignored), all at
   once: each design variant of this source (a text-edited copy; trapped
   unless ``--untrapped``: its ``mbar_wait`` traps after 2^24 tries, so a
   deadlock fails its launch instead of hanging the card); with ``--parent
   ROOT`` (an earlier commit unpacked with ``git archive``) this source and
   the parent's, untrapped.  Printed: ptxas's registers, spills and C75xx
   notes (``wgmma`` serialized) of the streamed instances (bf16, f16), and
   the ``HGMMA``, ``UTMALDG`` and ``STL`` counts of their SASS.
2. With ``--parent``: every instance the parent has (16-bit ``wgmma``,
   TF32, wide family), this source's SASS against the parent's, instruction
   by instruction (addresses and encodings stripped).
3. Each variant through the port's wrapper: bf16 at B 1, T 2048, H 8 over 8,
   hd 640, 768, 896 and 1024 (the timed shapes), f16 at hd 640 and 1024, GQA
   batches (B 2, T 1152, H 4 over 2, hd 640; B 2, T 640, H 4 over 2, hd
   1152, where q's chunks stream too), hd 896 (B 1, T 640, H 2 over 1) and
   the shortest T (128, hd 1280): o within the type's gate of the plain
   version (``chip_smoke.FLASH_TOLERANCES``: 2e-2 abs in bf16, 8e-3 in
   f16), m within 1e-4 abs and l within 1e-5 of its largest, o, m and l bit
   for bit on a second call, one launch of ``..._fwd_streamed``; then
   device ms (``cuda_time(flush_l2=True, hold=True)``, median of 20) at the
   timed shapes, the variants in turns and again in reverse.
4. With ``--parent``, the A/B: parent, change, change, parent on the same
   tensors, each through its own library's C entry (the parent's 16-bit
   forward at these widths is the wide family's ``_wide`` entry), bf16 at
   hd 640, 768 and 1024 and f16 at 640; SDPA's forward at each shape.  Then
   the kernels the change leaves as they were, in eight turns (parent,
   change, change, parent, twice), each through its own library's C entry:
   bf16 forward, dK/dV and dQ at hd 128 (T 2048, H 32 over 8) and at hd 512
   (H 8 over 8), the f32 TF32 forward, dK/dV and dQ at hd 128 and the bf16
   wide dK/dV and dQ at hd 640 (H 8 over 8); their outputs bit for bit the
   parent's.

``--quick`` builds the trapped source alone (with ``--parent``, also the
change and the parent for step 2) and runs step 3 once, untimed but for one
pass: a new kernel's first call on the card.

The variants:

* ``source``: as committed (Q resident up to hd 1024, two V stages up to
  896 and one at 1024, the ring as deep as shared memory allows, at most 16
  chunk stages);
* ``vstages2``: two V stages at every hd, Q resident while four chunk
  stages fit beside them (the layout written first);
* ``vstages1``: one V stage at every hd, the ring deeper by its 32 KB;
* ``stream_q``: Q never resident, each chunk stage brings Q's chunk beside
  K's (the layout past hd 1024, at every width);
* ``ring4``: at most four chunk stages;
* ``head_major``: the blocks handed out head by head (each head's row tiles
  longest first, its slices side by side), so that the blocks in flight
  read the K and V of one or two heads, not of every head.

Prints one JSON line per build, check and timing, then the times side by
side.
"""

from __future__ import annotations

import os
import sys

from _ab_flash import ROOT, build_all, emit, parser, sub

OUT = os.path.join(ROOT, "_probe", "fwd_streamed")
GATES = {"bfloat16": 2e-2, "float16": 8e-3}  # chip_smoke.FLASH_TOLERANCES' output gates
M_GATE, L_GATE = 1e-4, 1e-5
NEW = "flash_streamed_fwd_kernel"
# (dtype, B, T, H, KVH, hd): the timed shapes first
TIMED = [("bfloat16", 1, 2048, 8, 8, hd) for hd in (640, 768, 896, 1024)]
CHECKED = TIMED + [("float16", 1, 2048, 8, 8, 640), ("float16", 1, 2048, 8, 8, 1024),
                   ("bfloat16", 2, 1152, 4, 2, 640), ("float16", 2, 640, 4, 2, 1152), ("bfloat16", 1, 640, 2, 1, 896),
                   ("bfloat16", 1, 128, 2, 1, 1280)]
AB = [c for c in TIMED if c[5] != 896] + [("float16", 1, 2048, 8, 8, 640)]

RESIDENT = "    s.resident = s.q_bytes + C::kVBytes + C::kResidentRing * C::kChunkBytes <= C::kData;"
VSHIFT = "    s.vshift = s.q_bytes + 2 * C::kVBytes + C::kTwoVRing * s.stage_bytes <= C::kData ? 1 : 0;"
RING = "    static constexpr int kMaxRing = 16;"
ORDER = """    const int qi = gridDim.z - 1 - blockIdx.z;  // the longest rows first, over every head
    const int h = blockIdx.x / lay.slices, cs = blockIdx.x % lay.slices, b = blockIdx.y;  // cs: the column slice"""
HEAD_MAJOR = """    const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const int cs = lin % lay.slices, rest = lin / lay.slices;
    const int qi = gridDim.z - 1 - rest % gridDim.z, h = rest / gridDim.z % p.H, b = rest / gridDim.z / p.H;"""

VARIANTS = {
    "source": (lambda s: s, lambda s: s),
    "vstages2": (lambda s: sub(sub(s, VSHIFT, "    s.vshift = 1;"), RESIDENT, RESIDENT.replace(
        "C::kVBytes + C::kResidentRing", "2 * C::kVBytes + 4")), lambda s: s),
    "vstages1": (lambda s: sub(s, VSHIFT, "    s.vshift = 0;"), lambda s: s),
    "stream_q": (lambda s: sub(s, RESIDENT, "    s.resident = 0;"), lambda s: s),
    "ring4": (lambda s: sub(s, RING, RING.replace("16", "4")), lambda s: s),
    "head_major": (lambda s: sub(s, ORDER, HEAD_MAJOR), lambda s: s),
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
    gen = torch.Generator(device=dev).manual_seed(33)

    def inputs(dtype, B, T, H, KVH, hd):
        dt = getattr(torch, dtype)
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(dt)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(dt)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)  # a view of a fused projection, as the model's
        return q, k, v

    def dev_ms(fn):
        return cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]

    def errs(got, plain):
        (o, m, l), (op, mp, lp) = got, plain
        return {"o_abs": (o.float() - op.float()).abs().max().item(), "m_abs": (m - mp).abs().max().item(),
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
            launched = {k: c for k, c in _lib.launch_counts().items() if c} == {"flash_attention_causal_fwd_streamed": 1}
            e = errs(got, plain)
            same = all(torch.equal(a, b) for a, b in zip(FA.flash_attention_causal_fwd(*qkv), got))
            ok = e["o_abs"] <= GATES[case[0]] and e["m_abs"] <= M_GATE and e["l_rel"] <= L_GATE and same and launched
            all_ok &= ok
            rows.append({"case": case, "ok": ok, "same_bits": same, "launched": launched, **e})
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
        try:
            sdpa[str(case)] = dev_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        except RuntimeError as e:  # no SDPA backend takes this shape and type
            sdpa[str(case)] = str(e)[:200]
        del qt, kt, vt
    emit("sdpa_fwd_device_ms", **sdpa)
    runs, outs = {}, {}
    for side in ("parent", "change", "change", "parent"):
        lib = libs[side]
        entry = "bnb_flash_attention_causal_fwd_" + ("streamed" if side == "change" else "wide")
        for case in AB:
            qkv = data[case][0]
            got = fwd(lib, entry, *qkv)
            ms = dev_ms(lambda: fwd(lib, entry, *qkv))
            prev = outs.setdefault((side, case), got)
            if not all(torch.equal(a, b) for a, b in zip(prev, got)):
                emit("differs_from_run_to_run", side=side, case=case)
                return 1
            runs.setdefault(f"{case[0]} B{case[1]} T{case[2]} H{case[3]} KVH{case[4]} hd{case[5]} fwd", []).append(
                (side, entry, ms))
    diffs = {}
    for case in AB:
        (o0, m0, l0), (o1, m1, l1) = outs[("parent", case)], outs[("change", case)]
        diffs[str(case)] = {"o_abs_change_vs_parent": (o1.float() - o0.float()).abs().max().item(),
                            "m_abs": (m1 - m0).abs().max().item(),
                            "l_rel": ((l1 - l0).abs().max() / l0.abs().max()).item()}
    emit("ab_device_ms", order=["parent", "change", "change", "parent"],
         **{k: {"entries": [e for _, e, _ in v], "ms": [ms for _, _, ms in v]} for k, v in runs.items()})
    emit("ab_outputs", **diffs)

    # the unchanged kernels, eight turns
    def bwd_inputs(dt, *case):
        q, k, v = inputs("float32", *case)
        do = torch.randn_like(q)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        return tuple(t.to(dt) for t in (q, k, v, do)) + (m, l, di)

    entries = {"fwd": "fwd", "dkv": "bwd_dkv", "dq": "bwd_dq"}
    same = {}
    for hd, H, KVH in ((128, 32, 8), (512, 8, 8)):
        bwd = bwd_inputs(torch.bfloat16, 1, 2048, H, KVH, hd)
        for key, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
            same[(f"bf16 hd{hd} {key}", fn, "bnb_flash_attention_causal_" + entries[key])] = bwd
    bwd32 = bwd_inputs(torch.float32, 1, 2048, 32, 8, 128)
    for key, fn in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
        same[(f"f32 tf32 hd128 {key}", fn, "bnb_flash_attention_causal_" + entries[key] + "_tf32")] = bwd32
    bwd640 = bwd_inputs(torch.bfloat16, 1, 2048, 8, 8, 640)
    for key, fn in (("dkv", dkv), ("dq", dq)):
        same[(f"bf16 wide hd640 {key}", fn, "bnb_flash_attention_causal_" + entries[key] + "_wide")] = bwd640
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
