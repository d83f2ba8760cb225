#!/usr/bin/env python3
"""Kernel 19's f32 instance at head_dim 128 and 256 (the causal flash dQ on
three-pass TF32 ``wgmma``, ``csrc/flash_attention.cu``'s
``flash_tf32_dq_kernel``) on one NVIDIA GPU, in one process.

    python3 experiments/ab_flash_dq_tf32_torch.py [--parent ROOT] [--variants NAME ...] [--quick] [--untrapped]

1. Builds: ``csrc/flash_attention.cu`` alone, each with ``nvcc -Xptxas -v``
   into its own library under ``_probe/dq_tf32/`` (git-ignored), all at
   once: each design variant of this source (a text-edited copy; trapped
   unless ``--untrapped``: its ``mbar_wait`` traps after 2^24 tries, so a
   deadlock fails its launch instead of hanging the card); with ``--parent
   ROOT`` (an earlier commit unpacked with ``git archive``) this source and
   the parent's, untrapped.  Printed: ptxas's registers, spills and C75xx
   notes (``wgmma`` serialized) of the TF32 instances, and the ``HGMMA``
   (``.TF32`` among them), ``UTMALDG`` and ``STL`` counts of their SASS.
2. With ``--parent``: every 16-bit ``wgmma`` instance, TF32 dK/dV instance
   and wide-family kernel the parent has, this source's SASS against the
   parent's, instruction by instruction (addresses and encodings stripped).
3. Each variant through the port's wrapper on f32 q, k, v: B 1, T 2048, H 32
   over 8, hd 128 (``chip_smoke.py`` 4r's attention) and H 16 over 16, hd
   256 (Gemma-7B's), two batched GQA shapes (B 2, T 1152, H 8 over 2, hd
   128; B 2, T 640, H 4 over 2, hd 256) and the shortest T (128): dq
   against the plain version within ``FLASH_TOLERANCES["float32"]``'s 1e-4
   of its largest magnitude, bit for bit on a second call, one launch of
   ``..._bwd_dq_tf32``; then device ms (``cuda_time(flush_l2=True,
   hold=True)``, median of 20) at the timed shapes, the variants in turns
   and again in reverse.
4. With ``--parent``, the A/B: parent, change, change, parent on the same
   tensors, each through its own library's C entry (the parent's f32 dQ is
   the wide family's ``_wide`` entry), at f32 hd 128, T 1024, 2048 and 4096
   (H 32 over 8) and hd 256, T 2048 (H 16 over 16); the TF32 dK/dV on both
   sides at hd 128, T 2048 (unchanged code: its bits and time must not
   move); SDPA's f32 backward (dq, dk and dv in one call) at each shape.
   Then the kernels the change leaves as they were, in eight turns (parent,
   change, change, parent, twice), each through its own library's C entry:
   bf16 forward, dK/dV and dQ at hd 128 (T 2048, H 32 over 8) and at hd 512
   (H 8 over 8), the f32 wide forward at hd 128; their outputs bit for bit
   the parent's.

``--quick`` builds the trapped source alone (with ``--parent``, also the
change and the parent for step 2) and runs step 3 once, untimed but for one
pass: a new kernel's first call on the card.

The variants:

* ``source``: as committed (four ring stages at hd 128, two at 256);
* ``stages3``: three ring stages at hd 128;
* ``rna``: big rounded by ``cvt.rna.tf32.f32`` too (every split, the
  TF32 dK/dV's included).

Prints one JSON line per build, check and timing, then the times side by
side.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bitsandbytes_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "_probe", "dq_tf32")
GATE = 1e-4  # chip_smoke.FLASH_TOLERANCES["float32"]'s gradient gate
NEW = "flash_tf32_dq_kernel"
# (B, T, H, KVH, hd), f32: the timed shapes first
TIMED = [(1, 2048, 32, 8, 128), (1, 2048, 16, 16, 256)]
CHECKED = TIMED + [(2, 1152, 8, 2, 128), (2, 640, 4, 2, 256), (1, 128, 2, 1, 128)]
AB = [(1, 1024, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 2048, 16, 16, 256)]

CFG = "    static constexpr int kStages = HD == 128 ? 4 : 2;\n    static constexpr uint32_t kTile = 64 * 128;          // a"
BIG = "    big = __float_as_uint(x) & 0xFFFFE000u;"

VARIANTS = {
    "source": (lambda s: s, lambda s: s),
    "stages3": (lambda s: sub(s, CFG, CFG.replace("? 4 : 2", "? 3 : 2")), lambda s: s),
    "rna": (lambda s: s, lambda s: sub(s, BIG, '    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));')),
}


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the source no longer holds {old[:60]!r} once")
    return src.replace(old, new)


def trap(sm90: str) -> str:
    return sub(sm90, """    do {
        asm volatile(
            "{\\n.reg .pred p;\\nmbarrier.try_wait""", """    uint32_t tries = 0;
    do {
        if (++tries == (1u << 24)) __trap();
        asm volatile(
            "{\\n.reg .pred p;\\nmbarrier.try_wait""")


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def instance(name: str):
    """(kernel, type, hd) of a 16-bit wgmma instance, TF32 instance or
    wide-family kernel by mangled name, else None."""
    for kern in ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel", "flash_tf32_dkv_kernel", NEW):
        m = re.search(kern + r"ILi(\d+)E", name)
        if m:
            return kern, "f32" if "tf32" in kern else "bf16" if "bfloat16" in name else "f16", int(m.group(1))
    for kern in ("flash_wide_fwd_kernel", "flash_wide_dkv_kernel", "flash_wide_dq_kernel"):
        if kern in name:
            return kern, "f32" if "IfE" in name else "bf16" if "bfloat16" in name else "f16", 0
    return None


def build(nvcc, flags, name, csrc_dir, edits=(None, None), trapped=False):
    """Copies ``csrc_dir``'s flash attention sources to OUT/name (edited:
    flash_attention.cu, sm90.cuh) and starts its nvcc; returns (dir,
    process)."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in ("common.cuh", "sm90.cuh", "flash_attention.cu"):
        shutil.copy(os.path.join(csrc_dir, f), d)
    sm90_edit = edits[1]
    if trapped:
        sm90_edit = (lambda s, e=sm90_edit: trap(e(s) if e else s))
    for f, fn in (("flash_attention.cu", edits[0]), ("sm90.cuh", sm90_edit)):
        if fn:
            path = os.path.join(d, f)
            src = fn(open(path).read())
            with open(path, "w") as fh:
                fh.write(src)
    cmd = [nvcc, *flags, "-shared", "-Xptxas", "-v", "-I", d, os.path.join(d, "flash_attention.cu"),
           "-o", os.path.join(d, "fa.so")]
    return d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(nvcc, name, d, proc, signatures):
    """Waits for a build: ptxas lines and SASS counts of each TF32 dQ
    instance, the SASS bodies of every instance, and the library."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out[-6000:]}")
    ptxas, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance(m.group(1))
            key = f"hd{inst[2]}" if inst and inst[0] == NEW else None
        elif key and ("spill" in line or "Used" in line):
            ptxas.setdefault(key, []).append(line.split(":", 1)[-1].strip())
        if "(C75" in line:
            ptxas.setdefault("notes", []).append(re.sub(r"'\S+'", "", line.strip())[:200])
    so = os.path.join(d, "fa.so")
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    bodies, counts, fn = {}, {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = instance(line.split("Function :")[1].strip())
            if fn:
                bodies[fn] = []
                if fn[0] == NEW:
                    counts[f"hd{fn[2]}"] = {"HGMMA": 0, "HGMMA_TF32": 0, "UTMALDG": 0, "STL": 0}
        elif fn and "/*" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins:
                bodies[fn].append(ins)
            if fn[0] == NEW:
                c = counts[f"hd{fn[2]}"]
                for op in ("HGMMA", "UTMALDG", "STL"):
                    c[op] += f" {op}" in line
                c["HGMMA_TF32"] += " HGMMA" in line and ".TF32" in line
    emit("build", name=name, ptxas=ptxas, sass=counts)
    lib = ctypes.CDLL(so)
    for entry, argtypes in signatures.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib, bodies


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of an earlier checkout: the SASS check and the A/B")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--quick", action="store_true", help="the trapped source alone, checked and timed once")
    ap.add_argument("--untrapped", action="store_true", help="build the variants without the trapping wait")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    emit("device", card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                       capture_output=True, text=True).stdout.strip())
    nvcc = _lib._nvcc()
    emit("toolkit", nvcc=subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.split("\n")[-2],
         torch=torch.__version__, cuda=torch.version.cuda)
    variants = ["source"] if args.quick else args.variants
    prefix = "free_" if args.untrapped and not args.quick else "trap_"
    jobs = {prefix + n: build(nvcc, _lib._NVCC_FLAGS, prefix + n, CSRC, edits=VARIANTS[n], trapped=prefix == "trap_")
            for n in variants}
    if args.parent:
        jobs["change"] = build(nvcc, _lib._NVCC_FLAGS, "change", CSRC)
        jobs["parent"] = build(nvcc, _lib._NVCC_FLAGS, "parent",
                               os.path.join(os.path.abspath(args.parent), "bitsandbytes_tpu_torch", "csrc"))
    libs, bodies = {}, {}
    for name, (d, proc) in jobs.items():
        libs[name], bodies[name] = finish(nvcc, name, d, proc, _lib._SIGNATURES)

    if args.parent:  # the instances the parent has, against the change's
        for key in sorted(bodies["parent"]):
            a, b = bodies["parent"][key], bodies["change"].get(key)
            emit("sass_against_parent", kernel=key[0], dtype=key[1], hd=key[2], parent_instructions=len(a),
                 change_instructions=None if b is None else len(b),
                 differing=None if b is None else sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)

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
        data[case] = (bwd, FA.flash_attention_causal_bwd_dq_plain(*bwd))
    all_ok = True
    for n in variants:
        _lib._lib = libs[prefix + n]
        rows = []
        for case in CHECKED:
            bwd, dqp = data[case]
            _lib.reset_launch_counts()
            dq = FA.flash_attention_causal_bwd_dq(*bwd)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES["flash_attention_causal_bwd_dq_tf32"] == 1
            err = rel(dq, dqp)
            same = torch.equal(FA.flash_attention_causal_bwd_dq(*bwd), dq)
            ok = err <= GATE and same and launched
            all_ok &= ok
            rows.append({"case": case, "ok": ok, "same_bits": same, "dq_rel": err})
        emit("check", variant=n, all_ok=all(r["ok"] for r in rows), rows=rows)
    timed = {}
    for order in (variants, variants[::-1]):
        for n in order:
            _lib._lib = libs[prefix + n]
            for case in TIMED:
                bwd = data[case][0]
                timed.setdefault(str(case), {}).setdefault(n, []).append(
                    dev_ms(lambda: FA.flash_attention_causal_bwd_dq(*bwd)))
        if args.quick:
            break
    emit("variants_device_ms", **timed)
    if not args.parent or args.quick:
        return 0 if all_ok else 1

    # 4. parent, change, change, parent through each library's C entries
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
        q, k, v, do = data[case][0][:4]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        sdpa[str(case)] = dev_ms(lambda: torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, so
    emit("sdpa_f32_bwd_device_ms", **sdpa)
    work = [(case, "dq") for case in AB] + [(AB[1], "dkv")]
    runs, outs = {}, {}
    for side in ("parent", "change", "change", "parent"):
        lib = libs[side]
        for case, key in work:
            bwd = data[case][0]
            fn = dq if key == "dq" else dkv
            entry = ("bnb_flash_attention_causal_bwd_dq_tf32" if side == "change"
                     else "bnb_flash_attention_causal_bwd_dq_wide") if key == "dq" \
                else "bnb_flash_attention_causal_bwd_dkv_tf32"
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
    same[("f32 wide hd128 fwd", "fwd", fwd)] = data[AB[1]][0]
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
    # the TF32 dK/dV is the same code on both sides: its bits must not move
    return 0 if all_ok and errs[f"{AB[1]} dkv"]["same_bits"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
