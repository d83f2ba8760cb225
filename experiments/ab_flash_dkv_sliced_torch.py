#!/usr/bin/env python3
"""Kernel 18's ``wgmma`` instances above head_dim 256 (the causal flash
dK/dV in bf16 and f16 at head_dim 384 and 512, ``csrc/flash_attention.cu``:
a ring stage holds the item's 128 columns of Q and dO, the rest of head_dim
streams through a ring of 64-column chunks) on one NVIDIA GPU, in one
process.

    python3 experiments/ab_flash_dkv_sliced_torch.py [--parent ROOT] [--variants NAME ...] [--quick] [--untrapped]

1. Builds: ``csrc/flash_attention.cu`` alone, each with ``nvcc -Xptxas -v``
   into its own library under ``_probe/dkv_sliced/`` (git-ignored), all at
   once: this checkout's source; with ``--parent ROOT`` (an earlier commit
   unpacked with ``git archive``) the parent's; and each design variant, a
   text-edited copy of this source whose ``mbar_wait`` traps after 2^24
   tries (a deadlock fails its launch instead of hanging the card; compare
   the variants with each other).  Printed: ptxas's registers, spills and
   C75xx notes (``wgmma`` serialized) of every dK/dV instance, and the
   ``HGMMA``, ``UTMALDG`` and ``STL`` counts of its SASS.
2. With ``--parent``: the bf16 and f16 instances of the three ``wgmma``
   kernels at head_dim 128 and 256 (and the forward's at 384 and 512), this
   source's SASS against the parent's, instruction by instruction
   (addresses and encodings stripped).
3. Each variant through the port's wrapper, at B 1, T 2048, H 8 over 8 in
   bf16 and f16 at head_dim 384 and 512 (``chip_smoke.py`` 3p's), a GQA
   batch whose plan splits key tiles (B 2, T 640, H 4 over 2) and the
   shortest T (128): dk and dv against the plain version within 3p's
   ``FLASH_TOLERANCES`` (bf16 1e-2, f16 5e-3 of the largest magnitude), bit
   for bit on a second call, one launch of ``..._bwd_dkv_sliced``; then
   device ms (``cuda_time(flush_l2=True, hold=True)``, median of 20) at 3p's
   four shapes, the variants in turns and again in reverse.
4. With ``--parent``, the A/B: parent, change, change, parent, each through
   its own library's C entries on the same tensors (the parent's dK/dV at
   head_dim 384 and 512 is the wide family's ``_wide`` entry): dK/dV at 3p's
   four shapes; the bf16 forward, dK/dV and dQ at hd 128 (T 2048, H 32 over
   8) and dK/dV at hd 256 (T 4096, H 16 over 16); and the cases the change
   leaves on the wide family: f32 dK/dV and dQ at T 2048, H 32 over 8, hd
   128, and the 16-bit dQ at 3p's four shapes; SDPA's backward (dq, dk and
   dv in one call) once a 16-bit shape.  Each side's outputs must agree
   with the other's bit for bit where the kernel is the same.

``--other ROOT`` builds another checkout's source untrapped and checks and
times it beside the variants, through this checkout's wrapper.  ``--quick``
builds the trapped source alone (with ``--parent``, also the
change and the parent for step 2) and runs step 3 once, untimed but for one
pass: a new kernel's first call on the card.  ``--untrapped``
builds the variants without the trap, for timings comparable with the
committed source's (run it on variants that have passed trapped).

The variants (hd 128 and 256 are left as they are by each):

* ``source``: as committed (one stage of the item's 128 columns of Q and
  dO, and four 16 KB stages of the 64-column chunks outside them);
* ``chunks3``: three chunk stages;
* ``chunks6``: six chunk stages at hd 384;
* ``stages2``: two stages and three chunk stages at hd 384.

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
OUT = os.path.join(ROOT, "_probe", "dkv_sliced")
TOL = {"bfloat16": 1e-2, "float16": 5e-3}  # chip_smoke.FLASH_TOLERANCES' gradient gates
# (dtype, B, T, H, KVH, hd): 3p's four timed shapes first
TIMED = [(dt, 1, 2048, 8, 8, hd) for dt in ("bfloat16", "float16") for hd in (384, 512)]
CHECKED = TIMED + [("bfloat16", 2, 640, 4, 2, 384), ("float16", 2, 640, 4, 2, 512), ("bfloat16", 1, 128, 2, 1, 512),
                   ("float16", 1, 128, 2, 2, 384)]

# the parent's WGMMA_HEAD_DIMS (before this design: dK/dV wide above hd 256)
PARENT_WGMMA = {"fwd": (128, 256, 384, 512), "dkv": (128, 256), "dq": (128, 256)}

CFG = """    static constexpr int kStages = HD == 128 ? 4 : HD == 256 ? 2 : 1;
    static constexpr int kChunkStages = kOther ? 4 : 0;"""


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


VARIANTS = {
    "source": lambda s: s,
    "chunks3": lambda s: sub(s, CFG, CFG.replace("kOther ? 4 : 0", "kOther ? 3 : 0")),
    "chunks6": lambda s: sub(s, CFG, CFG.replace("kOther ? 4 : 0", "kOther ? (HD == 384 ? 6 : 4) : 0")),
    "stages2": lambda s: sub(s, CFG, CFG.replace("HD == 256 ? 2 : 1", "HD <= 384 ? 2 : 1").replace(
        "kOther ? 4 : 0", "kOther ? (HD == 384 ? 3 : 4) : 0")),
}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def instance(name: str):
    """(kernel, type, hd) of a wgmma instance's mangled name, else None."""
    for kern in ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"):
        m = re.search(kern + r"ILi(\d+)E", name)
        if m:
            return kern, "bf16" if "bfloat16" in name else "f16", int(m.group(1))
    return None


def build(nvcc, flags, name, csrc_dir, edit=None, trapped=False):
    """Copies ``csrc_dir``'s flash attention sources to OUT/name (edited)
    and starts its nvcc; returns (dir, process)."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in ("common.cuh", "sm90.cuh", "flash_attention.cu"):
        shutil.copy(os.path.join(csrc_dir, f), d)
    for f, fn in (("flash_attention.cu", edit), ("sm90.cuh", trap if trapped else None)):
        if fn:
            path = os.path.join(d, f)
            src = fn(open(path).read())
            with open(path, "w") as fh:
                fh.write(src)
    cmd = [nvcc, *flags, "-shared", "-Xptxas", "-v", "-I", d, os.path.join(d, "flash_attention.cu"),
           "-o", os.path.join(d, "fa.so")]
    return d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(nvcc, name, d, proc, signatures):
    """Waits for a build: ptxas lines and SASS counts of each dK/dV
    instance, the SASS bodies of every wgmma instance, and the library."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out[-4000:]}")
    ptxas, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance(m.group(1))
            key = f"{inst[1]} hd{inst[2]}" if inst and inst[0] == "flash_bwd_dkv_kernel" else None
        elif key and ("spill" in line or "Used" in line):
            ptxas.setdefault(key, []).append(line.split(":", 1)[-1].strip())
        if "(C75" in line:
            ptxas.setdefault("notes", []).append(line.strip()[-160:])
    so = os.path.join(d, "fa.so")
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    bodies, counts, fn = {}, {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = instance(line.split("Function :")[1].strip())
            if fn:
                bodies[fn] = []
                if fn[0] == "flash_bwd_dkv_kernel":
                    counts[f"{fn[1]} hd{fn[2]}"] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0}
        elif fn and "/*" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins:
                bodies[fn].append(ins)
            if fn[0] == "flash_bwd_dkv_kernel":
                for op in counts[f"{fn[1]} hd{fn[2]}"]:
                    counts[f"{fn[1]} hd{fn[2]}"][op] += f" {op}" in line
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
    ap.add_argument("--other", help="root of another checkout whose dK/dV is checked and timed as a variant")
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
    src_flash = open(os.path.join(CSRC, "flash_attention.cu")).read()
    prefix = "free_" if args.untrapped and not args.quick else "trap_"
    jobs = {prefix + n: build(nvcc, _lib._NVCC_FLAGS, prefix + n, CSRC, edit=VARIANTS[n], trapped=prefix == "trap_")
            for n in variants}
    if args.other:
        variants.append("other")
        jobs["other"] = build(nvcc, _lib._NVCC_FLAGS, "other",
                              os.path.join(os.path.abspath(args.other), "bitsandbytes_tpu_torch", "csrc"))
    ab = args.parent and not args.quick
    if args.parent:
        jobs["change"] = build(nvcc, _lib._NVCC_FLAGS, "change", CSRC)
        jobs["parent"] = build(nvcc, _lib._NVCC_FLAGS, "parent",
                               os.path.join(os.path.abspath(args.parent), "bitsandbytes_tpu_torch", "csrc"))
    assert VARIANTS["source"](src_flash) == src_flash
    libs, bodies = {}, {}
    for name, (d, proc) in jobs.items():
        libs[name], bodies[name] = finish(nvcc, name, d, proc, _lib._SIGNATURES)

    if args.parent:  # the wgmma instances the parent has, against the change's
        for key in sorted(bodies["parent"]):
            a, b = bodies["parent"][key], bodies["change"].get(key)
            emit("sass_against_parent", kernel=key[0], dtype=key[1], hd=key[2], parent_instructions=len(a),
                 change_instructions=None if b is None else len(b),
                 differing=None if b is None else sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)

    def inputs(dts, B, T, H, KVH, hd):
        dt = getattr(torch, dts)
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(dt)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(dt)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)  # a view of a fused projection, as the model's
        do = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, m, l, di

    def dev_ms(fn):
        return cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    # 3. the variants through the port's wrapper
    data = {}
    for case in CHECKED:
        bwd = inputs(*case)
        data[case] = (bwd, FA.flash_attention_causal_bwd_dkv_plain(*bwd))
    of = {n: libs["other" if n == "other" else prefix + n] for n in variants}  # each variant's library
    for n in variants:
        _lib._lib = of[n]
        rows = []
        for case in CHECKED:
            bwd, (dkp, dvp) = data[case]
            _lib.reset_launch_counts()
            dk, dv = FA.flash_attention_causal_bwd_dkv(*bwd)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES["flash_attention_causal_bwd_dkv_sliced"] == 1
            errs = {"dk_rel": rel(dk, dkp), "dv_rel": rel(dv, dvp)}
            same = all(torch.equal(a, b) for a, b in zip(FA.flash_attention_causal_bwd_dkv(*bwd), (dk, dv)))
            splits = len(FA._dkv_tables(*case[1:], dev)[0].combine)
            ok = max(errs.values()) <= TOL[case[0]] and same and launched
            rows.append({"case": case, "ok": ok, "same_bits": same, "split_key_tiles": splits, "errs": errs})
        emit("check", variant=n, all_ok=all(r["ok"] for r in rows), rows=rows)
    timed = {}
    for order in (variants, variants[::-1]):
        for n in order:
            _lib._lib = of[n]
            for case in TIMED:
                bwd = data[case][0]
                timed.setdefault(str(case), {}).setdefault(n, []).append(
                    dev_ms(lambda: FA.flash_attention_causal_bwd_dkv(*bwd)))
        if args.quick:
            break
    emit("variants_device_ms", **timed)
    if not ab:
        return 0

    sdpa = {}
    for case in TIMED:
        q, k, v, do = data[case][0][:4]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        sdpa[str(case)] = dev_ms(lambda: torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, so
    emit("sdpa_bwd_device_ms", **sdpa)

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

    def fwd(lib, entry, q, k, v, do, m, l, di):
        B, T, H, hd = q.shape
        o = torch.empty_like(q)
        mo, lo = torch.empty_like(m), torch.empty_like(l)
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), mo.data_ptr(),
                                  lo.data_ptr(), B, T, H, k.shape[2], hd, q.stride(0), q.stride(1), k.stride(0),
                                  k.stride(1), v.stride(0), v.stride(1), hd**-0.5, FA._KIND[q.dtype],
                                  _lib.stream(q))
        _lib.check(err, entry)
        return o, mo, lo

    ab_cases = TIMED + [("bfloat16", 1, 2048, 32, 8, 128), ("bfloat16", 1, 4096, 16, 16, 256),
                        ("float32", 1, 2048, 32, 8, 128)]
    for case in ab_cases[4:]:
        data[case] = (inputs(*case), None)
    base = {"fwd": "bnb_flash_attention_causal_fwd", "dkv": "bnb_flash_attention_causal_bwd_dkv",
            "dq": "bnb_flash_attention_causal_bwd_dq"}
    fns = {"fwd": fwd, "dkv": dkv, "dq": dq}
    # which kernels each case times: dK/dV everywhere; dQ where it stays wide
    # (16-bit hd 384 / 512, f32) or at hd 128; the forward at hd 128
    kinds = {case: ("dkv", "dq") for case in TIMED}
    kinds.update({ab_cases[4]: ("fwd", "dkv", "dq"), ab_cases[5]: ("dkv",), ab_cases[6]: ("dkv", "dq")})
    runs, outs = {}, {}
    for turn, side in enumerate(("parent", "change", "change", "parent")):
        lib = libs[side]
        for case in ab_cases:
            bwd = data[case][0]
            dt, hd = case[0], case[5]
            for key in kinds[case]:
                wgmma = dt != "float32" and hd in (FA.WGMMA_HEAD_DIMS if side == "change" else PARENT_WGMMA)[key]
                entry = base[key] + ("" if wgmma else "_wide")
                got = fns[key](lib, entry, *bwd)
                ms = dev_ms(lambda: fns[key](lib, entry, *bwd))
                prev = outs.setdefault((side, case, key), got)
                if not all(torch.equal(a, b) for a, b in zip(prev, got)):
                    emit("differs_from_run_to_run", side=side, case=case, kernel=key)
                    return 1
                runs.setdefault(f"{dt} B{case[1]} T{case[2]} H{case[3]} KVH{case[4]} hd{hd} {key}", []).append(
                    (turn, side, entry, ms))
    same_sides = {}
    for (side, case, key), ts in outs.items():
        if side == "change":
            p = outs[("parent", case, key)]
            moved = key == "dkv" and case[0] != "float32" and case[5] > 256
            same_sides[f"{case} {key}"] = {"same_bits": all(torch.equal(a, b) for a, b in zip(p, ts)),
                                           "same_kernel": not moved}
    emit("ab_device_ms", order=["parent", "change", "change", "parent"],
         **{k: {"entries": [e for _, _, e, _ in v], "ms": [ms for _, _, _, ms in v]} for k, v in runs.items()})
    emit("ab_bits", **same_sides)
    bad = [k for k, v in same_sides.items() if v["same_kernel"] and not v["same_bits"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
