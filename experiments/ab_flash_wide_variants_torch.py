#!/usr/bin/env python3
"""Two checks of kernels 17-19 (``csrc/flash_attention.cu``) on one NVIDIA
GPU, in one process.

    python3 experiments/ab_flash_wide_variants_torch.py [--parent ROOT]

1. With ``--parent ROOT`` (a checkout of an earlier commit, unpacked with
   ``git archive``): the bf16 instances of the wgmma forward, dK/dV and dQ
   kernels, compiled from both sources with this toolkit's ``nvcc -Xptxas
   -v``, against each other: ptxas's registers and spills, and the SASS
   bodies from ``cuobjdump -sass`` instruction by instruction (addresses
   and encodings stripped), so that templating the kernels on the element
   type can be shown to leave the bf16 code as it was.
2. Design variants of the wide family (``flash_wide_{fwd,dkv,dq}_kernel``:
   f32 at any head_dim, bf16 and f16 at 384 and up), each built from a
   text-edited copy of this checkout's sources under
   ``_probe/wide_variants/<name>/`` (git-ignored) into its own library:
   ptxas's registers and spills of each wide instance, each variant's
   results against the source's bit for bit, and the device ms of each
   kernel (``cuda_time(flush_l2=True, hold=True)``, median of 20) at B 1,
   T 2048 in f32 (H 32 over 8, hd 128), bf16 (H 8 over 8, hd 384) and f16
   (hd 512), the variants in turns and again in reverse order.

The variants:

* ``source``: as committed (a tile is staged one 8-value step at a time);
* ``unrolled``: the staging loop unrolled, every step's loads issued at
  once;
* ``fwd2``: the forward under ``__launch_bounds__(256, 2)``, which caps it
  at 128 registers.

Prints one JSON line per check and per variant, then the times side by
side.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bitsandbytes_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "_probe", "wide_variants")
CASES = [("float32", 32, 8, 128), ("bfloat16", 8, 8, 384), ("float16", 8, 8, 512)]

STAGE = "#pragma unroll 1\n    for (int n = 0; n < WideCfg::kTile * kGroups / WideCfg::kThreads; ++n) {"
FWD = "__global__ void __launch_bounds__(WideCfg::kThreads)\n    flash_wide_fwd_kernel"
VARIANTS = {"source": [], "unrolled": [(STAGE, STAGE.replace("unroll 1", "unroll"))],
            "fwd2": [(FWD, FWD.replace("(WideCfg::kThreads)", "(WideCfg::kThreads, 2)"))]}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"check": tag, **fields}), flush=True)


def ptxas(nvcc, flags, csrc, obj, pattern):
    """Compile csrc/flash_attention.cu to ``obj``; ptxas's register and spill
    lines of each entry matching ``pattern``."""
    res = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-I", csrc, "-c", os.path.join(csrc, "flash_attention.cu"),
                          "-o", obj], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr[-4000:])
    fn, out = None, {}
    for ln in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and re.search(pattern, fn) and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


def sass_bodies(nvcc, obj):
    """Each function's SASS instructions, addresses and encodings stripped."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    txt = subprocess.run([tool, "-sass", obj], capture_output=True, text=True, check=True).stdout
    bodies, fn = {}, None
    for line in txt.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            bodies[fn] = []
        elif fn and "/*" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins:
                bodies[fn].append(ins)
    return bodies


def wgmma_instance(name):
    """(kernel, hd) of a bf16 wgmma instance's mangled name, else None."""
    if "half" in name:
        return None
    for kern in ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"):
        if kern in name:
            return kern, 128 if "Li128E" in name else 256
    return None


def templating_check(parent, nvcc, flags):
    pattern = r"flash_(fwd|bwd_dkv|bwd_dq)_kernel"
    tmp = os.path.join(OUT, "objs")
    os.makedirs(tmp, exist_ok=True)
    objs = {"parent": os.path.join(tmp, "parent.o"), "change": os.path.join(tmp, "change.o")}
    regs = {"parent": ptxas(nvcc, flags, os.path.join(parent, "bitsandbytes_tpu_torch", "csrc"), objs["parent"],
                            pattern),
            "change": ptxas(nvcc, flags, CSRC, objs["change"], pattern)}
    bodies = {k: {wgmma_instance(n): b for n, b in sass_bodies(nvcc, o).items() if wgmma_instance(n)}
              for k, o in objs.items()}
    for side in regs:
        emit("ptxas_bf16", side=side, instances={str(wgmma_instance(n)): v for n, v in regs[side].items()
                                                 if wgmma_instance(n)})
    for key in sorted(bodies["parent"]):
        a, b = bodies["parent"][key], bodies["change"].get(key)
        differing = None if b is None else sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        emit("sass_bf16_against_parent", kernel=key[0], hd=key[1], parent_instructions=len(a),
             change_instructions=None if b is None else len(b), differing=differing)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of an earlier checkout, for the bf16 templating check")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    nvcc = _lib._nvcc()
    emit("toolkit", nvcc=subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.split("\n")[-2])
    if args.parent:
        templating_check(os.path.abspath(args.parent), nvcc, _lib._NVCC_FLAGS)

    libs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        path = os.path.join(d, "flash_attention.cu")
        src = open(path).read()
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"the source no longer holds {old[:60]!r} once")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        regs = ptxas(nvcc, _lib._NVCC_FLAGS, d, os.path.join(d, "fa.o"), r"flash_wide_")
        emit("variant", name=name, ptxas={re.sub(r".*(flash_wide_\w+?_kernelI\w+?E).*", r"\1", n): v
                                          for n, v in regs.items()})
        _lib._lib, _lib._CSRC = None, d
        _lib.lib()
        libs[name] = _lib._lib
    _lib._CSRC = CSRC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    timed, same = {}, {}
    for dts, H, KVH, hd in CASES:
        dt = getattr(torch, dts)
        q, k, v, do = (torch.randn(1, 2048, n, hd, generator=gen, device=dev).to(dt) for n in (H, KVH, KVH, H))
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, m, l, di)
        ref = None
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                _lib._lib = libs[name]
                got = (FA.flash_attention_causal_fwd(q, k, v)[0], *FA.flash_attention_causal_bwd_dkv(*bwd),
                       FA.flash_attention_causal_bwd_dq(*bwd))
                ref = ref or got
                same[f"{dts} hd{hd} {name}"] = all(torch.equal(a, b) for a, b in zip(got, ref))
                for key, fn in (("fwd", lambda: FA.flash_attention_causal_fwd(q, k, v)),
                                ("dkv", lambda: FA.flash_attention_causal_bwd_dkv(*bwd)),
                                ("dq", lambda: FA.flash_attention_causal_bwd_dq(*bwd))):
                    ms = cuda_time(fn, n=20, flush_l2=True, hold=True)["median"]
                    timed.setdefault(f"{dts} hd{hd} {key}", {}).setdefault(name, []).append(ms)
    emit("same_bits_as_source", **same)
    emit("device_ms", **timed)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
