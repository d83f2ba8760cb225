#!/usr/bin/env python3
"""Design variants of kernel 17, the causal flash attention forward
(``csrc/flash_attention.cu``), built side by side from text-edited copies of
this checkout's source and timed in one process on one NVIDIA GPU.

    python3 experiments/ab_flash_fwd_variants_torch.py [VARIANT ...]

With no arguments it runs every variant, the source as it stands first and
last.  Each copy goes to ``_probe/fwd_variants/<name>/`` (git-ignored) and
builds alone with ``nvcc -Xptxas -v``; its ``mbar_wait`` traps after 2^24
tries, so a variant that deadlocks fails its launch instead of hanging the
card (every variant carries the trap, so compare them with each other, not
with ``ab_flash_attention_torch.py``'s times).  For each variant: ptxas's
registers, spills and C75xx notes (``wgmma`` serialized) of each forward
instance, its SASS counts (``HGMMA``, ``UTMALDG``, ``STL``), and at
``chip_smoke.py`` 3p's five shapes the output against the plain version
(o 2e-2 abs, m 1e-4, l 1e-5 relative, bit for bit twice) and the device ms
(``cuda_time(flush_l2=True, hold=True)``, median of 20); SDPA once.

The variants:

* ``source``: the kernel as committed;
* ``hd256_no_overlap``: hd 256 without the next tile's S product issued
  before the softmax;
* ``overlap_128keys``: that overlap at hd 128 too (O, S and P of a
  warpgroup need 160 registers);
* ``overlap_64keys``: the overlap at hd 128 with 64-key tiles;
* ``pingpong``: at hd 128 the two consumer warpgroups take turns to issue
  their S products (named barriers 1 and 2);
* ``fence_before_wait``: the PV product's ``wgmma_fence`` before its
  ``mbar_wait`` spin, not after;
* ``hd256_two_consumers``: hd 256 as hd 128, two consumer warpgroups of 64
  rows at 384 threads;
* ``stages3``: a three-stage ring at hd 128.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bitsandbytes_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "_probe", "fwd_variants")
SHAPES = [(1, 1024, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 8192, 32, 8, 128),
          (1, 4096, 16, 16, 256)]


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


def overlap(src: str) -> str:
    return sub(src, "static constexpr bool kOverlap = kConsumers == 1;", "static constexpr bool kOverlap = true;")


def keys64(src: str) -> str:
    return sub(src, "static constexpr int kKeys = HD == 128 ? 128 : 64;", "static constexpr int kKeys = 64;")


def pingpong(src: str) -> str:
    return sub(src, """    if constexpr (!C::kOverlap) {
        for (int t = 0; t < ntiles; ++t) {
            issue_s(t);""", """    if constexpr (!C::kOverlap) {
        const int c = wg - 1;
        if (c == 1) asm volatile("bar.arrive 1, 256;\\n" ::: "memory");
        for (int t = 0; t < ntiles; ++t) {
            asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + c) : "memory");
            issue_s(t);
            if (c == 0 || t + 1 < ntiles) asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - c) : "memory");""")


def fence_before_wait(src: str) -> str:
    return sub(src, """        const int st = t % C::kStages;
        mbar_wait(full_v + st, (t / C::kStages) & 1);
        const uint32_t va = opaque(smem_addr(sV(st)));
        wgmma_fence();""", """        const int st = t % C::kStages;
        wgmma_fence();
        mbar_wait(full_v + st, (t / C::kStages) & 1);
        const uint32_t va = opaque(smem_addr(sV(st)));""")


VARIANTS = {
    "source": lambda s: s,
    "hd256_no_overlap": lambda s: sub(s, "static constexpr bool kOverlap = kConsumers == 1;",
                                      "static constexpr bool kOverlap = false;"),
    "overlap_128keys": overlap,
    "overlap_64keys": lambda s: keys64(overlap(s)),
    "pingpong": pingpong,
    "fence_before_wait": fence_before_wait,
    "hd256_two_consumers": lambda s: sub(s, "static constexpr int kConsumers = HD == 128 ? 2 : 1;",
                                         "static constexpr int kConsumers = 2;"),
    "stages3": lambda s: sub(s, "static constexpr int kStages = 2;",
                             "static constexpr int kStages = HD == 128 ? 3 : 2;"),
}


def emit(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import flash_attention as FA
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    order = argv or ["source", *[n for n in VARIANTS if n != "source"], "source"]
    names = list(dict.fromkeys(order))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", card=card)
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
    sm90 = trap(open(os.path.join(CSRC, "sm90.cuh")).read())
    nvcc = _lib._nvcc()
    procs = {}
    for n in names:
        d = os.path.join(OUT, n)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(CSRC, "common.cuh"), d)
        with open(os.path.join(d, "sm90.cuh"), "w") as f:
            f.write(sm90)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(VARIANTS[n](src))
        cmd = [nvcc, *_lib._NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", d, os.path.join(d, "flash_attention.cu"),
               "-o", os.path.join(d, "fa.so")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    libs = {}
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(out[-4000:], file=sys.stderr)
            return p.returncode
        ptxas, hd = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '.*flash_fwd_kernelILi(\d+)", line)
            if m or "Compiling entry function" in line:
                hd = f"hd{m.group(1)}" if m else None
            elif hd and ("spill" in line or "Used" in line):
                ptxas.setdefault(hd, []).append(line.strip().removeprefix("ptxas info    : "))
            if "(C75" in line:
                ptxas.setdefault("notes", []).append("C75" + line.split("(C75")[1][:2])
        so = os.path.join(OUT, n, "fa.so")
        sass, fn = {}, None
        text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1]
                fn = ("hd256" if "ILi256" in name else "hd128") if "flash_fwd_kernel" in name else None
                if fn:
                    sass[fn] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0}
            elif fn:
                for op in sass[fn]:
                    sass[fn][op] += f" {op}" in line
        emit("build", variant=n, ptxas=ptxas, sass=sass)
        lib = ctypes.CDLL(so)
        fwd = lib.bnb_flash_attention_causal_fwd
        fwd.argtypes = _lib._SIGNATURES["bnb_flash_attention_causal_fwd"]
        fwd.restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(60)
    data = []
    for B, T, H, KVH, hd in SHAPES:
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(torch.bfloat16)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(torch.bfloat16)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)
        data.append(([B, T, H, KVH, hd], (q, k, v), FA.flash_attention_causal_fwd_plain(q, k, v)))
    for n in order:
        _lib._lib = libs[n]
        rows = []
        for shape, (q, k, v), (op, mp, lp) in data:
            o, m, l = FA.flash_attention_causal_fwd(q, k, v)
            errs = {"o_abs": (o.float() - op.float()).abs().max().item(), "m_abs": (m - mp).abs().max().item(),
                    "l_rel": ((l - lp).abs().max() / lp.abs().max()).item()}
            same = all(torch.equal(a, b) for a, b in zip(FA.flash_attention_causal_fwd(q, k, v), (o, m, l)))
            ok = errs["o_abs"] <= 2e-2 and errs["m_abs"] <= 1e-4 and errs["l_rel"] <= 1e-5 and same
            ms = cuda_time(lambda: FA.flash_attention_causal_fwd(q, k, v), n=20, flush_l2=True, hold=True)["median"]
            rows.append({"shape": shape, "ms": ms, "ok": ok, "errs": errs})
        emit("variant", variant=n, rows=rows)
    sdpa = {}
    for shape, (q, k, v), _ in data:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa[str(shape)] = cuda_time(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                            enable_gqa=True),
                                     n=20, flush_l2=True, hold=True)["median"]
    emit("sdpa", ms=sdpa)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
