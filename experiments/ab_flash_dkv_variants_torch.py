#!/usr/bin/env python3
"""Design variants of kernel 18, the causal flash attention dK/dV backward
(``csrc/flash_attention.cu``, ``flash_bwd_dkv_kernel`` and its combine),
built side by side from text-edited copies of this checkout's source and
timed in one process on one NVIDIA GPU.

    python3 experiments/ab_flash_dkv_variants_torch.py [VARIANT ...]

With no arguments it runs every variant, the source as it stands first and
last.  Each copy goes to ``_probe/dkv_variants/<name>/`` (git-ignored) and
builds alone with ``nvcc -Xptxas -v``; its ``mbar_wait`` traps after 2^24
tries, so a variant that deadlocks fails its launch instead of hanging the
card (every variant carries the trap: compare them with each other, not with
``ab_flash_attention_torch.py``'s times).  For each variant: ptxas's
registers, spills and C75xx notes (``wgmma`` serialized) of each dK/dV
instance, its SASS counts (``HGMMA``, ``UTMALDG``, ``STL``), and at
``chip_smoke.py`` 3p's five timed shapes and its two batched ones dk and dv
against the plain version (each within 1e-2 of its largest magnitude, bit
for bit twice) and, at the timed shapes, the device ms
(``cuda_time(flush_l2=True, hold=True)``, median of 20, the combine
included) and the combine's own ms on the plan's partials.

The variants:

* ``source``: the kernel as committed;
* ``nosplit``: the same kernel under a plan that splits no key tile (what
  the partials and the combine cost, against the balance they buy);
* ``stages2``: a two-stage ring at hd 128 (four in the source);
* ``overlap``: each tile's dV and dK products left running while the next
  tile's S^T and dP^T are issued (S^T, dP^T, dK and dV of a warpgroup: 224
  accumulator and fragment registers);
* ``dv_early``: dV += P^T dO issued as soon as P is packed, so that ds is
  computed while that product runs.
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
OUT = os.path.join(ROOT, "_probe", "dkv_variants")
SHAPES = [(1, 1024, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 8192, 32, 8, 128),
          (1, 4096, 16, 16, 256)]
BATCHED = [(2, 1152, 8, 2, 128), (3, 640, 2, 1, 256)]


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


def stages2(src: str) -> str:
    return sub(src, "static constexpr int kStages = HD == 128 ? 4 : 2;", "static constexpr int kStages = 2;")


def overlap(src: str) -> str:
    """dV and dK of tile n stay in flight while tile n + 1's S^T and dP^T are
    issued; the stage of tile n is released once they land."""
    src = sub(src, """        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(sa[kk]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }
""", """        wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
""")
    src = sub(src, """        wgmma_wait<1>();  // S^T has landed, dP^T may still run
        fence_regs(s);
""", """        wgmma_wait<1>();  // the last tile's dV and dK and this S^T have landed, dP^T may still run
        fence_regs(s);
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(sa[kk]);
        }
        __syncwarp();
        if (n > 0 && lane == 0) mbar_arrive(empty + (n - 1) % C::kStages);  // done with the last tile's stage
""")
    return src


def dv_early(src: str) -> str:
    """dV += P^T dO issued as soon as P is packed, before dP^T has landed,
    so that ds is computed while the dV product runs."""
    src = sub(src, """        wgmma_wait<0>();
        fence_regs(dp);
        // ds = (dp - di) p scale;""", """#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk)
            wgmma_rs_tb<C::kCols>(dv, pa[kk], gmma_desc_sw128(oa + half_off + kk * 16 * 128, C::kRows * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed, dV may still run
        fence_regs(dp);
        // ds = (dp - di) p scale;""")
    src = sub(src, """            for (int r = 0; r < 4; ++r) {
                pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
                sa[kk][r] = pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
            }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kRows / 16; ++kk)
            wgmma_rs_tb<C::kCols>(dv, pa[kk], gmma_desc_sw128(oa + half_off + kk * 16 * 128, C::kRows * 128, 1024), 1);
#pragma unroll""", """            for (int r = 0; r < 4; ++r) sa[kk][r] = pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        wgmma_fence();
#pragma unroll""")
    return src


def same(src: str) -> str:
    return src


# name -> (source edit, the plan's slots: None for the card's SMs, 1 to split
# nothing); variants of one edit share a build
VARIANTS = {
    "source": (same, None),
    "nosplit": (same, 1),
    "stages2": (stages2, None),
    "overlap": (overlap, None),
    "dv_early": (dv_early, None),
}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def build(names, nvcc, flags):
    """Each variant's copy of the sources and its library, built at once:
    {name: (so, ptxas lines of the dK/dV and combine kernels)}."""
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()
    sm90 = trap(open(os.path.join(CSRC, "sm90.cuh")).read())
    procs, built, first = {}, {}, {}
    for n in names:
        edit = VARIANTS[n][0]
        if edit in first:
            continue
        d = os.path.join(OUT, n)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(CSRC, "common.cuh"), d)
        with open(os.path.join(d, "sm90.cuh"), "w") as f:
            f.write(sm90)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(edit(src))
        cmd = [nvcc, *flags, "-shared", "-Xptxas", "-v", "-I", d, os.path.join(d, "flash_attention.cu"),
               "-o", os.path.join(d, "fa.so")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        first[edit] = n
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{n}: nvcc failed\n{out[-6000:]}")
        ptxas, fn = {}, None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"flash_bwd_dkv_kernelILi(\d+)", line)
                fn = f"dkv_hd{m.group(1)}" if m else ("combine" if "dkv_combine" in line else None)
            elif fn and ("spill" in line or "Used" in line):
                ptxas.setdefault(fn, []).append(line.strip().removeprefix("ptxas info    : "))
            if "(C75" in line:
                code = "C75" + line.split("(C75")[1][:2]
                m = re.search(r"(flash_\w+?_kernel)ILi(\d+)", line)
                ptxas.setdefault("notes", []).append(f"{code} {m.group(1)}<{m.group(2)}>" if m else line[-160:])
        built[n] = (os.path.join(OUT, n, "fa.so"), ptxas)
    return {n: built[first[VARIANTS[n][0]]] for n in names}


def sass_counts(so: str, nvcc: str) -> dict:
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    sass, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1]
            fn = ("hd256" if "ILi256" in name else "hd128") if "flash_bwd_dkv_kernel" in name else None
            if fn:
                sass[fn] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0}
        elif fn:
            for op in sass[fn]:
                sass[fn][op] += f" {op}" in line
    return sass


def main(argv) -> int:
    import torch

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
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    nvcc = _lib._nvcc()
    libs = {}
    for n, (so, ptxas) in build(names, nvcc, _lib._NVCC_FLAGS).items():
        emit("build", variant=n, ptxas=ptxas, sass=sass_counts(so, nvcc))
        lib = ctypes.CDLL(so)
        for fn in ("bnb_flash_attention_causal_bwd_dkv", "bnb_flash_attention_causal_bwd_dkv_combine"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(60)
    data = []
    for B, T, H, KVH, hd in SHAPES + BATCHED:
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(torch.bfloat16)
        qkv = torch.randn(B, T, (H + 2 * KVH) * hd, generator=gen, device=dev).to(torch.bfloat16)
        v = qkv[..., (H + KVH) * hd:].reshape(B, T, KVH, hd)
        do = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
        o, m, l = FA.flash_attention_causal_fwd_plain(q, k, v)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, m, l, di)
        data.append(([B, T, H, KVH, hd], bwd, FA.flash_attention_causal_bwd_dkv_plain(*bwd)))
        del o
    plan0 = FA.dkv_plan
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()  # noqa: E731
    for n in order:
        _lib._lib = libs[n]
        FA._DKV_TABLES.clear()
        slots = VARIANTS[n][1]
        FA.dkv_plan = plan0 if slots is None else (lambda B, T, H, KVH, hd, _, s=slots: plan0(B, T, H, KVH, hd, s))
        rows = []
        for shape, bwd, (dkp, dvp) in data:
            dk, dv = FA.flash_attention_causal_bwd_dkv(*bwd)
            torch.cuda.synchronize()
            errs = {"dk_rel": rel(dk, dkp), "dv_rel": rel(dv, dvp)}
            again = FA.flash_attention_causal_bwd_dkv(*bwd)
            same = torch.equal(again[0], dk) and torch.equal(again[1], dv)
            row = {"shape": shape, "ok": max(errs.values()) <= 1e-2 and same, "errs": errs, "bits_twice": same}
            if shape[:1] == [1]:  # the timed shapes
                row["ms"] = cuda_time(lambda: FA.flash_attention_causal_bwd_dkv(*bwd), n=20, flush_l2=True,
                                      hold=True)["median"]
                plan, _, table = FA._dkv_tables(*shape, dev)
                row["items"], row["split_tiles"], row["target"] = len(plan.items), len(plan.combine), plan.target
                if plan.slots:
                    part = torch.randn(plan.slots, FA.DKV_KEYS, FA.DKV_COLS, generator=gen, device=dev)
                    row["combine_ms"] = cuda_time(
                        lambda: FA.flash_attention_causal_bwd_dkv_combine(part, part, table, dk, dv), n=20,
                        flush_l2=True, hold=True)["median"]
            rows.append(row)
        emit("variant", variant=n, rows=rows)
    FA.dkv_plan = plan0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
