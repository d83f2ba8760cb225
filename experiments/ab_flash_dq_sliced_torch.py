#!/usr/bin/env python3
"""Kernel 19's ``wgmma`` instances above head_dim 256 (the causal flash dQ
in bf16 and f16 at head_dim 384 and 512, ``csrc/flash_attention.cu``: a
block owns half of dq's columns, a ring stage holds the K tile's slice, and
K's other 64-column chunks and V's stream through a ring of chunk stages)
on one NVIDIA GPU, in one process.

    python3 experiments/ab_flash_dq_sliced_torch.py [--parent ROOT] [--variants NAME ...] [--quick] [--untrapped]

1. Builds: ``csrc/flash_attention.cu`` alone, each with ``nvcc -Xptxas -v``
   into its own library under ``_probe/dq_sliced/`` (git-ignored), all at
   once: this checkout's source; with ``--parent ROOT`` (an earlier commit
   unpacked with ``git archive``) the parent's; and each design variant, a
   text-edited copy of this source whose ``mbar_wait`` traps after 2^24
   tries (a deadlock fails its launch instead of hanging the card; compare
   the variants with each other).  Printed: ptxas's registers, spills and
   C75xx notes (``wgmma`` serialized) of every dQ instance, and the
   ``HGMMA``, ``UTMALDG`` and ``STL`` counts of its SASS.
2. With ``--parent``: every ``wgmma`` instance the parent has (the three
   kernels at head_dim 128 and 256, the forward and dK/dV at 384 and 512),
   this source's SASS against the parent's, instruction by instruction
   (addresses and encodings stripped).
3. Each variant through the port's wrapper, at B 1, T 2048, H 8 over 8 in
   bf16 and f16 at head_dim 384 and 512 (``chip_smoke.py`` 3p's), GQA
   batches (B 2, T 640, H 4 over 2) and the shortest T (128): dq against
   the plain version within 3p's ``FLASH_TOLERANCES`` (bf16 1e-2, f16 5e-3
   of the largest magnitude), bit for bit on a second call, one launch of
   ``..._bwd_dq_sliced``; then device ms (``cuda_time(flush_l2=True,
   hold=True)``, median of 20) at 3p's four shapes, the variants in turns
   and again in reverse.
4. With ``--parent``, the A/B: parent, change, change, parent, each through
   its own library's C entries on the same tensors (the parent's dQ at
   head_dim 384 and 512 is the wide family's ``_wide`` entry): the forward,
   dK/dV and dQ at 3p's four shapes, in bf16 at hd 128 (T 2048, H 32 over
   8) and hd 256 (T 4096, H 16 over 16), and in f32 at T 2048, H 32 over 8,
   hd 128 (the wide family); SDPA's backward (dq, dk and dv in one call)
   once a 16-bit shape.  Each side's outputs must agree with the other's
   bit for bit where the kernel is the same (all but the 16-bit dQ at 384
   and 512).

``--quick`` builds the trapped source alone (with ``--parent``, also the
change and the parent for step 2) and runs step 3 once, untimed but for one
pass: a new kernel's first call on the card.  ``--untrapped`` builds the
variants without the trap, for timings comparable with the committed
source's (run it on variants that have passed trapped).

The variants (hd 128 and 256 are left as they are by each), with their
stages and 8 KB chunk stages at hd 384 / 512:

* ``source``: as committed, 2 + 6 / 1 + 8;
* ``two_stages``: 2 + 6 / 2 + 4 (the design written first);
* ``chunks4``: 2 + 4 / 1 + 4;
* ``chunks8``: 2 + 8 / 1 + 8;
* ``chunks3``: 2 + 3 / 2 + 3;
* ``stages3``: 3 + 6 / 1 + 8;
* ``kv_slices``: the other layout: a stage holds the K and the V tile's
  slices, and the 64-column chunks of K and V outside them stream together
  through two 16 KB chunk stages (one commit group a chunk for S and dP),
  2 + 2 / 1 + 2;
* ``early_probs``: p computed once S has landed, at V's second chunk,
  while the rest of dP streams (the source computes it under V's last
  chunk).

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
OUT = os.path.join(ROOT, "_probe", "dq_sliced")
TOL = {"bfloat16": 1e-2, "float16": 5e-3}  # chip_smoke.FLASH_TOLERANCES' gradient gates
# (dtype, B, T, H, KVH, hd): 3p's four timed shapes first
TIMED = [(dt, 1, 2048, 8, 8, hd) for dt in ("bfloat16", "float16") for hd in (384, 512)]
CHECKED = TIMED + [("bfloat16", 2, 640, 4, 2, 384), ("float16", 2, 640, 4, 2, 512), ("bfloat16", 2, 640, 4, 2, 512),
                   ("float16", 2, 640, 4, 2, 384), ("bfloat16", 1, 128, 2, 1, 512), ("float16", 1, 128, 2, 2, 384)]

# the parent's WGMMA_HEAD_DIMS (before this design: dQ wide above hd 256)
PARENT_WGMMA = {"fwd": (128, 256, 384, 512), "dkv": (128, 256, 384, 512), "dq": (128, 256)}

STAGES = "    static constexpr int kKeys = 64;  // keys of a ring stage\n    static constexpr int kStages = HD == 512 ? 1 : 2;"
CHUNKS = "static constexpr int kChunkStages = kStream ? (HD == 384 ? 6 : 8) : 0;"


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


def between(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` up to ``end`` replaced by ``new``."""
    if src.count(start) != 1 or src.count(end) != 1 or src.index(start) > src.index(end):
        raise ValueError(f"the source no longer holds {start[:60]!r} once before {end[:60]!r}")
    return src[:src.index(start)] + new + src[src.index(end):]


def cfg(s384: int, c384: int, s512: int, c512: int):
    """Stages and chunk stages at hd 384 and 512."""
    return lambda s: sub(sub(s, STAGES, STAGES.replace("HD == 512 ? 1 : 2", f"HD == 384 ? {s384} : HD == 512 ? {s512} : 2")),
                         CHUNKS, CHUNKS.replace("(HD == 384 ? 6 : 8)", f"(HD == 384 ? {c384} : {c512})"))


# the kv_slices layout: the configuration, the producer's loop and the consumer's
KV_CFG = [("kStream = kSlices > 1 ? kOtherK + kChunks : 0;", "kStream = kSlices > 1 ? kOtherK : 0;"),
          ("kChunkStages = kStream ? (HD == 384 ? 6 : 8) : 0;", "kChunkStages = kStream ? 2 : 0;"),
          ("kChunkBytes = kKeys * 128;", "kChunkBytes = 2 * kKeys * 128;"),
          ("kStageBytes = kStream ? kKeys * kCols * 2 :", "kStageBytes = kStream ? 2 * kKeys * kCols * 2 :")]
KV_PRODUCER = (
    "                for (int t = 0; t < ntiles; ++t) {\n                    const int a0 = t * C::kStream;",
    "            } else {\n                for (int t = 0; t < ntiles; ++t) {",
    """                for (int t = 0; t < ntiles; ++t) {
                    for (int j = 0; j < C::kStream; ++j) {  // K's and V's chunk j outside the block's columns
                        const int a = t * C::kStream + j, sa = a % C::kChunkStages;
                        if (a >= C::kChunkStages) mbar_wait(empty_c + sa, ((a / C::kChunkStages) - 1) & 1);
                        mbar_expect_tx(full_c + sa, C::kChunkBytes);
                        tma_load_4d(sChunk(sa), &tk, full_c + sa, other(j) * 64, kvh, t * N, b);
                        tma_load_4d(sChunk(sa) + C::kChunkBytes / 2, &tv, full_c + sa, other(j) * 64, kvh, t * N, b);
                    }
                    const int st = t % C::kStages;
                    if (t >= C::kStages) mbar_wait(empty + st, ((t / C::kStages) - 1) & 1);
                    mbar_expect_tx(full + st, C::kStageBytes);
                    for (int c = 0; c < C::kColChunks; ++c) {
                        tma_load_4d(sK(st) + c * N * 128, &tk, full + st, (c0 + c) * 64, kvh, t * N, b);
                        tma_load_4d(sK(st) + C::kStageBytes / 2 + c * N * 128, &tv, full + st, (c0 + c) * 64, kvh,
                                    t * N, b);
                    }
                }
""")
KV_CONSUMER = (
    "        for (int t = 0; t < ntiles; ++t) {\n            const int st = t % C::kStages;\n"
    "            const int a0 = t * C::kStream;",
    "    // dQ in E (the block's columns)",
    """        for (int t = 0; t < ntiles; ++t) {
            const int st = t % C::kStages;
            const int a0 = t * C::kStream;
#pragma unroll
            for (int j = 0; j < C::kStream; ++j) {
                const int a = a0 + j;
                mbar_wait(full_c + a % C::kChunkStages, (a / C::kChunkStages) & 1);
                const uint32_t qa = opaque(smem_addr(sQ)) + other(j) * C::kRows * 128, oa = qa + C::kQBytes;
                const uint32_t ka = opaque(smem_addr(sChunk(a % C::kChunkStages))), va = ka + C::kChunkBytes / 2;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<N, E>(s, gmma_desc_sw128(qa + kk * 32, 16, 1024), gmma_desc_sw128(ka + kk * 32, 16, 1024),
                                   j > 0 || kk > 0);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<N, E>(dp, gmma_desc_sw128(oa + kk * 32, 16, 1024), gmma_desc_sw128(va + kk * 32, 16, 1024),
                                   j > 0 || kk > 0);
                wgmma_commit();
                if (j > 0) {
                    wgmma_wait<1>();
                    release_chunk(a - 1);
                }
            }
            mbar_wait(full + st, (t / C::kStages) & 1);
            const uint32_t qa = opaque(smem_addr(sQ)) + c0 * C::kRows * 128, oa = qa + C::kQBytes;
            const uint32_t ka = opaque(smem_addr(sK(st))), va = ka + C::kStageBytes / 2;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::kCols / 16; ++kk) {
                const uint32_t off = (kk / 4) * C::kRows * 128 + (kk % 4) * 32;
                const uint32_t koff = (kk / 4) * N * 128 + (kk % 4) * 32;
                wgmma_ss<N, E>(s, gmma_desc_sw128(qa + off, 16, 1024), gmma_desc_sw128(ka + koff, 16, 1024), 1);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < C::kCols / 16; ++kk) {
                const uint32_t off = (kk / 4) * C::kRows * 128 + (kk % 4) * 32;
                const uint32_t koff = (kk / 4) * N * 128 + (kk % 4) * 32;
                wgmma_ss<N, E>(dp, gmma_desc_sw128(oa + off, 16, 1024), gmma_desc_sw128(va + koff, 16, 1024), 1);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the last chunk's group and S have landed
            fence_regs(s);
            release_chunk(a0 + C::kStream - 1);
            probs(t);
            wgmma_wait<0>();
            fence_regs(dp);
            dsoft();
            issue_dq(t);
            wgmma_wait<0>();
            dq_landed();
            release(t);
        }
    }

""")


def kv_slices(s: str) -> str:
    for old, new in KV_CFG:
        s = sub(s, old, new)
    return between(between(s, *KV_PRODUCER), *KV_CONSUMER)


EARLY = ("""                if (j > 0) {  // at j 1 S has landed too
                    wgmma_wait<1>();
                    release_chunk(a - 1);
                }
            }
            fence_regs(s);
            probs(t);  // while V's last chunk runs
""", """                if (j > 0) {  // at j 1 S has landed too
                    wgmma_wait<1>();
                    release_chunk(a - 1);
                }
                if (j == 1) {
                    fence_regs(s);
                    probs(t);
                }
            }
""")

VARIANTS = {
    "source": lambda s: s,
    "early_probs": lambda s: sub(s, *EARLY),
    "two_stages": cfg(2, 6, 2, 4),
    "chunks4": cfg(2, 4, 1, 4),
    "chunks8": cfg(2, 8, 1, 8),
    "chunks3": cfg(2, 3, 2, 3),
    "stages3": cfg(3, 6, 1, 8),
    "kv_slices": kv_slices,
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
    """Waits for a build: ptxas lines and SASS counts of each dQ instance,
    the SASS bodies of every wgmma instance, and the library."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out[-4000:]}")
    ptxas, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance(m.group(1))
            key = f"{inst[1]} hd{inst[2]}" if inst and inst[0] == "flash_bwd_dq_kernel" else None
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
                if fn[0] == "flash_bwd_dq_kernel":
                    counts[f"{fn[1]} hd{fn[2]}"] = {"HGMMA": 0, "UTMALDG": 0, "STL": 0}
        elif fn and "/*" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins:
                bodies[fn].append(ins)
            if fn[0] == "flash_bwd_dq_kernel":
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
    gen = torch.Generator(device=dev).manual_seed(29)

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
        data[case] = (bwd, FA.flash_attention_causal_bwd_dq_plain(*bwd))
    of = {n: libs[prefix + n] for n in variants}  # each variant's library
    failed = False
    for n in variants:
        _lib._lib = of[n]
        rows = []
        for case in CHECKED:
            bwd, dqp = data[case]
            _lib.reset_launch_counts()
            dq = FA.flash_attention_causal_bwd_dq(*bwd)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES["flash_attention_causal_bwd_dq_sliced"] == 1
            err = rel(dq, dqp)
            same = torch.equal(FA.flash_attention_causal_bwd_dq(*bwd), dq)
            ok = err <= TOL[case[0]] and same and launched
            rows.append({"case": case, "ok": ok, "same_bits": same, "launched": launched, "dq_rel": err})
        failed |= not all(r["ok"] for r in rows)
        emit("check", variant=n, all_ok=all(r["ok"] for r in rows), rows=rows)
    timed = {}
    for order in (variants, variants[::-1]):
        for n in order:
            _lib._lib = of[n]
            for case in TIMED:
                bwd = data[case][0]
                timed.setdefault(str(case), {}).setdefault(n, []).append(
                    dev_ms(lambda: FA.flash_attention_causal_bwd_dq(*bwd)))
        if args.quick:
            break
    emit("variants_device_ms", **timed)
    if not ab:
        return 1 if failed else 0

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
    kinds = {case: ("fwd", "dkv", "dq") for case in ab_cases}  # every kernel at every case
    runs, outs, entries = {}, {}, {}
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
                entries[(side, case, key)] = entry
                if not all(torch.equal(a, b) for a, b in zip(prev, got)):
                    emit("differs_from_run_to_run", side=side, case=case, kernel=key)
                    return 1
                runs.setdefault(f"{dt} B{case[1]} T{case[2]} H{case[3]} KVH{case[4]} hd{hd} {key}", []).append(
                    (turn, side, entry, ms))
    same_sides = {}
    for (side, case, key), ts in outs.items():
        if side == "change":
            p = outs[("parent", case, key)]
            moved = entries["parent", case, key] != entries[side, case, key]  # the route changed its kernel
            same_sides[f"{case} {key}"] = {"same_bits": all(torch.equal(a, b) for a, b in zip(p, ts)),
                                           "same_kernel": not moved}
    emit("ab_device_ms", order=["parent", "change", "change", "parent"],
         **{k: {"entries": [e for _, _, e, _ in v], "ms": [ms for _, _, _, ms in v]} for k, v in runs.items()})
    emit("ab_bits", **same_sides)
    bad = [k for k, v in same_sides.items() if v["same_kernel"] and not v["same_bits"]]
    return 1 if bad or failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
