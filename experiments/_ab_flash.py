"""What the TF32 and streamed flash attention A/B scripts share
(``ab_flash_fwd_tf32_torch.py``, ``ab_flash_dkv_tf32_torch.py``,
``ab_flash_dq_tf32_torch.py``, ``ab_flash_fwd_streamed_torch.py``): their
arguments, the text edits of a variant, the builds of ``csrc/flash_attention.cu``
with ``nvcc -Xptxas -v`` (one library each, all started at once), ptxas's notes
and the SASS counts of the instance under test, and each instance's SASS
against the parent's, instruction by instruction."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bitsandbytes_tpu_torch", "csrc")
# the instances told apart by mangled name: the 16-bit wgmma and the TF32 ones carry hd as a template argument
TEMPLATED = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel", "flash_tf32_dkv_kernel",
             "flash_tf32_dq_kernel", "flash_tf32_fwd_kernel")
WIDE = ("flash_wide_fwd_kernel", "flash_wide_dkv_kernel", "flash_wide_dq_kernel")
# the instances that take hd at run time: told apart by type alone
RUNTIME_HD = ("flash_streamed_fwd_kernel",)


def parser(variants) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of an earlier checkout: the SASS check and the A/B")
    ap.add_argument("--variants", nargs="*", default=list(variants))
    ap.add_argument("--quick", action="store_true", help="the trapped source alone, checked and timed once")
    ap.add_argument("--untrapped", action="store_true", help="build the variants without the trapping wait")
    return ap


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
    """(kernel, type, hd) of a 16-bit wgmma instance, TF32 instance,
    streamed instance or wide-family kernel by mangled name (hd 0 where the
    kernel takes it at run time), else None."""
    for kern in TEMPLATED:
        m = re.search(kern + r"ILi(\d+)E", name)
        if m:
            return kern, "f32" if "tf32" in kern else "bf16" if "bfloat16" in name else "f16", int(m.group(1))
    for kern in WIDE + RUNTIME_HD:
        if kern in name:
            return kern, "f32" if "IfE" in name else "bf16" if "bfloat16" in name else "f16", 0
    return None


def label(inst) -> str:
    """An instance's key in a build's report: its hd, or its type where the
    kernel takes hd at run time."""
    return f"hd{inst[2]}" if inst[2] else inst[1]


def build(nvcc, flags, out, name, csrc_dir, edits=(None, None), trapped=False):
    """Copies ``csrc_dir``'s flash attention sources to out/name (edited:
    flash_attention.cu, sm90.cuh) and starts its nvcc; returns (dir,
    process)."""
    d = os.path.join(out, name)
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


def finish(nvcc, name, d, proc, signatures, new):
    """Waits for a build: ptxas lines and SASS counts of each instance of
    the kernel ``new``, the SASS bodies of every instance, and the
    library."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out[-6000:]}")
    ptxas, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance(m.group(1))
            key = label(inst) if inst and inst[0] == new else None
        elif key and ("spill" in line or "Used" in line):
            ptxas.setdefault(key, []).append(line.split(":", 1)[-1].strip())
        if "(C75" in line:
            fn = re.search(r"'(\S+)'", line)
            inst = instance(fn.group(1)) if fn else None
            where = "/".join(map(str, inst)) if inst else key
            ptxas.setdefault("notes", []).append(f"{where}: " + re.sub(r"'\S+'", "", line.strip())[:160])
    so = os.path.join(d, "fa.so")
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    bodies, counts, fn = {}, {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = instance(line.split("Function :")[1].strip())
            if fn:
                bodies[fn] = []
                if fn[0] == new:
                    counts[label(fn)] = {"HGMMA": 0, "HGMMA_TF32": 0, "UTMALDG": 0, "STL": 0}
        elif fn and "/*" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins:
                bodies[fn].append(ins)
            if fn[0] == new:
                c = counts[label(fn)]
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


def build_all(args, variants, out, new):
    """The card and toolkit, then every library the arguments ask for, built
    at once: each variant's (``trap_`` or ``free_`` before its name) and,
    with ``--parent``, ``change`` and ``parent``, whose instances' SASS is
    held against each other.  Returns (the variants' names, their prefix,
    the libraries by name, whether every instance the parent has is the
    same)."""
    import torch

    from bitsandbytes_tpu_torch.ops import _lib

    emit("device", card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                       capture_output=True, text=True).stdout.strip())
    nvcc = _lib._nvcc()
    emit("toolkit", nvcc=subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.split("\n")[-2],
         torch=torch.__version__, cuda=torch.version.cuda)
    names = ["source"] if args.quick else args.variants
    prefix = "free_" if args.untrapped and not args.quick else "trap_"
    jobs = {prefix + n: build(nvcc, _lib._NVCC_FLAGS, out, prefix + n, CSRC, edits=variants[n],
                              trapped=prefix == "trap_") for n in names}
    if args.parent:
        jobs["change"] = build(nvcc, _lib._NVCC_FLAGS, out, "change", CSRC)
        jobs["parent"] = build(nvcc, _lib._NVCC_FLAGS, out, "parent",
                               os.path.join(os.path.abspath(args.parent), "bitsandbytes_tpu_torch", "csrc"))
    libs, bodies = {}, {}
    for name, (d, proc) in jobs.items():
        libs[name], bodies[name] = finish(nvcc, name, d, proc, _lib._SIGNATURES, new)

    same_sass = True
    if args.parent:  # the instances the parent has, against the change's
        for key in sorted(bodies["parent"]):
            a, b = bodies["parent"][key], bodies["change"].get(key)
            differing = None if b is None else sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            same_sass &= differing == 0
            emit("sass_against_parent", kernel=key[0], dtype=key[1], hd=key[2], parent_instructions=len(a),
                 change_instructions=None if b is None else len(b), differing=differing)
        emit("sass_against_parent_all_same", same=same_sass, instances=len(bodies["parent"]))
    return names, prefix, libs, same_sass
