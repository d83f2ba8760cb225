#!/usr/bin/env python3
"""A/B of the PyTorch port's blockwise quantize kernels (kernel 1,
``quantize_4bit_codes``, and kernel 13, ``quantize_blockwise8``) across
checkouts of this repo, on one NVIDIA GPU.

    python3 experiments/ab_quant_torch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (this one, or another commit unpacked with
``git archive``).  The roots run one after another, each in its own process
that imports ``bitsandbytes_tpu_torch`` from that root and builds its kernels;
give them in turns (A B B A) so that drift on the card shows.  Each run times,
with the L2 flushed before each call, median of 20, both with the host in the
window (``ms``) and held out (``device_ms``, ``cuda_time(hold=True)``):

* kernel 1 on Llama-3-8B's gate_up ``[28672, 4096]``, nf4, blocksize 64:
  f32 W; bf16 W as the root's loader quantizes it (in its type where the
  root's kernel takes bf16, else cast to f32 first, the cast inside the
  window); f32 W with uniforms (the stochastic mode);
* kernel 13 on the nested absmax of gate_up (1.8 M f32, blocksize 256) and
  on an lm_head-sized tensor ``[32000, 4096]`` (blocksize 4096), the dynamic
  map;

and fingerprints every output.  Then it loads Llama-3-8B (32 layers, random
bf16 weights from seed 0, fused, nf4 blocksize 64) through the root's
``quantize_params_4bit``, plain and double-quantized, under
``torch.profiler``, and sums the device time by class: kernel 1, kernel 13,
the concatenations of fused weights, copies and casts (by kernel name, so
with the elementwise kernels that load or store with a cast), the other
kernels (packing, ``fixed_order_mean``).  Last,
the local stores (SASS ``STL``) of each kernel's instances in the root's
build, from ``cuobjdump -sass``.  Prints one JSON line per run, then one line
with the runs' times side by side and whether every root's outputs carry the
same bits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

BS = 64


def sass_stl(so: str, nvcc: str, kernel: str):
    """STL count over the instances of ``kernel`` in ``so`` (None without cuobjdump)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True, timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if f"{kernel}_kernel" in name and f"de{kernel}_kernel" not in name else None
            if fn:
                found[fn] = 0
        elif fn and " STL" in line:
            found[fn] += 1
    return {"instances": len(found), "stl": sum(found.values())}


def run_one(root: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    from bitsandbytes_tpu_torch.functional.codebooks import create_dynamic_map
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import _lib
    from bitsandbytes_tpu_torch.ops import quant4bit as Q4
    from bitsandbytes_tpu_torch.ops.blockwise8 import quantize_blockwise8
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    so = _lib.build()

    def fingerprint(t):  # exact integer arithmetic on the bytes
        x = t.reshape(-1).view(torch.uint8).to(torch.int64)
        return int((x * (torch.arange(x.numel(), device=dev) % 65521 + 1)).sum())

    def times(fn):
        return {"ms": cuda_time(fn, flush_l2=True)["median"],
                "device_ms": cuda_time(fn, flush_l2=True, hold=True)["median"]}

    rows, prints = {}, {}
    N, K = 28672, 4096
    xb = (torch.randn(N, K, generator=gen, device=dev) * K**-0.5).to(torch.bfloat16).reshape(-1)
    x = xb.float()
    u = torch.rand(x.numel(), generator=gen, device=dev)
    takes_bf16 = torch.bfloat16 in getattr(Q4, "QUANTIZE_DTYPES", {})
    calls = {
        "k1_gate_up_f32": lambda: Q4.quantize_4bit_codes(x, "nf4", BS),
        "k1_gate_up_bf16": (lambda: Q4.quantize_4bit_codes(xb, "nf4", BS)) if takes_bf16 else
                           (lambda: Q4.quantize_4bit_codes(xb.to(torch.float32), "nf4", BS)),
        "k1_gate_up_f32_stochastic": lambda: Q4.quantize_4bit_codes(x, "nf4", BS, u),
    }
    dyn = create_dynamic_map()
    am = x.reshape(-1, BS).abs().amax(1)
    xa = (am - am.mean()).contiguous()  # gate_up's absmax, as the nested load quantizes it
    xl = torch.randn(32000 * 4096, generator=gen, device=dev)
    calls["k13_nested_absmax"] = lambda: quantize_blockwise8(xa, dyn, 256)
    calls["k13_lm_head"] = lambda: quantize_blockwise8(xl, dyn, 4096)
    for key, fn in calls.items():
        out = fn()
        prints[key] = [fingerprint(t) for t in out]
        rows[key] = times(fn)
    rows["k1_takes_bf16"] = takes_bf16
    del xb, x, u, am, xa, xl, out
    torch.cuda.empty_cache()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    cfg = L.LlamaConfig.llama3_8b()
    load = {}
    for compress in (False, True):
        params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(cfg.num_layers):
                params["layers"][i] = L.quantize_params_4bit(
                    {"layers": [params["layers"][i]]}, fuse=True, compress_statistics=compress)["layers"][0]
            torch.cuda.synchronize()
        classes = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or device_us(e) <= 0:
                continue
            low = e.key.lower()
            label = ("kernel 1" if "quantize_4bit_codes" in e.key else "kernel 13" if "quantize_blockwise8" in e.key
                     else "concatenations" if "CatArrayBatchedCopy" in e.key
                     else "copies and casts" if ("copy" in low or "cast" in low) else "other kernels")
            c = classes.setdefault(label, {"ms": 0.0, "launches": 0})
            c["ms"] += device_us(e) / 1e3
            c["launches"] += e.count
        load["nested" if compress else "plain"] = {"device_ms": sum(c["ms"] for c in classes.values()),
                                                   "by_class": classes}
        prints[f"load_{compress}"] = [fingerprint(params["layers"][i][n].data) for i in (0, 31)
                                      for n in ("wqkv", "gate_up")]
        del params
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": card, "times": rows, "load": load,
            "sass_stl": {k: sass_stl(so, _lib._nvcc(), k) for k in ("quantize_4bit_codes", "quantize_blockwise8")},
            "fingerprints": prints}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"times": [{"root": r["root"], **r["times"]} for r in runs],
                      "load_device_ms": [{"root": r["root"], **{k: v["device_ms"] for k, v in r["load"].items()}}
                                         for r in runs],
                      "same_bits": all(r["fingerprints"] == runs[0]["fingerprints"] for r in runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
