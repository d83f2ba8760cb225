#!/usr/bin/env python3
"""A/B of the PyTorch port's 8-bit optimizer updates (kernels 14 and 15)
across checkouts of this repo, on one NVIDIA GPU.

    python3 experiments/ab_optim8bit_torch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (this one, or another commit unpacked with
``git archive``).  The roots run one after another, each in its own process
that imports ``bitsandbytes_tpu_torch`` from that root and builds its kernels;
give them in turns (A B B A) so that drift on the card shows.  Each run draws
the 448 adapter tensors of a Llama-3-8B QLoRA step (rank 64 on seven targets
of 32 layers, f32) with random 8-bit states from one seed, and times one
optimizer step over all of them, AdamW (kernel 14) and AdEMAMix (kernel 15),
step 5: as one grouped call where the checkout has
``optimizer_update_8bit_multi_``, else one call a tensor.  It times a 64 M
element tensor alone too.  Times are device times with the host held out: a
spin of about 57 ms on the card goes ahead of each timed call, longer than
the call's host time (checked), median of 10.  Each run then takes three
fresh steps from the same inputs and fingerprints every output (parameters,
states, absmax).  Prints one JSON line per run, then one line that holds the
runs' times side by side and whether every root's outputs carry the same
bits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HOLD_CYCLES = 100_000_000  # about 57 ms at the H100's 1.755 GHz
TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def run_one(root: str) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from bitsandbytes_tpu_torch.functional.codebooks import create_dynamic_map
    from bitsandbytes_tpu_torch.models import llama as L
    from bitsandbytes_tpu_torch.ops import optim8bit as O8
    from bitsandbytes_tpu_torch.optim.base import _ademamix_schedules

    dev = torch.device("cuda")
    cfg = L.LlamaConfig.llama3_8b()
    lora = L.add_lora(cfg, rank=64, targets=TARGETS, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    shapes = [tuple(t.shape) for t in L.lora_parameters(lora) if t.dim() > 0]
    del lora
    q1, q2 = create_dynamic_map(signed=True), create_dynamic_map(signed=False)
    codes = O8.StateCodes(q1, q2)
    alpha, beta3 = _ademamix_schedules(5, 5.0, 0.9999, 1000, 1000)
    rules = {
        "adamw": O8.UpdateScalars.make("adam", beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, step=5, lr=1e-3),
        "ademamix": O8.UpdateScalars.make("ademamix", beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2, step=5,
                                          lr=1e-3, beta3=beta3, alpha=alpha),
    }
    grouped = hasattr(O8, "optimizer_update_8bit_multi_")

    def inputs(sc, shapes, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = []
        for shp in shapes:
            n = 1
            for d in shp:
                n *= d
            nb = -(-n // 256)
            lead = (2,) if sc.ademamix else ()
            out.append((torch.randn(shp, generator=gen, device=dev) * 0.01, torch.randn(shp, generator=gen, device=dev),
                        torch.randint(0, 256, lead + shp, generator=gen, device=dev, dtype=torch.uint8),
                        torch.randint(0, 256, shp, generator=gen, device=dev, dtype=torch.uint8),
                        torch.rand(lead + (nb,), generator=gen, device=dev) * 0.01,
                        torch.rand(nb, generator=gen, device=dev) * 1e-4))
        return out

    def step_fn(sc, leaves):
        if grouped:
            return lambda: O8.optimizer_update_8bit_multi_(sc, leaves, codes)
        return lambda: [O8.optimizer_update_8bit_(sc, *lf, codes) for lf in leaves]

    def device_ms(fn, n=10):
        scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        fn()
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            scratch.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        # the spin must outlast the host's share, or host time would sit in the window
        assert max(host) < hold_ms, f"the host took {max(host)} ms, the spin {hold_ms}"
        return {"median": times[len(times) // 2], "min": times[0], "max": times[-1], "host_ms_max": max(host)}

    def fingerprint(t):  # exact integer arithmetic on the output's bits
        x = t.reshape(-1).contiguous().view(torch.uint8).to(torch.int64)
        return int((x * (torch.arange(x.numel(), device=dev) % 65521 + 1)).sum())

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    end.record()
    end.synchronize()
    hold_ms = start.elapsed_time(end)
    timing, prints = {"hold_ms": hold_ms}, {}
    for rule, sc in rules.items():
        leaves = inputs(sc, shapes, 1)
        t448 = device_ms(step_fn(sc, leaves))
        del leaves
        big = inputs(sc, [(64 << 20,)], 2)
        t64 = device_ms(step_fn(sc, big))
        del big
        torch.cuda.empty_cache()
        leaves = inputs(sc, shapes, 3)
        for _ in range(3):
            step_fn(sc, leaves)()
        torch.cuda.synchronize()
        prints[rule] = [fingerprint(t) for lf in leaves for t in lf[1:]]
        del leaves
        torch.cuda.empty_cache()
        timing[rule] = {"step_448_device_ms": t448, "leaf_64M_device_ms": t64}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": card, "grouped": grouped, "device_ms": timing, "sass_stl": sass_stl(),
            "fingerprints": prints}


def sass_stl():
    """Local stores (``STL``) of the optimizer kernels in this root's built
    library (``cuobjdump -sass``), by kernel: the most before an instance's
    first barrier (where a parameter indexed by a register gets copied to
    local memory) and the count in all; None without the tool."""
    from bitsandbytes_tpu_torch.ops import _lib

    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", _lib.build()], capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = None
            for kernel in ("optimizer_update_8bit_ademamix_kernel", "optimizer_update_8bit_kernel"):
                if kernel in name:
                    fn = out.setdefault(kernel, {"stl_before_first_barrier_max": 0, "stl": 0})
                    before, barrier = 0, False
                    break
        elif fn is not None and " BAR" in line:
            barrier = True
        elif fn is not None and " STL" in line:
            fn["stl"] += 1
            before += not barrier
            fn["stl_before_first_barrier_max"] = max(fn["stl_before_first_barrier_max"], before)
    return out


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
        print(json.dumps({k: v for k, v in runs[-1].items() if k != "fingerprints"}), flush=True)
    print(json.dumps({"device_ms": [{"root": r["root"], **r["device_ms"]} for r in runs],
                      "same_bits": all(r["fingerprints"] == runs[0]["fingerprints"] for r in runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
