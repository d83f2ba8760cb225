#!/usr/bin/env python3
"""A/B of the PyTorch port's paired 4-bit dequantize (kernels 3 and 6) across
checkouts of this repo, on one NVIDIA GPU.

    python3 experiments/ab_dequant_paired_torch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (this one, or another commit unpacked with
``git archive``).  The roots run one after another, each in its own process
that imports ``bitsandbytes_tpu_torch`` from that root and builds its kernels;
give them in turns (A B B A) so that drift on the card shows.  Each run
quantizes Llama-3-8B's four fused linears from one seed (NF4, blocksize 64,
plain and double-quantized), then for each linear and output type (bf16, f16,
f32) times ``dequantize_paired_fast`` and ``dequantize_paired_fast_dq`` on the
device with the host held out of the window (``cuda_time(flush_l2=True,
hold=True)``, median of 20) beside ``zero_()`` of the same W (the store
floor), and fingerprints every output.  It also times gate_up to bf16 and
its store floor once more after a clean flush: ``cuda_time``'s flush zeroes
256 MB, which can leave dirty lines in the L2 cache that drain inside the
next window; here a read of another 256 MB follows the zeroing, outside the
window.  Prints one JSON line per run, then one line that holds the runs'
layer sums side by side and whether every root's outputs carry the same
bits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

LINEARS = {"wqkv": (6144, 4096), "wo": (4096, 4096), "gate_up": (28672, 4096), "down": (4096, 14336)}
BS = 64


def run_one(root: str) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from bitsandbytes_tpu_torch.functional.codebooks import get_4bit_code
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops.gemm4bit_paired import dequantize_paired_fast, dequantize_paired_fast_dq
    from bitsandbytes_tpu_torch.utils.benchmark import cuda_time

    dev = torch.device("cuda")
    code = get_4bit_code("nf4", BS)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fingerprint(W):  # exact integer arithmetic on the output's bits
        x = W.reshape(-1).view(torch.int16 if W.element_size() == 2 else torch.int32).to(torch.int64)
        return int((x * (torch.arange(x.numel(), device=dev) % 65521 + 1)).sum())

    rows, prints = {}, {}
    for name, (N, K) in LINEARS.items():
        Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
        plain = QuantizedTensor.quantize(Wf, blocksize=BS)
        nested = QuantizedTensor.quantize(Wf, blocksize=BS, compress_statistics=True)
        del Wf
        st = nested.state
        calls = {
            "kernel3": lambda dt: dequantize_paired_fast(plain.data, plain.state.absmax, code, BS, dt),
            "kernel6": lambda dt: dequantize_paired_fast_dq(nested.data, st.absmax, st.state2.absmax, st.offset,
                                                           code, BS, dt),
        }
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            key = f"{name}_{str(dt)[6:]}"
            row = {}
            for kernel, fn in calls.items():
                W = fn(dt)
                prints[f"{key}_{kernel}"] = fingerprint(W)
                row[kernel] = cuda_time(lambda: fn(dt), flush_l2=True, hold=True)["median"]
            row["store_floor"] = cuda_time(lambda: W.zero_(), flush_l2=True, hold=True)["median"]
            rows[key] = row
            del W
        del plain, nested, st, calls
        torch.cuda.empty_cache()
    # the flush's dirty lines: the same calls after a clean flush
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    reader = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def clean_time(fn, n=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            scratch.zero_()
            reader.sum()  # evicts the zeroed lines: their write-back lands here
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[n // 2]

    N, K = LINEARS["gate_up"]
    Wf = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
    q = QuantizedTensor.quantize(Wf, blocksize=BS)
    del Wf
    W = dequantize_paired_fast(q.data, q.state.absmax, code, BS, torch.bfloat16)
    flush = {"kernel3_zero_flush": cuda_time(lambda: dequantize_paired_fast(q.data, q.state.absmax, code, BS),
                                             flush_l2=True, hold=True)["median"],
             "kernel3_clean_flush": clean_time(lambda: dequantize_paired_fast(q.data, q.state.absmax, code, BS)),
             "store_floor_zero_flush": cuda_time(lambda: W.zero_(), flush_l2=True, hold=True)["median"],
             "store_floor_clean_flush": clean_time(lambda: W.zero_())}
    del q, W, scratch, reader
    layer = {}
    for key, row in rows.items():
        dt = key.rsplit("_", 1)[1]
        for k, v in row.items():
            layer.setdefault(dt, {}).setdefault(k, 0.0)
            layer[dt][k] += v
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": card, "device_ms": rows, "layer_device_ms": layer, "gate_up_bf16_flush_ms": flush,
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
    print(json.dumps({"layer_device_ms": [{"root": r["root"], **r["layer_device_ms"]} for r in runs],
                      "same_bits": all(r["fingerprints"] == runs[0]["fingerprints"] for r in runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
