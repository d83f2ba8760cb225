#!/usr/bin/env python3
"""A/B of the PyTorch port's K-adjacent 4-bit dequantize (kernel 10, plain and
``_dq``) across checkouts of this repo, on one NVIDIA GPU.

    python3 experiments/ab_dequant_2d_torch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (this one, or another commit unpacked with
``git archive``).  The roots run one after another, each in its own process
that imports ``bitsandbytes_tpu_torch`` from that root and builds its kernels;
give them in turns (A B B A) so that drift on the card shows.  Each run
quantizes Llama-3-8B's four fused linears from one seed as the FSDP-QLoRA
recipe stores them (NF4, blocksize 64, bf16 ``quant_storage``: the K-adjacent
layout), plain and double-quantized, and the same weights on the paired
layout.  For each linear and output type (bf16, f16, f32) it times
``dequantize_4bit_2d`` on the resolved absmax and ``dequantize_4bit_2d_dq`` on
the codes, with the host held out of the window (``cuda_time(flush_l2=True,
hold=True)``, median of 20), beside ``zero_()`` of the same W (the store
floor) and kernel 3 (``dequantize_paired_fast``) on the paired copy of the
weight, and fingerprints every kernel-10 output.  Prints one JSON line per
run, then one line that holds the runs' layer sums side by side and whether
every root's outputs carry the same bits.
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
    from bitsandbytes_tpu_torch.functional.fourbit import payload_bytes
    from bitsandbytes_tpu_torch.nn.modules import QuantizedTensor
    from bitsandbytes_tpu_torch.ops.gemm4bit import dequantize_4bit_2d, dequantize_4bit_2d_dq
    from bitsandbytes_tpu_torch.ops.gemm4bit_paired import dequantize_paired_fast
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
        nested = QuantizedTensor.quantize(Wf, blocksize=BS, compress_statistics=True, quant_storage=torch.bfloat16)
        paired = QuantizedTensor.quantize(Wf, blocksize=BS)
        del Wf
        st = nested.state
        Bq = payload_bytes(nested.data).reshape(-1)
        am = st.dequant_absmax().contiguous()
        nest = (st.absmax.reshape(-1), st.state2.absmax, st.offset)
        calls = {
            "kernel10": lambda dt: dequantize_4bit_2d(Bq, am, code, BS, (N, K), dt),
            "kernel10_dq": lambda dt: dequantize_4bit_2d_dq(Bq, *nest, code, BS, (N, K), dt),
        }
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            key = f"{name}_{str(dt)[6:]}"
            row = {}
            for kernel, fn in calls.items():
                W = fn(dt)
                prints[f"{key}_{kernel}"] = fingerprint(W)
                row[kernel] = cuda_time(lambda: fn(dt), flush_l2=True, hold=True)["median"]
            assert prints[f"{key}_kernel10"] == prints[f"{key}_kernel10_dq"], f"{key}: _dq differs from plain"
            row["store_floor"] = cuda_time(lambda: W.zero_(), flush_l2=True, hold=True)["median"]
            row["kernel3"] = cuda_time(lambda: dequantize_paired_fast(paired.data, paired.state.absmax, code, BS, dt),
                                       flush_l2=True, hold=True)["median"]
            rows[key] = row
            del W
        del nested, paired, st, Bq, am, nest, calls
        torch.cuda.empty_cache()
    layer = {}
    for key, row in rows.items():
        dt = key.rsplit("_", 1)[1]
        for k, v in row.items():
            layer.setdefault(dt, {}).setdefault(k, 0.0)
            layer[dt][k] += v
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": card, "device_ms": rows, "layer_device_ms": layer, "fingerprints": prints}


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
