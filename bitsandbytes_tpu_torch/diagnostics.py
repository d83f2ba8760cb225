"""Diagnostics: ``python -m bitsandbytes_tpu_torch [--device cuda|cpu]``.

Counterpart of the JAX package's ``diagnostics.py``: prints the
environment (Python, PyTorch, CUDA, the card as ``nvidia-smi`` names it,
the kernel library's build directory), then runs a sanity check on the
device: one NF4 quantize round trip and one ``adamw8bit`` step, through
their kernels on CUDA (quantize, dequantize and the 8-bit update, each
launch counted).  Exits non-zero if a check fails.  Without a GPU it says
so and exits non-zero, unless ``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import argparse
import os
import platform
import subprocess
import sys
import traceback

import torch

__all__ = ["main", "print_environment", "sanity_check"]


def _header(title: str) -> None:
    print("+" + "-" * 62 + "+")
    print(f"| {title:<60} |")
    print("+" + "-" * 62 + "+")


def _nvidia_smi() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"(nvidia-smi not available: {e})"
    return res.stdout.strip() or f"(nvidia-smi exited {res.returncode})"


def print_environment(device: torch.device) -> None:
    from . import __version__
    from .ops import _lib

    _header("bitsandbytes_tpu_torch environment")
    print(f"bitsandbytes_tpu_torch: {__version__}")
    print(f"python:                 {sys.version.split()[0]} ({platform.platform()})")
    print(f"torch:                  {torch.__version__} (CUDA {torch.version.cuda})")
    print(f"CUDA available:         {torch.cuda.is_available()}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"device {i}:               {torch.cuda.get_device_name(i)}")
        print(f"nvidia-smi:             {_nvidia_smi()}")
    print(f"kernel sources:         {_lib._CSRC}")
    if device.type == "cuda":
        print(f"kernel library:         {os.path.dirname(_lib.build())}")
    else:
        print(f"kernel library:         not built (device {device}: the plain versions run)")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def sanity_check(device: torch.device) -> None:
    """One NF4 quantize round trip of a [256, 256] tensor and one
    ``adamw8bit`` step of a [64, 4096] parameter on ``device``; on CUDA each
    of kernels 1, 10 and 14 must launch once."""
    from . import optim
    from .functional import dequantize_4bit, quantize_4bit
    from .ops import launch_counts, reset_launch_counts

    gen = torch.Generator(device=device).manual_seed(0)
    reset_launch_counts()
    x = torch.randn(256, 256, generator=gen, device=device)
    packed, state = quantize_4bit(x, blocksize=64, quant_type="nf4")
    err = (x - dequantize_4bit(packed, quant_state=state)).abs().mean().item()
    _check(err < 0.1, f"NF4 round-trip error too large: {err}")
    print(f"quantize_4bit round trip: OK (mean abs err {err:.4f})")

    p = torch.nn.Parameter(torch.randn(64, 4096, generator=gen, device=device))
    before = p.detach().clone()
    opt = optim.adamw8bit([p], 1e-3)
    p.grad = before * 0.01
    opt.step()
    delta = (p.detach() - before).abs().max().item()
    _check(0 < delta < 1.0, f"AdamW8bit step moved the parameter by {delta}")
    _check(opt.state[p]["state1"].dtype == torch.uint8, "the step kept no 8-bit state")
    print(f"AdamW8bit step:           OK (max |dp| {delta:.2e})")
    if device.type == "cuda":
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        want = {"quantize_4bit_codes": 1, "dequantize_4bit_2d": 1, "optimizer_update_8bit": 1}
        _check(counts == want, f"kernel launches {counts} != {want}")
        print(f"kernel launches:          OK {counts}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bitsandbytes_tpu_torch", description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the sanity check runs (default: cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to check the plain versions on the CPU",
              file=sys.stderr)
        return 1
    try:
        print_environment(device)
        print()
        _header("sanity check")
        sanity_check(device)
    except Exception:
        traceback.print_exc()
        print("\nSanity check FAILED: see the traceback above.")
        return 1
    print("\nInstallation looks healthy.")
    return 0
