"""Tier selection by device: a CUDA tensor goes to the hand-written Hopper
kernel, a CPU tensor to the plain PyTorch version beside it.

The JAX package chooses its tier with an environment knob; here the
tensor's device is the only switch.  There is no fallback: a CUDA tensor
whose shape or type the kernel does not take raises in the kernel's
wrapper, it is never sent to the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["use_kernel", "resolve_device"]


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU.  Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on CUDA or all on the CPU, got {sorted(kinds)}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a GPU the default raises rather than carry on quietly
    on the CPU; pass ``device="cpu"`` to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
