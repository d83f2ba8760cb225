"""Timing on the card with CUDA events, and a bandwidth canary.

Counterpart of the JAX package's ``utils/benchmark.py``.  PyTorch returns
before the device finishes, so a kernel is timed with CUDA events around
each call after a warm-up, and the median of n calls is reported with its
min and max.  The canary times a device-to-device copy of >= 1 GB: the
memory rate this card reaches, against which decode steps are bounded.
Both refuse to run without a CUDA device.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_time", "bandwidth_canary"]


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")


def cuda_time(fn: Callable[[], object], n: int = 20, warmup: int = 3, flush_l2: bool = False) -> dict:
    """Milliseconds per call of ``fn()`` on the current stream:
    ``{"median", "min", "max", "n"}``.  ``flush_l2`` overwrites a buffer
    larger than the L2 cache before each timed call (outside the timed
    window), so the call finds its inputs in device memory, as a decode
    step finds each layer's weights."""
    _require_cuda()
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") if flush_l2 else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if scratch is not None:
            scratch.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return {"median": times[len(times) // 2], "min": times[0], "max": times[-1], "n": n}


def bandwidth_canary(nbytes: int = 1 << 30, n: int = 10) -> dict:
    """Device memory rate from a copy of ``nbytes`` (read once and written
    once, so 2 * nbytes move per copy).  Returns ``{"gb_s", "ms", "bytes"}``
    with the median time."""
    _require_cuda()
    if nbytes < (1 << 30):
        raise ValueError("the canary copies at least 1 GiB, far beyond the L2 cache")
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    t = cuda_time(lambda: dst.copy_(src), n=n, warmup=2)
    ms = t["median"]
    del src, dst
    return {"gb_s": 2 * nbytes / (ms * 1e-3) / 1e9, "ms": ms, "bytes": 2 * nbytes}
