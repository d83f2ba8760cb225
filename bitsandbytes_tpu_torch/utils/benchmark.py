"""Timing on the card with CUDA events, and a bandwidth canary.

Counterpart of the JAX package's ``utils/benchmark.py``.  PyTorch returns
before the device finishes, so a kernel is timed with CUDA events around
each call after a warm-up, and the median of n calls is reported with its
min and max.  The canary times a device-to-device copy of >= 1 GB: the
memory rate this card reaches, against which decode steps are bounded.
Both refuse to run without a CUDA device.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["cuda_time", "bandwidth_canary"]


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")


# card cycles of the spin that ``cuda_time(hold=True)`` queues ahead of a
# timed call: about 1 ms at the H100's clock, far more than a wrapper's host time
_HOLD_CYCLES = 2_000_000


def cuda_time(fn: Callable[[], object], n: int = 20, warmup: int = 3, flush_l2: bool = False,
              hold: bool = False, hold_cycles: int = _HOLD_CYCLES) -> dict:
    """Milliseconds per call of ``fn()`` on the current stream:
    ``{"median", "min", "max", "n"}``.  ``flush_l2`` overwrites a buffer
    larger than the L2 cache before each timed call (outside the timed
    window), so the call finds its inputs in device memory, as a decode
    step finds each layer's weights.  A call whose host work (the Python
    wrapper, the launch) outlasts the work queued ahead of it leaves the
    card idle inside the window; ``hold`` queues a spin of ``hold_cycles``
    on the card first (about a millisecond by default), so the window holds
    the device's time alone.  With ``hold`` the result also gives
    ``host_ms``, the longest host time of a call, and ``spin_ms``, the
    shortest spin: the host was held out where ``host_ms < spin_ms``."""
    _require_cuda()
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") if flush_l2 else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host, spin = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if scratch is not None:
            scratch.zero_()
        if hold:
            before = torch.cuda.Event(enable_timing=True)
            before.record()
            torch.cuda._sleep(hold_cycles)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if hold:
            spin.append(before.elapsed_time(start))
    times.sort()
    out = {"median": times[len(times) // 2], "min": times[0], "max": times[-1], "n": n}
    if hold:
        out.update(host_ms=max(host), spin_ms=min(spin))
    return out


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
