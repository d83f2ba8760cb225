"""Kernel wrappers (CUDA on a CUDA tensor, plain PyTorch on a CPU tensor)."""

from ._lib import build, launch_counts, reset_launch_counts

__all__ = ["build", "launch_counts", "reset_launch_counts"]
