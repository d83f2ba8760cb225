"""Spawning gloo ranks for the port's multi-rank CPU tests, each world
under a time limit of its own."""

import time

import pytest
import torch.multiprocessing as mp


def spawn_world(fn, world: int, tmp: str, limit_s: float) -> None:
    """Run ``fn(rank, world, tmp)`` in ``world`` spawned processes.  Past
    ``limit_s`` seconds the ranks are killed and the test fails: a rank
    left waiting on an exchange its partner never runs would otherwise hold
    the whole suite's clock."""
    ctx = mp.start_processes(fn, args=(world, tmp), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + limit_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            pytest.fail(f"{world} ranks did not finish within {limit_s} s (an unmatched exchange?)")
