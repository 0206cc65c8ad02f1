"""Wall-clock step timing on a CUDA device (MLUPS)."""

from __future__ import annotations

import time
from typing import Callable

import torch


def time_steps(run: Callable[[], object], cells: int, steps: int,
               warmup: int = 1, repeats: int = 3, device=None) -> dict:
    """Time run(), which advances `steps` steps of `cells` cells, between
    ``torch.cuda.synchronize`` barriers; the best of `repeats` gives the
    rate.  Raises without a CUDA device: a host clock on CPU tensors is
    not a device measurement."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_steps measures a CUDA device; none found")
    for _ in range(warmup):
        run()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    best = min(times)
    mlups = cells * steps / best / 1e6
    return {
        "best_s": best,
        "times_s": times,
        "mlups": mlups,
        "ns_per_cell_step": best / (cells * steps) * 1e9,
    }
