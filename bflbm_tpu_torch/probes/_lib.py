"""What the probes share: the device check, the timing that exists only
on the card, and the max |delta| of a check."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.timing import event_ms


def device_of(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a card raises (a probe
    measures the card and has no CPU fallback there)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device and none was "
                           "found; pass device='cpu' for the plain versions")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernels for device {device}")
    return device


def timed(device: torch.device, run: Callable[[], object], calls: int = 1,
          warmup: int = 1, repeats: int = 3) -> Optional[float]:
    """ms a call of run's work on the card (CUDA events, the best of
    `repeats` runs after `warmup`; run makes `calls` calls), or None on
    the CPU, where nothing is measured and run is not called."""
    if device.type != "cuda":
        return None
    return event_ms(run, calls=calls, warmup=warmup, repeats=repeats)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| (NaN when either holds one)."""
    return float((a - b).abs().max())
