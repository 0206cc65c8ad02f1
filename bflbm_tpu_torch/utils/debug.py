"""Runtime invariant guards on the card: NaN sentinel, mass, field
statistics (``bflbm_tpu/utils/debug.py``; reference Debug.H NaN sweep
:75-149, PrintMassConservation :233-249, compute_multifab_fluctuation
:153-202).  Each returns a 0-d tensor on the field's device, so that a
caller syncs once for all of them."""

from __future__ import annotations

from typing import Dict

import torch


def has_nonfinite(*tensors: torch.Tensor) -> torch.Tensor:
    """True where any element of any tensor is NaN or infinite."""
    bad = torch.zeros((), dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        bad = bad | ~torch.isfinite(t).all()
    return bad


def field_stats(field: torch.Tensor) -> Dict[str, torch.Tensor]:
    """mean, population standard deviation, min and max of a field."""
    return {"mean": field.mean(), "std": field.std(correction=0),
            "min": field.min(), "max": field.max()}


def mass(f: torch.Tensor) -> torch.Tensor:
    """Total mass of one species' populations, summed in float64."""
    return f.sum(dtype=torch.float64)
