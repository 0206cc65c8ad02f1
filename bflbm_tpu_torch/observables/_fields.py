"""What the fieldwise observables share: a field as a float64 tensor on
its device, the per-axis cell-centre coordinates, and binned means."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def as_field(a, dtype=torch.float64) -> torch.Tensor:
    """`a` (a tensor, or a numpy array, taken as a CPU tensor) in `dtype`
    on its device."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        a = torch.as_tensor(a if a.flags.writeable else a.copy())
    return a.to(dtype)


def host(a) -> np.ndarray:
    """A tensor (or array) as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def axis_coords(shape, device, offset: float = None) -> List[torch.Tensor]:
    """Per axis the float64 cell-centre coordinates i - n/2 + 1/2 (box
    centre at 0), or (i + 1/2) / n with offset="box" ([0, 1] box
    units)."""
    out = []
    for n in shape:
        i = torch.arange(n, dtype=torch.float64, device=device)
        out.append((i + 0.5) / n if offset == "box" else i - n / 2.0 + 0.5)
    return out


def marginals(field: torch.Tensor) -> List[torch.Tensor]:
    """Per axis the sum of `field` over the other axes."""
    dims = range(field.dim())
    return [field.sum(dim=tuple(b for b in dims if b != a)) for a in dims]


def bin_means(x: torch.Tensor, edges, *values: torch.Tensor
              ) -> List[np.ndarray]:
    """The mean of `x`, and of each of `values`, in every non-empty bin of
    `edges` (np.digitize's bins: edges[i] <= x < edges[i + 1]; x at or
    past the last edge falls in none), as numpy arrays."""
    edges = torch.as_tensor(np.asarray(edges), device=x.device)
    nbins = len(edges) - 1
    which = torch.bucketize(x, edges, right=True) - 1
    keep = which < nbins
    which = which[keep]
    cnt = torch.bincount(which, minlength=nbins)[:nbins]
    sel = cnt > 0
    n = cnt[sel].to(torch.float64)
    return [host(torch.bincount(which, weights=v[keep],
                                minlength=nbins)[:nbins][sel] / n)
            for v in (x,) + values]
