"""Global scalar observables: COM and fluctuation statistics
(``bflbm_tpu/observables/stats.py``; reference ``update_com``,
LBM_hydrovs.H:27-60, and Debug.H:153-249).

The centre of mass sums in float64: a float32 sum over 10^7 cells
carries errors of a fraction of a cell.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def center_of_mass(density: torch.Tensor) -> torch.Tensor:
    """Density-weighted COM in cell coordinates; returns (3,) float64."""
    d = density.to(torch.float64)
    total = d.sum()
    com = []
    for axis, n in enumerate(d.shape):
        others = tuple(a for a in range(d.dim()) if a != axis)
        profile = d.sum(dim=others)
        coords = torch.arange(n, dtype=torch.float64, device=d.device)
        com.append((profile * coords).sum() / total)
    return torch.stack(com)


def density_fluctuation(density: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean/sigma monitor (PrintDensityFluctuation, Debug.H:210-228):
    the population standard deviation."""
    return {"mean": density.mean(), "sigma": density.std(correction=0)}


def droplet_volume_ratio(rho: torch.Tensor, rho_mid: float,
                         r_init_cells: float) -> torch.Tensor:
    """Mass-conservation monitor: the number of cells above the
    interface midpoint density over the initial droplet volume
    (PrintMassConservation, Debug.H:233-249)."""
    vol = (rho > rho_mid).sum(dtype=torch.float64)
    return vol / (4.0 / 3.0 * math.pi * r_init_cells ** 3)
