"""Droplet Brownian motion: MSD and Stokes-Einstein diffusion
(``bflbm_tpu/observables/msd.py``).

Reference: ``xdg_msd_calc.ipynb`` (calculate_msd, stokes_einstein) and
``Droplet_Fluctuation.ipynb`` cells 9-19.  The measured COM MSD slope / 6
is compared against the finite-size-corrected Stokes-Einstein value

    D = kBT P / (f_n pi eta R),   P = 1 - 2.84 R/L,
    f_n = (6 + 4 a)/(1 + a)  (a = viscosity ratio; a = 1 -> f_n = 5)

with eta = rho cs^2 (tau_bar - 1/2).  The series are numpy on the host;
the COMs they take come from :func:`.droplet.center_of_mass`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unwrap_periodic(traj: np.ndarray, box) -> np.ndarray:
    """Unwrap a periodic COM trajectory (T, 3) into continuous coords."""
    traj = np.asarray(traj, dtype=float)
    box = np.asarray(box, dtype=float)
    d = np.diff(traj, axis=0)
    d -= box * np.round(d / box)
    return np.concatenate([traj[:1], traj[:1] + np.cumsum(d, axis=0)])


def msd(ts: np.ndarray, xs: np.ndarray, tmax: int,
        scalar: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Time-origin-averaged MSD over lags 0..tmax-1 (calculate_msd)."""
    ts = np.asarray(ts)
    xs = np.asarray(xs, dtype=float)
    dt = ts[1] - ts[0]
    lags = np.arange(tmax)
    out = np.array([
        np.mean((xs[t:] - xs[:len(xs) - t]) ** 2, axis=0) if t > 0
        else np.zeros(xs.shape[1:])
        for t in lags
    ])
    if scalar and out.ndim > 1:
        out = out.sum(axis=-1)
    return lags * dt, out


def diffusion_coefficient(lag_t: np.ndarray, msd_vals: np.ndarray,
                          dim: int = 3, fit_lo: float = 0.0,
                          fit_hi: float = np.inf) -> float:
    """D from the linear regime: MSD = 2 d D t."""
    sel = (lag_t > fit_lo) & (lag_t < fit_hi) & (lag_t > 0)
    slope = np.polyfit(lag_t[sel], msd_vals[sel], 1)[0]
    return float(slope / (2 * dim))


def stokes_einstein(radius: float, box_l: float, eta: float, kBT: float,
                    visc_ratio: float = 1.0) -> float:
    """Finite-size-corrected Stokes-Einstein D (xdg_msd_calc.ipynb)."""
    p = 1.0 - 2.84 * radius / box_l
    fn = (6.0 + 4.0 * visc_ratio) / (1.0 + visc_ratio)
    return kBT * p / (fn * np.pi * eta * radius)
