"""Droplet observables of the run driver's online radius series: COM,
equivalent-sphere radius and the tanh-profile fit.

A numpy copy of the part of ``bflbm_tpu/observables/droplet.py`` that
``run._droplet_record`` needs (reference ``LBM_hydrovs.H``: COM :27-60,
the tanh fit :117-213); the fit is scipy's least squares on the
spherically averaged profile, as there.  Gyration, Laplace law and shape
spectra wait for the analysis slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def cell_coords(shape) -> np.ndarray:
    """Cell-center coordinates relative to the box center; (X,Y,Z,3)."""
    idx = np.moveaxis(np.indices(shape), 0, -1).astype(float)
    return idx - np.asarray(shape) / 2.0 + 0.5


def center_of_mass(rho: np.ndarray) -> np.ndarray:
    """Density-weighted COM in box-center coordinates."""
    r = cell_coords(rho.shape)
    return np.einsum("xyz,xyzd->d", rho, r) / rho.sum()


def minimum_image(r: np.ndarray, box) -> np.ndarray:
    box = np.asarray(box, dtype=float)
    return r - box * np.round(r / box)


def radius_from_mass(rho: np.ndarray) -> float:
    """Equivalent-sphere radius from excess mass
    (droplet_radius_mass, xdg_msd_calc.ipynb)."""
    center = tuple(n // 2 for n in rho.shape)
    rho_in = rho[center]
    rho_out = rho[0, 0, 0]
    mass = float(np.sum(rho - rho_out))
    return float((3.0 / (4.0 * np.pi) * mass / (rho_in - rho_out)) ** (1 / 3))


def radial_profile(rho: np.ndarray, com: np.ndarray, nbins: int = 0):
    """Spherically averaged rho(r) about the COM; returns (r, rho_r).
    The bin means are taken with one ``np.bincount`` pass per quantity
    (a per-bin mask costs seconds at 256^3)."""
    r = np.linalg.norm(minimum_image(cell_coords(rho.shape) - com,
                                     rho.shape), axis=-1).ravel()
    v = rho.ravel().astype(float)
    nbins = nbins or int(min(rho.shape) // 2)
    edges = np.linspace(0, min(rho.shape) / 2.0, nbins + 1)
    which = np.digitize(r, edges) - 1
    keep = which < nbins
    which, r, v = which[keep], r[keep], v[keep]
    cnt = np.bincount(which, minlength=nbins)[:nbins]
    sel = cnt > 0
    rs = np.bincount(which, weights=r, minlength=nbins)[:nbins][sel]
    vs = np.bincount(which, weights=v, minlength=nbins)[:nbins][sel]
    return rs / cnt[sel], vs / cnt[sel]


def tanh_profile(r, w, radius, rho_lo, rho_hi):
    """rho(r) = rho_lo + (rho_hi-rho_lo)/2 (1 + tanh((R-r)/sqrt(2W)))
    — the fit model of LBM_hydrovs.H:117 (W = half squared width); |W|
    keeps the model finite when the optimizer probes negative widths."""
    arg = np.clip((radius - r) / np.sqrt(2.0 * np.abs(w) + 1e-300),
                  -25.0, 25.0)
    return rho_lo + 0.5 * (rho_hi - rho_lo) * (1.0 + np.tanh(arg))


def fit_droplet(rho: np.ndarray, com=None) -> Dict[str, float]:
    """Least-squares tanh fit; returns dict(W, R, rho_lo, rho_hi)
    (fittingDropletParams, LBM_hydrovs.H:117-213)."""
    from scipy.optimize import curve_fit

    if com is None:
        com = center_of_mass(rho)
    r, v = radial_profile(rho, com)
    lo0, hi0 = float(v.min()), float(v.max())
    r0 = r[np.argmin(np.abs(v - 0.5 * (lo0 + hi0)))]
    p0 = [0.5, max(r0, 1.0), lo0, hi0]
    popt, _ = curve_fit(tanh_profile, r, v, p0=p0, maxfev=20000)
    w, radius, rho_lo, rho_hi = popt
    return {"W": float(abs(w)), "R": float(radius),
            "rho_lo": float(rho_lo), "rho_hi": float(rho_hi)}
