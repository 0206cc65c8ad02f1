"""Flat-interface observables: height field and capillary-wave spectrum
(``bflbm_tpu/observables/interface.py``).

Reference workflow (``Flat_Interface.ipynb`` cells 4-10): the interface
height h(x, y) where rho crosses (rho_lo + rho_hi)/2, then the capillary
equipartition

    <|h_hat(k)|^2> = kBT / (gamma k^2)

gives gamma.  The height is the linear interpolation of the crossing
along z in each (x, y) column, in float64 on the field's device (a numpy
field on the CPU); the height series, their spectra and the fits are
numpy and scipy on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._fields import as_field, host


def interface_height(rho, level: float, upper: bool = True,
                     strict: bool = False) -> np.ndarray:
    """Height h(x, y) of the rho = level crossing along z, in cells from
    z = 0.

    upper=True picks the last crossing where rho decreases through
    `level` with z (the top interface of a stripe); False the first
    increasing one.  Columns with no crossing are NaN (use
    :func:`fill_missing`); strict=True raises instead."""
    s = as_field(rho) - level
    z = s.shape[2]
    sign = torch.sign(s)
    flip = sign[:, :, :-1] * sign[:, :, 1:] < 0
    grad_down = s[:, :, :-1] > s[:, :, 1:]
    pick = flip & (grad_down if upper else ~grad_down)
    if upper:
        ks = torch.arange(z - 1, device=s.device)
        k = torch.where(pick, ks, torch.full_like(ks, -1)).amax(dim=2)
    else:
        first = torch.argmax(pick.to(torch.int32), dim=2)
        k = torch.where(pick.any(dim=2), first, torch.full_like(first, -1))
    missing = k < 0
    if strict and bool(missing.any()):
        raise ValueError("no interface crossing found in some column")
    kc = k.clamp(min=0)
    s0 = torch.gather(s, 2, kc[..., None])[..., 0]
    s1 = torch.gather(s, 2, (kc + 1)[..., None])[..., 0]
    den = s0 - s1
    ok = den != 0
    frac = torch.where(ok, s0 / torch.where(ok, den, torch.ones_like(den)),
                       torch.full_like(den, 0.5))
    h = kc + frac
    return host(torch.where(missing, torch.full_like(h, float("nan")), h))


def fill_missing(h: np.ndarray, axis: int = 1) -> np.ndarray:
    """Fill NaN heights by periodic linear interpolation along `axis`
    (per-column degradation instead of dropping whole frames)."""
    h = np.asarray(h, float)
    if not np.isnan(h).any():
        return h
    out = np.array(h)
    it = np.ndindex(*(s for a, s in enumerate(h.shape) if a != axis))
    for rest in it:
        sl = list(rest)
        sl.insert(axis, slice(None))
        row = out[tuple(sl)]
        bad = np.isnan(row)
        if not bad.any():
            continue
        n = len(row)
        if bad.all():
            raise ValueError("no interface crossing found in an entire row")
        x = np.arange(n)
        # periodic interpolation: the good points one period each way
        good = ~bad
        xg = np.concatenate([x[good] - n, x[good], x[good] + n])
        vg = np.tile(row[good], 3)
        row[bad] = np.interp(x[bad], xg, vg)
        out[tuple(sl)] = row
    return out


def capillary_spectrum(heights: np.ndarray, axis: int = 1):
    """<|h_hat(k)|^2> over a stack of height fields (T, X, Y) along
    `axis` of the (X, Y) plane, averaged over frames and the other
    direction, the mean height removed per frame; returns (k, S_h) for
    k > 0, |h_hat(k)|^2 = (1/N)|sum h e^{-ikx}|^2 (unitary)."""
    h = np.asarray(heights, dtype=float)
    if h.ndim == 2:
        h = h[None]
    h = h - h.mean(axis=(1, 2), keepdims=True)
    ax = 1 + axis
    n = h.shape[ax]
    hk = np.fft.fft(h, axis=ax) / np.sqrt(n)
    s = (np.abs(hk) ** 2).mean(axis=tuple(a for a in (0, 1, 2) if a != ax))
    k = 2.0 * np.pi * np.fft.fftfreq(n)
    keep = k > 0
    return k[keep], s[keep]


def fit_capillary_gamma(k: np.ndarray, s_h: np.ndarray, kBT: float,
                        kmax: float = 1.0) -> float:
    """Fit S_h = kBT/(gamma k^2) over k < kmax (1/S against k^2 through
    the origin); returns gamma."""
    sel = (k > 0) & (k < kmax)
    x = k[sel] ** 2
    y = 1.0 / s_h[sel]
    slope = float(np.sum(x * y) / np.sum(x * x))
    return slope * kBT


def mean_profile(rho) -> np.ndarray:
    """Laterally averaged rho(z) (surface_tension_predict.ipynb cell 9)."""
    return host(as_field(rho).mean(dim=(0, 1)))


def profile_interface_width(z_profile: np.ndarray, rho_lo: float,
                            rho_hi: float) -> Tuple[float, float]:
    """Fit the upper interface of a laterally averaged stripe profile to
    rho(z) = rho_lo + (rho_hi-rho_lo)/2 (1 + tanh((z0 - z)/w));
    returns (z0, w)."""
    from scipy.optimize import curve_fit

    z = np.arange(len(z_profile), dtype=float)
    half = len(z_profile) // 2
    zz = z[half:]
    vv = np.asarray(z_profile[half:], dtype=float)

    def model(zv, z0, w):
        return rho_lo + 0.5 * (rho_hi - rho_lo) * (
            1.0 + np.tanh(np.clip((z0 - zv) / w, -25, 25)))

    mid = 0.5 * (rho_lo + rho_hi)
    z0_guess = zz[np.argmin(np.abs(vv - mid))]
    popt, _ = curve_fit(model, zz, vv, p0=[z0_guess, 1.0], maxfev=10000)
    return float(popt[0]), float(abs(popt[1]))


def capillary_spectrum_ref(heights_slice: np.ndarray):
    """<|h_k|^2> with the reference's conventions (Flat_Interface.ipynb
    cells 7-9): one x-slice height series (T, ny), backward-norm FFT (no
    1/N), the ensemble-mean height profile subtracted.  Returns (k, S)
    over positive k."""
    h = np.asarray(heights_slice, float)
    ny = h.shape[1]
    hmean = h.mean(axis=0)
    acc = np.zeros(ny)
    for row in h:
        hk = np.fft.fft(row - hmean)
        acc += np.abs(hk) ** 2
    s = acc / len(h)
    k = 2.0 * np.pi * np.fft.fftfreq(ny)
    keep = k > 0
    return k[keep], s[keep]


def fit_capillary_gamma_window(k: np.ndarray, s: np.ndarray, kBT: float,
                               kmin: float = 0.04,
                               kmax: float = 0.25) -> float:
    """gamma from least squares of 1/S against k^2 through the origin
    over the capillary window (low-k modes equilibrate slowly; high k
    leaves the continuum regime)."""
    sel = (k >= kmin) & (k <= kmax)
    x = k[sel] ** 2
    y = 1.0 / s[sel]
    return float(np.sum(x * y) / np.sum(x * x)) * kBT
