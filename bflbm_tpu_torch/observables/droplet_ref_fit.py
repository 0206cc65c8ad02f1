"""Exact replica of the reference's series-Jacobian droplet fitter
(``bflbm_tpu/observables/droplet_ref_fit.py``).

The reference fits the droplet tanh profile

    rho(r) ~ C0/2 (1 + tanh((R - |r - r0|) / sqrt(2 W)))

by a semi-implicit gradient descent whose Jacobian terms are analytic
series integrals (``fittingDroplet`` / ``fittingDropletParams``,
LBM_hydrovs.H:117-213; series library ``externlib.H:22-406``;
production call ``main_run_job.cpp:365`` with step_window=20,
undul_ratio=0.01, Nstep=400, W0=kappa, R0=init radius).  The direct
least-squares fitter (:mod:`.droplet`) is the default; this one settles
fit-convention parity with the reference's pinned R/L values.

The reference's conventions: the box is [0,1]^3 (R and W in units of
L), cell-centred coordinates (i+1/2)/n, plain-sum integrals with dV =
1/(nx ny nz).  The field integrals (:class:`_FieldIntegrals`) are torch
in float64 on the field's device (a numpy field on the CPU); the series
are numpy on the host, numpy longdouble mirroring the reference's
``long double`` accumulators in ``integral_func2_series``.
"""

from __future__ import annotations

from math import comb as _comb, cosh, exp, factorial, log, pi, sqrt
from typing import Dict, Tuple

import numpy as np
import torch

from ._fields import as_field, axis_coords, marginals

MIN_LEN_SCALE = 1e-6  # LBM_hydrovs.H:16
NUM_OF_TERMS = 20     # externlib.H:22


def _coef_s(n_terms: int = NUM_OF_TERMS) -> np.ndarray:
    """S_k coefficients of the sech^4 power series (externlib.H:56-90):
    A_{2k} recursion then the 4-fold Cauchy product of A'_k = A_k/(2k)!."""
    a = np.zeros(n_terms)
    a[0] = 1.0
    for k in range(1, n_terms):
        a[k] = -sum(a[kp] * _comb(2 * k, 2 * kp) for kp in range(k))
    ap = np.array([a[k] / factorial(2 * k) for k in range(n_terms)])
    s = np.zeros(n_terms)
    for k in range(n_terms):
        acc = 0.0
        for k1 in range(k + 1):
            for k2 in range(k - k1 + 1):
                for k3 in range(k - k1 - k2 + 1):
                    k4 = k - k1 - k2 - k3
                    acc += ap[k1] * ap[k2] * ap[k3] * ap[k4]
        s[k] = acc
    return s


_S_ARRAY = _coef_s()


def _integral_func2_series(n: int, d: float, c: float,
                           delta: float = None) -> float:
    """externlib.H:108-160 (long double accumulation); n in {2, 3, 4}."""
    delta = 1.0 / d if delta is None else delta
    L = np.longdouble
    int_val = L(0.0)
    factor = L(16.0) / L(6.0)
    ratio = L(c) / L(d)
    for k in range(len(_S_ARRAY)):
        ex = L((2 * k + 4) * d)
        i1 = L(1.0) / ex
        i2, i3, i4, i5 = i1 ** 2, i1 ** 3, i1 ** 4, i1 ** 5
        dm = ratio - L(delta)
        dp = ratio + L(delta)
        e_d = np.exp(-ex * L(delta))
        e_c = np.exp(L(-(2 * k + 4) * c))
        if n == 4:
            t1 = (i1 * dm ** 4 - 4 * i2 * dm ** 3 + 12 * i3 * dm ** 2
                  - 24 * i4 * dm + 24 * i5) * e_d - 24 * i5 * e_c
            t2 = (i1 * dp ** 4 + 4 * i2 * dp ** 3 + 12 * i3 * dp ** 2
                  + 24 * i4 * dp + 24 * i5) * e_d
        elif n == 3:
            t1 = (i1 * dm ** 3 - 3 * i2 * dm ** 2 + 6 * i3 * dm
                  - 6 * i4) * e_d + 6 * i4 * e_c
            t2 = (i1 * dp ** 3 + 3 * i2 * dp ** 2 + 6 * i3 * dp
                  + 6 * i4) * e_d
        elif n == 2:
            t1 = (i1 * dm ** 2 - 2 * i2 * dm + 2 * i3) * e_d - 2 * i3 * e_c
            t2 = (i1 * dp ** 2 + 2 * i2 * dp + 2 * i3) * e_d
        else:
            raise ValueError(n)
        sign = 1.0 if k % 2 == 0 else -1.0
        int_val += sign * factor * (k + 1) * (k + 2) * (k + 3) * (t1 + t2)
        val_n = L(0.0)
        for ell in range(n + 1):
            tmp = L(delta) ** (2 * k + ell + 1) - L(-delta) ** (2 * k + ell + 1)
            val_n += L(_comb(n, ell)) * ratio ** (n - ell) * tmp \
                / L(2 * k + ell + 1)
        int_val += L(_S_ARRAY[k]) * L(d) ** (2 * k) * val_n
    return float(int_val)


def _integral_func3_series(n: int, c: float, big_n: int = 50) -> float:
    """externlib.H:163-177."""
    v = 0.0
    for k in range(1, big_n + 1):
        k2, k3 = k * k, k ** 3
        if n == 3:
            v += 6 * (-1.0) ** (k + 1) * (c / k2 + 0.25 / k3 * exp(-2 * k * c))
        elif n == 2:
            v += (-1.0) ** k * exp(-2 * k * c) / k2 + (-1.0) ** (k + 1) * 2.0 / k2
    return v + 2.0 * c ** n


def _integral_func1_series(n: int, a: float, big_n: int = 100) -> float:
    """externlib.H:180-196."""
    if n == 3:
        s1 = sum((-1.0) ** (k + 1) / k ** 2 * exp(-2 * k * a)
                 for k in range(1, big_n + 1))
        s2 = sum((-1.0) ** (k + 1) / k ** 2 for k in range(1, big_n + 1))
        return 1.5 * s1 - 3.0 * s2 - 3.0 * a * a
    return -a - log(2.0) - log(cosh(a))


# -------- analytic Jacobian coefficients (externlib.H:199-247) --------

def _j_rn_rn(w, r, eta_r, dt, c0):
    c = r / sqrt(2 * w)
    return -c0 * eta_r * dt * sqrt(2 * w) * pi \
        * _integral_func2_series(2, 1.0, c)


def _j_rn_wn(w, r, eta_r, dt, c0):
    c = r / sqrt(2 * w)
    w2 = w * w
    factor = c0 * 0.25 * eta_r * dt * pi / w2
    return factor * (r * 2 * w * sqrt(2 * w) * _integral_func2_series(2, 1.0, c)
                     - 4 * w2 * _integral_func2_series(3, 1.0, c))


def _j_wn_rn(w, r, eta_w, dt, c0):
    c = r / sqrt(2 * w)
    factor = c0 * 0.25 * eta_w * dt
    return factor * (2 * sqrt(2.0) * pi * r / sqrt(w)
                     * _integral_func2_series(2, 1.0, c)
                     - 4 * pi * _integral_func2_series(3, 1.0, c))


def _j_wn_wn(w, r, eta_w, dt, c0):
    c = r / sqrt(2 * w)
    factor = -c0 * 0.125 * eta_w * dt * pi / w ** 3
    s2w = sqrt(2.0 * w)
    t1 = s2w ** 3 * r * r * _integral_func2_series(2, 1.0, c)
    t2 = s2w ** 5 * _integral_func2_series(4, 1.0, c)
    t3 = 2 * r * s2w ** 4 * _integral_func2_series(3, 1.0, c)
    return factor * (t1 + t2 - t3)


def _k_wn(w, r):
    """externlib.H:348-359."""
    c = r / sqrt(2 * w)
    factor = sqrt(2.0) * pi / sqrt(w) ** 3
    t1 = r * sqrt(2 * w) ** 3 * _integral_func3_series(2, c)
    t2 = 4.0 * w * w * _integral_func3_series(3, c)
    t3 = r * sqrt(2 * w) ** 3 * _integral_func1_series(2, c)
    t4 = 4.0 * w * w * _integral_func1_series(3, c)
    return factor * (t1 - t2 + t3 - t4)


def _k_rn(w, r):
    """externlib.H:362-371."""
    c = r / sqrt(2 * w)
    return 4.0 * pi * 2.0 * w * (_integral_func3_series(2, c)
                                 + _integral_func1_series(2, c))


def _sech2(x: torch.Tensor) -> torch.Tensor:
    """1/cosh^2 with the reference's overflow guard (externlib.H:25-31)."""
    ok = torch.abs(x) < 710.4
    safe = torch.where(ok, x, torch.zeros_like(x))
    return torch.where(ok, 1.0 / torch.cosh(safe) ** 2, torch.zeros_like(x))


class _FieldIntegrals:
    """Data-side integrals M_fW, M_fR (externlib.H:250-345) of a field in
    box units, on its device; the COM and the radius grid are fixed per
    field."""

    def __init__(self, rho):
        self.rho = as_field(rho)
        self.dv = 1.0 / float(np.prod(self.rho.shape))
        coords = axis_coords(self.rho.shape, self.rho.device, "box")
        mass = self.rho.sum()
        self.r0 = np.array([float((m * c).sum() / mass)
                            for m, c in zip(marginals(self.rho), coords)])
        dx, dy, dz = ((c - float(self.r0[a])) ** 2
                      for a, c in enumerate(coords))
        self.r_prime = torch.sqrt(dx[:, None, None] + dy[None, :, None]
                                  + dz[None, None, :])

    def mf_wn(self, w, r):
        s2w = sqrt(2.0 * w)
        dist = r - self.r_prime
        val = float((self.rho * dist * _sech2(dist / s2w)).sum()) * self.dv
        return val / s2w ** 3

    def mf_rn(self, w, r):
        s2w = sqrt(2.0 * w)
        dist = r - self.r_prime
        val = float((self.rho * _sech2(dist / s2w)).sum()) * self.dv
        return val / s2w


def _params_variations(fi: _FieldIntegrals, w, r, eta_w, eta_r, dt, c0):
    """Semi-implicit update (paramsVariations, externlib.H:374-406)."""
    jrr = _j_rn_rn(w, r, eta_r, dt, c0)
    jwr = _j_wn_rn(w, r, eta_w, dt, c0)
    jrw = _j_rn_wn(w, r, eta_r, dt, c0)
    jww = _j_wn_wn(w, r, eta_w, dt, c0)
    mat_a = np.array([[1.0 - jrr, jwr], [jrw, 1.0 - jww]])
    mat_b = np.diag([-eta_w * dt, eta_r * dt])
    vec_c = np.array([fi.mf_wn(w, r) - 0.5 * _k_wn(w, r),
                      fi.mf_rn(w, r) - 0.5 * _k_rn(w, r)])
    det_d = (1.0 - jww) * (1.0 - jrr) - jwr * jrw
    return (mat_a @ mat_b @ vec_c) / det_d


def _fitting_droplet(fi: _FieldIntegrals, w0, r0, eta_w, eta_r, dt,
                     nstep) -> np.ndarray:
    """The descent loop (fittingDroplet, LBM_hydrovs.H:117-146);
    returns the (nstep, 2) (W, R) iterate trace."""
    trace = np.empty((nstep, 2))
    w, r = w0, r0
    trace[0] = (w, r)
    c0 = float(fi.rho.max() - fi.rho.min())
    for k in range(1, nstep):
        dw, dr = _params_variations(fi, w, r, eta_w, eta_r, dt, c0)
        w += dw
        r += dr
        if w <= 0:  # revert W only and shrink the step (LBM_hydrovs.H:133)
            w -= dw
            dt = dt / 5.0
        if abs(w) < MIN_LEN_SCALE:
            w = w0
        trace[k] = (w, r)
    return trace


def fit_droplet_ref(rho: np.ndarray, w0: float = 0.1, r0: float = 0.3,
                    step_window: int = 20, undul_ratio: float = 0.01,
                    nstep: int = 400, eta_w: float = 0.2,
                    eta_r: float = 0.2, dt: float = 0.02) -> Dict[str, float]:
    """fittingDropletParams (LBM_hydrovs.H:159-213) with the production
    arguments of main_run_job.cpp:365 (W0=kappa, R0=init radius).

    Returns dict(W, R, err) with R and sqrt(W) in units of the box
    length L (the reference's R/L convention).
    """
    fi = _FieldIntegrals(rho)
    trace = _fitting_droplet(fi, w0, r0, eta_w, eta_r, dt, nstep)

    def window_stats(tr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        win = tr[nstep - step_window:nstep]
        return win.mean(axis=0), win.max(axis=0), win.min(axis=0)

    mean, mx, mn = window_stats(trace)
    und_w = (mx[0] - mn[0]) / mean[0]
    und_r = (mx[1] - mn[1]) / mean[1]
    dt_new = dt / 5.0
    it = 1
    while it <= 10 and not (und_w <= undul_ratio and und_r <= undul_ratio):
        trace = _fitting_droplet(fi, mean[0], mean[1], eta_w, eta_r,
                                 dt_new, nstep)
        mean, mx, mn = window_stats(trace)
        und_w = (mx[0] - mn[0]) / mean[0]
        und_r = (mx[1] - mn[1]) / mean[1]
        it += 1
        dt_new = dt_new / 5.0
    if not (und_w <= undul_ratio and und_r <= undul_ratio):
        raise RuntimeError(
            f"statistical undulation ({und_w:.2e}, {und_r:.2e}) out of "
            "bounds (fittingDropletParams)")
    return {"W": float(mean[0]), "R": float(mean[1]),
            "err": float(max(und_w, und_r))}
