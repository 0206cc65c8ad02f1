"""Free-energy theory of the binary Shan-Chen mixture
(``bflbm_tpu/observables/free_energy.py``; reference
``surface_tension_predict.ipynb`` cells 0-7).

The continuum free-energy density with coupling G, the second species
eliminated by phi = rho_t - rho,

    f(rho) = cs^2 [rho ln rho + (rho_t - rho) ln(rho_t - rho)]
             + G cs^2 rho (rho_t - rho) + (G cs^4 / 2) (d rho/dz)^2;

the binodal densities solve ln(rho / (rho_t - rho)) + G (rho_t - 2 rho)
= 0, and the planar interface tension is the square-gradient quadrature

    gamma = sqrt(2 G) cs^2 Int_{rho_0}^{rho_1} sqrt(df(rho)) d rho .

One-dimensional work: numpy and scipy on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CS2 = 1.0 / 3.0


def bulk_free_energy(rho: np.ndarray, rho_t: float, g: float) -> np.ndarray:
    rho = np.asarray(rho, dtype=float)
    return CS2 * (rho * np.log(rho) + (rho_t - rho) * np.log(rho_t - rho)) \
        + g * CS2 * rho * (rho_t - rho)


def binodal_densities(rho_t: float, g: float) -> Tuple[float, float]:
    """Coexisting bulk densities (rho_lo, rho_hi); requires g rho_t > 2
    (below the spinodal there is no phase separation)."""
    from scipy.optimize import brentq

    def dfb(r):
        return np.log(r / (rho_t - r)) + g * (rho_t - 2.0 * r)

    # the spinodal points 2 g r (rho_t - r) = rho_t bracket the unstable
    # region
    a, b, c = 2.0 * g, -2.0 * g * rho_t, rho_t
    d = b * b - 4 * a * c
    if d <= 0:
        raise ValueError(f"no phase separation for G={g}, rho_t={rho_t}")
    sp_lo = (-b - np.sqrt(d)) / (2 * a)
    lo = brentq(dfb, 1e-12, sp_lo)
    hi = rho_t - lo  # symmetry rho -> rho_t - rho
    return float(lo), float(hi)


def surface_tension_theory(rho_t: float, g: float, n: int = 4001) -> float:
    """Square-gradient quadrature for the planar interface tension."""
    lo, hi = binodal_densities(rho_t, g)
    rho = np.linspace(lo, hi, n)
    df = bulk_free_energy(rho, rho_t, g) - bulk_free_energy(lo, rho_t, g)
    df = np.clip(df, 0.0, None)
    return float(np.trapezoid(CS2 * np.sqrt(2.0 * g * df), rho))


def interface_profile_theory(rho_t: float, g: float, half_width: float = 30.0,
                             n: int = 2001):
    """Planar interface profile rho(z) from the Euler-Lagrange BVP

        G cs^4 rho'' = cs^2 ln(rho/(rho_t - rho)) + G cs^2 (rho_t - 2 rho)

    (surface_tension_predict.ipynb cell 7).  Returns (z, rho)."""
    from scipy.integrate import solve_bvp

    lo, hi = binodal_densities(rho_t, g)
    a = 1.0 / (g * CS2)
    b = -2.0 / CS2
    s0 = rho_t / CS2

    def ode(z, y):
        r = np.clip(y[0], 1e-9, rho_t - 1e-9)
        return np.vstack((y[1], a * np.log(r / (rho_t - r)) + b * r + s0))

    def bc(ya, yb):
        return np.array([ya[0] - lo, yb[0] - hi])

    z = np.linspace(-half_width, half_width, n)
    guess = np.zeros((2, z.size))
    guess[0] = lo + (hi - lo) * 0.5 * (1 + np.tanh(z))
    guess[1] = (hi - lo) * 0.5 / np.cosh(z) ** 2
    sol = solve_bvp(ode, bc, z, guess, max_nodes=100000)
    if not sol.success:
        raise RuntimeError(f"interface BVP failed: {sol.message}")
    return z, sol.sol(z)[0]


def pressure(rho, phi, g: float):
    """Bulk equation of state P = (rho + phi) cs^2 + G cs^2 rho phi
    (Surface_Tension.ipynb cell 13, raw-density psi)."""
    return (np.asarray(rho) + np.asarray(phi)) * CS2 \
        + g * CS2 * np.asarray(rho) * np.asarray(phi)
