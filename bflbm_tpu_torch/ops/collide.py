"""MRT collision in moment space with Guo forcing and per-mode noise.

Reference: ``equilibrium_moments`` (LBM_binary.H:356-402), ``phi_moments``
(LBM_binary.H:404-449), ``collide`` (LBM_binary.H:451-516).  Per cell and
species s with density n_s and tau_bar = tau_s + 1/2:

    m <- m + (m_eq(n_s, v_b) - m)/tau_bar + Phi_s + xi_s

with v_b the barycentric velocity of the real species velocities.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import LBMParams
from ..lattice import Q
from .hydro import Hydro
from .moments import density, moments, populations

# Test hook (tests/test_torch_general_tau.py): route tau = 1/2 through the
# general relaxation update instead of the exact-relaxation branch, in the
# plain collide and in the CUDA K kernel (kernels.fused_step.general_relax).
FORCE_GENERAL_RELAX = False


def equilibrium_moments(n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """m_eq(n, u): mass, momentum and the second-order stress modes;
    ghost modes zero.  u has shape (3, ...)."""
    ux, uy, uz = u[0], u[1], u[2]
    u2 = ux * ux + uy * uy + uz * uz
    zeros = torch.zeros_like(n)
    rows = [
        n,
        n * ux, n * uy, n * uz,
        n * u2,
        n * (3.0 * ux * ux - u2),
        n * (uy * uy - uz * uz),
        n * ux * uy, n * uy * uz, n * ux * uz,
    ] + [zeros] * (Q - 10)
    return torch.stack(rows)


def force_moments(n: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                  tau: float) -> torch.Tensor:
    """Guo force moments with the half-step prefactor
    s = 1/(1 + 1/(2 tau)); ghost modes zero."""
    s = 1.0 / (1.0 + 1.0 / (2.0 * tau))
    ax, ay, az = a[0], a[1], a[2]
    ux, uy, uz = u[0], u[1], u[2]
    au = ax * ux + ay * uy + az * uz
    zeros = torch.zeros_like(n)
    rows = [
        zeros,
        s * n * ax, s * n * ay, s * n * az,
        s * 2.0 * n * au,
        s * n * (6.0 * ax * ux - 2.0 * au),
        s * 2.0 * n * (ay * uy - az * uz),
        s * n * (ax * uy + ay * ux),
        s * n * (ay * uz + az * uy),
        s * n * (ax * uz + az * ux),
    ] + [zeros] * (Q - 10)
    return torch.stack(rows)


def collide(f: torch.Tensor, g: torch.Tensor, h: Hydro,
            xi_f: torch.Tensor, xi_g: torch.Tensor,
            params: LBMParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MRT collision for both species (LBM_binary.H:451-516)."""
    rho, phi = h.rho, h.phi
    v_b = (rho[None] * h.uf + phi[None] * h.ug) / (rho + phi)[None]

    mf_eq = equilibrium_moments(rho, v_b)
    mg_eq = equilibrium_moments(phi, v_b)
    phi_f = force_moments(rho, h.uf, h.af, params.tau_f)
    phi_g = force_moments(phi, h.ug, h.ag, params.tau_g)

    if (params.tau_f == 0.5 and params.tau_g == 0.5
            and not FORCE_GENERAL_RELAX):
        # Exact relaxation (lambda_bar = 1): every non-conserved moment is
        # replaced by m_eq + Phi + xi, so the incoming moments are never
        # needed.
        mf = mf_eq + phi_f + xi_f
        mg = mg_eq + phi_g + xi_g
    else:
        mf = moments(f)
        mg = moments(g)
        inv_tf = 1.0 / params.tau_f_bar
        inv_tg = 1.0 / params.tau_g_bar
        mf = mf + inv_tf * (mf_eq - mf) + phi_f + xi_f
        mg = mg + inv_tg * (mg_eq - mg) + phi_g + xi_g

    f1 = populations(mf)
    g1 = populations(mg)
    # Exact-mass restoration: the f32 round trip's rounding is coherent
    # across near-identical cells and would bias total mass by ~1e-8 per
    # step; absorb the per-cell defect into the rest population.
    f1[0] += mf[0] - density(f1)
    g1[0] += mg[0] - density(g1)
    return f1, g1
