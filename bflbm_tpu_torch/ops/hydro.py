"""Hydrodynamic variable reconstruction (modified -> real variables).

Reference: ``hydrovars`` / ``hydrovars_bar_density``
(``LBM_binary.H:196-354``).  Real velocities carry the half-step force,
the cross-species friction and the noise corrections:

    uf = uf_bar + a_f/2
         - (lam_f/2) phi/(rho+phi) [ (uf_bar - ug_bar) + (a_f - a_g)/2 ]
         + xi_f / (2 rho)

with lam = 1/(tau + 1/2) and a_f = -cs^2 alpha0 psi(rho) grad(psi(phi))
/ rho - cs^2 alpha1 grad lap psi(phi), and the symmetric formulas for g.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import LBMParams
from ..lattice import C, CS2
from . import stencil
from .moments import contract, density

# Output schema of the reference plotfiles (AMReX_FileIO.H:209-295 /
# main_run_job.cpp:147): 22 components, in the order :func:`pack` stacks
# them; frames and structure factors are keyed by these names.
HYDRO_NAMES: Tuple[str, ...] = (
    "rho", "phi",
    "ufx", "ufy", "ufz",
    "p_bulk",
    "ugx", "ugy", "ugz",
    "afx", "afy", "afz",
    "agx", "agy", "agz",
    "ubx", "uby", "ubz",
    "nfbarx", "ngbarx", "ufbarx", "ugbarx",
)


class HydroBar(NamedTuple):
    """Modified (bare LB) fields."""

    rho: torch.Tensor     # sum_i f_i
    phi: torch.Tensor     # sum_i g_i
    uf_bar: torch.Tensor  # (3,X,Y,Z) = jf / rho
    ug_bar: torch.Tensor  # (3,X,Y,Z) = jg / phi


class Hydro(NamedTuple):
    """Real hydrodynamic fields."""

    rho: torch.Tensor
    phi: torch.Tensor
    uf: torch.Tensor
    ug: torch.Tensor
    af: torch.Tensor
    ag: torch.Tensor
    ub: torch.Tensor
    rho_tot: torch.Tensor
    uf_bar: torch.Tensor
    ug_bar: torch.Tensor
    nf_vel: torch.Tensor
    ng_vel: torch.Tensor


def _safe_div(num, den, eps):
    ok = torch.abs(den) > eps
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def momentum(f: torch.Tensor) -> torch.Tensor:
    """j_d = sum_i f_i c_{i,d}; returns (3, X, Y, Z)."""
    return contract(C.T, f)


def hydrovars_bar(f: torch.Tensor, g: torch.Tensor,
                  params: LBMParams) -> HydroBar:
    """Densities + bare velocities from populations (LBM_binary.H:315-340)."""
    rho = density(f)
    phi = density(g)
    uf_bar = _safe_div(momentum(f), rho[None], params.div_eps)
    ug_bar = _safe_div(momentum(g), phi[None], params.div_eps)
    return HydroBar(rho, phi, uf_bar, ug_bar)


def accelerations(rho: torch.Tensor, phi: torch.Tensor,
                  params: LBMParams, at=None, centre=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shan-Chen cross-species accelerations (LBM_binary.H:232-257),
    evaluated (like the JAX package) even when alpha0 = 0, and the alpha1
    square-gradient term, evaluated only when alpha1 != 0:

        a_f -= cs^2 alpha1 grad lap psi(phi)   (a_g likewise with rho),

    not divided by the density.  at, centre: on a halo-extended block
    (:mod:`bflbm_tpu_torch.ops.blocked`), where rho and phi reach beyond
    the cells wanted, the stencils' neighbour function and the cut of a
    field to the wanted cells; periodic and the identity by default."""
    use_sc, n0 = params.use_sc_pseudo, params.sc_ref_density
    eps = params.div_eps
    centre = centre or (lambda t: t)
    grad_phi = centre(stencil.gradient(phi, use_sc, n0, at=at))
    grad_rho = centre(stencil.gradient(rho, use_sc, n0, at=at))
    rho_c, phi_c = centre(rho), centre(phi)
    psi_rho = stencil.pseudopotential(rho_c, use_sc, n0)
    psi_phi = stencil.pseudopotential(phi_c, use_sc, n0)
    af = -CS2 * params.alpha0 * _safe_div(psi_rho[None] * grad_phi,
                                          rho_c[None], eps)
    ag = -CS2 * params.alpha0 * _safe_div(psi_phi[None] * grad_rho,
                                          phi_c[None], eps)
    if params.alpha1 != 0.0:
        af = af - CS2 * params.alpha1 * centre(
            stencil.grad_laplacian(phi, use_sc, n0, at=at))
        ag = ag - CS2 * params.alpha1 * centre(
            stencil.grad_laplacian(rho, use_sc, n0, at=at))
    return af, ag


def hydrovars(f: torch.Tensor, g: torch.Tensor,
              xi_f: torch.Tensor, xi_g: torch.Tensor,
              params: LBMParams,
              hbar: Optional[HydroBar] = None) -> Hydro:
    """Full real-variable reconstruction (LBM_binary.H:196-295)."""
    if hbar is None:
        hbar = hydrovars_bar(f, g, params)
    af, ag = accelerations(hbar.rho, hbar.phi, params)
    return hydrovars_with_acc(f, g, hbar, af, ag, xi_f, xi_g, params)


def hydrovars_with_acc(f: torch.Tensor, g: torch.Tensor, hbar: HydroBar,
                       af: torch.Tensor, ag: torch.Tensor,
                       xi_f: torch.Tensor, xi_g: torch.Tensor,
                       params: LBMParams) -> Hydro:
    """Velocity-correction part of hydrovars, given the accelerations."""
    rho, phi, uf_bar, ug_bar = hbar
    eps = params.div_eps

    nf_vel = _safe_div(xi_f[1:4], rho[None], eps)
    ng_vel = _safe_div(xi_g[1:4], phi[None], eps)

    rho_tot = rho + phi
    wf = phi / rho_tot
    wg = rho / rho_tot
    du = uf_bar - ug_bar + 0.5 * (af - ag)
    uf = uf_bar + 0.5 * af - 0.5 * params.lam_f * wf[None] * du + 0.5 * nf_vel
    ug = ug_bar + 0.5 * ag + 0.5 * params.lam_g * wg[None] * du + 0.5 * ng_vel

    ub = (rho[None] * uf_bar + phi[None] * ug_bar
          + 0.5 * (rho[None] * af + phi[None] * ag)) / rho_tot[None]

    return Hydro(rho=rho, phi=phi, uf=uf, ug=ug, af=af, ag=ag, ub=ub,
                 rho_tot=rho_tot, uf_bar=uf_bar, ug_bar=ug_bar,
                 nf_vel=nf_vel, ng_vel=ng_vel)


def pack(h: Hydro) -> torch.Tensor:
    """Stack to the reference's 22-component output schema
    (:data:`HYDRO_NAMES`)."""
    return torch.cat([
        h.rho[None], h.phi[None],
        h.uf,
        h.rho_tot[None],  # "p_bulk" slot holds total density
        h.ug, h.af, h.ag, h.ub,
        h.nf_vel[:1], h.ng_vel[:1], h.uf_bar[:1], h.ug_bar[:1],
    ])
