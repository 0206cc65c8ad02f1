"""Droplet observables: COM, radius fits, gyration, Laplace law, shape
spectra (``bflbm_tpu/observables/droplet.py``).

Reference: the C++ analysis stack ``LBM_hydrovs.H`` (COM :27-60, the
tanh fit :117-213, gyration :258-335) and the droplet helpers of
``xdg_msd_calc.ipynb`` / ``Droplet_Fluctuation.ipynb``.

Fieldwise work (COM, gyration, profiles, the trilinear ray sampling) is
torch in float64 on the field's device; a numpy field is taken as a CPU
tensor.  The fits, the harmonic projections and the series stay numpy
and scipy on the host.  Results are numpy arrays, floats and dicts, as
in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ._fields import as_field, axis_coords, bin_means, host, marginals

CS2 = 1.0 / 3.0


def cell_coords(shape) -> np.ndarray:
    """Cell-center coordinates relative to the box center; (X,Y,Z,3)."""
    idx = np.moveaxis(np.indices(shape), 0, -1).astype(float)
    return idx - np.asarray(shape) / 2.0 + 0.5


def minimum_image(r, box):
    """r wrapped into the periodic box, |r_d| <= box_d / 2 (a tensor or
    a numpy array)."""
    if isinstance(r, torch.Tensor):
        b = torch.as_tensor(np.asarray(box, dtype=float), dtype=r.dtype,
                            device=r.device)
        return r - b * torch.round(r / b)
    box = np.asarray(box, dtype=float)
    return r - box * np.round(r / box)


def _offsets(shape, com, device):
    """Per axis the minimum-image offsets of the cell centres from
    `com`."""
    com = np.asarray(com, dtype=float)
    return [minimum_image(c - float(com[a]), float(shape[a]))
            for a, c in enumerate(axis_coords(shape, device))]


def _radii(offsets) -> torch.Tensor:
    """|r| on the grid from per-axis offsets, summed x, y, z as
    ``np.linalg.norm`` sums them."""
    rx, ry, rz = offsets
    return torch.sqrt((rx * rx)[:, None, None] + (ry * ry)[None, :, None]
                      + (rz * rz)[None, None, :])


def center_of_mass(rho) -> np.ndarray:
    """Density-weighted COM in box-center coordinates."""
    rho = as_field(rho)
    coords = axis_coords(rho.shape, rho.device)
    com = torch.stack([(m * c).sum() for m, c in
                       zip(marginals(rho), coords)]) / rho.sum()
    return host(com)


def gyration_tensor(rho, com) -> np.ndarray:
    """Mass covariance (gyration) tensor with minimum-image convention
    (fittingDropletCovariance, LBM_hydrovs.H:258-335)."""
    rho = as_field(rho)
    r = _offsets(rho.shape, com, rho.device)
    m = marginals(rho)
    s = torch.zeros((3, 3), dtype=torch.float64, device=rho.device)
    for a in range(3):
        s[a, a] = (m[a] * r[a] * r[a]).sum()
        for b in range(a + 1, 3):
            plane = rho.sum(dim=3 - a - b)      # axes (a, b)
            s[a, b] = s[b, a] = (r[a][:, None] * plane * r[b][None, :]).sum()
    return host(s / rho.sum())


def principal_radii(rho, com, radius: float) -> np.ndarray:
    """Principal semi-axes a,b,c scaled so that a*b*c = R^3 (the
    xdg_msd_calc.ipynb `principal_radii` construction)."""
    e = np.linalg.eigvalsh(gyration_tensor(rho, com))[::-1]
    out = []
    for n in range(3):
        i, j, k = np.roll(np.arange(3), -n)
        out.append(radius * ((e[i] * e[i]) / (e[j] * e[k])) ** (1.0 / 6.0))
    return np.asarray(out)


def radius_from_mass(rho) -> float:
    """Equivalent-sphere radius from excess mass
    (droplet_radius_mass, xdg_msd_calc.ipynb)."""
    rho = as_field(rho)
    center = tuple(n // 2 for n in rho.shape)
    rho_in = np.float64(rho[center].item())
    rho_out = np.float64(rho[0, 0, 0].item())
    mass = float((rho - rho_out).sum())
    return float((3.0 / (4.0 * np.pi) * mass / (rho_in - rho_out)) ** (1 / 3))


def radial_profile(rho, com, nbins: int = 0):
    """Spherically averaged rho(r) about the COM; returns (r, rho_r), the
    mean radius and density of each non-empty bin of width
    min(shape) / 2 / nbins."""
    rho = as_field(rho)
    r = _radii(_offsets(rho.shape, com, rho.device)).ravel()
    nbins = nbins or int(min(rho.shape) // 2)
    rs, vs = bin_means(r, np.linspace(0, min(rho.shape) / 2.0, nbins + 1),
                       rho.ravel())
    return rs, vs


def tanh_profile(r, w, radius, rho_lo, rho_hi):
    """rho(r) = rho_lo + (rho_hi-rho_lo)/2 (1 + tanh((R-r)/sqrt(2W)))
    — the fit model of LBM_hydrovs.H:117 (W = half squared width); |W|
    keeps the model finite when the optimizer probes negative widths."""
    arg = np.clip((radius - r) / np.sqrt(2.0 * np.abs(w) + 1e-300),
                  -25.0, 25.0)
    return rho_lo + 0.5 * (rho_hi - rho_lo) * (1.0 + np.tanh(arg))


def fit_droplet(rho, com=None) -> Dict[str, float]:
    """Least-squares tanh fit of the radial profile; returns dict(W, R,
    rho_lo, rho_hi) (fittingDropletParams, LBM_hydrovs.H:117-213)."""
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


def fit_droplet_allcells(rho, com=None) -> Dict[str, float]:
    """The reference's pinned-radius fit (Surface_Tension.ipynb cell 8):
    least squares of rho over ALL cells against the distance from the
    COM, model rho(r) = rho_hi - (rho_hi - rho_lo)/2 (1 + tanh((r - R)/W)),
    in box units ([0,1]^3, cell centres (i+1/2)/n), COM = plain
    density-weighted mean (no minimum image), p0 = [max, min, 0.5, 0.5].
    Returns dict(R, W, rho_hi, rho_lo) with R, W in units of L."""
    from scipy.optimize import curve_fit

    rho = as_field(rho)
    coords = axis_coords(rho.shape, rho.device, "box")
    if com is None:
        mass = rho.sum()
        com = np.array([float((m * c).sum() / mass)
                        for m, c in zip(marginals(rho), coords)])
    dx, dy, dz = ((c - float(com[a])) ** 2 for a, c in enumerate(coords))
    r = torch.sqrt(dx[:, None, None] + dy[None, :, None] + dz[None, None, :])

    def model(rv, hi, lo, radius, w):
        return hi - 0.5 * (hi - lo) * (
            1.0 + np.tanh(np.clip((rv - radius) / w, -25, 25)))

    v = host(rho).ravel()
    popt, _ = curve_fit(model, host(r).ravel(), v,
                        p0=[v.max(), v.min(), 0.5, 0.5], maxfev=20000)
    hi, lo, radius, w = popt
    return {"R": float(radius), "W": float(abs(w)),
            "rho_hi": float(hi), "rho_lo": float(lo)}


def laplace_delta_p(rho, phi, alpha0: float, com=None) -> float:
    """Pressure jump P_in - P_out with P = rho_t cs^2 + G cs^2 rho phi,
    sampled at the droplet center vs a box corner
    (Surface_Tension.ipynb cell 13)."""
    from .free_energy import pressure

    rho, phi = as_field(rho), as_field(phi)
    if com is None:
        com = center_of_mass(rho)
    shape = np.asarray(rho.shape)
    c = tuple(int(x) for x in (com + shape / 2.0 - 0.5))
    c = tuple(int(x) for x in np.clip(c, 0, shape - 1))
    corner = (0, 0, 0)
    p_in = pressure(rho[c].item(), phi[c].item(), alpha0)
    p_out = pressure(rho[corner].item(), phi[corner].item(), alpha0)
    return float(p_in - p_out)


def shape_fluctuation_gamma(axes_series: np.ndarray, kBT: float
                            ) -> Dict[str, float]:
    """Surface tension from principal-axis fluctuations of a droplet
    (Droplet_Fluctuation.ipynb cells 22-25):

        gamma_(2,0)   = 15 kBT / (16 pi <(da_i + da_j)^2>)
        gamma_(2,+-2) = 45 kBT / (16 pi <(da_i - da_j)^2>)

    averaged over the three distinct (i, j) pairs; axes_series (T, 3) =
    principal semi-axes per frame."""
    a = np.asarray(axes_series, dtype=float)
    da = a - a.mean(axis=0, keepdims=True)
    pairs = [(0, 1), (1, 2), (0, 2)]
    plus = np.mean([np.mean((da[:, i] + da[:, j]) ** 2) for i, j in pairs])
    minus = np.mean([np.mean((da[:, i] - da[:, j]) ** 2) for i, j in pairs])
    return {
        "gamma_20": 15.0 * kBT / (16.0 * np.pi * plus),
        "gamma_22": 45.0 * kBT / (16.0 * np.pi * minus),
    }


def _sphere_grid(n_theta: int, n_phi: int):
    """(theta, phi, w) quadrature grid: Gauss-Legendre nodes in
    cos(theta) x uniform phi, which makes the harmonic projections exact
    for l <= 2*n_theta - 1 (an equi-angular midpoint rule leaks ~1e-3 *
    zeta_00 into zeta_20 for a perfect sphere)."""
    x, gw = np.polynomial.legendre.leggauss(n_theta)
    theta = np.arccos(x[::-1])
    w = gw[::-1] * (2.0 * np.pi / n_phi)
    phi = np.arange(n_phi) * 2.0 * np.pi / n_phi
    return theta, phi, w


def surface_radius_map(rho, com, level: float, n_theta: int = 32,
                       n_phi: int = 64, r_max: float = None) -> np.ndarray:
    """R(theta, phi): radius where rho crosses `level` along radial rays
    from the COM (Droplet_Fluctuation.ipynb cells 32-39 extract the
    surface by marching cubes instead; :mod:`.marching_cubes`).
    Trilinear sampling on periodic coordinates, on the field's device;
    rays on the Gauss-Legendre grid of :func:`_sphere_grid`."""
    rho = as_field(rho)
    shape = np.asarray(rho.shape)
    r_max = r_max or float(shape.min()) / 2.0 - 1.0
    theta, phi, _ = _sphere_grid(n_theta, n_phi)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                     np.cos(tt)], axis=-1)  # (nt, np, 3)
    rs = np.linspace(0.5, r_max, 256)
    pts = (com + shape / 2.0 - 0.5)[None, None, None, :] \
        + dirs[:, :, None, :] * rs[None, None, :, None]
    s = _trilinear_periodic(rho, torch.as_tensor(pts, device=rho.device)) \
        - level
    # first crossing from inside (s > 0) to outside (s <= 0)
    sign_flip = (s[..., :-1] > 0) & (s[..., 1:] <= 0)
    first = torch.argmax(sign_flip.to(torch.int32), dim=-1)
    i0 = torch.where(sign_flip.any(dim=-1), first,
                     torch.full_like(first, len(rs) - 2))
    s0 = torch.gather(s, -1, i0[..., None])[..., 0]
    s1 = torch.gather(s, -1, (i0 + 1)[..., None])[..., 0]
    frac = torch.where(s0 != s1, s0 / (s0 - s1), torch.zeros_like(s0))
    rs_t = torch.as_tensor(rs, device=rho.device)
    return host(rs_t[i0] + frac * (rs[1] - rs[0]))


def _trilinear_periodic(field, pts) -> torch.Tensor:
    """Trilinear interpolation with periodic wrap; pts[..., 3] in cell
    coordinates (tensors on one device)."""
    field = as_field(field)
    pts = as_field(pts).to(field.device)
    n = field.shape
    p = torch.remainder(pts, torch.as_tensor(n, dtype=torch.float64,
                                             device=field.device))
    i0 = torch.floor(p).to(torch.int64)
    frac = p - i0
    out = torch.zeros(p.shape[:-1], dtype=torch.float64, device=field.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = tuple(torch.remainder(i0[..., a] + d, n[a])
                            for a, d in enumerate((dx, dy, dz)))
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                out += w * field[idx]
    return out


def spherical_harmonic_amplitudes(r_map: np.ndarray, lmax: int = 4
                                  ) -> Dict[Tuple[int, int], complex]:
    """Spherical-harmonic coefficients zeta_lm of the surface radius map
    R(theta, phi) in the reference's convention
    (Droplet_Fluctuation.ipynb cell 32):

        zeta_lm = sum(R * conj(Y_lm) * w) / sum(|Y_lm|^2 * w),

    solid-angle weights w, orthonormal (scipy) Y_lm, the radius in
    length units (zeta_00 = R0 sqrt(4 pi)); capillary equipartition for
    l = 2 reads 2 gamma <zeta_20^2> = kBT / 2 (cell 39).  The map lives
    on the Gauss-Legendre grid of :func:`_sphere_grid`."""
    from scipy.special import sph_harm_y

    r_map = np.asarray(r_map)
    nt, npp = r_map.shape
    theta, phi, w = _sphere_grid(nt, npp)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    domega = np.broadcast_to(w[:, None], (nt, npp))
    out = {}
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, m, tt, pp)
            num = np.sum(r_map * np.conj(ylm) * domega)
            den = np.sum(np.abs(ylm) ** 2 * domega)
            out[(l, m)] = complex(num / den)
    return out


def zeta_equipartition_gamma(zeta20_series, kBT: float) -> float:
    """Surface tension from the l=2 capillary equipartition relation
    2 gamma <zeta_20^2> = kBT/2 (Droplet_Fluctuation.ipynb cell 39)."""
    z = np.real(np.asarray(zeta20_series))
    return float(kBT / (4.0 * np.mean(z ** 2)))


def surface_tension_laplace(radii, delta_ps) -> Tuple[float, float]:
    """Fit DeltaP = 2 gamma / R over droplets of several radii; returns
    (gamma, intercept)."""
    x = 2.0 / np.asarray(radii, dtype=float)
    y = np.asarray(delta_ps, dtype=float)
    gamma, icpt = np.polyfit(x, y, 1)
    return float(gamma), float(icpt)
