"""Fluctuation-dissipation thermal noise (``LBM_binary.H:73-132``).

Per-relaxation-mode noise: zero on the mass mode; on the momentum modes
the amplitude sqrt(2 (lam - lam^2/2) kBT |rho phi / rho_t|), with the
g draw anti-correlated (xi_g = -xi_f); on the stress and ghost modes
sqrt(2 (lam - lam^2/2) kBT / cs^2 * b_a * |rho|), independent per
species.

The port draws its normals only from the coordinate-keyed hash stream
(:func:`hash_normal_stack`), a pure function of (word, step, cell), so a
trajectory is a pure function of its per-step word sequence.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import LBMParams
from ..lattice import B, CS2, Q

N_CHANNELS = 33   # 3 momentum + 15 f-ghost + 15 g-ghost normals


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in x's dtype.  CPU torch's
    vectorized float32 sqrt is off by one ulp for some inputs; a float64
    sqrt rounded back to float32 is exact (53 >= 2*24 + 2 bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def noise_amplitudes(rho, phi, params: LBMParams, dtype=None):
    """Per-mode noise std-devs; returns (amp_mom, amp_ghost_f,
    amp_ghost_g) with amp_mom (X,Y,Z) and amp_ghost_* (15, X, Y, Z)."""
    dtype = dtype or rho.dtype
    lam_f = params.lam_f
    lam_g = params.lam_g
    pref_f = 2.0 * (lam_f - 0.5 * lam_f * lam_f) * params.kBT
    pref_g = 2.0 * (lam_g - 0.5 * lam_g * lam_g) * params.kBT
    rhot = rho + phi
    reduced = torch.where(torch.abs(rhot) > params.div_eps, rho * phi / rhot,
                          torch.zeros_like(rhot))
    amp_mom = _sqrt(torch.tensor(pref_f, dtype=dtype, device=rho.device)
                    * torch.abs(reduced))
    b_ghost = torch.as_tensor(B[4:], dtype=dtype, device=rho.device).reshape(
        (Q - 4,) + (1,) * rho.dim())
    amp_gf = _sqrt((pref_f / CS2) * b_ghost * torch.abs(rho)[None])
    amp_gg = _sqrt((pref_g / CS2) * b_ghost * torch.abs(phi)[None])
    return amp_mom, amp_gf, amp_gg


def _apply_amplitudes(n: torch.Tensor, rho, phi, params: LBMParams,
                      dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(33, X, Y, Z) standard normals -> per-mode noise moments.

    Channel order (the fused kernel's draw order): 0-2 momentum (shared,
    g anti-correlated), 3-17 f ghost modes a=4..18, 18-32 g ghost modes.
    """
    amp_mom, amp_gf, amp_gg = noise_amplitudes(rho, phi, params, dtype)
    zero = torch.zeros((1,) + tuple(rho.shape), dtype=dtype,
                       device=rho.device)
    xi_mom = amp_mom[None] * n[:3]
    xi_f = torch.cat([zero, xi_mom, amp_gf * n[3:18]])
    xi_g = torch.cat([zero, -xi_mom, amp_gg * n[18:33]])
    return xi_f, xi_g


def _roll3(field: torch.Tensor, shift) -> torch.Tensor:
    """Periodic translation by an integer 3-vector: cell x samples the
    field at x - shift (the COM-frame shift of USE_REF_STATE)."""
    return torch.roll(field, tuple(int(s) for s in shift), (0, 1, 2))


def _amplitude_fields(rho, phi, ref_state):
    """The (rho, phi) pair the amplitudes are evaluated at: the live
    densities, or — USE_REF_STATE (LBM_binary.H:92-106) — a stored
    equilibrium state translated by the integer COM displacement.
    ref_state: (rho_eq, phi_eq, com_shift); com_shift None means the
    fields are already rolled."""
    if ref_state is None:
        return rho, phi
    rho_eq, phi_eq, com_shift = ref_state
    rho_eq = torch.as_tensor(rho_eq, dtype=rho.dtype, device=rho.device)
    phi_eq = torch.as_tensor(phi_eq, dtype=rho.dtype, device=rho.device)
    if com_shift is None:
        return rho_eq, phi_eq
    shift = torch.round(torch.as_tensor(com_shift)).to(torch.int64).tolist()
    return _roll3(rho_eq, shift), _roll3(phi_eq, shift)


def hash_normal_stack(word: int, step: int, shape, dtype,
                      dist: str = "clt4", device=None, origin=(0, 0, 0),
                      domain=None) -> torch.Tensor:
    """(33, X, Y, Z) standard deviates of the coordinate-keyed hash
    stream, in kernel channel order, on the (X, Y, Z) region at global
    `origin` of the global `domain` (default: the region is the domain).

    Channel a is draw a of the kernel's ``normal(a)`` interleave (JAX
    ``n1[a//2]`` for even a, ``n2[a//2]`` for odd a): with dist="u8"
    byte a % 4 of hash word a // 4; "clt4" the byte sum of hash word a;
    "clt2" half a % 2 of hash word a // 2; "bm" the cosine (even a) or
    sine (odd a) Box-Muller normal of the uniforms of words a - a % 2
    and a - a % 2 + 1.  Bitwise the stream the CUDA kernel consumes for
    u8, clt4 and clt2; Box-Muller's log, cos and sin round differently
    on every platform.
    """
    from ..kernels import fused_step as fs

    fs.check_noise_dist(dist)
    nwords = {"u8": (N_CHANNELS + 3) // 4, "clt4": N_CHANNELS,
              "clt2": fs._NPAIR, "bm": 2 * fs._NPAIR}[dist]
    ws = fs.hash_words(word, step, shape, nwords, device, origin, domain)
    if dist == "u8":
        draws = [d for w in ws for d in fs.u8_quad(w, dtype)]
    elif dist == "clt4":
        draws = [fs.clt4_normal(w, dtype) for w in ws]
    elif dist == "clt2":
        draws = [d for w in ws for d in fs.clt2_pair(w, dtype)]
    else:
        us = [fs.hash_uniform(w, dtype) for w in ws]
        draws = [d for p in range(fs._NPAIR)
                 for d in fs.bm_pair(us[2 * p], us[2 * p + 1])]
    return torch.stack(draws[:N_CHANNELS])


def thermal_noise_hash(word: int, step: int, rho: torch.Tensor,
                       phi: torch.Tensor, params: LBMParams,
                       ref_state=None, dist: str = "clt4",
                       origin=(0, 0, 0), domain=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mode noise moments (xi_f, xi_g), each (19, X, Y, Z), from the
    hash stream keyed by (word, step); zeros when kBT == 0.  ref_state:
    optional (rho_eq, phi_eq, com_shift) — the USE_REF_STATE amplitudes
    (:func:`_amplitude_fields`).  origin, domain: where the (X, Y, Z)
    cells lie in the global domain (:func:`hash_normal_stack`)."""
    shape = tuple(rho.shape)
    dtype = rho.dtype
    if not params.noise_on:
        z = torch.zeros((Q,) + shape, dtype=dtype, device=rho.device)
        return z, z
    rho, phi = _amplitude_fields(rho, phi, ref_state)
    n = hash_normal_stack(word, step, shape, dtype, dist, rho.device, origin,
                          domain)
    return _apply_amplitudes(n, rho, phi, params, dtype)
