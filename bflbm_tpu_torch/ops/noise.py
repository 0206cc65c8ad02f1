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


def hash_normal_stack(word: int, step: int, shape, dtype,
                      dist: str = "u8", device=None) -> torch.Tensor:
    """(33, X, Y, Z) standard deviates of the coordinate-keyed hash
    stream, in kernel channel order.

    Channel a is draw a of the kernel's ``normal(a)`` interleave: with
    dist="u8" byte a % 4 of hash word a // 4, with dist="clt4" the byte
    sum of hash word a.  Bitwise the stream the CUDA kernel consumes.
    """
    from ..kernels.fused_step import clt4_normal, hash_words, u8_quad

    if dist == "u8":
        ws = hash_words(word, step, shape, (N_CHANNELS + 3) // 4, device)
        draws = [d for w in ws for d in u8_quad(w, dtype)]
    elif dist == "clt4":
        ws = hash_words(word, step, shape, N_CHANNELS, device)
        draws = [clt4_normal(w, dtype) for w in ws]
    else:
        raise NotImplementedError(
            f"dist={dist!r} is not ported yet (ROADMAP Queue 2, K3)")
    return torch.stack(draws[:N_CHANNELS])


def thermal_noise_hash(word: int, step: int, rho: torch.Tensor,
                       phi: torch.Tensor, params: LBMParams,
                       dist: str = "u8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mode noise moments (xi_f, xi_g), each (19, X, Y, Z), from the
    hash stream keyed by (word, step); zeros when kBT == 0."""
    shape = tuple(rho.shape)
    dtype = rho.dtype
    if not params.noise_on:
        z = torch.zeros((Q,) + shape, dtype=dtype, device=rho.device)
        return z, z
    n = hash_normal_stack(word, step, shape, dtype, dist, rho.device)
    return _apply_amplitudes(n, rho, phi, params, dtype)
