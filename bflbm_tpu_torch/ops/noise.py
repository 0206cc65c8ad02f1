"""Fluctuation-dissipation thermal noise (``LBM_binary.H:73-132``).

Per-relaxation-mode noise: zero on the mass mode; on the momentum modes
the amplitude sqrt(2 (lam - lam^2/2) kBT |rho phi / rho_t|), with the
g draw anti-correlated (xi_g = -xi_f); on the stress and ghost modes
sqrt(2 (lam - lam^2/2) kBT / cs^2 * b_a * |rho|), independent per
species.

Two sources of normals, each a pure function of the step's word and the
step, so a trajectory is a pure function of its per-step word sequence: the
coordinate-keyed hash stream (:func:`hash_normal_stack`, keyed by (word,
step, cell); what the CUDA kernels draw) and the bulk source
(:func:`bulk_normal_stack`, one (33, X, Y, Z) draw of a generator on the
fields' device seeded with (step, word)), the counterpart of the JAX
package's threefry draw (``thermal_noise``).  The bulk source's bits
differ from threefry's and between the CPU and the card; its
distribution is the same: exact independent normals.
"""

from __future__ import annotations

import math
import threading
from typing import Tuple

import torch

from ..config import LBMParams
from ..lattice import B, CS2, Q
from .moments import constant

N_CHANNELS = 33   # 3 momentum + 15 f-ghost + 15 g-ghost normals
NOISE_SOURCES = ("threefry", "hash")
_WORD_MASK = 0xFFFFFFFF
# hash words drawn a vectorized group, at most: on the card, few launches
# (a captured chunk of the plain engine); on the CPU, ops under torch's
# grain size (32768), which run on one thread and in cache
_GROUP_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 14}
_SEED_MASK = 0xFFFFFFFFFFFFFFFF
_generators = threading.local()   # a bulk-source generator per thread
#                                   and device


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
    amp_mom = _sqrt(constant(pref_f, dtype, rho.device) * torch.abs(reduced))
    b_ghost = constant(B[4:], dtype, rho.device).reshape(
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
    on every platform.  word and step: ints, or 0-dim int64 tensors on
    `device` (:func:`~bflbm_tpu_torch.kernels.fused_step.hash_word_groups`).
    The words are drawn in vectorized groups of at most
    ``_GROUP_ELEMS[device type]`` words (at least one draw, a pair for
    bm).
    """
    from ..kernels import fused_step as fs

    fs.check_noise_dist(dist)
    nwords = {"u8": (N_CHANNELS + 3) // 4, "clt4": N_CHANNELS,
              "clt2": fs._NPAIR, "bm": 2 * fs._NPAIR}[dist]
    cells = math.prod(int(n) for n in shape)
    kind = torch.device(device).type if device is not None else "cpu"
    per = 2 if dist == "bm" else 1                    # bm's pairs
    limit = _GROUP_ELEMS.get(kind, _GROUP_ELEMS["cpu"])
    group = max(per, limit // cells // per * per)
    draws = []
    for w in fs.hash_word_groups(word, step, shape, nwords, group, device,
                                 origin, domain):
        if dist == "u8":
            d = torch.stack(fs.u8_quad(w, dtype), 1).flatten(0, 1)
        elif dist == "clt4":
            d = fs.clt4_normal(w, dtype)
        elif dist == "clt2":
            d = torch.stack(fs.clt2_pair(w, dtype), 1).flatten(0, 1)
        else:
            u = fs.hash_uniform(w, dtype)
            d = torch.stack(fs.bm_pair(u[0::2], u[1::2]), 1).flatten(0, 1)
        draws.append(d)
    return torch.cat(draws)[:N_CHANNELS]


def bulk_seed(word: int, step: int) -> int:
    """The bulk source's 64-bit seed of a step: splitmix64's finalizer
    (a bijection) of the step's 32 low bits above the word's (as
    uint32).  The card's Philox takes all 64 bits, so no two (word, step)
    keys share a draw there; the CPU's mt19937 keeps the low 32, a hash
    of both."""
    z = ((int(step) & _WORD_MASK) << 32) | (int(word) & _WORD_MASK)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _SEED_MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _SEED_MASK
    return z ^ (z >> 31)


def bulk_normal_stack(word: int, step: int, shape, dtype=torch.float32,
                      device=None, out=None) -> torch.Tensor:
    """(33, X, Y, Z) independent standard normals of the bulk source: a
    generator on `device` seeded with :func:`bulk_seed` (word, step), one
    ``torch.randn`` draw.  A function of (word, step), as the hash stream
    is, so two steps that draw the same word draw different normals;
    bitwise on one device, the CPU and the card draw different bits.
    out: an optional (33, X, Y, Z) tensor to draw into."""
    device = torch.device(device if device is not None
                          else out.device if out is not None else "cpu")
    gens = getattr(_generators, "by_device", None)
    if gens is None:
        gens = _generators.by_device = {}
    gen = gens.get(device)
    if gen is None:
        gen = gens[device] = torch.Generator(device=device)
    gen.manual_seed(bulk_seed(word, step))
    if out is not None:
        return torch.randn(out.shape, generator=gen, out=out)
    return torch.randn((N_CHANNELS,) + tuple(shape), generator=gen,
                       dtype=dtype, device=device)


def thermal_noise(word: int, step: int, rho: torch.Tensor,
                  phi: torch.Tensor, params: LBMParams, ref_state=None,
                  normals=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mode noise moments (xi_f, xi_g), each (19, X, Y, Z), from the
    bulk source (JAX ``thermal_noise``, ``ops/noise.py:97-114``); zeros
    when kBT == 0.  normals: (33, X, Y, Z) standard normals to use in
    place of the word's draw (JAX's own, in a test; a chunk's
    pre-drawn ones, in :mod:`~bflbm_tpu_torch.models.plain_session`).
    ref_state: as :func:`thermal_noise_hash`."""
    shape = tuple(rho.shape)
    dtype = rho.dtype
    if not params.noise_on:
        z = torch.zeros((Q,) + shape, dtype=dtype, device=rho.device)
        return z, z
    rho, phi = _amplitude_fields(rho, phi, ref_state)
    if normals is None:
        normals = bulk_normal_stack(word, step, shape, dtype, rho.device)
    return _apply_amplitudes(normals, rho, phi, params, dtype)


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
