"""Binary fluctuating-LBM model: the plain-torch timestep and the
initializers.

One step (reference ``LBM_timestep``, LBM_binary.H:545-594, restructured
as in the JAX package) is

    prelude:  hbar(f, g) -> draw noise -> real hydrovars
    collide:  MRT relaxation + forcing + noise in moment space
    stream:   pull shifts

Noise comes from one of two sources (``noise_source``), each keyed by
one int32 word per physical step, so a trajectory is a pure function of
its word sequence: ``"hash"`` (the default here), the coordinate-keyed
hash stream with clt4 (the default generator, as in the JAX package),
u8, clt2 or Box-Muller deviates (the generators the CUDA kernel runs),
keyed by the word and ``state.step`` (the JAX package's
``noise_source="hash"``); or ``"threefry"``, the bulk source: exact
normals drawn by a generator seeded with the word and ``state.step``
(:func:`~bflbm_tpu_torch.ops.noise.bulk_normal_stack`), the counterpart
of the JAX package's threefry draw (its default at this level; its bits
are not threefry's).  A word is drawn from ``state.gen`` for every step,
noise on or off, unless the caller passes it.

The initializers build their state on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, LBMParams, RunConfig
from ..lattice import Q, W
from ..ops import collide as collide_ops
from ..ops import hydro as hydro_ops
from ..ops import moments as moments_ops
from ..ops import noise as noise_ops
from ..ops import stream as stream_ops
from ..state import SimState, draw_words, init_state


def _noise_ref(hbar: hydro_ops.HydroBar, ref_state):
    """The (rho_eq, phi_eq, com_shift) the amplitudes read: the COM of
    the current density against com_ref, or a zero shift when com_ref is
    None (fields already rolled, as the kernel sessions pass them)."""
    if ref_state is None:
        return None
    rho_eq, phi_eq, com_ref = ref_state
    if com_ref is None:
        return (rho_eq, phi_eq, None)
    from ..observables import stats

    com = stats.center_of_mass(hbar.rho)
    return (rho_eq, phi_eq,
            com - torch.as_tensor(com_ref, dtype=com.dtype, device=com.device))


def prelude(state: SimState, params: LBMParams, word: Optional[int] = None,
            *, ref_state=None, noise_dist: str = "clt4",
            noise_source: str = "hash", normals=None):
    """Noise draw + real-hydrovar reconstruction of the current state.
    Returns (hydro, xi_f, xi_g).

    ref_state: optional (rho_eq, phi_eq, com_ref) — the reference's
    USE_REF_STATE noise path (LBM_binary.H:92-106): amplitudes evaluated
    at the stored equilibrium state translated into the instantaneous
    centre-of-mass frame; com_ref=None marks the fields as already
    rolled.  noise_source: "hash" (the hash stream, generator
    noise_dist) or "threefry" (the bulk source).  normals: the step's
    (33, X, Y, Z) normals, already drawn from the source (the word then
    keys nothing)."""
    if noise_source not in noise_ops.NOISE_SOURCES:
        raise ValueError(f"noise_source {noise_source!r} not in "
                         f"{noise_ops.NOISE_SOURCES}")
    hbar = hydro_ops.hydrovars_bar(state.f, state.g, params)
    if word is None:
        (word,) = draw_words(state.gen, 1)
    nref = _noise_ref(hbar, ref_state) if params.noise_on else None
    if noise_source == "hash" and normals is None:
        xi_f, xi_g = noise_ops.thermal_noise_hash(
            word, state.step, hbar.rho, hbar.phi, params, nref, noise_dist)
    else:
        xi_f, xi_g = noise_ops.thermal_noise(word, state.step, hbar.rho,
                                             hbar.phi, params, nref, normals)
    h = hydro_ops.hydrovars(state.f, state.g, xi_f, xi_g, params, hbar)
    return h, xi_f, xi_g


def step(state: SimState, params: LBMParams, word: Optional[int] = None, *,
         ref_state=None, noise_dist: str = "clt4",
         noise_source: str = "hash", normals=None
         ) -> Tuple[SimState, hydro_ops.Hydro]:
    """One full LB timestep; returns (new_state, hydro-at-step-start)."""
    h, xi_f, xi_g = prelude(state, params, word, ref_state=ref_state,
                            noise_dist=noise_dist, noise_source=noise_source,
                            normals=normals)
    f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g, params)
    f2 = stream_ops.stream(f1)
    g2 = stream_ops.stream(g1)
    return state.replace(f=f2, g=g2, step=state.step + 1), h


def nsteps(state: SimState, params: LBMParams, n: int,
           words: Optional[Sequence[int]] = None, *, ref_state=None,
           noise_dist: str = "clt4", noise_source: str = "hash") -> SimState:
    """n steps; words: optional per-step noise words (default: drawn)."""
    if words is None:
        words = draw_words(state.gen, n)
    if len(words) != n:
        raise ValueError(f"need {n} words, got {len(words)}")
    for w in words:
        state, _ = step(state, params, w, ref_state=ref_state,
                        noise_dist=noise_dist, noise_source=noise_source)
    return state


# ---------------------------------------------------------------------------
# Initializers (LBM_binary.H:598-742).  All set populations to the rest
# equilibrium f_i = w_i * density.
# ---------------------------------------------------------------------------

def _rest_populations(rho_field: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(W, dtype=rho_field.dtype,
                        device=rho_field.device).reshape(
        (Q,) + (1,) * rho_field.dim())
    return w * rho_field[None]


def _from_densities(rho: torch.Tensor, params: LBMParams,
                    seed: int) -> SimState:
    """Rest populations of rho and phi = (rho_hi + rho_lo) - rho."""
    phi = (params.rho_hi + params.rho_lo) - rho
    return init_state(_rest_populations(rho), _rest_populations(phi), seed)


def init_mixture(shape, params: LBMParams, seed: int = 12345,
                 dtype=DEFAULT_DTYPE, c1: float = 0.5, c2: float = 0.5,
                 device="cuda") -> SimState:
    """Uniform mixture rho = 2*C1, phi = 2*C2 (LBM_binary.H:598-629)."""
    rho = torch.full(tuple(shape), 2.0 * c1, dtype=dtype, device=device)
    phi = torch.full(tuple(shape), 2.0 * c2, dtype=dtype, device=device)
    return init_state(_rest_populations(rho), _rest_populations(phi), seed)


def _grid(shape, dtype, device):
    return torch.meshgrid(
        *[torch.arange(n, dtype=dtype, device=device) for n in shape],
        indexing="ij")


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh with the argument clamped to +-25, where it is exactly +-1 at
    any float precision (the JAX package clamps for XLA's lowering)."""
    return torch.tanh(torch.clamp(x, -25.0, 25.0))


def _width(params: LBMParams, width: float) -> float:
    """Interface width: the override, or the reference's sqrt(kappa)."""
    return width or math.sqrt(params.kappa)


def init_stripe(shape, params: LBMParams, seed: int = 12345,
                dtype=DEFAULT_DTYPE, frac: float = 0.5, width: float = 0.0,
                device="cuda") -> SimState:
    """Double-tanh slab along z (LBM_init_stripe, LBM_binary.H:664-695).

    rho rises from rho_lo to rho_hi inside |z - Lz/2| < frac*Lz/2 with
    interface width sqrt(kappa); phi = (rho_hi + rho_lo) - rho.
    width > 0 overrides sqrt(kappa) (RunConfig.init_width)."""
    _, _, z = _grid(shape, dtype, device)
    lz = shape[2]
    pos = z - lz // 2
    pos_lo = -0.5 * frac * lz
    pos_hi = 0.5 * frac * lz
    w = _width(params, width)
    rho = (params.rho_hi - params.rho_lo) * 0.5 * (
        _tanh((pos - pos_lo) / w) + _tanh((pos_hi - pos) / w)
    ) + params.rho_lo
    return _from_densities(rho, params, seed)


def init_droplet(shape, params: LBMParams, seed: int = 12345,
                 dtype=DEFAULT_DTYPE, radius: float = 0.2,
                 width: float = 0.0, device="cuda") -> SimState:
    """Tanh sphere of f inside g (LBM_init_droplet, LBM_binary.H:699-742).

    radius is a fraction of the box x-extent.  The centre is at (X/2,
    Y/2, X//2): the reference's z centre uses box[0]/2
    (LBM_binary.H:725), identical for cubic domains.  width > 0 overrides
    the sqrt(kappa) interface width."""
    x, y, z = _grid(shape, dtype, device)
    rx = x - shape[0] / 2.0
    ry = y - shape[1] / 2.0
    rz = z - shape[0] // 2
    r = torch.sqrt(rx * rx + ry * ry + rz * rz)
    cap_r = radius * shape[0]
    w = _width(params, width)
    rho = (params.rho_hi - params.rho_lo) * 0.5 * (
        1.0 + _tanh((cap_r - r) / w)
    ) + params.rho_lo
    return _from_densities(rho, params, seed)


def init_checkpoint(f, g, seed: int, step: int, device="cuda") -> SimState:
    """Restart from stored populations (LBM_init, LBM_binary.H:632-661)."""
    ft = torch.as_tensor(np.ascontiguousarray(f), device=device)
    gt = torch.as_tensor(np.ascontiguousarray(g), device=device)
    return init_state(ft, gt, seed, int(step))


def make_initial_state(cfg: RunConfig, device="cuda") -> SimState:
    """Dispatch on cfg.init the way main_run_job.cpp:248-292 does.

    init="checkpoint" reads a checkpoint of the port, whose generator
    continues the stored word stream, or of the JAX package, whose
    threefry key cannot be continued in torch: the generator is then
    seeded from the stored key
    (:func:`bflbm_tpu_torch.io.checkpoint.load_state`).  cfg.reseed seeds
    it from cfg.seed instead (independent ensembles branching from one
    checkpoint)."""
    p = cfg.params
    if cfg.init == "mixture":
        return init_mixture(cfg.shape, p, cfg.seed, cfg.dtype, device=device)
    if cfg.init == "stripe":
        return init_stripe(cfg.shape, p, cfg.seed, cfg.dtype, cfg.init_frac,
                           cfg.init_width, device=device)
    if cfg.init == "droplet":
        return init_droplet(cfg.shape, p, cfg.seed, cfg.dtype,
                            cfg.init_radius, cfg.init_width, device=device)
    if cfg.init == "checkpoint":
        from ..io.checkpoint import load_state

        if not cfg.checkpoint_path:
            raise ValueError("init='checkpoint' requires checkpoint_path")
        return load_state(cfg.checkpoint_path,
                          seed=cfg.seed if cfg.reseed else None,
                          device=device)
    raise ValueError(f"unknown init kind {cfg.init!r}")


def perturbed_populations(shape, seed: int, *, rho0: float = 1.0,
                          base=None, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, g) float32 with f_i = b_i (1 + 0.05 N(0,1)), the normals drawn
    with numpy from `seed`, and b_i = w_i rho0, or the populations of
    `base` (a SimState): a non-uniform state, so that streaming matters
    (a uniform mixture streams to itself).  Test input."""
    rng = np.random.default_rng(seed)
    if base is None:
        bases = [W.reshape((Q, 1, 1, 1)) * rho0] * 2
    else:
        bases = [base.f.cpu().numpy(), base.g.cpu().numpy()]
    out = []
    for b in bases:
        a = b * (1.0 + 0.05 * rng.standard_normal((Q,) + tuple(shape)))
        out.append(torch.as_tensor(a.astype(np.float32), device=device))
    return out[0], out[1]


def boosted_state(shape, u3, seed: int = 7, device=None):
    """(state, rho, phi): equilibrium populations of an off-centre blob
    along z, rho = 0.05 + 3 exp(-(z - Z/4)^2 / 72) and phi = rho / 2,
    moving at the velocity u3.  With alpha0 = 0 its centre of mass
    advances ~|u3| cells a step: what the USE_REF_STATE roll must follow
    (``tests/test_session.py:_boosted_state``).  Test input."""
    zz = torch.arange(shape[2], dtype=torch.float32, device=device)
    blob = 0.05 + 3.0 * torch.exp(-0.5 * ((zz - shape[2] / 4) / 6.0) ** 2)
    rho = blob.expand(tuple(shape)).contiguous()
    phi = 0.5 * rho
    u = torch.stack([torch.full(tuple(shape), v, dtype=torch.float32,
                                device=device) for v in u3])
    f = moments_ops.populations(collide_ops.equilibrium_moments(rho, u))
    g = moments_ops.populations(collide_ops.equilibrium_moments(phi, u))
    return init_state(f, g, seed), rho, phi
