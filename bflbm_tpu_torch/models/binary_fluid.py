"""Binary fluctuating-LBM model: the plain-torch timestep and the
uniform-mixture initializer.

One step (reference ``LBM_timestep``, LBM_binary.H:545-594, restructured
as in the JAX package) is

    prelude:  hbar(f, g) -> draw noise -> real hydrovars
    collide:  MRT relaxation + forcing + noise in moment space
    stream:   pull shifts

Noise comes from the coordinate-keyed hash stream with u8 deviates (the
one generator the CUDA kernel runs), keyed by one int32 word per
physical step and by ``state.step`` (the JAX package's
``noise_source="hash"``, ``noise_dist="u8"``), so a trajectory is a pure
function of its word sequence.  A word is drawn from ``state.gen`` for
every step, noise on or off, unless the caller passes it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, LBMParams
from ..lattice import Q, W
from ..ops import collide as collide_ops
from ..ops import hydro as hydro_ops
from ..ops import noise as noise_ops
from ..ops import stream as stream_ops
from ..state import SimState, draw_words, init_state


def prelude(state: SimState, params: LBMParams, word: Optional[int] = None):
    """Noise draw + real-hydrovar reconstruction of the current state.
    Returns (hydro, xi_f, xi_g)."""
    hbar = hydro_ops.hydrovars_bar(state.f, state.g, params)
    if word is None:
        (word,) = draw_words(state.gen, 1)
    xi_f, xi_g = noise_ops.thermal_noise_hash(
        word, state.step, hbar.rho, hbar.phi, params)
    h = hydro_ops.hydrovars(state.f, state.g, xi_f, xi_g, params, hbar)
    return h, xi_f, xi_g


def step(state: SimState, params: LBMParams, word: Optional[int] = None
         ) -> Tuple[SimState, hydro_ops.Hydro]:
    """One full LB timestep; returns (new_state, hydro-at-step-start)."""
    h, xi_f, xi_g = prelude(state, params, word)
    f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g, params)
    f2 = stream_ops.stream(f1)
    g2 = stream_ops.stream(g1)
    return state.replace(f=f2, g=g2, step=state.step + 1), h


def nsteps(state: SimState, params: LBMParams, n: int,
           words: Optional[Sequence[int]] = None) -> SimState:
    """n steps; words: optional per-step noise words (default: drawn)."""
    if words is None:
        words = draw_words(state.gen, n)
    if len(words) != n:
        raise ValueError(f"need {n} words, got {len(words)}")
    for w in words:
        state, _ = step(state, params, w)
    return state


def _rest_populations(rho_field: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(W, dtype=rho_field.dtype,
                        device=rho_field.device).reshape(
        (Q,) + (1,) * rho_field.dim())
    return w * rho_field[None]


def init_mixture(shape, params: LBMParams, seed: int = 12345,
                 dtype=DEFAULT_DTYPE, c1: float = 0.5, c2: float = 0.5,
                 device=None) -> SimState:
    """Uniform mixture rho = 2*C1, phi = 2*C2 (LBM_binary.H:598-629)."""
    rho = torch.full(tuple(shape), 2.0 * c1, dtype=dtype, device=device)
    phi = torch.full(tuple(shape), 2.0 * c2, dtype=dtype, device=device)
    return init_state(_rest_populations(rho), _rest_populations(phi), seed)


def perturbed_populations(shape, seed: int, *, rho0: float = 1.0,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, g) float32 with f_i = w_i rho0 (1 + 0.05 N(0,1)), the normals
    drawn with numpy from `seed`: a non-uniform state, so that streaming
    matters (a uniform mixture streams to itself).  Test input."""
    rng = np.random.default_rng(seed)
    w = W.reshape((Q, 1, 1, 1))
    out = []
    for _ in range(2):
        a = w * rho0 * (1.0 + 0.05 * rng.standard_normal((Q,) + tuple(shape)))
        out.append(torch.as_tensor(a.astype(np.float32), device=device))
    return out[0], out[1]
