"""Carry parameters and state across from the JAX package (numpy only;
nothing here imports JAX)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import DEFAULT_DTYPE, LBMParams
from .state import SimState, init_state


def params_from_dict(d: dict) -> LBMParams:
    """The port's LBMParams from ``dataclasses.asdict`` of a JAX
    ``LBMParams`` (same field names; unknown keys are an error)."""
    names = {f.name for f in dataclasses.fields(LBMParams)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown LBMParams fields: {sorted(extra)}")
    return LBMParams(**d)


def state_from_arrays(f, g, step, seed: int, device=None) -> SimState:
    """A SimState from the numpy arrays of a JAX ``SimState`` (f, g of
    shape (19, X, Y, Z)); the generator is seeded from `seed`."""
    ft = torch.as_tensor(np.ascontiguousarray(f), dtype=DEFAULT_DTYPE,
                         device=device)
    gt = torch.as_tensor(np.ascontiguousarray(g), dtype=DEFAULT_DTYPE,
                         device=device)
    return init_state(ft, gt, seed, int(np.asarray(step)))


def load_jax_checkpoint(path: str, seed: int, device=None) -> SimState:
    """Read a checkpoint npz written by ``bflbm_tpu.io.checkpoint
    .save_state`` (arrays f, g, key, step).

    The stored threefry ``key`` cannot be continued in torch: the port's
    generator is seeded from `seed` instead, so the noise after the
    restart is a different (equally valid) stream.  To continue a JAX
    run bitwise, derive its per-step words on the JAX side and pass them
    explicitly (``FusedSession.advance(pc, n, words=...)``)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as d:
        return state_from_arrays(d["f"], d["g"], d["step"], seed, device)
