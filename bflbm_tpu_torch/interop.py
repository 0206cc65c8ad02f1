"""Carry parameters, run configurations and state across from the JAX
package (numpy only; nothing here imports JAX).  State is built on the
card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import LBMParams, RunConfig
from .models.binary_fluid import init_checkpoint
from .state import SimState


def _check_fields(cls, d: dict) -> None:
    extra = set(d) - {f.name for f in dataclasses.fields(cls)}
    if extra:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(extra)}")


def params_from_dict(d: dict) -> LBMParams:
    """The port's LBMParams from ``dataclasses.asdict`` of a JAX
    ``LBMParams`` (same field names; unknown keys are an error)."""
    _check_fields(LBMParams, d)
    return LBMParams(**d)


def _torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or anything numpy
    reads as one (e.g. ``jnp.float32``)."""
    if isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, np.dtype(dt).name)


def run_config_from_dict(d: dict) -> RunConfig:
    """The port's RunConfig from ``dataclasses.asdict`` of a JAX
    ``RunConfig``: params through :func:`params_from_dict`, dtype as the
    torch dtype of the same name (unknown keys are an error)."""
    _check_fields(RunConfig, d)
    kw = dict(d)
    if "params" in kw:
        p = kw["params"]
        kw["params"] = p if isinstance(p, LBMParams) else params_from_dict(p)
    if "dtype" in kw:
        kw["dtype"] = _torch_dtype(kw["dtype"])
    if "shape" in kw:
        kw["shape"] = tuple(int(s) for s in kw["shape"])
    return RunConfig(**kw)


def state_from_arrays(f, g, step, seed: int, device="cuda") -> SimState:
    """A float32 SimState from the numpy arrays of a JAX ``SimState`` (f,
    g of shape (19, X, Y, Z)); the generator is seeded from `seed`."""
    return init_checkpoint(np.asarray(f, np.float32),
                           np.asarray(g, np.float32), seed,
                           int(np.asarray(step)), device)


def seed_from_key(key) -> int:
    """A generator seed from a stored threefry key (its uint32 words as
    one integer), so that resuming a checkpoint twice draws the same
    words."""
    seed = 0
    for w in np.asarray(key).astype(np.uint32).ravel():
        seed = ((seed << 32) | int(w)) % 2 ** 64
    return seed


def load_jax_checkpoint(path: str, seed: Optional[int] = None,
                        device="cuda") -> SimState:
    """Read a checkpoint npz written by ``bflbm_tpu.io.checkpoint
    .save_state`` (arrays f, g, key, step).

    The stored threefry ``key`` cannot be continued in torch: the port's
    generator is seeded from `seed`, or, when `seed` is None, from the
    key's words (:func:`seed_from_key`), so the noise after the restart
    is a different (equally valid) stream.  To continue a JAX run
    bitwise, derive its per-step words on the JAX side and pass them
    explicitly (``FusedSession.advance(pc, n, words=...)``)."""
    from .io.checkpoint import load_state

    return load_state(path, seed=seed, device=device)
