"""Checkpoint / resume of (f, g, step, noise generator) and the
equilibrium-state artifact (``bflbm_tpu/io/checkpoint.py``).

The reference writes raw populations as end-of-run plotfiles and resumes
without its RNG stream (main_run_job.cpp:400-409, LBM_binary.H:632-661).
The JAX package stores its threefry key; the port stores the state of
its CPU word generator (``torch.Generator.get_state()``, a uint8 array)
instead, so a restarted run draws the same words as the unbroken one and
continues it bitwise.  The equilibrium artifact has the JAX package's
npz keys, so artifacts cross between the packages in both directions,
and :func:`load_state` also reads a JAX checkpoint (its stored key seeds
the generator, :func:`bflbm_tpu_torch.interop.seed_from_key`).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..state import SimState, generator_from_state, make_generator


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: SimState, extra: Optional[dict] = None
               ) -> str:
    """Write the state to ``<path>.npz`` (f, g, step, gen_state) plus a
    small JSON sidecar ``<path>.json`` (step, shape, dtype and `extra`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = state.f.detach().cpu().numpy()
    g = state.g.detach().cpu().numpy()
    np.savez(path + ".npz", f=f, g=g, step=np.asarray(state.step),
             gen_state=state.gen.get_state().numpy())
    meta = {"step": int(state.step), "shape": list(f.shape[1:]),
            "dtype": str(f.dtype)}
    if extra:
        meta.update(extra)
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh)
    return path + ".npz"


def load_state(path: str, seed: Optional[int] = None,
               device="cuda") -> SimState:
    """Read a checkpoint of the port (its generator continues the stored
    word stream) or of the JAX package (the generator is seeded from the
    stored key).  seed: seed the generator from it instead (independent
    ensembles branching from one checkpoint)."""
    from ..interop import seed_from_key

    with np.load(_npz(path)) as d:
        f = torch.as_tensor(np.ascontiguousarray(d["f"]), device=device)
        g = torch.as_tensor(np.ascontiguousarray(d["g"]), device=device)
        step = int(np.asarray(d["step"]))
        if seed is not None:
            gen = make_generator(seed)
        elif "gen_state" in d.files:
            gen = generator_from_state(d["gen_state"])
        else:
            gen = make_generator(seed_from_key(d["key"]))
    return SimState(f=f, g=g, step=step, gen=gen)


def save_equilibrium(path: str, rho, phi, rho_tot) -> str:
    """Store the time-averaged equilibrium state artifact — the reference's
    ``equilibrium_{rho,phi,rhot}`` plotfiles (main_run_job.cpp:428-439)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", rho=np.asarray(rho), phi=np.asarray(phi),
             rho_tot=np.asarray(rho_tot))
    return path + ".npz"


def load_equilibrium(path: str):
    """(rho, phi, rho_tot) numpy arrays of an equilibrium artifact."""
    with np.load(_npz(path)) as d:
        return d["rho"], d["phi"], d["rho_tot"]
