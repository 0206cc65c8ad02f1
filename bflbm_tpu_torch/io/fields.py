"""Hydro-field frame output (plotfile analog; ``bflbm_tpu/io/fields.py``).

Frames are npz files keyed by the 22-component schema names
(:data:`bflbm_tpu_torch.ops.hydro.HYDRO_NAMES`) plus ``step``, readable
by the JAX package's ``read_frame`` and any numpy workflow.
``np.savez_compressed`` is too slow for a 256^3 frame (1.47 GB), so
``fmt="auto"`` compresses only frames below 32 MiB and writes larger
ones with plain ``np.savez``.  The JAX package's native, HDF5 and AMReX
containers are not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..ops.hydro import HYDRO_NAMES

_AUTO_COMPRESS_BYTES = 32 * 2 ** 20   # auto: compress frames below this
_NOT_PORTED = ("native", "h5", "amrex")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def frame_path(out_dir: str, step: int, ndigits: int = 7,
               ext: str = "npz") -> str:
    return os.path.join(out_dir, f"plt{step:0{ndigits}d}.{ext}")


def write_frame(out_dir: str, step: int, packed_hydro,
                fmt: str = "auto") -> str:
    """packed_hydro: (22, X, Y, Z) tensor or array in HYDRO_NAMES order.
    fmt: "auto" (npz, compressed below 32 MiB) or "npz" (compressed)."""
    if fmt in _NOT_PORTED:
        raise NotImplementedError(
            f"frame format {fmt!r} is not ported (ROADMAP Queue 1 item 7); "
            "the port writes npz")
    if fmt not in ("auto", "npz"):
        raise ValueError(f"unknown frame format {fmt!r}")
    os.makedirs(out_dir, exist_ok=True)
    arr = _host(packed_hydro)
    path = frame_path(out_dir, step)
    save = (np.savez if fmt == "auto" and arr.nbytes >= _AUTO_COMPRESS_BYTES
            else np.savez_compressed)
    save(path, step=step, **{n: arr[i] for i, n in enumerate(HYDRO_NAMES)})
    return path


def read_frame(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an npz frame, by name."""
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def write_noise_frame(out_dir: str, step: int, xi_f, xi_g) -> str:
    """Dump the 19-component per-mode noise fields (WriteOutNoise analog,
    Debug.H:381-409)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"noise{step:07d}.npz")
    np.savez_compressed(path, step=step, xi_f=_host(xi_f), xi_g=_host(xi_g))
    return path
