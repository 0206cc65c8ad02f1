"""Hydro-field frame output (plotfile analog; ``bflbm_tpu/io/fields.py``,
rule for rule).

Frames are keyed by the 22-component schema names
(:data:`bflbm_tpu_torch.ops.hydro.HYDRO_NAMES`).  Formats, as in the JAX
package, and readable by both packages:

- ``npz``: compressed npz with ``step``;
- ``native``: the ``.bflbm`` container of the repository's native library
  (:mod:`.native`), written in the call or, given ``writer=``, by an
  :class:`.native.AsyncFieldWriter`'s background threads;
- ``h5``: HDF5 through h5py (:mod:`.hdf5`; RuntimeError without h5py);
- ``amrex``: an AMReX plotfile directory (:mod:`.amrex`);
- ``auto``: ``native`` for frames of 32 MiB and more
  (``np.savez_compressed`` is too slow for a 256^3 frame, 1.47 GB), npz
  below.

``native`` without the native library falls back to npz, as in the JAX
package.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.hydro import HYDRO_NAMES

_AUTO_NATIVE_BYTES = 32 * 2 ** 20  # frames above this use the native writer


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def frame_path(out_dir: str, step: int, ndigits: int = 7,
               ext: str = "npz") -> str:
    return os.path.join(out_dir, f"plt{step:0{ndigits}d}.{ext}")


def write_frame(out_dir: str, step: int, packed_hydro,
                fmt: str = "auto", writer=None) -> str:
    """packed_hydro: (22, X, Y, Z) tensor or array in HYDRO_NAMES order.
    fmt: "auto", "npz", "native", "h5" or "amrex" (module docstring).
    writer: optional :class:`.native.AsyncFieldWriter` for native frames:
    the fields are copied at submit and written by its threads."""
    if fmt not in ("auto", "npz", "native", "h5", "amrex"):
        raise ValueError(f"unknown frame format {fmt!r}")
    os.makedirs(out_dir, exist_ok=True)
    arr = _host(packed_hydro)
    if fmt == "auto":
        fmt = "native" if arr.nbytes >= _AUTO_NATIVE_BYTES else "npz"
    if fmt == "amrex":
        from . import amrex

        path = os.path.join(out_dir, f"plt{step:07d}")
        amrex.write_plotfile(path, arr, HYDRO_NAMES, time=float(step),
                             step=step)
        return path
    if fmt == "h5":
        from . import hdf5

        if not hdf5.available():
            raise RuntimeError("fmt='h5' requires h5py")
        return hdf5.write_frame_h5(frame_path(out_dir, step, ext="h5"),
                                   step, arr, HYDRO_NAMES)
    if fmt == "native":
        from . import native

        if writer is not None:
            path = frame_path(out_dir, step, ext="bflbm")
            writer.submit(path, list(HYDRO_NAMES),
                          [np.ascontiguousarray(arr[i])
                           for i in range(len(HYDRO_NAMES))])
            return path
        if native.available():
            path = frame_path(out_dir, step, ext="bflbm")
            native.write_fields(
                path, {n: arr[i] for i, n in enumerate(HYDRO_NAMES)})
            return path
    path = frame_path(out_dir, step)
    np.savez_compressed(path, step=step,
                        **{n: arr[i] for i, n in enumerate(HYDRO_NAMES)})
    return path


def read_frame(path: str, names: Optional[Sequence[str]] = None
               ) -> Dict[str, np.ndarray]:
    """The arrays of a frame, by name, with its step: an AMReX plotfile
    directory, a ``.h5``, a ``.bflbm`` (the step from the file name) or
    an npz file.  names: only these arrays (and the step); a ``.bflbm``
    or npz frame then reads no other field."""
    if os.path.isdir(path):
        from . import amrex

        fields, meta = amrex.read_plotfile(path)
        fields["step"] = np.asarray(meta["step"])
        return _only(fields, names)
    if path.endswith(".h5"):
        from . import hdf5

        return _only(hdf5.read_frame_h5(path), names)
    if path.endswith(".bflbm"):
        from . import native

        out = native.read_fields(path, names)
        m = re.search(r"plt(\d+)\.bflbm$", path)
        if m:
            out["step"] = np.asarray(int(m.group(1)))
        return out
    with np.load(path) as d:
        return {k: d[k] for k in d.files
                if names is None or k in names or k == "step"}


def _only(fields: Dict[str, np.ndarray], names) -> Dict[str, np.ndarray]:
    if names is None:
        return fields
    return {k: v for k, v in fields.items() if k in names or k == "step"}


def write_noise_frame(out_dir: str, step: int, xi_f, xi_g) -> str:
    """Dump the 19-component per-mode noise fields (WriteOutNoise analog,
    Debug.H:381-409)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"noise{step:07d}.npz")
    np.savez_compressed(path, step=step, xi_f=_host(xi_f), xi_g=_host(xi_g))
    return path


def read_noise_frame(path: str) -> Dict[str, np.ndarray]:
    """A noise dump of :func:`write_noise_frame`: xi_f, xi_g and step."""
    with np.load(path) as d:
        return {k: d[k] for k in ("xi_f", "xi_g", "step")}
