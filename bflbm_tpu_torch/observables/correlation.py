"""Correlation and time-evolution diagnostics
(``bflbm_tpu/observables/correlation.py``).

Reference: ``Correlation.ipynb`` (axis line cuts of accumulated
structure factors, e.g. S_ufbarx(kx) at ky = kz = 0) and
``VelocityEvolution.ipynb`` (time series of field means / extrema over
stored frames).  Field statistics are torch in float64 on the fields'
device (numpy fields on the CPU); the velocity series stay numpy.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ._fields import as_field, host


def axis_cut(sk, axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Line cut of a 3D spectrum along one k axis with the other two at 0.

    sk must be UNshifted (k = 0 at index 0).  Returns (k, S) for k > 0 up
    to below the Nyquist index, k in integer frequency units."""
    n = sk.shape[axis]
    idx = [0, 0, 0]
    idx[axis] = slice(1, max(n // 2, 1))
    cut = sk[tuple(idx)]
    cut = host(cut) if isinstance(cut, torch.Tensor) else np.asarray(cut)
    return np.arange(1, max(n // 2, 1), dtype=float), cut


def time_series(frames: Sequence[Dict], field: str = "rho"
                ) -> Dict[str, np.ndarray]:
    """Per-frame mean / std / min / max of a hydro field over stored
    frames (VelocityEvolution.ipynb monitoring; Debug.H:210-228)."""
    means, stds, mins, maxs, steps = [], [], [], [], []
    for d in frames:
        a = as_field(d[field])
        means.append(a.mean())
        stds.append(a.std(correction=0))
        mins.append(a.min())
        maxs.append(a.max())
        steps.append(int(d.get("step", len(steps))))
    stat = {k: host(torch.stack(v)) if v else np.zeros(0)
            for k, v in (("mean", means), ("std", stds), ("min", mins),
                         ("max", maxs))}
    return {"step": np.asarray(steps), **stat}


def time_mean_density(frames: Sequence[Dict], fields=("rho", "phi")
                      ) -> Dict[str, np.ndarray]:
    """Ensemble (time) mean density fields over a frame window —
    Correlation.ipynb cell 7's mean densities / the equilibrium
    state estimator."""
    acc = {f: None for f in fields}
    n = 0
    for d in frames:
        for f in fields:
            a = as_field(d[f])
            acc[f] = a if acc[f] is None else acc[f] + a
        n += 1
    return {f: host(acc[f] / max(n, 1)) for f in fields}


def velocity_autocorrelation(series: np.ndarray, tmax: int) -> np.ndarray:
    """Time-origin-averaged autocorrelation C(t) = <v(0) . v(t)> of a
    (T, ...) velocity sample series (normalized to C(0) = 1)."""
    v = np.asarray(series, float).reshape(len(series), -1)
    c = np.array([
        np.mean(np.sum(v[t:] * v[:len(v) - t], axis=1))
        for t in range(min(tmax, len(v)))
    ])
    return c / c[0] if c[0] != 0 else c
