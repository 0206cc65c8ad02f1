"""Isotropic 19-point lattice stencils — gradient, laplacian and
grad-laplacian (``LBM_binary.H:134-194``) — as compositions of periodic
``torch.roll`` shifts (``bflbm_tpu/ops/stencil.py``).

Each stencil takes an optional ``at(field, cvec)``: the field evaluated at
x + cvec.  The default is the periodic shift; on a halo-extended block
(:mod:`bflbm_tpu_torch.ops.blocked`) it is a slice that gives up one cell
of the field's ring, so the same arithmetic runs on both."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..lattice import C, CS2, W

# +- direction pairs (i, j) with c_j = -c_i, skipping the rest velocity.
_PAIRS: Tuple[Tuple[int, int], ...] = tuple(
    (i, int(np.argwhere((C == -C[i]).all(axis=1))[0, 0]))
    for i in range(1, 19)
    if C[i][np.argmax(C[i] != 0)] > 0
)


def shift(field: torch.Tensor, cvec, dims=(-3, -2, -1)) -> torch.Tensor:
    """field evaluated at x + cvec (periodic)."""
    sh = [int(-c) for c in cvec]
    ax = [a for a, s in zip(dims, sh) if s != 0]
    sh = [s for s in sh if s != 0]
    if not sh:
        return field
    return torch.roll(field, sh, ax)


def pseudopotential(field: torch.Tensor, use_sc: bool,
                    ref_density: float) -> torch.Tensor:
    """Shan-Chen pseudopotential transform (LBM_binary.H:141)."""
    if not use_sc:
        return field
    return ref_density * (1.0 - torch.exp(-field / ref_density))


def _periodic(dims):
    return lambda a, c: shift(a, c, dims)


def gradient(field: torch.Tensor, use_sc: bool = False,
             ref_density: float = 1.0, dims=(-3, -2, -1),
             at=None) -> torch.Tensor:
    """grad_d psi(x) = (1/cs^2) sum_i w_i psi(x + c_i) c_{i,d}, as 9
    antisymmetric pair differences; returns (3, *shape) with the shape of
    ``at``'s output (field's shape when periodic)."""
    at = at or _periodic(dims)
    psi = pseudopotential(field, use_sc, ref_density)
    out = [torch.zeros_like(at(psi, (0, 0, 0))) for _ in range(3)]
    for i, j in _PAIRS:
        diff = at(psi, C[i]) - at(psi, C[j])
        coeff = float(W[i] / CS2)
        for d in range(3):
            if C[i, d] != 0:
                out[d] = out[d] + (coeff * float(C[i, d])) * diff
    return torch.stack(out)


def laplacian(field: torch.Tensor, use_sc: bool = False,
              ref_density: float = 1.0, dims=(-3, -2, -1),
              at=None) -> torch.Tensor:
    """19-point lattice laplacian (LBM_binary.H:152-168):
    lap psi(x) = (2/cs^2) sum_i w_i (psi(x + c_i) - psi(x)), as 9
    symmetric pair sums."""
    at = at or _periodic(dims)
    psi = pseudopotential(field, use_sc, ref_density)
    centre = at(psi, (0, 0, 0))
    acc = torch.zeros_like(centre)
    wsum = 0.0
    for i, j in _PAIRS:
        acc = acc + float(W[i]) * (at(psi, C[i]) + at(psi, C[j]))
        wsum += float(2.0 * W[i])
    return (2.0 / CS2) * (acc - wsum * centre)


def grad_laplacian(field: torch.Tensor, use_sc: bool = False,
                   ref_density: float = 1.0,
                   dims=(-3, -2, -1), at=None) -> torch.Tensor:
    """Gradient of the laplacian (``grad_laplacian_2nd``,
    LBM_binary.H:170-194) as gradient(laplacian(psi)); the pseudopotential
    applies to the innermost field only, as in the reference.  Returns
    (3, *field.shape)."""
    psi = pseudopotential(field, use_sc, ref_density)
    return gradient(laplacian(psi, False, ref_density, dims, at), False,
                    ref_density, dims, at)
