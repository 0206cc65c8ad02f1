"""D3Q19 lattice tables for the PyTorch port (numpy only).

The tables are rebuilt here from the same defining polynomials as
``bflbm_tpu/lattice.py`` (which cannot be imported: that package's
``__init__`` pulls in JAX).  ``M`` (moments = M @ f) and ``M_INV``
(f = M_INV @ m) follow from the discrete orthogonality relation

    sum_i w_i e_k(c_i) e_l(c_i) = b_k delta_kl,
    M[k, i] = e_k(c_i),   M_INV[i, k] = w_i e_k(c_i) / b_k.

Velocity ordering follows the reference (``LBM_d3q19.H:12-32``): rest;
+-x, +-y, +-z faces; xy, yz, xz edge diagonals.
"""

from __future__ import annotations

import numpy as np

Q = 19
CS2 = 1.0 / 3.0

C = np.array(
    [
        [0, 0, 0],
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
        [1, 1, 0], [-1, -1, 0], [1, -1, 0], [-1, 1, 0],
        [0, 1, 1], [0, -1, -1], [0, 1, -1], [0, -1, 1],
        [1, 0, 1], [-1, 0, -1], [1, 0, -1], [-1, 0, 1],
    ],
    dtype=np.int64,
)

# Quadrature weights: 1/3 rest, 1/18 faces, 1/36 edges.
W = np.where(
    (C == 0).all(axis=1),
    1.0 / 3.0,
    np.where(np.abs(C).sum(axis=1) == 1, 1.0 / 18.0, 1.0 / 36.0),
).astype(np.float64)


def _basis_polynomials() -> np.ndarray:
    """The 19 Duenweg/Schiller basis polynomials on the velocity set:
    mass; momentum; bulk, two diagonal and three off-diagonal stress
    modes; six third-order and three fourth-order ghost modes."""
    cx, cy, cz = (C[:, 0].astype(np.float64), C[:, 1].astype(np.float64),
                  C[:, 2].astype(np.float64))
    c2 = cx * cx + cy * cy + cz * cz
    rows = [
        np.ones(Q),
        cx, cy, cz,
        c2 - 1.0,
        3.0 * cx * cx - c2,
        cy * cy - cz * cz,
        cx * cy, cy * cz, cx * cz,
        (3.0 * c2 - 5.0) * cx,
        (3.0 * c2 - 5.0) * cy,
        (3.0 * c2 - 5.0) * cz,
        (cy * cy - cz * cz) * cx,
        (cz * cz - cx * cx) * cy,
        (cx * cx - cy * cy) * cz,
        3.0 * c2 * c2 - 6.0 * c2 + 1.0,
        (2.0 * c2 - 3.0) * (3.0 * cx * cx - c2),
        (2.0 * c2 - 3.0) * (cy * cy - cz * cz),
    ]
    return np.stack(rows, axis=0)


M = _basis_polynomials()
B = np.einsum("i,ki,ki->k", W, M, M)   # mode norms b_k
M_INV = (W[:, None] * M.T) / B[None, :]

# Mode-norm table of the reference (LBM_d3q19.H:56-76), a cross-check only.
B_REFERENCE = np.array(
    [1.0, 1 / 3, 1 / 3, 1 / 3, 2 / 3, 4 / 3, 4 / 9, 1 / 9, 1 / 9, 1 / 9,
     2 / 3, 2 / 3, 2 / 3, 2 / 9, 2 / 9, 2 / 9, 2.0, 4 / 3, 4 / 9],
    dtype=np.float64,
)


def sanity() -> None:
    """Raise if the constructed basis is inconsistent."""
    if not (np.allclose(B, B_REFERENCE)
            and np.allclose(M @ M_INV, np.eye(Q), atol=1e-14)
            and np.isclose(W.sum(), 1.0)
            and np.allclose(np.einsum("i,ia,ib->ab", W, C.astype(float),
                                      C.astype(float)),
                            CS2 * np.eye(3), atol=1e-15)):
        raise RuntimeError("D3Q19 basis construction is inconsistent")


sanity()
