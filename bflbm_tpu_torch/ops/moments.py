"""Population <-> moment transforms as 19x19 contractions.

Reference: the hand-unrolled ``moments()`` / ``populations()``
(``LBM_d3q19.H:100-156`` / ``:167-247``).  Every contraction runs in
full float32: on a CUDA tensor it refuses to run while TF32 matmuls are
allowed (``torch.backends.cuda.matmul.allow_tf32``), because TF32 keeps
about three decimal digits and the moments -> populations round trip
would then break mass conservation and kBT ~ 1e-5 noise statistics (the
JAX package pins ``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import M, M_INV

_constants = {}


def constant(value, dtype, device) -> torch.Tensor:
    """`value` (a numpy array or a number) as a tensor of `dtype` on
    `device`, copied from the host once and then reused: a step copies
    nothing from the host, so it can be captured in a CUDA graph
    (:mod:`~bflbm_tpu_torch.models.plain_session`).  Not to be written."""
    arr = np.asarray(value)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype,
           torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.as_tensor(arr, dtype=dtype,
                                              device=device)
    return t


def contract(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """sum_j mat[k, j] x[j, ...] in x's dtype, without TF32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "float32 contractions need full precision: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    m = constant(mat, x.dtype, x.device)
    return torch.tensordot(m, x, dims=([1], [0]))


def density(f: torch.Tensor) -> torch.Tensor:
    """sum_i f_i over the leading population axis, added in the order
    i = 0..18 as the kernels add them.  ``torch.sum`` adds in an order
    that depends on the number of cells (its vectorized loop and its
    tail differ), so a block of a decomposed domain would not sum its
    cells as the whole domain does."""
    acc = f[0]
    for i in range(1, f.shape[0]):
        acc = acc + f[i]
    return acc


def moments(f: torch.Tensor) -> torch.Tensor:
    """m_k = sum_i M[k,i] f_i over the leading population axis."""
    return contract(M, f)


def populations(m: torch.Tensor) -> torch.Tensor:
    """f_i = sum_k M_INV[i,k] m_k over the leading moment axis."""
    return contract(M_INV, m)
