"""Online pair structure factors S_AB(k) on the card
(``bflbm_tpu/observables/structfact.py``).

A running sum of the cross-spectra A_hat(k) conj(B_hat(k)) of the packed
hydro fields, with ``torch.fft.fftn`` on the fields' device (the JAX
package's TPU backend has no FFT and uses a matmul DFT, ``ops/rfft.py``;
the port needs none).  Conventions as there: the product is scaled by
1/N (a unitary 1/sqrt(N) transform of each factor); :func:`finalize`
zeroes k = 0 (the reference's ``zero_avg=1``) and fftshifts.

The offline spectra of the Debug.ipynb recipe (cells 5-8):
:func:`spectrum`, a unitary power spectrum in float64 on the field's
device, and :func:`radial_average` over the integer-frequency radii of
:func:`fftfreq_grid`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.hydro import HYDRO_NAMES
from ._fields import as_field, bin_means

# pairA/pairB of main_run_job.cpp:301-309, indices into HYDRO_NAMES.
REFERENCE_PAIRS: Tuple[Tuple[int, int], ...] = (
    (0, 0), (1, 1), (0, 1), (2, 2), (3, 3), (4, 4), (6, 6), (7, 7), (8, 8),
    (2, 6), (9, 9), (15, 15), (16, 16), (17, 17), (15, 16), (18, 18),
    (19, 19), (20, 20), (21, 21), (20, 21), (20, 18), (21, 18),
)


def pair_names(pairs=REFERENCE_PAIRS, names=HYDRO_NAMES):
    return tuple(f"{names[a]}*{names[b]}" for a, b in pairs)


class StructFactState(NamedTuple):
    """Running sums of Re/Im of A_hat(k) conj(B_hat(k)) per pair."""

    accum_re: torch.Tensor   # (npairs, X, Y, Z)
    accum_im: torch.Tensor   # (npairs, X, Y, Z)
    count: int


def init_structfact(npairs: int, shape, dtype=torch.float32,
                    device="cuda") -> StructFactState:
    z = torch.zeros((npairs,) + tuple(shape), dtype=dtype, device=device)
    return StructFactState(accum_re=z, accum_im=z.clone(), count=0)


def accumulate(sf: StructFactState, fields: torch.Tensor,
               pairs: Sequence[Tuple[int, int]] = REFERENCE_PAIRS
               ) -> StructFactState:
    """Add one frame.  fields: (C, X, Y, Z) packed component stack on the
    accumulators' device.  Updates the accumulators in place."""
    n = float(np.prod(tuple(fields.shape[1:])))
    used = sorted({i for ab in pairs for i in ab})
    idx = {c: i for i, c in enumerate(used)}
    sub = fields[used].to(sf.accum_re.dtype)
    spec = torch.fft.fftn(sub, dim=(1, 2, 3))
    re, im = spec.real, spec.imag
    scale = 1.0 / n   # (1/sqrt(N))^2 applied to the product
    for p, (a, b) in enumerate(pairs):
        ia, ib = idx[a], idx[b]
        # A * conj(B) = (ar br + ai bi) + i (ai br - ar bi)
        sf.accum_re[p] += (re[ia] * re[ib] + im[ia] * im[ib]) * scale
        sf.accum_im[p] += (im[ia] * re[ib] - re[ia] * im[ib]) * scale
    return sf._replace(count=sf.count + 1)


def finalize(sf: StructFactState, zero_avg: bool = True,
             shift: bool = True) -> np.ndarray:
    """Mean cross-spectra as a complex numpy array; optionally zero k = 0
    and fftshift (reference WritePlotFile semantics, zero_avg=1)."""
    cnt = max(int(sf.count), 1)
    s = (sf.accum_re.cpu().numpy() / cnt
         + 1j * (sf.accum_im.cpu().numpy() / cnt))
    if zero_avg:
        s[:, 0, 0, 0] = 0.0
    if shift:
        s = np.fft.fftshift(s, axes=(-3, -2, -1))
    return s


# ---------------------------------------------------------------------------
# Direct (offline) spectra — the Debug.ipynb cells 5-8 recipe.
# ---------------------------------------------------------------------------

def spectrum(field, remove_mean: bool = True) -> torch.Tensor:
    """|F[field]|^2 / N (unitary normalization) of a real (X, Y, Z)
    field, in float64 on its device (a numpy field on the CPU)."""
    x = as_field(field)
    if remove_mean:
        x = x - x.mean()
    f = torch.fft.fftn(x)
    return (f.real * f.real + f.imag * f.imag) / float(np.prod(x.shape[-3:]))


def fftfreq_grid(shape) -> np.ndarray:
    """|k| magnitude grid in integer-frequency units (host-side)."""
    freqs = [np.fft.fftfreq(n) * n for n in shape]
    kx, ky, kz = np.meshgrid(*freqs, indexing="ij")
    return np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)


def radial_average(sk, nbins: int = 0):
    """Spherically averaged S(|k|); returns (k_centers, S_mean), numpy.

    Integer-frequency radii |k_idx| with k = 0 excluded (the notebooks'
    flat-S(k) equilibrium checks); nbins equal bins up to the largest
    |k| (default its integer part), the largest |k| itself in none.
    The input must be UNshifted (k = 0 at index 0); a tensor is averaged
    on its device."""
    vals = as_field(sk).ravel()
    kmag = torch.as_tensor(fftfreq_grid(tuple(sk.shape)).ravel(),
                           device=vals.device)
    mask = kmag > 0
    kmag, vals = kmag[mask], vals[mask]
    kmax = float(kmag.max())
    nbins = nbins or int(kmax)
    return tuple(bin_means(kmag, np.linspace(0, kmax, nbins + 1), vals))
