"""Physical / model parameters of the PyTorch port.

The same fields and derived properties as ``bflbm_tpu.config.LBMParams``
(reference: ``LBM_binary.H:17-30``); the JAX module cannot be reused
because it imports ``jax.numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# float32 machine epsilon, the reference's |rho| guard for divisions
# (FLT_EPSILON in hydrovars, LBM_binary.H:246-264).
FLT_EPSILON = 1.1920928955078125e-07

DEFAULT_DTYPE = torch.float32


@dataclass(frozen=True)
class LBMParams:
    """tau_f, tau_g: bare relaxation times (tau_bar = tau + 1/2).
    alpha0: cross-species Shan-Chen coupling; alpha1: square-gradient
    coefficient.  kBT: thermal noise temperature (0 switches noise off).
    kappa: interface-width parameter of the initial profiles.
    use_sc_pseudo / sc_ref_density: pseudopotential psi(n) = n0 (1 -
    exp(-n/n0)) instead of the raw density.  rho_lo / rho_hi: density
    bounds of the stripe / droplet profiles.  div_eps: |rho| guard."""

    tau_f: float = 0.5
    tau_g: float = 0.5
    alpha0: float = 0.0
    alpha1: float = 0.0
    kBT: float = 0.0
    kappa: float = 1.0
    use_sc_pseudo: bool = False
    sc_ref_density: float = 1.0
    rho_lo: float = 0.0
    rho_hi: float = 1.0
    div_eps: float = FLT_EPSILON

    @property
    def noise_on(self) -> bool:
        return self.kBT != 0.0

    @property
    def tau_f_bar(self) -> float:
        return self.tau_f + 0.5

    @property
    def tau_g_bar(self) -> float:
        return self.tau_g + 0.5

    @property
    def lam_f(self) -> float:
        """lambda_bar = 1/(tau+1/2), the modified relaxation frequency."""
        return 1.0 / (self.tau_f + 0.5)

    @property
    def lam_g(self) -> float:
        return 1.0 / (self.tau_g + 0.5)

    @property
    def viscosity(self) -> float:
        """Kinematic viscosity prefactor cs^2 (tau_bar - 1/2) per unit rho."""
        return (self.tau_f_bar - 0.5) / 3.0
