"""Physical parameters, run configuration and named presets of the
PyTorch port.

The same fields, defaults and presets as ``bflbm_tpu.config``
(reference: ``LBM_binary.H:17-30``, ``main_run_job.cpp:77-106``, the
recipes of the reference's ``Parameters`` file); the JAX module cannot be
reused because it imports ``jax.numpy``.  ``RunConfig.dtype`` is a torch
dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

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


@dataclass(frozen=True)
class RunConfig:
    """Execution configuration (reference: ``main_run_job.cpp:77-106``);
    field by field ``bflbm_tpu.config.RunConfig``, read by the run
    driver :func:`bflbm_tpu_torch.run.run`.  ``noise_source`` has the
    JAX package's meaning: the plain engine's noise, ``"threefry"`` (the
    default: the bulk source, exact normals from a generator seeded with
    the step's word and the step; not threefry's bits) or ``"hash"`` (the
    coordinate-keyed hash stream the kernels draw), and a non-default
    source selects the plain engine (``run.resolve_engine``); the kernel
    session always draws the hash stream.  ``noise_dist`` picks the hash
    stream's generator."""

    shape: Tuple[int, int, int] = (32, 32, 32)
    params: LBMParams = field(default_factory=LBMParams)
    seed: int = 12345            # LBM_binary.H:17
    nsteps: int = 500
    step_continue: int = 0
    plot_int: int = 0            # hydro fields every N steps (0 = off)
    plot_save: bool = True
    plot_fmt: str = "auto"
    print_int: int = 0
    sf_window: int = 0           # trailing window for structure factors
    sf_every: int = 100
    t_window: int = 0            # trailing window of the equilibrium mean
    out_dir: str = "out"
    dtype: Any = DEFAULT_DTYPE
    use_ref_state: bool = False  # noise amplitudes from a stored state
    ref_state_path: Optional[str] = None
    out_noise_int: int = 0
    init: str = "mixture"        # mixture | stripe | droplet | checkpoint
    init_radius: float = 0.2     # droplet radius as a fraction of the box
    init_frac: float = 0.5       # stripe fraction of the box
    init_width: float = 0.0      # tanh width override in cells; 0 = the
    #                              reference's sqrt(kappa)
    checkpoint_path: Optional[str] = None
    reseed: bool = False         # checkpoint init: seed the noise words
    #                              from `seed`, not from the stored key
    noise_source: str = "threefry"  # the plain engine's: threefry | hash
    noise_dist: str = "clt4"     # hash-stream generator: clt4, u8,
    #                              clt2 or bm
    droplet_int: int = 0
    chunk_cap: int = 1000

    def with_params(self, **kw) -> "RunConfig":
        return replace(self, params=replace(self.params, **kw))

    def replace(self, **kw) -> "RunConfig":
        return replace(self, **kw)


# ----------------------------------------------------------------------------
# Named presets reproducing the recipes in the reference `Parameters` file
# (bflbm_tpu/config.py:161-307).  Each physical case is a two-phase
# protocol: deterministic equilibration (kBT=0), then fluctuating
# continuation from the stored equilibrium state.
# ----------------------------------------------------------------------------

_DROPLET = dict(kappa=0.1, rho_lo=0.0, rho_hi=3.0)
_DEEP = dict(kappa=0.001, rho_lo=0.0, rho_hi=1.0)
_EQ32 = dict(shape=(32, 32, 32), nsteps=20_000, plot_int=100,
             t_window=1000, droplet_int=100, init="droplet")

_PRESETS: Dict[str, RunConfig] = {
    "mixture-eq": RunConfig(                 # Mixture Step I
        shape=(32, 32, 32), params=LBMParams(alpha0=0.0, kBT=0.0),
        nsteps=500, plot_int=10, t_window=100, init="mixture"),
    "mixture-fluct": RunConfig(              # Mixture Step II
        shape=(32, 32, 32), params=LBMParams(alpha0=0.0, kBT=1e-5),
        nsteps=600_000, step_continue=500, plot_int=2000,
        sf_window=200_000, sf_every=100, init="checkpoint"),
    "interface-eq": RunConfig(               # Flat interface Step I
        shape=(8, 256, 64),
        params=LBMParams(alpha0=1.5, kBT=0.0, kappa=0.1, rho_lo=0.1,
                         rho_hi=3.0),
        nsteps=3000, plot_int=10, t_window=500, init="stripe"),
    "interface-fluct": RunConfig(            # Flat interface Step II
        shape=(8, 256, 64),
        params=LBMParams(alpha0=1.5, kBT=1e-5, kappa=0.1, rho_lo=0.1,
                         rho_hi=3.0),
        nsteps=800_000, step_continue=3000, plot_int=1000,
        init="checkpoint"),
    "droplet-eq": RunConfig(                 # Droplet Case I, alpha0=1.5
        params=LBMParams(alpha0=1.5, kBT=0.0, **_DROPLET),
        init_radius=0.2, **_EQ32),
    "droplet-fluct": RunConfig(              # Droplet Case I Step II
        shape=(32, 32, 32), params=LBMParams(alpha0=1.5, kBT=1e-5,
                                             **_DROPLET),
        nsteps=600_000, step_continue=20_000, plot_int=500, droplet_int=500,
        init="checkpoint"),
    "droplet64-eq": RunConfig(               # Droplet Case II
        shape=(64, 64, 64), params=LBMParams(alpha0=1.5, kBT=0.0,
                                             **_DROPLET),
        nsteps=50_000, plot_int=200, t_window=10_000, droplet_int=200,
        init="droplet", init_radius=0.2),
    "droplet-a0.8-eq": RunConfig(            # alpha0=0.8 family
        params=LBMParams(alpha0=0.8, kBT=0.0, **_DROPLET),
        init_radius=0.4, **_EQ32),
    "droplet-a1.7-eq": RunConfig(            # alpha0=1.7 family
        params=LBMParams(alpha0=1.7, kBT=0.0, **_DROPLET),
        init_radius=0.2, **_EQ32),
    "droplet-a2.5-eq": RunConfig(            # alpha0=2.5, rho_hi=2
        params=LBMParams(alpha0=2.5, kBT=0.0, kappa=0.1, rho_lo=0.0,
                         rho_hi=2.0),
        init_radius=0.25, **_EQ32),
    "droplet-a4-eq": RunConfig(              # alpha0=4, rho_hi=1
        params=LBMParams(alpha0=4.0, kBT=0.0, **_DEEP),
        init_radius=0.5, **_EQ32),
    "droplet-msd-eq": RunConfig(             # droplet MSD case, 64^3
        shape=(64, 64, 64), params=LBMParams(alpha0=4.0, kBT=0.0, **_DEEP),
        nsteps=20_000, plot_int=0, init="droplet", init_radius=0.2),
    "droplet-msd-fluct": RunConfig(          # its continuation, kBT=5e-5
        shape=(64, 64, 64), params=LBMParams(alpha0=4.0, kBT=5e-5,
                                             **_DEEP),
        nsteps=1_000_000, step_continue=20_000, plot_int=100,
        droplet_int=100, init="checkpoint"),
    "bench-256": RunConfig(                  # the 256^3 benchmark config
        shape=(256, 256, 256), params=LBMParams(alpha0=0.0, kBT=1e-5),
        nsteps=100, init="mixture"),
}


def preset(name: str) -> RunConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(_PRESETS)}"
        ) from None


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))
