"""Lattice <-> physical unit system (``bflbm_tpu/utils/units.py``).

Reference: ``system_unit.ipynb`` cell 0 — the pinned unit system of the
droplet-diffusion comparison against Bell et al.:

    dx = 1.613e-9 m,  dt = 0.250e-12 s,  dm = 4.196e-24 kg
    rho = 1 lbu  <-> 1e3 kg/m^3
    eta = 0.096 lbu <-> 1e-2 Pa s
    R = 6.2 dx <-> 10 nm

plus the Ohnesorge number and the Stokes-Einstein conversion that quote
D in physical units (xdg_msd_calc.ipynb).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class UnitSystem:
    dx: float = 1.613e-9    # m per lattice spacing
    dt: float = 0.250e-12   # s per time step
    dm: float = 4.196e-24   # kg per lattice mass unit

    @property
    def density_si(self) -> float:
        """kg/m^3 per lbu density."""
        return self.dm / self.dx ** 3

    @property
    def velocity_si(self) -> float:
        return self.dx / self.dt

    @property
    def viscosity_si(self) -> float:
        """Pa s per lbu dynamic viscosity (dm/(dx dt))."""
        return self.dm / (self.dx * self.dt)

    @property
    def surface_tension_si(self) -> float:
        """N/m per lbu surface tension (dm/dt^2)."""
        return self.dm / self.dt ** 2

    @property
    def diffusion_si(self) -> float:
        """m^2/s per lbu diffusion coefficient."""
        return self.dx ** 2 / self.dt

    @property
    def energy_si(self) -> float:
        return self.dm * self.dx ** 2 / self.dt ** 2

    def stokes_si(self, d_lbu: float) -> float:
        """D in Stokes (cm^2/s = 1e-4 m^2/s)."""
        return d_lbu * self.diffusion_si * 1e4


DEFAULT_UNITS = UnitSystem()


def ohnesorge(eta: float, rho: float, gamma: float, radius: float) -> float:
    """Oh = eta / sqrt(rho gamma R) (any consistent units); the reference
    pins Oh = 1.231 for its droplet case (system_unit.ipynb)."""
    return eta / np.sqrt(rho * gamma * radius)
