from . import (  # noqa: F401
    correlation, droplet, droplet_ref_fit, free_energy, interface,
    marching_cubes, msd, stats, structfact)
