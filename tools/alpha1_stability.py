#!/usr/bin/env python3
"""Stability of the alpha1 droplet configuration on the JAX package's jnp
path, on the CPU: the droplet-eq preset at 32^3 with alpha0 = 1.2,
kappa = 0.1, rho_lo = 0.1, rho_hi = 3.0, kBT = 1e-5 and clt4 hash noise,
500 steps, for each alpha1 given (default 0.5, 0.2, 0.1, 0.05), printing
finiteness and the density ranges every 100 steps.

    JAX_PLATFORMS=cpu python tools/alpha1_stability.py [alpha1 ...]

It chooses the alpha1 that bflbm_tpu_torch's chip_smoke.py runs at
256^3: the largest that stays finite.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
jax.config.update("jax_platforms", "cpu")

from bflbm_tpu.config import LBMParams  # noqa: E402
from bflbm_tpu.models import binary_fluid as model  # noqa: E402


def check(alpha1: float, steps: int = 500) -> bool:
    p = LBMParams(alpha0=1.2, alpha1=alpha1, kappa=0.1, rho_lo=0.1,
                  rho_hi=3.0, kBT=1e-5)
    st = model.init_droplet((32, 32, 32), p, dtype=jnp.float32, radius=0.2)
    one = jax.jit(lambda s: model.step(s, p, noise_source="hash",
                                       noise_dist="clt4")[0])
    for k in range(1, steps + 1):
        st = one(st)
        if k % 100 == 0:
            rho = np.asarray(st.f).sum(0)
            phi = np.asarray(st.g).sum(0)
            ok = bool(np.isfinite(rho).all() and np.isfinite(phi).all())
            print(f"alpha1 {alpha1} step {k}: finite {ok}, rho "
                  f"[{rho.min():.4f}, {rho.max():.4f}], phi "
                  f"[{phi.min():.4f}, {phi.max():.4f}]", flush=True)
            if not ok:
                return False
    return True


if __name__ == "__main__":
    for a1 in [float(v) for v in sys.argv[1:]] or [0.5, 0.2, 0.1, 0.05]:
        if check(a1):
            print(f"largest finite alpha1: {a1}")
            break
