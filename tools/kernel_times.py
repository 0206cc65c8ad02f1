#!/usr/bin/env python3
"""Times of the whole-domain K kernels at 256^3 on one CUDA card: K1a
(uncoupled, u8, on a perturbed mixture) and, on a perturbed droplet
(alpha0 = 1.5), the coupled pair's kernel B (clt4), B with general tau
(K1d, tau_f 0.7, tau_g 0.6), B with Box-Muller and B-A1 (alpha0 1.2,
alpha1 0.5, clt4), 20 launches a run, best of 3 between
``torch.cuda.synchronize`` barriers, as ``chip_smoke.py`` times them.
Prints the card and one JSON line.

The package is whichever ``bflbm_tpu_torch`` the interpreter finds first,
so two checkouts are compared in one call by running it in turns:

    PYTHONPATH=build/parent python tools/kernel_times.py   # a parent tree
    PYTHONPATH=. python tools/kernel_times.py              # this tree
"""

import dataclasses
import json
import subprocess
import sys

SHAPE = (256, 256, 256)
NREP = 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import bflbm_tpu_torch
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.utils.timing import time_steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    out = {"package": bflbm_tpu_torch.__file__}
    mix = LBMParams(kBT=1e-5)
    drop = LBMParams(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=1e-5)
    droplet = model.init_droplet(SHAPE, drop, radius=0.2, device="cpu")
    for key, params, dist, base in (
            ("k1a", mix, "u8", None),
            ("b", drop, "clt4", droplet),
            ("k1d", dataclasses.replace(drop, tau_f=0.7, tau_g=0.6), "clt4",
             droplet),
            ("bm", drop, "bm", droplet),
            ("b_a1", dataclasses.replace(drop, alpha0=1.2, alpha1=0.5,
                                         rho_lo=0.1), "clt4", droplet)):
        f, g = model.perturbed_populations(SHAPE, 7, base=base, device=dev)
        fo, go = torch.empty_like(f), torch.empty_like(g)
        psi = (fused_step.density_psi(f, g, params)
               if fused_step.is_coupled(params) else None)
        lap = (fused_step.laplacian_psi(psi) if fused_step.has_alpha1(params)
               else None)

        def run():
            for i in range(NREP):
                fused_step.launch_k(f, g, 1, i, params, (fo, go), psi, dist,
                                    lap=lap)

        out[key + "_ms"] = time_steps(run, cells, NREP)["best_s"] / NREP * 1e3
        del f, g, fo, go, psi, lap
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
