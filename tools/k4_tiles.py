#!/usr/bin/env python3
"""Tiles of K4 with a force at 256^3 on one CUDA card: ms a step of the
blocked kernel (``csrc/blocked_step.cu``) on each (y, z) cross-section
whose shared memory fits a thread block, at every (stencil depth, T) the
port takes with a force (coupled T = 2, 3; alpha1 T = 2), in three modes
(the noise off, clt4, general tau with clt4), beside the one-step pair
A + B (triple A + L + B-A1) on the same perturbed droplet; NREP launches
a run, best of 3 between ``torch.cuda.synchronize`` barriers, as
``chip_smoke.py`` times them.  Prints the card and one JSON line; the
fastest tile per (depth, T) is what ``fused_step._BLOCKED_SECTIONS``
should hold.

    PYTHONPATH=. python tools/k4_tiles.py
"""

import dataclasses
import json
import subprocess
import sys

SHAPE = (256, 256, 256)
NREP = 10
# (depth, T) -> candidate (y, z) cross-sections
TILES = {
    ("coupled", 2): ((8, 16), (8, 8), (4, 16), (4, 32), (16, 8), (4, 8)),
    ("coupled", 3): ((4, 8), (4, 4), (8, 4), (2, 16), (2, 8)),
    ("alpha1", 2): ((8, 8), (4, 8), (4, 16), (8, 4), (4, 4)),
}
FORCE = {"coupled": dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0,
                         kBT=1e-5),
         "alpha1": dict(alpha0=1.2, alpha1=0.5, kappa=0.1, rho_lo=0.1,
                        rho_hi=3.0, kBT=1e-5)}
MODES = {"off": (dict(kBT=0.0), "u8"), "clt4": ({}, "clt4"),
         "general": (dict(tau_f=0.7, tau_g=0.6), "clt4")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_tiles: no CUDA device", file=sys.stderr)
        return 1
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.utils.timing import time_steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    out = {}
    for depth in ("coupled", "alpha1"):
        base = LBMParams(**FORCE[depth])
        sd = fused_step.sd_depth(base)
        droplet = model.init_droplet(SHAPE, base, radius=0.2, device="cpu")
        f, g = model.perturbed_populations(SHAPE, 7, base=droplet,
                                           device=dev)
        fo, go = torch.empty_like(f), torch.empty_like(g)
        psi = torch.empty((2,) + SHAPE, dtype=f.dtype, device=dev)
        lap = torch.empty_like(psi) if sd == 3 else None
        for mode, (kw, dist) in MODES.items():
            p = dataclasses.replace(base, **kw)

            def one_step():
                for i in range(NREP):
                    fused_step.fused_stream_collide(
                        f, g, 1, i, p, out=(fo, go), noise_dist=dist,
                        psi=psi, lap=lap)

            out[f"{depth} {mode} T=1"] = time_steps(
                one_step, cells, NREP)["best_s"] / NREP * 1e3
            for (d, T), tiles in TILES.items():
                if d != depth:
                    continue
                for tile in tiles:
                    need = fused_step.blocked_smem_bytes(T, (1,) + tile, sd)
                    if need > fused_step.SMEM_PER_BLOCK:
                        continue
                    fused_step._BLOCKED_SECTIONS[(sd, T)] = tile

                    def sweeps(T=T):
                        for i in range(NREP):
                            fused_step.blocked_stream_collide(
                                f, g, [1] * T, i, p, T, out=(fo, go),
                                noise_dist=dist)

                    ms = time_steps(sweeps, cells, NREP)["best_s"] / NREP
                    out[f"{depth} {mode} T={T} {tile[0]}x{tile[1]}"] = \
                        ms * 1e3 / T
        del f, g, fo, go, psi, lap
        torch.cuda.empty_cache()
    for k, v in out.items():
        print(f"{k}: {v:.4f} ms a step", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
