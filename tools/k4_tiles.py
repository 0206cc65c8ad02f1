#!/usr/bin/env python3
"""Tiles and clusters of K4 at 256^3 on one CUDA card: ms a step of the
blocked kernel (``csrc/blocked_step.cu``) on each (y, z) sub-tile whose
shared memory fits a thread block, times each cluster shape (blocks along
y, z), at every (stencil depth, T) the port takes (uncoupled T = 2, 3, 4;
coupled T = 2, 3; alpha1 T = 2), with clt4 noise (u8 uncoupled), then
the three fastest pairs of each (depth, T) again in three modes (the
noise off, clt4 or u8, general tau), beside the one-step kernel K, the
pair A + B and the triple A + L + B-A1 on the same state (a perturbed
droplet with a force, a perturbed mixture without); NREP launches a run,
best of 3 between ``torch.cuda.synchronize`` barriers, as
``chip_smoke.py`` times them.  Prints the card and one JSON line; the
fastest pair per (depth, T) is what ``fused_step._BLOCKED_SECTIONS`` and
``fused_step._BLOCKED_CLUSTERS`` should hold.

    PYTHONPATH=. python tools/k4_tiles.py
"""

import dataclasses
import json
import subprocess
import sys

SHAPE = (256, 256, 256)
NREP = 6
CLUSTERS = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (4, 1))
# (stencil depth, T) -> candidate (y, z) sub-tiles
TILES = {
    (1, 2): ((8, 32), (4, 32), (8, 16)),
    (1, 3): ((8, 8), (4, 16), (4, 8)),
    (1, 4): ((4, 8), (2, 16), (4, 4)),
    (2, 2): ((8, 16), (4, 16), (8, 8)),
    (2, 3): ((4, 8), (4, 4), (2, 8)),
    (3, 2): ((4, 16), (8, 8), (4, 8)),
}
FORCE = {1: dict(kBT=1e-5),
         2: dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=1e-5),
         3: dict(alpha0=1.2, alpha1=0.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0,
                 kBT=1e-5)}
NOISE = {1: "u8", 2: "clt4", 3: "clt4"}
MODES = {"off": dict(kBT=0.0), "noise": {},
         "general": dict(tau_f=0.7, tau_g=0.6)}
DEPTH = {1: "uncoupled", 2: "coupled", 3: "alpha1"}


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
    for sd in (1, 2, 3):
        base = LBMParams(**FORCE[sd])
        if sd == 1:
            f, g = model.perturbed_populations(SHAPE, 7, device=dev)
        else:
            droplet = model.init_droplet(SHAPE, base, radius=0.2,
                                         device="cpu")
            f, g = model.perturbed_populations(SHAPE, 7, base=droplet,
                                               device=dev)
        fo, go = torch.empty_like(f), torch.empty_like(g)
        psi = torch.empty((2,) + SHAPE, dtype=f.dtype, device=dev)
        lap = torch.empty_like(psi) if sd == 3 else None
        dist = NOISE[sd]

        def step_ms(p, T, tile=None, cluster=None):
            if T == 1:
                def run():
                    for i in range(NREP):
                        fused_step.fused_stream_collide(
                            f, g, 1, i, p, out=(fo, go), noise_dist=dist,
                            psi=psi, lap=lap)
            else:
                fused_step._BLOCKED_SECTIONS[(sd, T)] = tile
                fused_step._BLOCKED_CLUSTERS[(sd, T)] = cluster

                def run():
                    for i in range(NREP):
                        fused_step.blocked_stream_collide(
                            f, g, [1] * T, i, p, T, out=(fo, go),
                            noise_dist=dist)
            return time_steps(run, cells, NREP)["best_s"] / NREP * 1e3 / T

        survey = {}
        for (d, T), tiles in TILES.items():
            if d != sd:
                continue
            for tile in tiles:
                if fused_step.blocked_smem_bytes(T, (1,) + tile, sd) \
                        > fused_step.SMEM_PER_BLOCK:
                    continue
                for cl in CLUSTERS:
                    if (cl[0] > 1 and tile[0] < sd) or \
                            (cl[1] > 1 and tile[1] < sd):
                        continue
                    ms = step_ms(base, T, tile, cl)
                    key = (f"{DEPTH[sd]} {NOISE[sd]} T={T} "
                           f"{tile[0]}x{tile[1]} cluster {cl[0]}x{cl[1]}")
                    survey[(T, tile, cl)] = ms
                    out[key] = ms
                    print(f"{key}: {ms:.4f} ms a step", flush=True)
        for mode, kw in MODES.items():
            p = dataclasses.replace(base, **kw)
            out[f"{DEPTH[sd]} {mode} T=1"] = step_ms(p, 1)
            print(f"{DEPTH[sd]} {mode} T=1 (one-step "
                  f"{['K', 'A + B', 'A + L + B-A1'][sd - 1]}): "
                  f"{out[f'{DEPTH[sd]} {mode} T=1']:.4f} ms a step",
                  flush=True)
            for T in sorted({t for t, _, _ in survey}):
                best = sorted((ms, tile, cl) for (t, tile, cl), ms
                              in survey.items() if t == T)[:3]
                for _, tile, cl in best:
                    ms = step_ms(p, T, tile, cl)
                    key = (f"{DEPTH[sd]} {mode} T={T} {tile[0]}x{tile[1]} "
                           f"cluster {cl[0]}x{cl[1]}")
                    out[key] = ms
                    print(f"{key}: {ms:.4f} ms a step", flush=True)
        del f, g, fo, go, psi, lap
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
