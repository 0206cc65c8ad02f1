#!/usr/bin/env python3
"""Tiles of kernels L and B-A1 at 256^3 on one CUDA card: ms a launch of
the laplacian pre-pass (``csrc/laplacian_psi.cu``) and of the alpha1 K
kernel (the A1 build of ``csrc/fused_step.cu``, clt4) on each (ty, tz)
tile and x chunk of TILES x CHUNKS, on the alpha1 droplet one perturbed
step in (alpha0 1.2, alpha1 0.5, kappa 0.1, rho_lo 0.1, rho_hi 3); NREP
launches a run replayed from a CUDA graph (``utils.timing.graph_ms``: the
device's time, without the gaps the wrappers' host enqueue leaves between
L's short launches), and eager, best of 3 between ``torch.cuda.synchronize``
barriers, as ``chip_smoke.py`` times them.  Every tiling's output is
checked bitwise
against the first one's (a cell's arithmetic does not depend on the
tile).  Prints the card, a line a case and one JSON line; the fastest
(ty, tz, xc) of each kernel on the device is what
``fused_step._STENCIL_TILES`` should hold.

    PYTHONPATH=. python tools/stencil_tiles.py
"""

import json
import subprocess
import sys

SHAPE = (256, 256, 256)
NREP = 20
TILES = ((4, 32), (8, 32), (4, 64), (2, 128), (8, 16), (2, 64))
CHUNKS = (8, 16, 32, 64)
ALPHA1 = dict(alpha0=1.2, alpha1=0.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0,
              kBT=1e-5)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stencil_tiles: no CUDA device", file=sys.stderr)
        return 1
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.utils.timing import graph_ms, time_steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    params = LBMParams(**ALPHA1)
    droplet = model.init_droplet(SHAPE, params, radius=0.2, device="cpu")
    f, g = model.perturbed_populations(SHAPE, 7, base=droplet, device=dev)
    fo, go = torch.empty_like(f), torch.empty_like(g)
    psi = fused_step.density_psi(f, g, params)
    lap = torch.empty_like(psi)
    runs = {
        "l": lambda: fused_step.laplacian_psi(psi, out=lap),
        "b_a1": lambda i: fused_step.launch_k(f, g, 1, i, params, (fo, go),
                                              psi, "clt4", lap=lap),
    }
    out = {}
    first = {}
    fused_step.laplacian_psi(psi, out=lap)
    for kind in ("l", "b_a1"):
        saved = fused_step._STENCIL_TILES[kind]
        for ty, tz in TILES:
            for xc in CHUNKS:
                fused_step._STENCIL_TILES[kind] = (ty, tz, xc)
                if kind == "l":
                    runs["l"]()
                    got = (lap.clone(),)

                    def run():
                        for _ in range(NREP):
                            runs["l"]()
                else:
                    runs["b_a1"](0)
                    got = (fo.clone(), go.clone())

                    def run():
                        for i in range(NREP):
                            runs["b_a1"](i)
                torch.cuda.synchronize()
                same = True
                if kind in first:
                    same = all(torch.equal(a, b)
                               for a, b in zip(got, first[kind]))
                else:
                    first[kind] = got
                del got
                ms = graph_ms(run, NREP)
                eager = time_steps(run, cells, NREP)["best_s"] / NREP * 1e3
                smem = fused_step.stencil_smem_bytes(
                    (ty, tz), fused_step.stencil_fields(kind, params))
                key = f"{kind} {ty}x{tz} xc={xc}"
                out[key] = ms
                print(f"{key}: {ms:.4f} ms from a graph ({eager:.4f} "
                      f"eager), {smem} B of shared memory a block, bitwise "
                      f"the first tiling: {same}", flush=True)
                if not same:
                    print(f"stencil_tiles: {key} differs from the first "
                          "tiling", file=sys.stderr)
                    return 1
        fused_step._STENCIL_TILES[kind] = saved
        best = min((v, k) for k, v in out.items() if k.startswith(kind + " "))
        print(f"{kind} fastest: {best[1]} {best[0]:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
