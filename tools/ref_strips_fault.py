#!/usr/bin/env python3
"""The ref / strips K4 disagreement of ``tests/test_torch_gpu.py::
test_blocked_window_and_strip_launches[shape1-strips ...-ref-...]`` on one
CUDA card: the 32 x 80 x 72 droplet (rho_lo = 0, kBT = 1e-5, seed 43)
with USE_REF_STATE amplitudes 1 + 0.1 U (seed 44), words 7919 k - 3 from
step 40, clt4.

1. Every block of meshes (2, 1, 1) and (2, 2, 1), T = 2 and 3: the strip
   layout's serial K4 launch against its plain sweep, the cells over 2e-5
   counted and located (global coordinates).
2. The whole domain, three one-step launches against three plain steps:
   the cells over 2e-5 after each, the plain step on the kernel's own
   input against the kernel, and the streamed densities of both inputs at
   those cells beside the |rho| > eps guard.
3. ``--write PATH``: the kernel's post-collide populations after step 1 on
   the 3 x 3 x 3 cells around the first cell that step 2 puts over 2e-5
   (everything step 2 pulls there) and its step-2 output at that cell, as
   JSON: the card's side of ``tests/test_torch_ref_strips_jax.py``.

    PYTHONPATH=. python tools/ref_strips_fault.py [--write PATH]
"""

import argparse
import json
import subprocess
import sys

import numpy as np

SHAPE = (32, 80, 72)
TOL = 2e-5


def case(dev):
    """(params, f, g, ref, words, step0) of the failing cases."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.models import binary_fluid as model

    params = LBMParams(kBT=1e-5)
    base = model.init_droplet(SHAPE, params, device="cpu", radius=0.3)
    f, g = model.perturbed_populations(SHAPE, 43, base=base, device=dev)
    ref = (1.0 + 0.1 * torch.rand((2,) + SHAPE, generator=torch.Generator()
                                  .manual_seed(44))).to(dev)
    return params, f, g, ref, [7919 * k - 3 for k in range(3)], 40


def over(a, b):
    """Max |a - b| over both species and the cells where it exceeds
    TOL, as [x, y, z] lists."""
    d = np.maximum(np.abs(a[0] - b[0]).max(0), np.abs(a[1] - b[1]).max(0))
    return float(d.max()), np.argwhere(d > TOL).tolist()


def main(argv) -> int:
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import blocked, stream
    from bflbm_tpu_torch.ops.moments import density
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.state import init_state

    ap = argparse.ArgumentParser()
    ap.add_argument("--write", help="JSON file for the kernel's cells")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ref_strips_fault: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    params, f0, g0, ref, words, step0 = case(dev)

    def np2(pair):
        return [t.cpu().numpy() for t in pair]

    for mshape in ((2, 1, 1), (2, 2, 1)):
        for T in (2, 3):
            mesh = mesh_lib.make_mesh(mshape, dev)
            lay = kernel_par.layout(mesh, SHAPE, params, block=T,
                                    y_exchange="strips")
            ss = mesh_lib.shard_state(init_state(f0, g0, 0), mesh, lay.pad)
            halo.exchange_halo(ss.blocks, mesh, lay.pad)
            refs = mesh_lib.shard_field(ref, mesh, lay.pad)
            halo.exchange_halo(refs, mesh, lay.pad)
            exts = halo.block_exts(mesh, SHAPE, lay.pad)
            for b, (blk, ext, r) in enumerate(zip(ss.blocks, exts, refs)):
                k = fused_step.blocked_stream_collide(
                    blk[0], blk[1], words[:T], step0, params, T,
                    noise_dist="clt4", ref=r, ext=ext)
                box = ext.bounds(blk.shape)
                tile = fused_step.launch_tile(T, [hi - lo for lo, hi in box])
                p = blocked.blocked_sweep_reference(
                    blk[0], blk[1], words[:T], step0, params, T, tile,
                    "clt4", r, ext)
                mx, cells = over(np2([ext.region(t) for t in k]), np2(p))
                cells = [[c + o for c, o in zip(cell, ext.origin)]
                         for cell in cells]
                print(f"{mshape} T = {T} block {b}: max |K4 - plain| "
                      f"{mx:.4e}, {len(cells)} cells over {TOL}: "
                      f"{cells[:20]}", flush=True)

    kern, plain = [(f0, g0)], [(f0, g0)]
    for s in range(3):
        kern.append(fused_step.fused_stream_collide(
            *kern[-1], words[s], step0 + s, params, ref=ref,
            noise_dist="clt4"))
        plain.append(fused_step.k_step_reference(
            *plain[-1], words[s], step0 + s, params, "clt4", ref))
    first = None
    for s in range(1, 4):
        mx, cells = over(np2(kern[s]), np2(plain[s]))
        own = fused_step.k_step_reference(*kern[s - 1], words[s - 1],
                                          step0 + s - 1, params, "clt4", ref)
        own_mx, _ = over(np2(kern[s]), np2(own))
        print(f"whole domain, step {s}: max |K - plain| {mx:.4e}, "
              f"{len(cells)} cells over {TOL}: {cells[:20]}; plain on the "
              f"kernel's input: max |K - plain| {own_mx:.4e}", flush=True)
        rk = density(stream.stream(kern[s - 1][0]))
        rp = density(stream.stream(plain[s - 1][0]))
        eps = params.div_eps
        for c in cells[:5]:
            a, b = float(rk[tuple(c)]), float(rp[tuple(c)])
            print(f"  cell {c}: streamed rho of the input, kernel {a!r} "
                  f"(|rho| > eps: {abs(a) > eps}), plain {b!r} "
                  f"({abs(b) > eps})", flush=True)
        if cells and first is None:
            first = (s, cells[0])
    if args.write and first is not None:
        s, (x, y, z) = first
        cube = (slice(None), slice(x - 1, x + 2), slice(y - 1, y + 2),
                slice(z - 1, z + 2))
        k_in, k_out = np2(kern[s - 1]), np2(kern[s])
        rec = {"cell": [x, y, z], "step": s,
               "input_f": k_in[0][cube].tolist(),
               "input_g": k_in[1][cube].tolist(),
               "output_f": k_out[0][:, x, y, z].tolist(),
               "output_g": k_out[1][:, x, y, z].tolist()}
        with open(args.write, "w") as fh:
            json.dump(rec, fh)
        print(f"wrote {args.write}: the kernel's step {s - 1} output on the "
              f"cells around {[x, y, z]} and its step {s} output there",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
