#!/usr/bin/env python3
"""Times of the whole-domain K kernels and of kernel L at 256^3 on one
CUDA card: K1a (uncoupled, u8, on a perturbed mixture), K without a force
under general tau (``k1d_u``: tau_f 0.7, tau_g 0.6, clt4, the same
mixture) and, on a perturbed droplet (alpha0 = 1.5), the coupled pair's
kernel B (clt4), B with general tau (K1d; ``k1d_off`` with the noise
off), B with Box-Muller (without and with the ref operand, ``bm_ref``:
the state's densities rolled by (1, -1, 2)), K4 under general tau at
T = 2 (``k4_general`` on the mixture, ``k4_general_coupled`` on the
droplet: one launch of two steps), and on the alpha1 droplet (alpha0
1.2, alpha1 0.5, clt4) B-A1 and L (on the density
pre-pass's psi of the same state), B-A1 under general tau
(``b_a1_general``), and the same in their ext mode on the two blocks of
mesh (2, 1, 1) on the card (``l_ext``, ``b_a1_ext``,
``b_a1_general_ext``: a step's launches on both blocks); 20 launches
(steps) a run, best of 3
between ``torch.cuda.synchronize`` barriers, as ``chip_smoke.py`` times
them, and (``*_graph_ms``) replayed from a CUDA graph of the 20
launches, which leaves out the host's enqueue between them (the wrappers'
Python and ctypes cost, which bounds the eager time of a kernel shorter
than it; ``l_enqueue_us`` is L's, the host time of a call without a
barrier).  Beside each time, the SHA-256 of the kernel's output tensors
on its fixed input (one launch, word 1, step 0): two builds whose digests
agree compute the same bits.  Prints the card and one JSON line.
Arguments, if any, name the cases to run (``bm b_a1_general``); with
none, every case runs.

The package is whichever ``bflbm_tpu_torch`` the interpreter finds first,
so two checkouts are compared in one call by running it in turns:

    PYTHONPATH=build/parent python tools/kernel_times.py   # a parent tree
    PYTHONPATH=. python tools/kernel_times.py              # this tree
"""

import dataclasses
import hashlib
import json
import subprocess
import sys
import time

SHAPE = (256, 256, 256)
NREP = 20


def digest(*ts) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def graph_ms(run, calls):
    """Device ms a call of the `calls` launches run() makes, replayed from
    a CUDA graph of one run(): best of 3 replays between CUDA events.
    Written here, not imported, so that the tool also runs on trees whose
    package has no such helper."""
    import torch

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    best = None
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    return best / calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import bflbm_tpu_torch
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.state import init_state
    from bflbm_tpu_torch.utils.timing import time_steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    out = {"package": bflbm_tpu_torch.__file__}

    def ext_times(f, g, params, dist, key):
        """B-A1 (case `key`), and with case b_a1 L, on the two
        halo-extended blocks of mesh (2, 1, 1): digests of both blocks'
        outputs, ms a step (both blocks)."""
        mesh = mesh_lib.make_mesh((2, 1, 1), dev)
        pad = mesh.pads(fused_step.sd_depth(params))
        ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
        halo.exchange_halo(ss.blocks, mesh, pad)
        exts = halo.block_exts(mesh, SHAPE, pad)
        fgs = [(b[0], b[1]) for b in ss.blocks]
        psis = [fused_step.density_psi(fb, gb, params, ext=e)
                for (fb, gb), e in zip(fgs, exts)]
        laps = [fused_step.laplacian_psi(p, ext=e)
                for p, e in zip(psis, exts)]
        outs = [(torch.empty_like(fb), torch.empty_like(gb))
                for fb, gb in fgs]

        def k_run(i):
            for b, e in enumerate(exts):
                fused_step.launch_k(*fgs[b], 1, i, params, outs[b], psis[b],
                                    dist, lap=laps[b], ext=e)

        k_run(0)
        res = {key + "_ext_sha256": digest(*[e.region(t) for o, e in
                                             zip(outs, exts) for t in o])}
        runs = {}
        if key == "b_a1":
            res["l_ext_sha256"] = digest(*[e.region(lp, 2)
                                           for lp, e in zip(laps, exts)])

        def l_run():
            for _ in range(NREP):
                for p, lp, e in zip(psis, laps, exts):
                    fused_step.laplacian_psi(p, out=lp, ext=e)

        def b_run():
            for i in range(NREP):
                k_run(i)

        if key == "b_a1":
            runs["l_ext"] = l_run
        runs[key + "_ext"] = b_run
        for name, run in runs.items():
            res[name + "_ms"] = time_steps(run, cells, NREP)["best_s"] \
                / NREP * 1e3
            res[name + "_graph_ms"] = graph_ms(run, NREP)
        return res

    mix = LBMParams(kBT=1e-5)
    drop = LBMParams(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=1e-5)
    droplet = model.init_droplet(SHAPE, drop, radius=0.2, device="cpu")
    tau = dict(tau_f=0.7, tau_g=0.6)
    alpha1 = dataclasses.replace(drop, alpha0=1.2, alpha1=0.5, rho_lo=0.1)
    only = set(sys.argv[1:])
    # key -> (params, generator, base state, with the ref operand, T: 1
    # for the one-step kernel, T > 1 for a K4 launch of T steps)
    for key, params, dist, base, with_ref, T in (
            ("k1a", mix, "u8", None, False, 1),
            ("k1d_u", dataclasses.replace(mix, **tau), "clt4", None, False,
             1),
            ("k4_general", dataclasses.replace(mix, **tau), "clt4", None,
             False, 2),
            ("b", drop, "clt4", droplet, False, 1),
            ("k1d", dataclasses.replace(drop, **tau), "clt4", droplet, False,
             1),
            ("k1d_off", dataclasses.replace(drop, kBT=0.0, **tau), "u8",
             droplet, False, 1),
            ("k4_general_coupled", dataclasses.replace(drop, **tau), "clt4",
             droplet, False, 2),
            ("bm", drop, "bm", droplet, False, 1),
            ("bm_ref", drop, "bm", droplet, True, 1),
            ("b_a1", alpha1, "clt4", droplet, False, 1),
            ("b_a1_general", dataclasses.replace(alpha1, **tau), "clt4",
             droplet, False, 1)):
        if only and key not in only:
            continue
        f, g = model.perturbed_populations(SHAPE, 7, base=base, device=dev)
        fo, go = torch.empty_like(f), torch.empty_like(g)
        psi = (fused_step.density_psi(f, g, params)
               if fused_step.is_coupled(params) and T == 1 else None)
        lap = (fused_step.laplacian_psi(psi) if fused_step.has_alpha1(params)
               else None)
        ref = (torch.stack([f.sum(0), g.sum(0)]).roll((1, -1, 2), (1, 2, 3))
               .contiguous() if with_ref else None)

        def launch(i):
            if T > 1:
                fused_step.blocked_stream_collide(
                    f, g, [1 + s for s in range(T)], T * i, params, T,
                    out=(fo, go), noise_dist=dist, ref=ref)
            else:
                fused_step.launch_k(f, g, 1, i, params, (fo, go), psi, dist,
                                    ref, lap=lap)

        def run():
            for i in range(NREP):
                launch(i)

        launch(0)
        out[key + "_sha256"] = digest(fo, go)
        out[key + "_ms"] = time_steps(run, cells, NREP)["best_s"] / NREP * 1e3
        out[key + "_graph_ms"] = graph_ms(run, NREP)
        if lap is not None and key == "b_a1":
            out["l_sha256"] = digest(lap)

            def l_run():
                for _ in range(NREP):
                    fused_step.laplacian_psi(psi, out=lap)

            out["l_ms"] = time_steps(l_run, cells, NREP)["best_s"] \
                / NREP * 1e3
            out["l_graph_ms"] = graph_ms(l_run, NREP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l_run()
            out["l_enqueue_us"] = (time.perf_counter() - t0) / NREP * 1e6
            torch.cuda.synchronize()
        if lap is not None:
            out.update(ext_times(f, g, params, dist, key))
        del f, g, fo, go, psi, lap, ref
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
