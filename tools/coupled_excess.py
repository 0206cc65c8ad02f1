#!/usr/bin/env python3
"""The arms that split the coupled path's long-wavelength excess on the
card (capillary gamma low, droplet diffusion high against the JAX
package's runs) into its causes: the restore, the hash stream and the
kernels' arithmetic.

Arms (the protocols of ``python -m bflbm_tpu_torch.acceptance``, run
through ``acceptance.run_capillary_one`` / ``run_e_one``, seeds
``seed_base + 7919 i`` as phase c-ens and e take them):

  k-off      c-ens on the kernel session (hash stream, clt4) without the
             mass restore
  p-bulk-c   c-ens on the plain engine with the bulk source (exact
             normals), no restore: the JAX package's jnp protocol
  p-bulk-e   e at 32^3 on the plain engine with the bulk source
  p-hash-c   c-ens on the plain engine with the hash stream (clt4)
  s0         b-kernel (the 64 x 64 x 128 mixture on the kernel session,
             --dist clt4 or u8): S(k) by |k| shell, the four lowest
             shells on their own beside the all-k mean
  plain-us   the plain engine's us a step on the 8 x 256 x 64 interface
             and the 32^3 droplet: eager, from CUDA graphs, in --threads
             threads on their own streams; the graph replay against the
             eager chunk (bitwise)

Prints one JSON line a run and one for the arm (the card's name and
power limit in it).  Arms named together run in one process, an arm a
thread; a plain-engine arm runs its runs in threads, each on a CUDA
stream of its own, so that the card overlaps their small kernels
(processes would take turns on it); the kernel session is host-bound
and runs its runs one after another.

    PYTHONPATH=. python tools/coupled_excess.py p-bulk-c p-bulk-e \\
        --out /tmp/excess
    PYTHONPATH=. python tools/coupled_excess.py p-bulk-c:1:3 p-hash-c:0:2
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bflbm_tpu_torch import acceptance
from bflbm_tpu_torch.config import preset

# arm -> (protocol, run options)
ARMS = {
    "k-off": ("c-ens", dict(engine="auto", noise_source="threefry",
                            mass_restore_int=0)),
    "p-bulk-c": ("c-ens", dict(engine="jnp", noise_source="threefry")),
    "p-bulk-e": ("e", dict(engine="jnp", noise_source="threefry")),
    "p-hash-c": ("c-ens", dict(engine="jnp", noise_source="hash")),
    "s0": ("b-kernel", {}),
    "plain-us": ("timing", {}),
}
_print_lock = threading.Lock()


def emit(rec):
    with _print_lock:
        print(json.dumps(rec), flush=True)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def in_threads(fn, items, threads, device):
    """fn(item) for every item, in `threads` threads, each call on a
    fresh CUDA stream; results in order."""
    def one(item):
        if device.type != "cuda":
            return fn(item)
        with torch.cuda.stream(torch.cuda.Stream(device)):
            return fn(item)

    if threads <= 1:
        return [one(i) for i in items]
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(one, items))


def _mean_stderr(x):
    return acceptance._mean_stderr(x)


def arm_c_ens(args, device, opts):
    steps = args.steps or 800_000
    out_eq = acceptance._interface_eq(args, device)

    def one(i):
        seed = args.seed_base + 7919 * i
        out_dir = f"{args.out}/{args.arm}-{args.seed_base}-{i}"
        heights, wall = acceptance.run_capillary_one(
            out_eq, out_dir, steps, seed, True, device, **opts)
        g, per_mode, n_frames = acceptance.analyse_capillary(heights, steps,
                                                             out_dir)
        rec = {"arm": args.arm, "run": i, "seed": seed, "gamma": round(g, 6),
               **per_mode, "n_frames": n_frames, "wall_s": round(wall, 1),
               "us_per_step": round(wall / steps * 1e6, 2)}
        emit(rec)
        return rec

    t0 = time.time()
    runs = in_threads(one, range(args.run_start, args.run_start + args.runs),
                      args.threads, device)
    wall = time.time() - t0
    mean, se = _mean_stderr([r["gamma"] for r in runs])
    mavg, seavg = _mean_stderr([r["gamma_sliceavg"] for r in runs])
    return {"gamma_mean": round(mean, 6), "gamma_stderr": round(se, 6),
            "gamma_sliceavg_mean": round(mavg, 6),
            "gamma_sliceavg_stderr": round(seavg, 6),
            "gamma_scatter": round(float(np.std([r["gamma"] for r in runs],
                                                ddof=1)), 6)
            if len(runs) > 1 else None,
            "steps": steps, "runs": runs, "wall_s": round(wall, 1),
            "us_per_step_arm": round(wall / (steps * len(runs)) * 1e6, 2)}


def eq_droplet(args, device, n=32):
    """Phase e's 20k-step equilibration at n^3 (once); its directory."""
    out_eq = f"{args.out}/droplet-msd-eq{n}"
    acceptance._ensure_eq(preset("droplet-msd-eq").replace(
        shape=(n, n, n), out_dir=out_eq), device, 20_000)
    return out_eq


def arm_e(args, device, opts):
    n = 32
    steps = args.steps or 1_000_000
    out_eq = eq_droplet(args, device, n)

    def one(i):
        cfg = preset("droplet-msd-fluct").replace(
            shape=(n, n, n), nsteps=steps,
            checkpoint_path=f"{out_eq}/checkpoint0020000",
            plot_save=False, print_int=steps // 10,
            seed=args.seed_base + 7919 * i, reseed=True,
            out_dir=f"{args.out}/{args.arm}-{i}")
        t0 = time.time()
        d_fit, r_mean = acceptance.analyse_msd_rows(
            acceptance.run_e_one(cfg, n, device, **opts), cfg.shape)
        wall = time.time() - t0
        rec = {"arm": args.arm, "run": i, "seed": cfg.seed, "D_fit": d_fit,
               "R": round(r_mean, 4), "wall_s": round(wall, 1),
               "us_per_step": round(wall / steps * 1e6, 2)}
        emit(rec)
        return rec

    t0 = time.time()
    runs = in_threads(one, range(args.run_start, args.run_start + args.runs),
                      args.threads, device)
    wall = time.time() - t0
    d_mean, d_se = _mean_stderr([r["D_fit"] for r in runs])
    r_fin = [r["R"] for r in runs if np.isfinite(r["R"])]
    eta = 1.0 * (1.0 / 3.0) * (1.0 - 0.5)
    d_se_theory = (acceptance.msd_obs.stokes_einstein(
        float(np.mean(r_fin)), float(n), eta, 5e-5) if r_fin else None)
    return {"D_fit_mean": d_mean, "D_fit_stderr": d_se,
            "D_se": d_se_theory, "steps": steps, "runs": runs,
            "wall_s": round(wall, 1),
            "us_per_step_arm": round(wall / (steps * len(runs)) * 1e6, 2)}


def shells(sk: np.ndarray, shape, nshell: int = 4):
    """Shell index of every k of an (X, Y, Z) spectrum (unshifted):
    round(|k| / (2 pi / max(shape))); returns (index array, the lowest
    `nshell` nonzero indices)."""
    lmax = max(shape)
    ks = [np.fft.fftfreq(n, 1.0 / n) * (lmax / n) for n in shape]
    mag = np.sqrt(ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
                  + ks[2][None, None, :] ** 2)
    idx = np.rint(mag).astype(int)
    return idx, list(range(1, nshell + 1))


def arm_s0(args, device, opts):
    steps = args.steps or 200_000
    ns = argparse.Namespace(steps=steps, out=args.out,
                            noise_dist=args.dist,
                            seed_base=acceptance.DEFAULT_SEED)
    cfg, wall = acceptance.run_b(ns, device, kernel=True)
    base = acceptance.analyse_b(cfg.out_dir, device)
    f = sorted(p for p in os.listdir(cfg.out_dir)
               if p.startswith("structfact"))[-1]
    with np.load(os.path.join(cfg.out_dir, f), allow_pickle=True) as d:
        sk = np.fft.ifftshift(np.real(d["s_k"]), axes=(-3, -2, -1))
        names = [str(n) for n in d["names"]]
    idx, low = shells(sk[0], cfg.shape)
    by_shell = {}
    for p, name in enumerate(names):
        if name not in acceptance.SK_NORM:
            continue
        norm = acceptance.SK_NORM[name]
        row = {f"shell{s}": round(float(sk[p][idx == s].mean() / norm), 5)
               for s in low}
        row["all_k"] = base[name]
        by_shell[name] = row
    return {"dist": args.dist, "steps": steps, "sf_frames":
            int(cfg.sf_window // cfg.sf_every), "wall_s": round(wall, 1),
            "us_per_step": round(wall / steps * 1e6, 2),
            "shell_vectors": {f"shell{s}": int((idx == s).sum())
                              for s in low},
            "worst_abs_dev_all_k": base["worst_abs_dev"],
            "by_shell": by_shell}


def _timing_case(name, device, steps, threads):
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.models.plain_session import (GRAPH_STEPS,
                                                      PlainSession)
    from bflbm_tpu_torch.state import generator_from_state

    if name == "interface":
        cfg = preset("interface-fluct")
        init = model.init_stripe(cfg.shape, cfg.params, device=device)
    else:
        cfg = preset("droplet-msd-fluct").replace(shape=(32, 32, 32))
        init = model.init_droplet(cfg.shape, cfg.params, radius=0.2,
                                  device=device)
    p = cfg.params

    def fresh():
        return init.replace(f=init.f.clone(), g=init.g.clone(),
                            gen=generator_from_state(init.gen.get_state()))

    def timed(sess, n):
        st = sess.advance(sess.enter(fresh()),
                          GRAPH_STEPS if sess.graph else 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sess.advance(st, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6, st

    out = {"shape": list(cfg.shape)}
    eager = PlainSession(p, cfg.shape, device=device, graph=False)
    out["eager_us"], _ = timed(eager, 50)
    graph = PlainSession(p, cfg.shape, device=device)
    out["graph_us"], _ = timed(graph, steps)
    # the replay against the eager chunk, from one state and one word
    # stream: 2 chunks of 10 steps and a remainder of 3
    a = eager.advance(eager.enter(fresh()), 23)
    b = graph.exit(graph.advance(graph.enter(fresh()), 23))
    out["graph_bitwise"] = bool(torch.equal(a.f, b.f)
                                and torch.equal(a.g, b.g))
    out["graph_max_abs"] = float((a.f - b.f).abs().max())

    start = threading.Barrier(threads)

    def threaded(_):
        # captured and warm in every thread before the clocks start
        s = PlainSession(p, cfg.shape, device=device)
        st = s.advance(s.enter(fresh()), GRAPH_STEPS)
        torch.cuda.current_stream().synchronize()
        start.wait()
        t0 = time.perf_counter()
        s.advance(st, steps)
        torch.cuda.current_stream().synchronize()
        return time.perf_counter() - t0

    walls = in_threads(threaded, range(threads), threads, device)
    out[f"graph_{threads}threads_us_per_step_each"] = [
        round(w / steps * 1e6, 2) for w in walls]
    out[f"graph_{threads}threads_us_per_step_aggregate"] = round(
        max(walls) / (steps * threads) * 1e6, 2)
    return out


def arm_timing(args, device, opts):
    return {name: _timing_case(name, device, args.steps or 500, args.threads)
            for name in ("interface", "droplet32")}


def parse_arm(text):
    """"name[:start:runs]" -> (name, first run index or None, runs or
    None)."""
    name, *rest = text.split(":")
    if name not in ARMS or len(rest) not in (0, 2):
        raise argparse.ArgumentTypeError(
            f"{text!r}: an arm of {list(ARMS)}, optionally :start:runs")
    return (name, *(int(v) for v in rest)) if rest else (name, None, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("arms", nargs="+", type=parse_arm,
                    help="arms to run, each name[:start:runs] (runs i = "
                    "start .. start + runs - 1); several run together in "
                    "one process, an arm a thread")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a run (default: the protocol's: c-ens "
                    "800,000, e 1,000,000, b-kernel 200,000)")
    ap.add_argument("--run-start", type=int, default=0,
                    help="the first run's index i (seed seed_base + 7919 i)")
    ap.add_argument("--threads", type=int, default=None,
                    help="threads an arm (default: one a run on the plain "
                    "engine, one on the kernel session)")
    ap.add_argument("--seed-base", type=int, default=acceptance.DEFAULT_SEED)
    ap.add_argument("--dist", default="clt4", choices=["clt4", "u8"],
                    help="s0: the hash stream's generator")
    ap.add_argument("--out", default="out/excess")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    jobs = []
    for name, start, runs in args.arms:
        protocol, opts = ARMS[name]
        sub = dict(vars(args), arm=name)
        if start is not None:
            sub.update(run_start=start, runs=runs)
        if sub["threads"] is None:
            sub["threads"] = (sub["runs"] if opts.get("engine") == "jnp"
                              else 1)
        jobs.append((argparse.Namespace(**sub), protocol, opts))
    engines = {opts.get("engine", "auto") for _, _, opts in jobs}
    if len(jobs) > 1 and engines != {"jnp"}:
        raise SystemExit("name several arms together only on the plain "
                         "engine: a kernel session synchronizes the whole "
                         "device, which breaks a CUDA graph capture in "
                         "another thread")
    # the deterministic equilibrations first: a kernel session
    # synchronizes the whole device, which would break a CUDA graph
    # capture in another thread
    if any(p == "c-ens" for _, p, _ in jobs):
        acceptance._interface_eq(args, device)
    if any(p == "e" for _, p, _ in jobs):
        eq_droplet(args, device)
    return all(in_threads(lambda job: run_arm(*job, device), jobs, len(jobs),
                          torch.device("cpu")))


def run_arm(args, protocol, opts, device):
    fn = {"c-ens": arm_c_ens, "e": arm_e, "b-kernel": arm_s0,
          "timing": arm_timing}[protocol]
    t0 = time.time()
    res = fn(args, device, opts)
    rec = {"arm": args.arm, "protocol": protocol, **opts,
           "n_runs": args.runs if protocol in ("c-ens", "e") else 1,
           "run_start": args.run_start, "threads": args.threads,
           "seed_base": args.seed_base, **res,
           "arm_wall_s": round(time.time() - t0, 1), "card": card()}
    emit(rec)
    return rec


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
