"""Offline analysis CLI of the port (``bflbm_tpu/analysis.py``): the
replacement for the reference's notebook suite (Mixture /
Flat_Interface / Surface_Tension / Droplet_Fluctuation / xdg_msd_calc).
It reads run output directories (plt* frames, structfact*.npz,
noise*.npz, metrics.jsonl, or the last checkpoint of a frame-less run)
and prints JSON results, with the JAX CLI's subcommands, flags and keys.

    python -m bflbm_tpu_torch.analysis sk        --dir out/fluct [--kBT 1e-5]
    python -m bflbm_tpu_torch.analysis interface --dir out/iface --kBT 1e-5
    python -m bflbm_tpu_torch.analysis droplet   --dir out/drop  --alpha0 1.5
    python -m bflbm_tpu_torch.analysis msd       --dir out/drop  --kBT 1e-5
    python -m bflbm_tpu_torch.analysis laplace   --dirs out/r20 out/r25 ...
    python -m bflbm_tpu_torch.analysis noise     --dir out/fluct --kBT 1e-5
    python -m bflbm_tpu_torch.analysis convergence --dir out/eq --comp rho
    python -m bflbm_tpu_torch.analysis radius    --dir out/drop
    python -m bflbm_tpu_torch.analysis theory    --alpha0 1.5

Every subcommand takes ``--device`` (default ``cuda``): the fields go to
that device and the fieldwise work runs there, in float64.  Without a
CUDA device the CLI raises unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from .io import fields as fields_io
from .observables import droplet as drop_obs
from .observables import free_energy, interface as iface_obs, msd as msd_obs
from .observables import structfact as sf_lib

CS2 = 1.0 / 3.0
DENSITIES = ("rho", "phi")


def resolve_device(name: str) -> torch.device:
    """`name` as a torch.device; "cuda" without a card raises (the CLI
    never computes on the host unless asked to)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the analysis runs on the card "
                           "by default; pass --device cpu to run it on "
                           "the host")
    return device


def _frames(out_dir: str) -> List[str]:
    from .io import amrex

    fr = sorted(glob.glob(os.path.join(out_dir, "plt*.npz"))
                + glob.glob(os.path.join(out_dir, "plt*.bflbm"))
                + glob.glob(os.path.join(out_dir, "plt*.h5"))
                + [d for d in glob.glob(os.path.join(out_dir, "plt*"))
                   if amrex.is_plotfile(d)])
    if not fr:
        # frame-less runs (plot_int=0): the final checkpoint, its
        # densities summed in _read_any
        ck = sorted(glob.glob(os.path.join(out_dir, "checkpoint*.npz")))
        ck = [c for c in ck if "abort" not in os.path.basename(c)]
        if ck:
            return [ck[-1]]
        raise FileNotFoundError(f"no plt* frames in {out_dir}")
    return fr


def _read_any(path: str, device, names: Sequence[str] = DENSITIES) -> Dict:
    """The named fields of a frame as tensors on `device`, with its step;
    a checkpoint gives rho and phi as its population sums, added i = 0..18
    in the checkpoint's dtype as numpy adds them."""
    from .ops.moments import density

    if os.path.basename(path).startswith("checkpoint"):
        with np.load(path) as d:
            pops = {"rho": d["f"], "phi": d["g"]}
            step = d["step"]
            return {"step": step, **{
                n: density(torch.as_tensor(pops[n], device=device))
                for n in names}}
    frame = fields_io.read_frame(path, names)
    return {k: (v if k == "step" else torch.as_tensor(v, device=device))
            for k, v in frame.items()}


def _load_sf(out_dir: str):
    sfs = sorted(glob.glob(os.path.join(out_dir, "structfact*.npz")))
    if not sfs:
        return None
    with np.load(sfs[-1], allow_pickle=True) as d:
        return {"s_k": d["s_k"], "names": [str(n) for n in d["names"]]}


def cmd_sk(args) -> Dict:
    """Equilibrium structure factors: flatness of S_rho/(kBT/cs2) etc.
    (Mixture.ipynb cell 2 normalizations)."""
    sf = _load_sf(args.dir)
    out = {}
    if sf is not None:
        names = sf["names"]
        sk = np.fft.ifftshift(sf["s_k"], axes=(-3, -2, -1))
        norm = {"rho*rho": args.kBT / CS2, "phi*phi": args.kBT / CS2,
                "ufx*ufx": args.kBT, "ufy*ufy": args.kBT,
                "ufz*ufz": args.kBT,
                "ubx*ubx": args.kBT / 2.0, "uby*uby": args.kBT / 2.0,
                "ubz*ubz": args.kBT / 2.0}
        for p, name in enumerate(names):
            if name not in norm:
                continue
            k, s = sf_lib.radial_average(
                torch.as_tensor(np.real(sk[p]), device=args.device))
            ratio = s / norm[name]
            out[name] = {
                "mean_ratio": float(np.mean(ratio)),
                "std_ratio": float(np.std(ratio)),
            }
    else:
        # recompute from frames (Debug.ipynb recipe)
        frames = _frames(args.dir)[args.skip:]
        acc = None
        for f in frames:
            p = sf_lib.spectrum(_read_any(f, args.device, ("rho",))["rho"])
            acc = p if acc is None else acc + p
        k, s = sf_lib.radial_average(acc / len(frames))
        out["rho*rho"] = {
            "mean_ratio": float(np.mean(s / (args.kBT / CS2))),
            "std_ratio": float(np.std(s / (args.kBT / CS2))),
        }
    return out


def cmd_interface(args) -> Dict:
    """Capillary-wave spectrum gamma (Flat_Interface.ipynb cells 4-10)."""
    frames = _frames(args.dir)[args.skip:]
    heights = []
    for i, f in enumerate(frames):
        rho = _read_any(f, args.device, ("rho",))["rho"]
        if i == 0:
            rho_lo, rho_hi = float(rho.min()), float(rho.max())
            level = 0.5 * (rho_lo + rho_hi)
        heights.append(iface_obs.fill_missing(
            iface_obs.interface_height(rho, level)))
    k, s = iface_obs.capillary_spectrum(np.asarray(heights), axis=1)
    gamma = iface_obs.fit_capillary_gamma(k, s, args.kBT, kmax=args.kmax)
    z0, w = iface_obs.profile_interface_width(
        iface_obs.mean_profile(rho), rho_lo, rho_hi)
    return {"gamma_capillary": gamma, "n_frames": len(frames),
            "interface_z0": z0, "interface_width": w,
            "rho_lo": rho_lo, "rho_hi": rho_hi}


def cmd_droplet(args) -> Dict:
    """Droplet radius fit + gyration + shape-fluctuation gamma
    (Surface_Tension / Droplet_Fluctuation notebooks)."""
    frames = _frames(args.dir)[args.skip:]
    fits, axes, coms = [], [], []
    for f in frames:
        d = _read_any(f, args.device)
        rho = d["rho"]
        excess = rho - rho[0, 0, 0]
        com = drop_obs.center_of_mass(excess)
        coms.append(com)
        fits.append(drop_obs.fit_droplet(rho, com))
        r_mass = drop_obs.radius_from_mass(rho)
        axes.append(drop_obs.principal_radii(excess, com, r_mass))
    dp = drop_obs.laplace_delta_p(d["rho"], d["phi"], args.alpha0, coms[-1])
    out = {
        "R_mean": float(np.mean([f["R"] for f in fits])),
        "R_std": float(np.std([f["R"] for f in fits])),
        "W_mean": float(np.mean([f["W"] for f in fits])),
        "delta_p_last": dp,
        "n_frames": len(frames),
    }
    if args.kBT > 0 and len(axes) > 4:
        out.update(drop_obs.shape_fluctuation_gamma(np.asarray(axes),
                                                    args.kBT))
    return out


def cmd_laplace(args) -> Dict:
    """Laplace-law gamma from a sweep of droplet runs at several radii
    (Surface_Tension.ipynb cells 10-28)."""
    radii, dps, per_run = [], [], []
    for d in args.dirs:
        last = _read_any(_frames(d)[-1], args.device)
        rho, phi = last["rho"], last["phi"]
        com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
        fit = drop_obs.fit_droplet(rho, com)
        dp = drop_obs.laplace_delta_p(rho, phi, args.alpha0, com)
        radii.append(fit["R"])
        dps.append(dp)
        per_run.append({"dir": d, "R": fit["R"], "delta_p": dp})
    gamma, icpt = drop_obs.surface_tension_laplace(radii, dps)
    return {"gamma_laplace": gamma, "intercept": icpt, "runs": per_run}


def cmd_msd(args) -> Dict:
    """Droplet COM MSD + Stokes-Einstein comparison (xdg_msd_calc)."""
    frames = _frames(args.dir)[args.skip:]
    steps, coms, r_means = [], [], []
    for f in frames:
        d = _read_any(f, args.device, ("rho",))
        rho = d["rho"]
        coms.append(drop_obs.center_of_mass(rho - rho[0, 0, 0]))
        steps.append(int(d["step"]))
        r_means.append(drop_obs.radius_from_mass(rho))
    shape = tuple(rho.shape)
    traj = msd_obs.unwrap_periodic(np.asarray(coms), shape)
    ts, m = msd_obs.msd(np.asarray(steps, float), traj,
                        tmax=max(4, len(frames) // 4))
    d_meas = msd_obs.diffusion_coefficient(ts, m, dim=3)
    radius = float(np.mean(r_means))
    rho0 = 1.0
    eta = rho0 * CS2 * (args.tau + 0.5 - 0.5)  # eta = rho cs2 (tau_bar-1/2)
    d_se = msd_obs.stokes_einstein(radius, float(min(shape)), eta, args.kBT)
    return {"D_measured": d_meas, "D_stokes_einstein": d_se,
            "ratio": d_meas / d_se if d_se else None,
            "R_mean": radius, "n_frames": len(frames)}


def cmd_noise(args) -> Dict:
    """Per-mode noise-covariance ratio table from noise*.npz dumps —
    NoiseCovariance.ipynb cells 2-3: for each mode a, <xi_a^2> (ensemble
    over dumps, per cell) over the FDT variance

        momentum a=1..3 : factor1 * kBT * rho phi / rho_t
        ghost    a>=4   : factor1 * kBT / cs^2 * b_a * rho

    with factor1 = 2 lam - lam^2, lam = 1/(tau + 1/2); the densities
    default to the uniform mixture (rho = phi = 1, --rho / --phi)."""
    from .config import LBMParams
    from .lattice import B

    dumps = sorted(glob.glob(os.path.join(args.dir, "noise*.npz")))
    if not dumps:
        raise FileNotFoundError(f"no noise*.npz dumps in {args.dir}")
    dumps = dumps[args.skip:]
    acc_f = acc_g = None
    cross = []
    for path in dumps:
        d = fields_io.read_noise_frame(path)
        xf = torch.as_tensor(d["xi_f"], device=args.device).double()
        xg = torch.as_tensor(d["xi_g"], device=args.device).double()
        acc_f = xf ** 2 if acc_f is None else acc_f + xf ** 2
        acc_g = xg ** 2 if acc_g is None else acc_g + xg ** 2
        cross.append(float((xf[1:4] * xg[1:4]).mean()))
    acc_f /= len(dumps)
    acc_g /= len(dumps)

    p = LBMParams(kBT=args.kBT, tau_f=args.tau, tau_g=args.tau)
    lam = p.lam_f
    factor1 = 2.0 * lam - lam * lam
    rho, phi = args.rho, args.phi
    rhot = rho + phi
    theory = np.zeros(19)
    theory[1:4] = factor1 * args.kBT * rho * phi / rhot
    theory[4:] = factor1 * (args.kBT / CS2) * np.asarray(B[4:])
    theory_f = theory.copy()
    theory_f[4:] *= rho
    theory_g = theory.copy()
    theory_g[4:] *= phi

    out = {"n_frames": len(dumps)}
    for a in range(1, 19):
        rf = acc_f[a] / float(theory_f[a])
        rg = acc_g[a] / float(theory_g[a])
        out[f"f_a{a}"] = {"mean": float(rf.mean()),
                          "var": float(rf.var(correction=0))}
        out[f"g_a{a}"] = {"mean": float(rg.mean()),
                          "var": float(rg.var(correction=0))}
    # momentum anti-correlation: <xi_f,a xi_g,a> / var should be -1
    out["momentum_anticorr"] = float(np.mean(cross) / theory[1])
    return out


def cmd_convergence(args) -> Dict:
    """Equilibration convergence report (PrintConvergence, Debug.H:276-358):
    deviation field (1/N) sum_t |c(t) - c_mean| over the trailing frames,
    reported as L1 (cell mean) and Linf (cell max) norms."""
    frames = _frames(args.dir)[args.skip:]
    if args.window:
        frames = frames[-args.window:]
    comp = args.comp

    def read(f):
        arr = fields_io.read_frame(f, (comp,))[comp]
        return torch.as_tensor(arr, device=args.device).double()

    mean = None
    for f in frames:
        arr = read(f)
        mean = arr if mean is None else mean + arr
    mean /= len(frames)
    dev = torch.zeros_like(mean)
    for f in frames:
        dev += torch.abs(read(f) - mean)
    dev /= len(frames)
    return {"comp": comp, "n_frames": len(frames),
            "dev_l1": float(dev.mean()), "dev_linf": float(dev.max()),
            "mean_l1": float(torch.abs(mean).mean())}


def cmd_radius(args) -> Dict:
    """Online droplet-radius series from metrics.jsonl — the consumer of
    RunConfig.droplet_int's in-loop fits (the reference appends
    radius_steps_out every plot_int inside the step loop,
    main_run_job.cpp:353-378, then reads the series back offline)."""
    path = os.path.join(args.dir, "metrics.jsonl")
    steps, r_fit, w_fit, r_mass = [], [], [], []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "droplet_R_mass" not in rec:
                continue
            steps.append(rec["step"])
            r_mass.append(rec["droplet_R_mass"])
            r_fit.append(rec.get("droplet_R"))
            w_fit.append(rec.get("droplet_W"))
    if not steps:
        raise SystemExit(
            f"{path}: no droplet records — run with droplet_int > 0")
    rs = np.asarray([r for r in r_fit if r is not None], float)
    out = {
        "n_records": len(steps),
        "step_first": steps[0], "step_last": steps[-1],
        "R_mass_last": r_mass[-1],
        "n_fit_converged": int(rs.size),
    }
    if rs.size:
        half = rs[rs.size // 2:]
        out.update({
            "R_last": float(rs[-1]),
            "W_last": float([w for w in w_fit if w is not None][-1]),
            "R_mean_tail": float(half.mean()),
            "R_std_tail": float(half.std()),
            # convergence diagnostic: relative radius drift over the
            # trailing half of the series (0 when equilibrated)
            "R_drift_tail": float((half[-1] - half[0])
                                  / max(abs(half.mean()), 1e-30)),
        })
    if args.series:
        out["series"] = {"step": steps, "R": r_fit, "W": w_fit,
                         "R_mass": r_mass}
    return out


def cmd_theory(args) -> Dict:
    """Free-energy theory numbers (surface_tension_predict.ipynb)."""
    lo, hi = free_energy.binodal_densities(args.rho_t, args.alpha0)
    gamma = free_energy.surface_tension_theory(args.rho_t, args.alpha0)
    return {"rho_lo_binodal": lo, "rho_hi_binodal": hi,
            "gamma_quadrature": gamma}


COMMANDS = {"sk": cmd_sk, "interface": cmd_interface, "droplet": cmd_droplet,
            "laplace": cmd_laplace, "msd": cmd_msd, "noise": cmd_noise,
            "convergence": cmd_convergence, "theory": cmd_theory,
            "radius": cmd_radius}


def main(argv=None) -> Dict:
    """Parse `argv`, run the subcommand, print its JSON and return it."""
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def parser(name, common=True):
        p = sub.add_parser(name)
        p.add_argument("--device", default="cuda",
                       help="device of the fieldwise work (default cuda; "
                            "cpu runs it on the host)")
        if common:
            p.add_argument("--dir", required=False)
            p.add_argument("--kBT", type=float, default=1e-5)
            p.add_argument("--skip", type=int, default=0,
                           help="skip first N frames")
        return p

    parser("sk")
    parser("interface").add_argument("--kmax", type=float, default=1.0)
    parser("droplet").add_argument("--alpha0", type=float, default=1.5)
    p = parser("laplace", common=False)
    p.add_argument("--dirs", nargs="+", required=True)
    p.add_argument("--alpha0", type=float, default=1.5)
    parser("msd").add_argument("--tau", type=float, default=0.5)
    p = parser("noise")
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--phi", type=float, default=1.0)
    p = parser("convergence")
    p.add_argument("--comp", default="rho")
    p.add_argument("--window", type=int, default=0,
                   help="use only the last N frames")
    parser("radius").add_argument(
        "--series", action="store_true",
        help="include the full (step, R, W, R_mass) series")
    p = parser("theory", common=False)
    p.add_argument("--alpha0", type=float, default=1.5)
    p.add_argument("--rho-t", dest="rho_t", type=float, default=3.1)

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    out = COMMANDS[args.cmd](args)
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
