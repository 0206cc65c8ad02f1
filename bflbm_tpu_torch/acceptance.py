"""Acceptance physics runs of the port (``benchmarks/acceptance.py``,
``benchmarks/acceptance_c2.py`` and ``benchmarks/tpu_massdrift_r5.py`` of
the JAX package): the reference's headline validations (BASELINE.md) at
full length on the card.

  a         mixture equilibration (two-phase protocol entry)
  b         fluctuating 32^3 mixture -> equilibrium S(k) flat at the
            Mixture.ipynb normalizations (target: within 1%), clt4
  b-kernel  the same at 64 x 64 x 128 with --noise-dist u8|clt4|clt2|bm
  c         flat interface -> capillary-wave spectrum (gamma 0.012162)
  c-ens     independent-seed capillary ensemble (+ spectrum.npy and
            hk_series.npy, the mode series of each run)
  c2        phase c's trajectory continued from its last checkpoint, the
            spectrum of the continuation's frames only
  d         droplet radius sweep -> Laplace slope + equilibrium radii
            (reference pinned R/L: 0.176, 0.204, 0.231, 0.257, 0.283)
  d-sweep   alpha0 in {0.8, 1.7, 2.0, 2.5} Laplace sweeps (--alpha0)
  e         droplet Brownian MSD / Stokes-Einstein (--size 32|64)
  f         droplet shape fluctuations (zeta_20, principal axes)
  f-static  static / fluctuation decomposition of <zeta_20^2> from the
            artifacts phase f saved (no simulation)
  massdrift the 256^3 u8 mixture session over --steps (default 100,000)
            with the exact-mass restore every --mass-restore-int steps and
            without it: the relative mass series, drift per step, MLUPS

Usage:
    python -m bflbm_tpu_torch.acceptance <phase> [--steps N] [--n-runs N]
        [--alpha0 A] [--seed-base S] [--size 32|64] [--noise-dist D]
        [--out DIR] [--device cuda|cpu]

Each phase runs on ``--device`` (default ``cuda``; without a card it
raises unless ``--device cpu`` is given) and prints one JSON line with
its results (c-ens and e with more than one run also print a line a
run).  The simulations go through :func:`bflbm_tpu_torch.run.run` (one
engine: the hand-written kernels and the coordinate-keyed hash stream,
the generator chosen by ``noise_dist``); the fieldwise analysis runs on
the same device, the fits and series stay numpy / scipy on the host.
Each phase is a run part, which writes or collects the artifacts, and an
analyse part, which reads them.  ``--steps`` also cuts phase a's 500
steps (the JAX script's phase a ignores it).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import run as run_mod
from .analysis import resolve_device
from .config import LBMParams, preset
from .io import fields as fields_io
from .observables import droplet as drop_obs
from .observables import interface as iface
from .observables import marching_cubes as mc_obs
from .observables import msd as msd_obs
from .observables import structfact as sf_lib

KBT = 1e-5
CS2 = 1.0 / 3.0
GAMMA_REF = 0.012162       # Flat_Interface.ipynb's capillary gamma
IFACE_LEVEL = 0.5 * (0.1 + 3.0)
# Equilibrium normalizations of S(k) (Mixture.ipynb cells 1-2): bare LB
# velocities carry kBT/rho; the real velocities in the 22-component
# schema carry the 3/4-identity; the uf.ug cross carries 1/4 kBT.
SK_NORM = {"rho*rho": KBT / CS2, "phi*phi": KBT / CS2,
           "ufx*ufx": 0.75 * KBT, "ufy*ufy": 0.75 * KBT,
           "ufz*ufz": 0.75 * KBT, "ufx*ugx": 0.25 * KBT,
           "ufbarx*ufbarx": KBT, "ugbarx*ugbarx": KBT,
           "ubx*ubx": KBT / 2, "uby*uby": KBT / 2, "ubz*ubz": KBT / 2}
DEFAULT_SEED = 20_000


def _field(a, device) -> torch.Tensor:
    """`a` (a tensor or a numpy array) as a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _densities(state):
    """(rho, phi) of a state: its population sums, on its device."""
    return state.f.sum(dim=0), state.g.sum(dim=0)


def _ensure_eq(cfg, device, ckpt_step: int) -> None:
    """Run the deterministic equilibration `cfg` unless its checkpoint at
    `ckpt_step` exists."""
    if not os.path.exists(os.path.join(cfg.out_dir,
                                       f"checkpoint{ckpt_step:07d}.npz")):
        run_mod.run(cfg, device=device)


# -- A: mixture equilibration -------------------------------------------------

def phase_a(args, device):
    cfg = preset("mixture-eq").replace(out_dir=f"{args.out}/mixture-eq",
                                       plot_int=100, t_window=200)
    if args.steps:
        cfg = cfg.replace(nsteps=args.steps)
    state = run_mod.run(cfg, device=device)
    return {"phase": "A", "final_step": int(state.step),
            "out": cfg.out_dir}


# -- B: S(k) equipartition ------------------------------------------------------

def run_b(args, device, kernel: bool = False):
    """The fluctuating mixture from phase a's checkpoint (b), or at 64 x
    64 x 128 from an equilibration of its own (b-kernel); returns (the
    run's config, wall seconds)."""
    steps = args.steps or 200_000
    window = min(steps // 2, 100_000)
    cfg = preset("mixture-fluct").replace(
        nsteps=steps, step_continue=500,
        checkpoint_path=f"{args.out}/mixture-eq/checkpoint0000500",
        sf_window=window, sf_every=100, plot_int=0, print_int=steps // 10,
        out_dir=f"{args.out}/mixture-fluct")
    if kernel:
        shape = (64, 64, 128)
        eq_dir = f"{args.out}/mixture-eq-kernel"
        _ensure_eq(preset("mixture-eq").replace(
            shape=shape, out_dir=eq_dir, plot_int=0, t_window=0), device,
            500)
        suffix = f"-{args.noise_dist}" if args.noise_dist else ""
        cfg = cfg.replace(
            shape=shape, checkpoint_path=f"{eq_dir}/checkpoint0000500",
            out_dir=f"{args.out}/mixture-fluct-kernel{suffix}")
        if args.seed_base != DEFAULT_SEED:
            # an independent seed: the ratios must differ from an earlier
            # run's at the sampling level
            cfg = cfg.replace(seed=args.seed_base, reseed=True)
    t0 = time.time()
    run_mod.run(cfg, device=device,
                noise_dist=args.noise_dist if kernel else None)
    return cfg, time.time() - t0


def analyse_b(out_dir: str, device) -> Dict[str, float]:
    """S(k) of the last structfact*.npz of `out_dir`: each normalized
    pair's radially averaged mean over its equilibrium value, and the
    worst deviation from 1."""
    sf_files = sorted(glob.glob(os.path.join(out_dir, "structfact*")))
    with np.load(sf_files[-1], allow_pickle=True) as d:
        sk = np.fft.ifftshift(d["s_k"], axes=(-3, -2, -1))
        names = [str(n) for n in d["names"]]
    out, worst = {}, 0.0
    for p, name in enumerate(names):
        if name not in SK_NORM:
            continue
        _, s = sf_lib.radial_average(_field(np.real(sk[p]), device))
        r = float(np.mean(s) / SK_NORM[name])
        out[name] = round(r, 5)
        worst = max(worst, abs(r - 1.0))
    out["worst_abs_dev"] = round(worst, 5)
    return out


def phase_b(args, device, kernel: bool = False):
    cfg, wall = run_b(args, device, kernel)
    out = {"phase": "B-kernel" if kernel else "B", "steps": cfg.nsteps,
           "wall_s": round(wall, 1), "sf_frames": int(cfg.sf_window // 100)}
    if kernel and args.noise_dist:
        out["noise_dist"] = args.noise_dist
    if args.seed_base != DEFAULT_SEED:
        out["seed"] = args.seed_base
    out.update(analyse_b(cfg.out_dir, device))
    return out


# -- C: capillary waves -----------------------------------------------------------

def _interface_eq(args, device) -> str:
    out_eq = f"{args.out}/interface-eq"
    _ensure_eq(preset("interface-eq").replace(out_dir=out_eq, plot_int=0),
               device, 3000)
    return out_eq


def _heights(rho, device) -> np.ndarray:
    """The interface height h(x, y) of a frame's rho, NaN columns filled
    (overhangs) instead of dropping the frame."""
    return iface.fill_missing(iface.interface_height(_field(rho, device),
                                                     IFACE_LEVEL))


def _frame_files(out_dir: str, formats=("npz", "bflbm")) -> List[str]:
    return sorted(sum((glob.glob(os.path.join(out_dir, f"plt*.{fmt}"))
                       for fmt in formats), []))


def _per_mode(k, s, modes) -> Dict[str, float]:
    return {f"gamma_m{m}": round(float(KBT / (s[m - 1] * k[m - 1] ** 2)), 6)
            for m in modes}


def run_c(args, device):
    out_eq = _interface_eq(args, device)
    steps = args.steps or 200_000
    cfg = preset("interface-fluct").replace(
        nsteps=steps, step_continue=3000,
        checkpoint_path=f"{out_eq}/checkpoint0003000",
        plot_int=500, print_int=steps // 10,
        out_dir=f"{args.out}/interface-fluct")
    t0 = time.time()
    run_mod.run(cfg, device=device)
    return cfg, time.time() - t0


def analyse_c(out_dir: str, device) -> Dict[str, float]:
    """The reference's capillary spectrum (slice x = 4) of the second half
    of the frames (the first half is the noise-equilibration transient)."""
    frames = _frame_files(out_dir)
    heights = [_heights(fields_io.read_frame(f, names=("rho",))["rho"],
                        device)[4, :]
               for f in frames[len(frames) // 2:]]
    k, s = iface.capillary_spectrum_ref(np.asarray(heights))
    gamma = iface.fit_capillary_gamma_window(k, s, KBT)
    return {"n_frames": len(heights), "gamma_ref": GAMMA_REF,
            "gamma_capillary": round(gamma, 6),
            "rel_dev": round(abs(gamma / GAMMA_REF - 1), 4),
            **_per_mode(k, s, (1, 2, 3, 5, 8))}


def phase_c(args, device):
    cfg, wall = run_c(args, device)
    res = analyse_c(cfg.out_dir, device)
    return {"phase": "C", "steps": cfg.nsteps, "wall_s": round(wall, 1),
            **res}


def run_capillary_one(out_eq, out_dir, steps, seed, reseed, device, *,
                      engine="auto", noise_source="threefry",
                      noise_dist=None, mass_restore_int=1000):
    """One interface-fluct run with its heights collected in memory (no
    frames on disk); returns ([(step, h (X, Y))], wall seconds).
    engine, noise_source (the config's), noise_dist, mass_restore_int:
    passed to :func:`bflbm_tpu_torch.run.run` (the defaults are the
    phases' own: the kernel session, the hash stream's clt4, the restore
    every 1000 steps)."""
    heights = []

    def on_frame(step_i, packed):
        # all 8 x-slices: slice 4 feeds the reference's single-slice
        # convention, the rest the slice-averaged spectrum
        heights.append((step_i, _heights(packed[0], device)))

    cfg = preset("interface-fluct").replace(
        nsteps=steps, step_continue=3000,
        checkpoint_path=f"{out_eq}/checkpoint0003000",
        plot_int=500, plot_save=False, print_int=steps // 4,
        seed=seed, reseed=reseed, out_dir=out_dir,
        noise_source=noise_source)
    t0 = time.time()
    run_mod.run(cfg, on_frame=on_frame, device=device, engine=engine,
                noise_dist=noise_dist, mass_restore_int=mass_restore_int)
    return heights, time.time() - t0


def analyse_capillary(heights, steps: int, out_dir: str):
    """The reference spectrum conventions (Flat_Interface.ipynb cells
    7-9: one x-slice, backward-norm FFT, mean profile subtracted) on the
    frames past 3000 + steps / 2; also the slice-averaged spectrum and
    the x-averaged height's (the pure kx = 0 capillary mode).  Saves
    spectrum.npy and hk_series.npy (modes 0-32 of slice 4 and of the
    x-average a frame); returns (gamma, per-mode dict, frames)."""
    cut = 3000 + steps // 2
    hs = np.asarray([h for s, h in heights if s > cut])      # (T, 8, Y)
    k, s = iface.capillary_spectrum_ref(hs[:, 4, :])
    gamma = iface.fit_capillary_gamma_window(k, s, KBT)
    s_all = np.mean([iface.capillary_spectrum_ref(hs[:, x, :])[1]
                     for x in range(hs.shape[1])], axis=0)
    gamma_avg = iface.fit_capillary_gamma_window(k, s_all, KBT)
    k2d, s2d = iface.capillary_spectrum_ref(hs.mean(axis=1))
    gamma_xavg = iface.fit_capillary_gamma_window(k2d, s2d, KBT)
    np.save(os.path.join(out_dir, "spectrum.npy"),
            np.stack([k, s, s_all, s2d]))
    hk_slice = np.fft.fft(hs[:, 4, :], axis=1)[:, :33]
    hk_xavg = np.fft.fft(hs.mean(axis=1), axis=1)[:, :33]
    np.save(os.path.join(out_dir, "hk_series.npy"),
            np.stack([hk_slice, hk_xavg], axis=1))
    per_mode = _per_mode(k, s, (1, 2, 3, 5, 8))
    per_mode["gamma_sliceavg"] = round(gamma_avg, 6)
    per_mode["gamma_xavg"] = round(gamma_xavg, 6)
    return gamma, per_mode, len(hs)


def _mean_stderr(x):
    x = np.asarray(x)
    stderr = (float(x.std(ddof=1) / np.sqrt(len(x))) if len(x) > 1
              else float("nan"))
    return float(x.mean()), stderr


def phase_c_ens(args, device):
    """Independent-seed ensemble of capillary runs branching from the
    shared deterministic equilibration: gamma as mean +- stderr."""
    out_eq = _interface_eq(args, device)
    steps = args.steps or 800_000
    gammas, runs = [], []
    for i in range(args.n_runs):
        seed = args.seed_base + 7919 * i
        out_dir = f"{args.out}/interface-ens-{args.seed_base}-{i}"
        heights, wall = run_capillary_one(out_eq, out_dir, steps, seed,
                                          True, device)
        g, per_mode, n_frames = analyse_capillary(heights, steps, out_dir)
        gammas.append(g)
        runs.append({"seed": seed, "gamma": round(g, 6), **per_mode,
                     "wall_s": round(wall, 1), "n_frames": n_frames})
        print(json.dumps({"ens_run": i, **runs[-1]}), flush=True)
    mean, stderr = _mean_stderr(gammas)
    mean_avg, stderr_avg = _mean_stderr([r["gamma_sliceavg"] for r in runs])
    return {"phase": "C-ens", "steps": steps, "n_runs": args.n_runs,
            "runs": runs, "gamma_mean": round(mean, 6),
            "gamma_stderr": round(stderr, 6),
            "gamma_sliceavg_mean": round(mean_avg, 6),
            "gamma_sliceavg_stderr": round(stderr_avg, 6),
            "gamma_ref": GAMMA_REF,
            "rel_dev": round(abs(mean / GAMMA_REF - 1), 4),
            "rel_stderr": round(stderr / GAMMA_REF, 4),
            "rel_dev_sliceavg": round(abs(mean_avg / GAMMA_REF - 1), 4),
            "rel_stderr_sliceavg": round(stderr_avg / GAMMA_REF, 4)}


def phase_c2(args, device):
    """Phase c's trajectory continued from its last checkpoint by --steps
    (default 400,000), the spectrum of the continuation's frames only
    (approximating the reference's 500k-800k window of an 800k-step run;
    no NaN fill, as in the JAX script)."""
    src = f"{args.out}/interface-fluct"
    ck = sorted(glob.glob(os.path.join(src, "checkpoint*.npz")))[-1]
    start = int(ck.split("checkpoint")[-1].split(".")[0])
    steps = args.steps or 400_000
    cfg = preset("interface-fluct").replace(
        nsteps=steps, step_continue=start, checkpoint_path=ck[:-4],
        plot_int=500, print_int=steps // 8,
        out_dir=f"{args.out}/interface-fluct2")
    t0 = time.time()
    run_mod.run(cfg, device=device)
    wall = time.time() - t0
    heights = [iface.interface_height(_field(fields_io.read_frame(
        f, names=("rho",))["rho"], device), IFACE_LEVEL)[4, :]
        for f in _frame_files(cfg.out_dir, ("npz",))]
    k, s = iface.capillary_spectrum_ref(np.asarray(heights))
    gamma = iface.fit_capillary_gamma_window(k, s, KBT)
    return {"phase": "C2", "from_step": start, "steps": steps,
            "wall_s": round(wall, 1), "n_frames": len(heights),
            "gamma_ref": GAMMA_REF, "gamma_capillary": round(gamma, 6),
            "rel_dev": round(abs(gamma / GAMMA_REF - 1), 4),
            **_per_mode(k, s, (1, 2, 3, 5, 8, 12))}


# -- D: Laplace law -----------------------------------------------------------------

D_RADII = [0.2, 0.23, 0.25, 0.28, 0.3]
D_REF_RADII = [0.1760534, 0.20426208, 0.23111422, 0.25739767, 0.2831091]
D_SLOPE_REF = 0.021567889346707517   # Surface_Tension.ipynb cell 17


def analyse_droplet_eq(state, alpha0: float, device, binned: bool = False
                       ) -> Dict[str, float]:
    """The equilibrium droplet of a deterministic run, unrounded: "R" the
    reference's all-cells fit R / L (Surface_Tension.ipynb cell 8), "dp"
    the Laplace pressure jump and, with `binned`, "R_binned" the binned
    radial fit's R in cells."""
    rho, phi = (_field(x, device) for x in _densities(state))
    com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
    out = {"R": drop_obs.fit_droplet_allcells(rho)["R"],
           "dp": drop_obs.laplace_delta_p(rho, phi, alpha0, com)}
    if binned:
        out["R_binned"] = drop_obs.fit_droplet(rho, com)["R"]
    return out


def phase_d(args, device):
    steps = args.steps or 20_000
    results = []
    for r in D_RADII:
        cfg = preset("droplet-eq").replace(
            nsteps=steps, init_radius=r, plot_int=0,
            out_dir=f"{args.out}/droplet-r{r:.2f}")
        eq = analyse_droplet_eq(run_mod.run(cfg, device=device), 1.5,
                                device, binned=True)
        results.append({"init_r": r, "R_over_L": round(eq["R"], 6),
                        "R_over_L_binned": round(eq["R_binned"] / 32, 6),
                        "delta_p": round(eq["dp"], 6)})
    gamma, icpt = drop_obs.surface_tension_laplace(
        [32 * x["R_over_L"] for x in results],
        [x["delta_p"] for x in results])
    devs = [abs(a["R_over_L"] - b) / b for a, b in zip(results, D_REF_RADII)]
    # The reference fits DeltaP against 1/(R/L) and quotes slope / 2; this
    # fit uses lattice-unit R: k_ref = gamma_lat / (L / 2).
    k_ref_conv = gamma / 16.0
    return {"phase": "D", "steps": steps, "runs": results,
            "gamma_laplace_slope_lat": round(gamma, 6),
            "laplace_intercept": round(icpt, 6),
            "slope_ref_convention": round(k_ref_conv, 6),
            "slope_reference_value": D_SLOPE_REF,
            "slope_rel_dev": round(abs(k_ref_conv / 0.021567889 - 1), 5),
            "ref_radii": D_REF_RADII,
            "radius_max_rel_dev": round(max(devs), 5)}


SWEEPS = {
    # alpha0 -> (preset, radii, the reference's saved slope or None)
    # Surface_Tension.ipynb cells 18-28.  The reference's own saved
    # outputs for alpha0 = 0.8 and 2.5 have negative Laplace slopes (radii
    # 0.36-0.42 of the box: the droplets interact with their periodic
    # images), recorded as they are.
    1.7: ("droplet-a1.7-eq", [0.20, 0.23, 0.25, 0.28], 0.026914662086),
    2.0: ("droplet-a2.5-eq", [0.20, 0.23, 0.25, 0.28], None),
    0.8: ("droplet-a0.8-eq", [0.38, 0.40, 0.42], -0.00248879718),
    2.5: ("droplet-a2.5-eq", [0.36, 0.38, 0.40, 0.42], -0.0007536467744),
}


def _sweep_one(cfg, a0, device):
    """One run of a sweep: its R / L and Delta p rounded, or None when
    its density is not finite."""
    state = run_mod.run(cfg, device=device)
    if not bool(torch.isfinite(_densities(state)[0]).all()):
        return None
    eq = analyse_droplet_eq(state, a0, device)
    return {"R_over_L": round(eq["R"], 6), "delta_p": round(eq["dp"], 6)}


def phase_d_sweep(args, device):
    """Laplace-law sweeps of the alpha0 variants (Surface_Tension cells
    18-28); --alpha0 picks the family."""
    a0 = args.alpha0
    if a0 == 2.0:
        # cell 21: alpha0 = 2.0 with the rho_hi = 3 recipe.  The
        # reference-exact sqrt(kappa) init width diverges within ~10 steps
        # at this quench depth; init_width = 1.0 relaxes the start, and
        # 'width_check' runs r = 0.20 with the exact width as well.
        base = preset("droplet-a1.7-eq")
        base = base.replace(params=dataclasses.replace(base.params,
                                                       alpha0=2.0),
                            init_width=1.0)
        radii, ref_slope = [0.20, 0.23, 0.25, 0.28], None
    else:
        name, radii, ref_slope = SWEEPS[a0]
        base = preset(name)
        if a0 == 2.5:
            base = base.replace(params=dataclasses.replace(base.params,
                                                           alpha0=2.5))
    steps = args.steps or 20_000
    results = []
    for r in radii:
        cfg = base.replace(nsteps=steps, init_radius=r, plot_int=0,
                           t_window=0,
                           out_dir=f"{args.out}/droplet-a{a0}-r{r:.2f}")
        res = _sweep_one(cfg, a0, device)
        # a non-finite run (deep-quench float32 instability) is recorded
        results.append({"init_r": r, **(res or {"nonfinite": True})})
    width_check = None
    if a0 == 2.0:
        cfg = base.replace(nsteps=steps, init_radius=0.20, plot_int=0,
                           t_window=0, init_width=0.0,
                           out_dir=f"{args.out}/droplet-a{a0}-r0.20-refinit")
        eq = analyse_droplet_eq(run_mod.run(cfg, device=device), a0, device)
        r20 = next(x for x in results if x["init_r"] == 0.20)
        width_check = {
            "R_over_L_refinit": round(eq["R"], 6),
            "delta_p_refinit": round(eq["dp"], 6),
            "R_rel_dev": round(abs(eq["R"] / r20["R_over_L"] - 1), 6),
            "dp_rel_dev": round(abs(eq["dp"] / r20["delta_p"] - 1), 6)}
    ok = [x for x in results if "R_over_L" in x]
    inv_r = np.array([1.0 / x["R_over_L"] for x in ok])
    dps = np.array([x["delta_p"] for x in ok])
    slope, icpt = np.polyfit(inv_r, dps, 1)
    out = {"phase": f"D-sweep-a{a0}", "steps": steps, "runs": results,
           "width_check": width_check,
           "slope": round(float(slope), 8),
           "intercept": round(float(icpt), 8),
           "gamma_quoted": round(float(slope) / 2.0, 8)}
    if ref_slope is not None:
        out["slope_reference_saved"] = ref_slope
        out["slope_rel_dev"] = round(abs(slope / ref_slope - 1), 4)
    return out


# -- E: droplet Brownian motion -------------------------------------------------

def frame_reducer(n: int, device):
    """The per-frame reduction of phase e on the frame's device, in
    float32: the notebook's img_filter (rho > 0.06) then the filtered
    density's centre of mass (box-centre coordinates) and its mass radius
    (droplet_radius_mass).  Returns rho -> tensor [R_mass, x, y, z]."""
    c = torch.arange(n, dtype=torch.float32, device=device) - n / 2 + 0.5
    grids = (c[:, None, None], c[None, :, None], c[None, None, :])

    def reduce(rho: torch.Tensor) -> torch.Tensor:
        rho = rho.to(torch.float32)
        filt = torch.where(rho > 0.06, rho, torch.zeros_like(rho))
        mass = filt.sum()
        com = torch.stack([(filt * g).sum() for g in grids]) / mass
        rho_d = filt[n // 2, n // 2, n // 2]
        rho_m = filt[0, 0, 0]
        excess = (filt - rho_m).sum()
        r = (3.0 / (4.0 * np.pi) * excess / (rho_d - rho_m)) ** (1.0 / 3.0)
        return torch.cat([r[None], com])

    return reduce


def run_e_one(cfg, n: int, device, *, engine="auto", noise_source=None,
              noise_dist=None, mass_restore_int=1000) -> np.ndarray:
    """One droplet-msd-fluct run; returns its rows (step, R_mass, com x,
    y, z), frame 0 dropped as the notebook does, and saves them as
    msd_rows.npy.  The rows stay on the device until the run ends.
    engine, noise_source (None: the config's), noise_dist,
    mass_restore_int: passed to :func:`bflbm_tpu_torch.run.run`."""
    reduce = frame_reducer(n, device)
    steps_i, vals = [], []

    def on_frame(step_i, packed):
        steps_i.append(step_i)
        vals.append(reduce(_field(packed[0], device)))

    if noise_source is not None:
        cfg = cfg.replace(noise_source=noise_source)
    run_mod.run(cfg, on_frame=on_frame, device=device, engine=engine,
                noise_dist=noise_dist, mass_restore_int=mass_restore_int)
    v = torch.stack(vals).cpu().numpy().astype(np.float64)
    arr = np.concatenate([np.asarray(steps_i, float)[:, None], v],
                         axis=1)[1:]
    np.save(os.path.join(cfg.out_dir, "msd_rows.npy"), arr)
    return arr


def analyse_msd_rows(arr: np.ndarray, shape, tau: int = 100):
    """(D from the MSD slope / 6 over `tau` frame lags, the mean mass
    radius) of one run's rows."""
    steps_f, r_mass, coms = arr[:, 0], arr[:, 1], arr[:, 2:5]
    traj = msd_obs.unwrap_periodic(coms, shape)
    ts, m = msd_obs.msd(steps_f, traj, tau)
    return float(np.polyfit(ts, m, 1)[0] / 6.0), float(r_mass.mean())


def phase_e(args, device):
    """Droplet Brownian MSD / Stokes-Einstein (xdg_msd_calc.ipynb; its
    saved output on its own data: Dse = 9.2952e-07, Db = 9.6660e-07,
    diff 3.99%).  Protocol: alpha0 = 4, rho_hi = 1, r = 0.2 droplet; a
    20k-step deterministic equilibration, then the fluctuating kBT = 5e-5
    continuation; the COM of the threshold-filtered density a frame, the
    MSD over 100 frame lags, D = slope / 6 against stokes_einstein(R, L,
    eta = rho0 / 6, kT)."""
    n = args.size      # 32: the system_unit.ipynb droplet (R = 6.2,
    #                    P = 0.450); 64: the xdg_msd_calc data set
    out_eq = f"{args.out}/droplet-msd-eq{n}"
    _ensure_eq(preset("droplet-msd-eq").replace(shape=(n, n, n),
                                                out_dir=out_eq), device,
               20_000)
    steps = args.steps or 1_000_000
    eta = 1.0 * (1.0 / 3.0) * (1.0 - 0.5)     # rho0 cs2 (tau_r - 1/2)
    t0 = time.time()
    d_fits, r_list, runs = [], [], []
    for i in range(args.n_runs):
        cfg = preset("droplet-msd-fluct").replace(
            shape=(n, n, n), nsteps=steps,
            checkpoint_path=f"{out_eq}/checkpoint0020000",
            plot_save=False, print_int=steps // 10,
            seed=args.seed_base + 7919 * i, reseed=args.n_runs > 1,
            out_dir=f"{args.out}/droplet-msd-fluct{n}-{i}"
            if args.n_runs > 1 else f"{args.out}/droplet-msd-fluct{n}")
        d_fit, r_mean = analyse_msd_rows(run_e_one(cfg, n, device),
                                         cfg.shape)
        d_fits.append(d_fit)
        r_list.append(r_mean)
        runs.append({"seed": cfg.seed, "D_fit": d_fit,
                     "R": round(r_mean, 4)})
        if args.n_runs > 1:
            print(json.dumps({"msd_run": i, **runs[-1]}), flush=True)
    wall = time.time() - t0
    d_fit = float(np.mean(d_fits))
    R = float(np.mean(r_list))
    d_se = msd_obs.stokes_einstein(R, float(n), eta, 5e-5)
    dx, dt = 1.613e-9, 0.250e-12          # system_unit.ipynb cell 0
    out = {"phase": f"E-msd-{n}", "steps": steps, "n_runs": args.n_runs,
           "wall_s": round(wall, 1),
           "n_frames": int(steps // 100), "R_mass_mean": round(R, 4),
           "P_factor": round(1 - 2.84 * R / n, 4),
           "D_fit": d_fit, "D_se": d_se,
           "rel_diff": round((d_fit - d_se) / d_se, 4),
           "D_fit_stokes": d_fit * dx * dx / dt * 1e4}
    if args.n_runs > 1:
        stderr = float(np.std(d_fits, ddof=1) / np.sqrt(len(d_fits)))
        out["D_fit_stderr"] = stderr
        out["ratio_stderr"] = round(stderr / d_se, 4)
        out["runs"] = runs
    if n == 64:
        out["reference_saved"] = {"Dse": 9.2952e-07, "Db": 9.6660e-07,
                                  "diff_pct": 3.99}
    else:
        out["reference_P"] = 0.450
    return out


# -- F: droplet shape fluctuations ----------------------------------------------

GAMMA_THEORY = 0.01216


def analyse_shape_frame(rho):
    """Per-frame shape observables on the frame's device: the gyration
    eigenvalues and zeta_20 by both surface extractors (the ray /
    Gauss-Legendre radius map and the reference's marching-cubes vertex
    pipeline), so that the extraction method's share of <zeta_20^2> is
    measured on identical frames.  Returns (R_mass, eigenvalues
    descending, zeta_20 ray, zeta_20 marching cubes, boundary edges)."""
    com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
    rad = drop_obs.radius_from_mass(rho)
    eig = np.sort(np.linalg.eigvalsh(drop_obs.gyration_tensor(rho, com)))
    level = 0.5 * (float(rho.min()) + float(rho.max()))
    rmap = drop_obs.surface_radius_map(rho, com, level)
    amps = drop_obs.spherical_harmonic_amplitudes(rmap, lmax=2)
    # marching cubes wants the COM in array-index coordinates
    com_idx = com + (np.asarray(rho.shape) - 1) / 2.0
    amps_mc, diag = mc_obs.mc_surface_amplitudes(rho, com_idx, level)
    return (rad, eig[::-1], amps[(2, 0)].real, amps_mc[(2, 0)].real,
            diag["boundary_edges"])


def _f_eq(args, device) -> str:
    """Phase d's alpha0 = 1.5, r = 0.25 equilibration (run here if phase
    d has not)."""
    out_eq = f"{args.out}/droplet-r0.25"
    _ensure_eq(preset("droplet-eq").replace(nsteps=20_000, plot_int=0,
                                            init_radius=0.25,
                                            out_dir=out_eq), device, 20_000)
    return out_eq


def run_f(args, device):
    """The droplet-fluct trajectory from phase d's r = 0.25 droplet;
    returns (its config, the rho frames on the device, wall seconds)."""
    out_eq = _f_eq(args, device)
    steps = args.steps or 1_150_000
    frames = []

    def on_frame(step_i, packed):
        frames.append(_field(packed[0], device).clone())

    reseed = args.seed_base != DEFAULT_SEED
    cfg = preset("droplet-fluct").replace(
        nsteps=steps, checkpoint_path=f"{out_eq}/checkpoint0020000",
        plot_int=500, plot_save=False, print_int=steps // 10,
        seed=args.seed_base, reseed=reseed,
        out_dir=f"{args.out}/droplet-shapefluct"
        + (f"-{args.seed_base}" if reseed else ""))
    t0 = time.time()
    run_mod.run(cfg, on_frame=on_frame, device=device)
    return cfg, frames, time.time() - t0


def analyse_f(frames: Sequence, out_dir: str) -> Dict:
    """Shape-fluctuation surface tensions (Droplet_Fluctuation.ipynb):
    principal-axis equipartition gamma_(2,0), gamma_(2,+-2) (cells 24-25)
    and the zeta_20 equipartition (cells 35, 39) over the frames past the
    first eighth; saves shapefluct.npz for f-static."""
    skip = len(frames) // 8           # noise-equilibration transient
    rows = [analyse_shape_frame(f) for f in frames[skip:]]
    rads = [r[0] for r in rows]
    e = np.asarray([r[1] for r in rows])
    z = np.asarray([r[2] for r in rows])
    z_mc = np.asarray([r[3] for r in rows])
    holes = [r[4] for r in rows]
    # principal semi-axes at a fixed R0 (a per-frame mass radius adds a
    # common-mode delta R that swamps the shape signal)
    r0 = float(np.mean(rads))
    axes = np.stack([r0 * ((e[:, i] * e[:, i])
                           / (e[:, j] * e[:, k])) ** (1.0 / 6.0)
                     for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1))],
                    axis=1)
    da = axes - axes.mean(axis=0, keepdims=True)
    gpair = drop_obs.shape_fluctuation_gamma(axes, KBT)
    # the reference's formula (cell 24) sums over the three pairs
    pairs = ((0, 1), (1, 2), (0, 2))
    plus = sum(np.mean((da[:, i] + da[:, j]) ** 2) for i, j in pairs)
    minus = sum(np.mean((da[:, i] - da[:, j]) ** 2) for i, j in pairs)
    g_zeta = drop_obs.zeta_equipartition_gamma(z, KBT)
    g_zeta_mc = drop_obs.zeta_equipartition_gamma(z_mc, KBT)
    np.savez(os.path.join(out_dir, "shapefluct.npz"),
             axes=axes, eigs=e, rads=np.asarray(rads), zeta20=z,
             zeta20_mc=z_mc, mc_boundary_edges=np.asarray(holes))
    return {"n_frames": len(frames) - skip, "R0": round(r0, 4),
            # the reference's cell 25 statistics (lattice units): 0.000129,
            # 0.0265, 0.0133, 0.0131 on its 2301 frames
            "mean_abs_da_sum": float(np.abs(da.sum(axis=1)).mean()),
            "mean_abs_da": [float(x) for x in np.abs(da).mean(axis=0)],
            "gamma_20_axes_sum": round(15 * KBT / (16 * np.pi * plus), 6),
            "gamma_22_axes_sum": round(45 * KBT / (16 * np.pi * minus), 6),
            "gamma_20_axes_mean": round(gpair["gamma_20"], 6),
            "gamma_22_axes_mean": round(gpair["gamma_22"], 6),
            # cell 39: 2 gamma_theory <zeta_20^2> against kBT / 2; the
            # reference's own saved output is 2.5488e-07 against 5e-06
            "equipartition_lhs": float(2 * GAMMA_THEORY * np.mean(z ** 2)),
            "equipartition_rhs": KBT / 2,
            "reference_saved_lhs": 2.5488e-07,
            "zeta20_var": float(np.mean(z ** 2)),
            # the marching-cubes numbers on the same frames, the direct
            # comparable to the reference's saved 1.048e-05
            "zeta20_var_mc": float(np.mean(z_mc ** 2)),
            "equipartition_lhs_mc": float(2 * GAMMA_THEORY
                                          * np.mean(z_mc ** 2)),
            "mc_mean_boundary_edges": float(np.mean(holes)),
            "reference_zeta20_var": 1.048e-05,
            "gamma_zeta20": round(g_zeta, 6),
            "gamma_zeta20_mc": round(g_zeta_mc, 6),
            "gamma_theory": GAMMA_THEORY}


def phase_f(args, device):
    """Droplet shape-fluctuation surface tensions against gamma_theory =
    0.01216 at alpha0 = 1.5.  The reference's trajectory (cell 21): init
    r = 0.25, 32^3, kBT = 1e-5, frames every 500 steps, 2301 frames
    (~1.15M steps); its equilibrium R0 = 7.655 (mass radius, cell 41)."""
    cfg, frames, wall = run_f(args, device)
    res = analyse_f(frames, cfg.out_dir)
    return {"phase": "F-shapefluct", "steps": cfg.nsteps,
            "wall_s": round(wall, 1), **res}


def phase_f_static(args, device):
    """<zeta_20^2> = static^2 + fluctuation variance from phase f's saved
    artifacts.  The static term is each extractor's zeta_20 on the kBT = 0
    equilibrium droplet (0 by symmetry: anything else is the surface
    pipeline's lattice quadrupole bias); a synthetic tanh-droplet radius
    scan shows how that bias oscillates with R on the 32^3 grid."""
    from scipy.optimize import curve_fit

    with np.load(f"{args.out}/droplet-shapefluct/shapefluct.npz") as z:
        ray, mc = np.asarray(z["zeta20"]), np.asarray(z["zeta20_mc"])
    with np.load(f"{args.out}/droplet-r0.25/checkpoint0020000.npz") as ck:
        rho_eq = ck["f"].sum(axis=0)
    _, _, s_ray, s_mc, _ = analyse_shape_frame(_field(rho_eq, device))

    # synthetic scan: the equilibrium droplet's profile shape (the fit
    # and the model stay numpy on the host)
    n = rho_eq.shape[0]
    x = np.arange(n) - (n - 1) / 2
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    com = drop_obs.center_of_mass(_field(rho_eq - rho_eq[0, 0, 0], device))
    r = np.sqrt((X - com[0]) ** 2 + (Y - com[1]) ** 2 + (Z - com[2]) ** 2)

    def prof(r, R, w, lo, hi):
        return lo + (hi - lo) * 0.5 * (1 - np.tanh((r - R) / w))

    p, _ = curve_fit(prof, r.ravel(), rho_eq.ravel(),
                     p0=[7.5, 1.0, 0.01, 3.4])
    scan = {}
    for R in (7.0, 7.25, 7.51, 7.655, 7.8, 8.0):
        _, _, zr, zm, _ = analyse_shape_frame(_field(prof(r, R, *p[1:]),
                                                     device))
        scan[f"{R:.3f}"] = {"ray_sq": float(zr ** 2),
                            "mc_sq": float(zm ** 2)}
    fluct = 0.5 * (np.var(ray) + np.var(mc))
    return {"phase": "f-static",
            "total_ray": float(np.mean(ray ** 2)),
            "total_mc": float(np.mean(mc ** 2)),
            "fluct_var_ray": float(np.var(ray)),
            "fluct_var_mc": float(np.var(mc)),
            "corr_ray_mc": float(np.corrcoef(ray, mc)[0, 1]),
            "traj_mean_ray": float(np.mean(ray)),
            "traj_mean_mc": float(np.mean(mc)),
            "static_eq_ray": float(s_ray), "static_eq_mc": float(s_mc),
            # closure: static^2 + var must reproduce the totals
            "predicted_total_ray": float(s_ray ** 2 + np.var(ray)),
            "predicted_total_mc": float(s_mc ** 2 + np.var(mc)),
            "reference_total": 1.048e-05,
            "reference_implied_static_sq": float(1.048e-05 - fluct),
            "synthetic_radius_scan": scan}


# -- long-run mass ------------------------------------------------------------------

def massdrift_run(shape, steps: int, restore_int: int, device) -> Dict:
    """The u8 mixture session (kBT = 1e-5, the driver's main path) over
    `steps` K steps with the exact-mass restore every `restore_int` (0:
    off): the relative total f mass every 10,000 steps and at the end,
    after min(100, steps / 2) untimed steps, summed in float64 as the
    restore sums it, and the session's MLUPS over the timed steps (the
    readings included)."""
    from .kernels.session import make_session
    from .models import binary_fluid as model

    params = LBMParams(alpha0=0.0, kBT=KBT)
    sess = make_session(params, shape, noise_dist="u8",
                        mass_restore_int=restore_int)
    st = model.init_mixture(shape, params, device=device)
    m0 = float(st.f.sum(dtype=torch.float64))
    warmup = min(100, steps // 2)
    pc = sess.advance(sess.enter(st), warmup - 1)
    run_mod._sync(device)
    series = []
    t0 = time.perf_counter()
    done = warmup
    while done < steps:
        n = min(10_000, steps - done)
        for k in range(0, n, 1000):
            pc = sess.advance(pc, min(1000, n - k))
        done += n
        mf = float(sess.exit_view(pc).f.sum(dtype=torch.float64))
        series.append(mf / m0 - 1.0)
    wall = time.perf_counter() - t0
    return {"rel_mass_series_per_10k": series, "end_rel_drift": series[-1],
            "drift_per_step": series[-1] / done,
            "mlups": float(np.prod(shape)) * (done - warmup) / wall / 1e6,
            "wall_s": wall}


def phase_massdrift(args, device):
    """The long-run float32 mass drift (``tpu_massdrift_r5.py``): the
    session with the restore every --mass-restore-int steps (default
    1000) and with none; writes massdrift.json under --out."""
    shape = tuple(args.shape)
    steps = args.steps or 100_000
    out = {"phase": "massdrift", "steps": steps, "shape": list(shape),
           "mass_restore_int": args.mass_restore_int}
    for label, mri in (("restore_on", args.mass_restore_int),
                       ("restore_off", 0)):
        out[label] = massdrift_run(shape, steps, mri, device)
        print(json.dumps({label: out[label]["end_rel_drift"],
                          "mlups": out[label]["mlups"]}), flush=True)
    out["throughput_ratio"] = (out["restore_on"]["mlups"]
                               / out["restore_off"]["mlups"])
    out["verdict_done"] = (abs(out["restore_on"]["drift_per_step"]) <= 1e-10
                           and out["throughput_ratio"] >= 0.98)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "massdrift.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return out


PHASES = {"a": phase_a, "b": phase_b,
          "b-kernel": lambda a, d: phase_b(a, d, kernel=True),
          "c": phase_c, "c-ens": phase_c_ens, "c2": phase_c2,
          "d": phase_d, "d-sweep": phase_d_sweep, "e": phase_e,
          "f": phase_f, "f-static": phase_f_static,
          "massdrift": phase_massdrift}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("phase", choices=list(PHASES))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--n-runs", type=int, default=8)
    ap.add_argument("--alpha0", type=float, default=1.7)
    ap.add_argument("--seed-base", type=int, default=DEFAULT_SEED)
    ap.add_argument("--size", type=int, default=32,
                    help="phase e domain edge (32: system_unit droplet; "
                    "64: the xdg_msd_calc data set)")
    ap.add_argument("--out", default="out/acceptance")
    ap.add_argument("--noise-dist", default=None,
                    choices=["u8", "clt4", "clt2", "bm"],
                    help="the hash stream's normal generator for b-kernel "
                    "(default clt4)")
    ap.add_argument("--device", default="cuda",
                    help="where the runs and the fieldwise analysis run "
                    "(default cuda; raises without a card)")
    ap.add_argument("--shape", type=int, nargs=3, default=[256, 256, 256],
                    help="massdrift: the mixture's shape")
    ap.add_argument("--mass-restore-int", type=int, default=1000,
                    help="massdrift: the restore cadence of the restored "
                    "run")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    res = PHASES[args.phase](args, device)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
