"""Run driver + CLI of the port (``bflbm_tpu/run.py``; the reference's
``main_run_job.cpp``).

The reference pipeline on the card: init (mixture / stripe / droplet /
checkpoint) -> the resident kernel session in chunks between observable
events, with frame output, online structure factors over the trailing
window, the droplet radius series, metrics and the NaN sentinel -> the
end-of-run checkpoint -> (deterministic runs) the trailing-window time
average stored as the equilibrium artifact (main_run_job.cpp:428-439).
Every campaign of the reference is two-phase: a deterministic
equilibration writes the checkpoint and the artifact, and a fluctuating
continuation starts from them (``--checkpoint``, ``--ref-state``).

Usage:
    python -m bflbm_tpu_torch.run --preset droplet-eq --out out/eq
    python -m bflbm_tpu_torch.run --preset droplet-fluct \\
        --checkpoint out/eq/checkpoint0020000 \\
        --ref-state out/eq/equilibrium.npz --out out/fluct
    python -m bflbm_tpu_torch.run --preset droplet-eq --mesh 2 1 1
    python -m bflbm_tpu_torch.run --preset mixture-fluct --block 2
    python -m bflbm_tpu_torch.run --preset droplet-eq --mesh 2 1 1 --block 2

``--mesh X Y Z`` decomposes the domain over a mesh of blocks, one per
card (:class:`~bflbm_tpu_torch.kernels.session.ShardedSession`); on a
node with fewer cards the cards repeat.  Views, frames, observables and
checkpoints are taken from the gathered state, so a run writes the same
files with or without a mesh.  ``--block T`` runs T K steps per kernel
launch (K4, every configuration: the droplet presets too; default
auto), on one card or, with ``--mesh``, on every block (pads sd T deep,
one exchange every T steps).

Engines (``--engine``, as the JAX CLI's): ``auto`` (the default) runs
the kernel session, whose noise is the coordinate-keyed hash stream
(clt4 unless ``--noise-dist`` says otherwise); ``jnp`` runs the plain
PyTorch step on the same device (the JAX package's jnp engine:
:class:`~bflbm_tpu_torch.models.plain_session.PlainSession`, CUDA graphs
of a chunk on the card, no mass restore) with the noise of
``RunConfig.noise_source`` (``--noise-source``): ``threefry``, the bulk
source (exact normals, a generator seeded with the step's word and
the step), or
``hash``, the kernels' stream.  A non-default source (``hash``) selects
the plain engine, as in JAX; asking for the kernel session with it
raises.

Noise words: every step draws one word from the state's generator.
Observable views *peek* the next word (the one the next step consumes)
without drawing it, so the trajectory does not depend on the observable
cadence, and a checkpoint stores the generator, so a restart continues
the word stream bitwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import RunConfig, preset, preset_names
from .io import checkpoint as ckpt
from .io import fields as fields_io
from .io.metrics import MetricsWriter
from .kernels.session import make_session
from .models import binary_fluid as model
from .models.plain_session import PlainSession
from .observables import stats
from .observables import structfact as sf_lib
from .ops import hydro as hydro_ops
from .ops import noise as noise_ops
from .parallel import mesh as mesh_lib
from .state import SimState, peek_words
from .utils import debug

# The last run()'s wall seconds by part: "advance" (the kernel session,
# synchronized; "ref_backup" of it, the USE_REF_STATE rollback copies),
# "views" (exit views, preludes, packing, S(k), metrics), "host_obs" (the
# droplet fit), "io" (frames, checkpoints, artifacts) and "total"; and
# "ref_retry_steps", the K steps rerun after a COM crossing.
last_run_stats: Dict[str, float] = {}


def _pick_chunk(events, nsteps: int, cap: int) -> int:
    """Steps per session advance: gcd of the event cadences, capped (the
    largest divisor of the gcd <= cap keeps every event on a chunk
    boundary; cap 0 = uncapped).  With no events, min(nsteps, cap)."""
    if not events:
        return min(nsteps, cap) if cap else nsteps
    chunk = events[0]
    for v in events[1:]:
        chunk = math.gcd(chunk, v)
    chunk = max(1, min(chunk, nsteps))
    if cap and chunk > cap:
        chunk = max(d for d in range(1, cap + 1) if chunk % d == 0)
    return chunk


ENGINES = ("auto", "jnp", "kernel")


def resolve_engine(engine: str, noise_source: str) -> str:
    """The engine a run takes, by the JAX driver's rule
    (``bflbm_tpu/run.py:119-140``): a non-default noise source is a
    plain-engine selection, so ``auto`` resolves to ``jnp`` and a kernel
    engine raises; otherwise ``auto`` is the kernel session.  Returns
    "jnp" or "kernel"."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES} (the JAX "
                         "package's pallas and halo engines are not "
                         "ported)")
    if noise_source not in noise_ops.NOISE_SOURCES:
        raise ValueError(f"noise_source {noise_source!r} not in "
                         f"{noise_ops.NOISE_SOURCES}")
    if noise_source != "threefry":
        if engine == "kernel":
            raise ValueError(
                f"noise_source={noise_source!r} selects the plain engine's "
                "stream; use engine='jnp' or 'auto' (the kernel session "
                "draws the hash stream with noise_dist)")
        return "jnp"
    return "kernel" if engine == "auto" else engine


def _sync(device, stream_only: bool = False) -> None:
    """Wait for the device; stream_only: for the current stream only (the
    plain engine launches nothing elsewhere, so runs in other threads,
    on their own streams, go on)."""
    if torch.device(device).type == "cuda":
        if stream_only:
            torch.cuda.current_stream(device).synchronize()
        else:
            torch.cuda.synchronize(device)


def run(cfg: RunConfig, *, device="cuda", on_frame: Optional[Callable] = None,
        noise_dist: Optional[str] = None, mass_restore_int: int = 1000,
        mesh=None, overlap="auto", y_exchange: str = "auto",
        block: Optional[int] = None, engine: str = "auto") -> SimState:
    """Execute a configured run on `device`; returns the final state.

    on_frame(step, packed_hydro) is called at plot_int cadence.
    noise_dist: the hash-stream generator (default cfg.noise_dist).
    mass_restore_int: the session's exact-mass restore cadence (0 = off).
    mesh: a :class:`~bflbm_tpu_torch.parallel.mesh.Mesh` or a mesh shape
    (X, Y, Z) to decompose the domain over (a shape takes the node's
    cards, or `device` for a CPU run); the state, its views and
    everything written stay on `device`.  overlap, y_exchange: the
    decomposed sweep (``kernels.session.ShardedSession``; no CLI flag, as
    in JAX's CLI), e.g. ``run(cfg, mesh=(2, 2, 1), overlap=True)``.
    block: K steps a launch (K4; None: 1, one step a launch), as
    ``--block``; with a mesh on every block (``ShardedSession(block=)``,
    fixed for the run, in every sweep: serial, the split or the strips).
    engine: "auto" (the kernel session), "kernel" (the same, by name) or
    "jnp" (the plain step with cfg.noise_source's noise, no mass restore:
    mass_restore_int does not apply; no mesh or block), resolved with
    cfg.noise_source by :func:`resolve_engine`.
    """
    t_start = time.perf_counter()
    tm = {"advance": 0.0, "views": 0.0, "host_obs": 0.0, "io": 0.0}
    p = cfg.params
    dist = noise_dist or cfg.noise_dist
    engine = resolve_engine(engine, cfg.noise_source)
    plain = engine == "jnp"
    if plain and (mesh is not None or block is not None):
        raise ValueError("the plain engine runs one device a step: no mesh "
                         "or block")
    # the noise of the views' preludes: the engine's own
    view_source = cfg.noise_source if plain else "hash"
    state = model.make_initial_state(cfg, device=device)
    if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
        mesh = mesh_lib.make_mesh(
            mesh, None if torch.device(device).type == "cuda" else device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    metrics = MetricsWriter(os.path.join(cfg.out_dir, "metrics.jsonl"))

    # async frame writer: large frames go to background writer threads
    # (reference analog: AMReX async plotfile I/O)
    frame_writer = None
    if cfg.plot_int > 0 and cfg.plot_save and cfg.plot_fmt in ("auto",
                                                               "native"):
        nbytes = 22 * int(np.prod(cfg.shape)) * np.dtype(np.float32).itemsize
        if nbytes >= fields_io._AUTO_NATIVE_BYTES:
            from .io import native as native_io

            if native_io.available():
                frame_writer = native_io.AsyncFieldWriter()
    try:

        # USE_REF_STATE noise path: amplitudes from the stored equilibrium
        # state in the COM frame (main_run_job.cpp:216-235 + LBM_binary.H:92)
        ref_state = None
        if cfg.use_ref_state:
            if not cfg.ref_state_path:
                raise ValueError("use_ref_state requires ref_state_path")
            rho_eq, phi_eq, _ = ckpt.load_equilibrium(cfg.ref_state_path)
            rho_eq = torch.as_tensor(rho_eq, dtype=cfg.dtype, device=device)
            phi_eq = torch.as_tensor(phi_eq, dtype=cfg.dtype, device=device)
            ref_state = (rho_eq, phi_eq, stats.center_of_mass(rho_eq))
        if plain:
            sess = PlainSession(p, cfg.shape, noise_source=cfg.noise_source,
                                noise_dist=dist, ref_state=ref_state,
                                device=device)
        else:
            sess = make_session(p, cfg.shape, noise_dist=dist,
                                mass_restore_int=mass_restore_int,
                                ref_fields=ref_state, mesh=mesh,
                                overlap=overlap, y_exchange=y_exchange,
                                block=block)

        def prelude_peek(s: SimState):
            (word,) = peek_words(s.gen, 1)
            return model.prelude(s, p, word, ref_state=ref_state,
                                 noise_dist=dist, noise_source=view_source)

        def hydro_only(s: SimState) -> torch.Tensor:
            return hydro_ops.pack(prelude_peek(s)[0])

        events = [v for v in (cfg.plot_int, cfg.print_int, cfg.out_noise_int,
                              cfg.droplet_int,
                              cfg.sf_every if (p.noise_on and cfg.sf_window)
                              else 0) if v]
        chunk = _pick_chunk(events, cfg.nsteps, cfg.chunk_cap)

        # structure factors over the trailing window
        # (main_run_job.cpp:330,342-349)
        sf_state = None
        sf_start = cfg.step_continue + cfg.nsteps - cfg.sf_window
        use_sf = p.noise_on and cfg.sf_window > 0

        # frame 0 output (main_run_job.cpp:313-323)
        first = int(state.step)
        if cfg.plot_int > 0 and cfg.step_continue == 0:
            t0 = time.perf_counter()
            packed = hydro_only(state)
            tm["views"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            if cfg.plot_save:
                fields_io.write_frame(cfg.out_dir, first, packed,
                                      fmt=cfg.plot_fmt)
            if on_frame:
                on_frame(first, packed)
            tm["io"] += time.perf_counter() - t0

        # equilibrium-state trailing average (deterministic runs), on the card
        eq_accum = None
        eq_count = 0
        eq_paths = []  # frame files in the window, for the convergence report
        eq_start = cfg.step_continue + cfg.nsteps - cfg.t_window

        t0_loop = time.perf_counter()
        last = cfg.step_continue + cfg.nsteps
        step_i = first
        pc = None  # session-resident post-collide state
        while step_i < last:
            n = min(chunk, last - step_i)
            t0 = time.perf_counter()
            if pc is None:
                pc = sess.enter(state)  # counts as 1 step
                state = None
                if n > 1:
                    pc = sess.advance(pc, n - 1)
            else:
                pc = sess.advance(pc, n)
            _sync(device, plain)
            tm["advance"] += time.perf_counter() - t0
            step_i += n

            dump_due = (cfg.out_noise_int > 0
                        and step_i % cfg.out_noise_int == 0)
            need_hydro = (
                (cfg.plot_int > 0 and step_i % cfg.plot_int == 0)
                or (use_sf and step_i >= sf_start
                    and step_i % cfg.sf_every == 0)
                or (cfg.print_int > 0 and step_i % cfg.print_int == 0)
                or (cfg.droplet_int > 0 and step_i % cfg.droplet_int == 0)
                or step_i == last
            )
            t0 = time.perf_counter()
            if dump_due or step_i >= last:
                # full session exit: a noise dump must dump the draw the next
                # step consumes (the re-entry prelude), and the end-of-run
                # checkpoint needs the standard state
                state = sess.exit(pc)
                pc = None
                view = state
            else:
                view = sess.exit_view(pc) if need_hydro else None

            if dump_due:
                _, xi_f, xi_g = prelude_peek(view)
                fields_io.write_noise_frame(cfg.out_dir, step_i, xi_f, xi_g)

            packed = hydro_only(view) if need_hydro else None

            if use_sf and step_i >= sf_start and step_i % cfg.sf_every == 0:
                if sf_state is None:
                    sf_state = sf_lib.init_structfact(
                        len(sf_lib.REFERENCE_PAIRS), cfg.shape, device=device)
                sf_state = sf_lib.accumulate(sf_state, packed,
                                             sf_lib.REFERENCE_PAIRS)
            _sync(device, plain)
            tm["views"] += time.perf_counter() - t0

            if cfg.plot_int > 0 and step_i % cfg.plot_int == 0:
                t0 = time.perf_counter()
                if cfg.plot_save:
                    path = fields_io.write_frame(cfg.out_dir, step_i, packed,
                                                 fmt=cfg.plot_fmt,
                                                 writer=frame_writer)
                if on_frame:
                    on_frame(step_i, packed)
                if not p.noise_on and cfg.t_window > 0 and step_i >= eq_start:
                    eq_accum = (packed.clone() if eq_accum is None
                                else eq_accum + packed)
                    eq_count += 1
                    if cfg.plot_save:
                        eq_paths.append(path)
                tm["io"] += time.perf_counter() - t0

            if cfg.droplet_int > 0 and step_i % cfg.droplet_int == 0:
                # online droplet-radius series (radius_steps_out analog,
                # main_run_job.cpp:353-378 + Debug.H:360-378): only rho
                # leaves the card
                t0 = time.perf_counter()
                metrics.log(step_i, **_droplet_record(packed[0].cpu().numpy()))
                tm["host_obs"] += time.perf_counter() - t0

            if cfg.print_int > 0 and step_i % cfg.print_int == 0:
                t0 = time.perf_counter()
                rho = packed[0]
                rec = {"mlups": (step_i - first) * np.prod(cfg.shape)
                       / (time.perf_counter() - t0_loop) / 1e6}
                if bool(debug.has_nonfinite(rho)):
                    ckpt.save_state(
                        os.path.join(cfg.out_dir, f"abort{step_i:07d}"), view)
                    raise FloatingPointError(
                        f"non-finite density at step {step_i}; "
                        "state checkpointed")
                st = debug.field_stats(rho)
                rec.update({k: float(v) for k, v in st.items()})
                rec["mass_f"] = float(debug.mass(view.f))
                rec["mass_g"] = float(debug.mass(view.g))
                if cfg.use_ref_state:
                    # USE_REF_STATE crossings isolated to one-step sub-chunks
                    # (the reference re-rolls per step, LBM_binary.H:92-106)
                    rec["ref_roll_violations"] = sess.ref_violations()
                metrics.log(step_i, **rec)
                tm["views"] += time.perf_counter() - t0
            del view, packed

        if cfg.use_ref_state and sess.ref_violations():
            warnings.warn(
                f"USE_REF_STATE: the droplet crossed a cell boundary "
                f"{sess.ref_violations()} time(s); each crossing was isolated "
                "to a one-step sub-chunk and handled at step granularity",
                stacklevel=2)

        # end-of-run artifacts; the frames submitted to the async writer
        # are on disk first (the convergence report reads them back)
        t0 = time.perf_counter()
        if frame_writer is not None:
            frame_writer.close()
        ckpt.save_state(
            os.path.join(cfg.out_dir, f"checkpoint{last:07d}"), state,
            extra={"config": _cfg_json(cfg)})
        if sf_state is not None:
            s = sf_lib.finalize(sf_state)
            np.savez(os.path.join(cfg.out_dir, f"structfact{last:07d}.npz"),
                     s_k=s, pairs=np.asarray(sf_lib.REFERENCE_PAIRS),
                     names=np.asarray(sf_lib.pair_names()))
        if eq_accum is not None and eq_count > 0:
            mean = (eq_accum / eq_count).cpu().numpy()
            ckpt.save_equilibrium(
                os.path.join(cfg.out_dir, "equilibrium"),
                mean[0], mean[1], mean[5])
            # PrintConvergence analog (Debug.H:276-358): deviation field
            # (1/N) sum_t |rho_t - rho_mean| over the trailing window, reported
            # as ||.||_1 (cell mean) and ||.||_inf (cell max) norms.
            conv = {"window_frames": eq_count}
            if eq_paths:
                dev = np.zeros_like(mean[0])
                for path in eq_paths:
                    dev += np.abs(fields_io.read_frame(path)["rho"] - mean[0])
                dev /= len(eq_paths)
                conv.update({"rho_dev_l1": float(dev.mean()),
                             "rho_dev_linf": float(dev.max()),
                             "window_frames": len(eq_paths)})
            with open(os.path.join(cfg.out_dir, "convergence.json"),
                      "w") as fh:
                json.dump(conv, fh)
            metrics.log(last, **conv)
    finally:
        # drain pending async frame writes on any exit: an exception mid-run
        # must not drop submitted frames
        if frame_writer is not None:
            frame_writer.close()
        metrics.close()
    tm["io"] += time.perf_counter() - t0
    tm["total"] = time.perf_counter() - t_start
    tm["ref_backup"] = sess.ref_backup_s
    tm["ref_retry_steps"] = sess.ref_retry_steps
    last_run_stats.clear()
    last_run_stats.update(tm)
    return state


def _droplet_record(rho: np.ndarray) -> dict:
    """One online droplet-fit record: tanh-profile (R, W) fit about the
    excess-mass COM (fittingDropletParams, LBM_hydrovs.H:117-213) plus
    the equivalent-sphere radius.  A non-converged tanh fit drops the
    (R, W) keys but still logs R_mass and the COM."""
    from .observables import droplet as drop_obs

    excess = rho - rho[0, 0, 0]
    com = drop_obs.center_of_mass(excess)
    rec = {"droplet_com": [float(c) for c in com],
           "droplet_R_mass": float(drop_obs.radius_from_mass(rho))}
    try:
        fit = drop_obs.fit_droplet(rho, com)
    except (RuntimeError, ValueError):
        return rec
    rec["droplet_R"] = fit["R"]
    rec["droplet_W"] = fit["W"]
    return rec


def _cfg_json(cfg: RunConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "") if cfg.dtype else None
    return d


def main(argv=None):
    """The CLI, on the card.  It keeps the JAX CLI's flags that have a
    meaning here; --distributed, --transform, --f64 and --profile-dir are
    not ported, nor --engine's pallas and halo (ROADMAP)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=preset_names(), default="mixture-eq")
    ap.add_argument("--out", default=None)
    ap.add_argument("--nsteps", type=int, default=None)
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--kBT", type=float, default=None)
    ap.add_argument("--alpha0", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--plot-int", type=int, default=None)
    ap.add_argument("--print-int", type=int, default=None)
    ap.add_argument("--plot-fmt", default=None,
                    choices=["auto", "npz", "native", "h5", "amrex"])
    ap.add_argument("--sf-window", type=int, default=None)
    ap.add_argument("--sf-every", type=int, default=None)
    ap.add_argument("--out-noise-int", type=int, default=None)
    ap.add_argument("--init-width", type=float, default=None,
                    help="initial tanh interface width in cells "
                         "(0 = sqrt(kappa); stabilizes deep quenches)")
    ap.add_argument("--radius", type=float, default=None,
                    help="droplet init radius (fraction of box)")
    ap.add_argument("--rho-lo", type=float, default=None)
    ap.add_argument("--rho-hi", type=float, default=None)
    ap.add_argument("--kappa", type=float, default=None)
    ap.add_argument("--tau-f", type=float, default=None)
    ap.add_argument("--tau-g", type=float, default=None)
    ap.add_argument("--ref-state", default=None,
                    help="equilibrium artifact enabling USE_REF_STATE noise")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--mesh", type=int, nargs=3, default=None,
                    help="device mesh shape (x y z)")
    ap.add_argument("--engine", choices=["auto", "jnp"], default="auto",
                    help="auto: the kernel session; jnp: the plain step "
                    "(CUDA graphs of a chunk on the card, no mass "
                    "restore); the JAX CLI's pallas and halo are not "
                    "ported")
    ap.add_argument("--block", type=int, default=None,
                    help="K steps per kernel launch (temporal blocking; "
                    "default auto)")
    ap.add_argument("--noise-dist", default=None,
                    choices=["clt4", "clt2", "u8", "bm"],
                    help="hash-stream normal generator (default clt4; "
                    "clt2: cheapest, exact first/second moments, support "
                    "+-2.44 sigma)")
    ap.add_argument("--mass-restore-int", type=int, default=None,
                    help="re-pin total f/g mass to the run's invariant "
                    "every N steps (default 1000; 0 disables)")
    ap.add_argument("--noise-source", default=None,
                    choices=["threefry", "hash"],
                    help="jnp-engine noise stream; 'hash' = per-cell "
                    "coordinate-keyed (RANDRAW analog, reconstructible; "
                    "requires --engine jnp); 'threefry' = the bulk "
                    "source, a generator seeded with the step's word and "
                    "the step")
    args = ap.parse_args(argv)

    cfg = preset(args.preset)
    if args.out:
        cfg = cfg.replace(out_dir=args.out)
    if args.nsteps is not None:
        cfg = cfg.replace(nsteps=args.nsteps)
    if args.shape is not None:
        cfg = cfg.replace(shape=tuple(args.shape))
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.plot_int is not None:
        cfg = cfg.replace(plot_int=args.plot_int)
    if args.print_int is not None:
        cfg = cfg.replace(print_int=args.print_int)
    if args.plot_fmt is not None:
        cfg = cfg.replace(plot_fmt=args.plot_fmt)
    if args.sf_window is not None:
        cfg = cfg.replace(sf_window=args.sf_window)
    if args.sf_every is not None:
        cfg = cfg.replace(sf_every=args.sf_every)
    if args.out_noise_int is not None:
        cfg = cfg.replace(out_noise_int=args.out_noise_int)
    if args.radius is not None:
        cfg = cfg.replace(init_radius=args.radius)
    if args.init_width is not None:
        cfg = cfg.replace(init_width=args.init_width)
    if args.ref_state:
        cfg = cfg.replace(use_ref_state=True, ref_state_path=args.ref_state)
    for name in ("rho_lo", "rho_hi", "kappa", "tau_f", "tau_g"):
        v = getattr(args, name)
        if v is not None:
            cfg = cfg.with_params(**{name: v})
    if args.checkpoint:
        cfg = cfg.replace(checkpoint_path=args.checkpoint, init="checkpoint")
    if args.kBT is not None:
        cfg = cfg.with_params(kBT=args.kBT)
    if args.alpha0 is not None:
        cfg = cfg.with_params(alpha0=args.alpha0)
    if args.noise_source is not None:
        cfg = cfg.replace(noise_source=args.noise_source,
                          **({"noise_dist": args.noise_dist}
                             if args.noise_dist is not None else {}))

    mesh = None
    if args.mesh is not None:
        mesh = mesh_lib.make_mesh(tuple(args.mesh))
    opts = {k: v for k, v in (("block", args.block),
                              ("noise_dist", args.noise_dist),
                              ("mass_restore_int", args.mass_restore_int))
            if v is not None}
    state = run(cfg, mesh=mesh, engine=args.engine, **opts)
    print(json.dumps({"final_step": int(state.step),
                      "out_dir": cfg.out_dir}))


if __name__ == "__main__":
    main()
