#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``bflbm_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

0. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; no CUDA device -> exit 1 with no result;
1. build every kernel library (one ``nvcc`` per source, in parallel) and
   print the build time and the ptxas register / spill counts of every
   instantiation;
2. the uncoupled K kernel against its plain PyTorch version on the card:
   one K on a perturbed state at 32^3 (kBT = 0 and 1e-5) and at 256^3,
   max |delta| <= 2e-5; time both at 256^3; a 32^3 session (enter + 4 +
   5 K steps + exit) against the plain step chain with the same words;
3. the mixture path: a 256^3 uniform mixture at kBT = 1e-5 driven by
   FusedSession — enter, 11 x advance(100) (crossing the mass restore at
   step 1000), exit_view — with the launch count, finiteness and the
   total masses and the density equipartition checked, and the session
   rate in MLUPS;
4. the coupled kernels (density pre-pass A, coupled K step B) against
   their plain versions, max |delta| <= 2e-5: 32^3 droplets (kBT 0; kBT
   1e-5 with u8 and with clt4; the pseudopotential), the flat interface
   at its own shape 8x256x64 (interface-fluct physics, clt4) and the
   256^3 droplet (clt4), where A, B (and B in its other modes), the pair,
   the plain versions and a library convolution are timed; a 32^3
   coupled session (1 + 4 + 5 steps) against the plain chain;
5. the coupled path: the droplet-fluct physics at 256^3 (make_initial_
   state of droplet-eq with kBT = 1e-5, make_session, clt4) — enter,
   11 x advance(100), exit_view — with both kernels' launch counts,
   finiteness, the masses after the restore, the droplet's centre of mass
   and volume ratio, and the session MLUPS;
6. the K modes of the run driver's flags against their plain versions,
   max |delta| <= 2e-5: general tau (K1d in population space, coupled and
   uncoupled, kBT 0 and 1e-5 with clt4, and the FORCE_GENERAL_RELAX hook
   at tau 1/2), the USE_REF_STATE operand (K1e, clt4 and u8), the clt2 and
   Box-Muller generators (uncoupled and coupled; Box-Muller also with the
   ref operand) on 32^3 droplets and on the 256^3 droplet, where B is
   timed in each mode beside its plain version, and K1d (coupled and
   uncoupled) and Box-Muller (with and without ref) also from a CUDA
   graph, printed with their bound, its share and the ptxas registers and
   spills of their instantiation; a ref session through a COM
   cell-boundary crossing against the plain per-step chain;
7. the run driver at 256^3, in a temporary directory under build/ that
   is removed afterwards: (1) the droplet-eq equilibration through
   ``run.main`` (400 steps; checkpoint, equilibrium artifact, convergence
   report, frames, droplet records, 399 launches of each kernel); (2) the
   fluctuating continuation through ``run.run`` with USE_REF_STATE and
   clt4 (1100 steps, a droplet record every 200; launches, the ref-roll
   counter, the masses after the restore at step 1000, the droplet's
   drift and radius, the driver's MLUPS and its time split); (3) 50-step
   continuations through ``run.run`` with tau 0.7 / 0.6, clt2, Box-Muller
   and Box-Muller with USE_REF_STATE, and 50 steps of the 256^3 mixture
   with tau 0.7 / 0.6 (uncoupled K1d); (4) S(k) through the driver on a
   64^3 mixture (the density
   structure factor over kBT / cs^2 within 5% of 1).  The 256^3 frames
   are ``.bflbm`` files written by the native async writer;
8. the alpha1 path (K1c: alpha0 = 1.2, alpha1 = 0.5, kappa = 0.1, rho_lo
   = 0.1, rho_hi = 3, the JAX package's alpha1 session configuration):
   (a) the laplacian pre-pass L and the K step B-A1 against their plain
   versions, max |delta| <= 2e-5, on 32^3 droplets (no noise, u8, clt4,
   clt2, Box-Muller; alpha0 0 and 1.2; exact and general tau; with and
   without the ref operand; the pseudopotential), on 20 x 12 x 40 (the
   tiles ragged) and on the 256^3 droplet, where A, L,
   B-A1, the triple, their plain versions and a circular ``Conv3d`` with
   the 19 laplacian taps are timed, and L's and B-A1's x-marching tiles
   printed (tile, x chunk, shared memory a block, time, bound and the
   share of the bound); (b) the 256^3 alpha1 droplet session
   with kBT = 1e-5 and clt4, 1 + 1100 steps with the restore at step 1000
   (launches of A, L and K, finiteness, masses, the droplet's centre of
   mass, MLUPS); (c) ``run(cfg)`` at 256^3 for 300 steps with frames at
   0 and 300 (``fmt="auto"``: a ``.bflbm`` written through the
   ``AsyncFieldWriter``), read back and held against the plain hydro of
   the final state, with the loop's wall split;
9. the decomposed path (K7 ext mode), the blocks of every mesh on one
   card: (a) ext A, L and K against their plain ext versions, max |delta|
   <= 2e-5, on 32^3 droplets in five modes (u8 uncoupled, clt4 with
   alpha0, alpha1, general tau, the ref operand) on meshes (2, 1, 1),
   (1, 2, 2) and (2, 2, 1), with the blocks' hash words and K's interiors
   against the whole domain's, bitwise; at 256^3 on mesh (2, 1, 1) the
   same checks and the ext kernels, their plain versions and the
   exchange timed per step beside the whole-domain kernels, and one 256^3
   block (the domain with its own x wrap as pads); (b) the phase-5
   droplet through ShardedSession on meshes (2, 1, 1) and (2, 2, 1), 1 +
   1100 steps with the restore at step 1000, against phase 5's
   FusedSession at steps 901 and 1101 (bitwise printed), with launches
   per block, MLUPS and the exchange's time; (c) ``run(cfg, mesh=(2, 1,
   1))`` with alpha1 at 256^3 for 100 steps, its final frame read back
   against the frame of the same run without a mesh;
10. the rest of K7, the blocks on one card: (a) A, L and K launched on
   the overlap split's windows (the interior window and the seam bands)
   into NaN-filled outputs, in four modes (u8 uncoupled, clt4 with
   alpha0, alpha1, the ref operand) on meshes (2, 1, 1) and (2, 2, 1):
   each writes exactly its window, bitwise the whole-block ext launch
   there, within 2e-5 of the plain versions; A and K fed by the exchanged
   y strips on (2, 2, 1) with NaN y pads, within 2e-5 of plain and
   bitwise the pad-fed launch, the strips K writes bitwise its edge rows;
   32^3 split and strips sessions bitwise the serial one through a
   restore; (b) at 256^3 the K launches of a step on the windows,
   strip-fed and pad-fed timed, and the phase-5 droplet through the split
   ShardedSession on (2, 1, 1) and (2, 2, 1) and the strips one on
   (2, 2, 1), 1 + 1100 steps with the restore at step 1000, against phase
   9b's serial sessions at steps 901 (bitwise printed) and 1101, with
   MLUPS, launches by mode, the host's enqueue time and, from CUDA
   events, each sweep's step split into exchange, interior kernels,
   exposed exchange and bands;
11. K4, T K steps a launch with the intermediate steps in shared memory
   (``csrc/blocked_step.cu``): (a) one launch at T = 2, 3, 4 in every
   uncoupled mode (noise off, u8, clt4, clt2, Box-Muller, the ref
   operand, general tau) at 32^3 and at 20 x 12 x 40, which no tile
   divides, against its plain version (the plain sweep on the kernel's
   tiles) and against T one-step K launches with the same words, max
   |delta| <= 2e-5, bitwise printed; (b) at 256^3 the same for u8
   against the plain sweep on one whole-domain tile (timed), and the K
   launch and the K4 launches timed in every mode (ms a launch and a
   step, and which T gives the fastest step; the sessions take 1); (c)
   phase 3's mixture session at T = 1, 2, 3, 4 (u8) and T = 3 (clt4):
   launches (11 x (100 // T) K4, 11 x (100 % T) K), masses after the restore, density
   variance, MLUPS, ms a step beside the bound; (d) the mixture's two
   phases through ``run.main`` at 64^3, the fluctuating one with
   ``--block 2``: S(k) within 5% of kBT / cs^2, beside phase 7's;
12. K4 with the force (the coupled droplet at T = 2, 3, alpha1 at
   T = 2; psi and its laplacian recomputed inside every phase): (a) one
   launch in every mode (noise off, u8, clt4, clt2, Box-Muller, the ref
   operand, general tau) at 32^3, at 20 x 12 x 40 and on the 256^3
   droplet one step in, against its plain version and against T one-step
   A + B (A + L + B-A1) launches, max |delta| <= 2e-5, bitwise printed,
   and no pre-pass launched; (b) at 256^3 the K4 launch timed in every
   mode beside the one-step pair (triple) with the bound a step and the
   fastest T (the sessions take 1), and each T's sub-tile, cluster, warp
   groups, shared memory a block and registers; (c) phase 5's droplet
   session at the default block (1), T = 2 and 3 (launches, those on
   clusters of more than one block, all of them at T = 2, masses, COM
   drift, volume ratio, MLUPS, step 901 against phase 5's) and phase 8's alpha1
   session at T = 2; (d) the droplet campaign at 64^3 through ``run.main
   --block 2`` and ``run(cfg, block=2)`` with USE_REF_STATE; and the
   ref case of ROADMAP Queue 3 (random amplitudes 1 + 0.1 U on the 256^3
   rho_lo = 0 droplet) printed with the guards its worst cell reads;
13. K4 on the decomposed path (``blocked_step.cu`` in its EXT mode, pads
   sd T deep, one exchange a sweep), the blocks on one card: (a) one ext
   K4 launch a block at sd = 1 (T = 2, 3), 2 (T = 2, 3) and 3 (T = 2) in
   every mode on meshes (2, 1, 1), (1, 2, 2) and (2, 2, 1) at 32^3 and
   at 20 x 12 x 40, against the plain ext sweep (max |delta| <= 2e-5),
   T one-step ext launches with an exchange before each and the
   whole-domain K4 launch on the block (bitwise, printed); (b) at 256^3
   on (2, 1, 1), T = 2, the same checks and the ext K4 launches and the
   exchange timed per sweep beside the whole-domain K4 and block 1's
   ext A + B (coupled clt4 and general tau; ext K uncoupled, noise off);
   (c) phase 5's droplet through ``ShardedSession(block=2)`` on (2, 1, 1)
   and (2, 2, 1), 1 + 1100 steps, against phase 12's
   ``FusedSession(block=2)`` at steps 901 (bitwise printed) and 1101,
   with launches a block, MLUPS and the exchange's ms a step, and the
   uncoupled mixture with the noise off on (2, 1, 1) at T = 2 and 1;
   (d) the 64^3 droplet campaign through ``run.main --mesh 2 1 1 --block
   2`` and ``run(cfg, mesh=(2, 1, 1), block=2)`` with USE_REF_STATE, its
   frames read back against the same campaign without a mesh;
14. K4 in the overlap split and the y strips (``blocked_step.cu``'s EXT
   mode on a window of the interior, or fed by the received y strips):
   (a) the K4 launches of one sweep at sd = 1 (T = 2, 3), 2 (T = 2, 3)
   and 3 (T = 2) in the modes off, u8, ref and general tau, for the split
   on (2, 2, 1) and (2, 1, 1), overlap="force" on (1, 1, 1) and the
   strips on (2, 2, 1) and (2, 1, 1), at 32^3 and 20 x 12 x 40 (cases
   without a split counted): the interior window on a block whose every
   pad is NaN writes exactly its window, finite, and with the seam bands
   the interior bitwise the serial ext K4 launch; the strip-fed launch
   with NaN y pads bitwise the serial launch, the strips it writes bitwise
   its edge rows; every launch within 2e-5 of plain; (b) at 256^3 on
   (2, 2, 1) the windowed and strip-fed launches of a sweep timed beside
   the serial ones, and phase 5's droplet through ShardedSession(block=2)
   on (2, 2, 1) with overlap=True and with y_exchange="strips", and the
   mixture with the noise off on (2, 1, 1) with overlap=True, 1 + 1100
   steps, against phase 13c's serial T = 2 sessions at steps 901 (bitwise)
   and 1101, with launches a block, MLUPS and each sweep's CUDA-event
   split beside the serial sweep's;
15. the platform probes (``bflbm_tpu_torch.probes``, the counterparts of
   the TPU probes under ``benchmarks/``) at 256^3 through their entry
   point ``probes.run`` (``python -m bflbm_tpu_torch.probes``): the
   library copy; the bulk (TMA) and staged copies through shared memory,
   a persistent ring at every (chunk, stages) of ``platform.copy_configs``
   (bitwise ``f.clone()``, each timed); the
   19 x 19 transform and its inverse unrolled and on the tensor cores in
   3xTF32 (within 2e-5 of the plain einsum; two ``torch.matmul`` timed);
   the mixture session (kBT 0 at block 2, 1e-5 at block 1); the twelve
   noise-generator cases (nine hash, three Philox; within 2e-5 of plain,
   ns a cell); 400 chained (8, 128) launches eager and replayed from a
   CUDA graph (bitwise 400, beside ``torch.add`` both ways); every probe
   kernel timed with CUDA events (best of 3) beside its bound, its plain
   version and its library call, then held against its plain version
   again on other inputs outside the counted run; a noise case's bound is
   the larger of its ALU-pipe integer operations over the INT32 rate and
   its FMA-pipe ones over the float32 rate (``noise_micro.OPS``, counted
   on the fast path of the kernel's SASS by ``tools/noise_ops.py``);
16. the analysis path (``python -m bflbm_tpu_torch.analysis``, no kernel
   of its own): every subcommand through ``analysis.main`` on the card,
   then with ``--device cpu`` on the same inputs, the JSON numbers within
   1e-9 relative of each other (1e-6 for fitted ones) and each wall
   printed.  droplet, convergence and msd read phase 7's three 256^3
   droplet-eq frames before phase 7 deletes them (so they run within
   phase 7), and marching cubes with its solid-angle harmonics and the
   ray map with its harmonics run on the last of them (faces equal,
   vertices within 1e-12); radius reads phase 7's continuation metrics,
   sk its 64^3 structure factors; noise, interface, laplace and msd read
   small runs made here (a 64^3 mixture with noise dumps, the
   interface-fluct physics at 8 x 256 x 64 from a stripe, two 64^3
   fluctuating droplets of radius 0.2 and 0.25 of the box); theory takes
   no input.  The results are held to the physics where a short run
   allows it (radii, S(k), the noise variances, the binodal);
17. the physics acceptance phases (``python -m bflbm_tpu_torch.acceptance``
   through its main, no kernel of their own), cut in steps where the
   protocol is long: (a) d at its full protocol (5 radii x 20,000 steps
   at 32^3), each R / L within 0.5% of the JAX package's (ACCEPTANCE.md
   phase D) and the Laplace slope within 1% of 0.021617; (b) b-kernel
   with u8 at 64 x 64 x 128 cut to 20,000 steps (a 10,000-step window,
   100 S(k) frames), every one of the 11 ratios within 3% of 1; (c) e at
   32^3 cut to one 100,000-step run, its rows finite and R_mass_mean
   within 10% of 5.05; (d) c, 3000 + 20,000 steps, gamma finite and
   positive; (e) f cut to 50,000 steps, then f-static on its artifacts,
   R0 within 3% of 7.53 and every gamma finite; (f) massdrift at 256^3
   cut to 3000 steps, the restored run's end relative drift within 5e-7
   (the unrestored one printed).  The phases run in four worker
   processes sharing the card (these boxes are host-bound), each zeroing
   the launch counts before its phases and reporting them after each;
   K in u8 and clt4 and A must have launched;
18. the plain engine (``run(cfg, engine="jnp")``, the JAX package's jnp
   engine: the plain PyTorch step on the card, CUDA graphs of ten steps,
   no mass restore) with the bulk noise source on the 8 x 256 x 64
   interface (interface-fluct physics from its stripe, 2000 steps, a
   frame every 500): its frames finite, the total mass within 1e-6
   relative of the start's, the graph replays counted; the bulk normals'
   per-channel variance within 2% of 1; a graph replay of 23 steps (two
   chunks and an eager remainder) bitwise the eager steps; us a step.

Phases 9 and 10 pass ``block=1``: they check the one-step launches.

Each phase prints its wall time.  Phase 0 prints the card's name and
power limit on a line of its own, as ``nvidia-smi`` gives them; the line
before the last is a JSON object with the per-kernel record; the last
line is the status JSON.
"""

import dataclasses
import json
import subprocess
import sys
import time

TOL = 2e-5            # f32 kernel vs plain torch: 1/x vs divide, FMA
MASS_RTOL = 1e-6
VAR_RTOL = 0.02       # 16.7M cells: sampling error ~1e-3
COM_TOL = 0.25        # cells
VOL_RANGE = (0.85, 1.05)
CS2 = 1.0 / 3.0
SMALL = (32, 32, 32)
SHAPE = (256, 256, 256)
INTERFACE = (8, 256, 64)
KBT = 1e-5
CHUNK, NCHUNKS = 100, 11
NREP = 20             # launches per timed run
# The card's published peaks (H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores (132 SMs x 128 FMA lanes x
# 2 at the 1.98 GHz boost clock); INT32 operations/s of the ALU pipe at 64
# a clock an SM (integer multiplies run on the FMA pipe and count with the
# float operations).
HBM_BPS = 3.35e12
F32_OPS = 67e12
SMS, CLOCK_HZ = 132, 1.98e9
INT32_OPS = 64 * SMS * CLOCK_HZ
# Bytes each kernel must move per cell (each input read once, each output
# written once) and operations per cell counted from its source (an FMA
# counts 2; integer hash operations count 1 at the float32 rate):
#   K uncoupled, u8: pull sums 266, back transforms 1404, noise ~300, rest
#     ~130;
#   K coupled, clt4: + gradients 216, forces and Guo rows ~80, clt4 words
#     ~560 in place of u8's ~170;
#   density pre-pass: 38 adds (+2 exp under the pseudopotential).
#   K1d (general tau, coupled): B + lam m_eq (~20) and the relaxation
#     (1 - lam) f_i + [M_INV q]_i, 19 FMAs a species (76), in population
#     space; uncoupled (clt4): K uncoupled with clt4's words (~+390) + the
#     same ~96;
#   K1e (ref, coupled): B + 8 B/cell for the ref operand, same operations;
#   clt2 (coupled): 17 hash words in place of clt4's 33 (~-250);
#   Box-Muller (coupled): 34 hash words, 17 logf + sincosf + sqrtf
#     (~100 each) in place of the byte sums.
KERNELS = {
    "k1a": dict(bytes=2 * 19 * 4 * 2, ops=2100),
    "a": dict(bytes=2 * 19 * 4 + 2 * 4, ops=40),
    "b": dict(bytes=2 * 19 * 4 * 2 + 2 * 4, ops=2800),
    "k1d": dict(bytes=2 * 19 * 4 * 2 + 2 * 4, ops=2900),
    "k1d_u": dict(bytes=2 * 19 * 4 * 2, ops=2590),
    "k1e": dict(bytes=2 * 19 * 4 * 2 + 2 * 4 + 2 * 4, ops=2810),
    "clt2": dict(bytes=2 * 19 * 4 * 2 + 2 * 4, ops=2550),
    "bm": dict(bytes=2 * 19 * 4 * 2 + 2 * 4, ops=4500),
    "bm_ref": dict(bytes=2 * 19 * 4 * 2 + 2 * 4 + 2 * 4, ops=4510),
    # laplacian pre-pass L: reads psi, writes lap (8 B each); 18 FMAs and
    # the centre term per species
    "l": dict(bytes=2 * 4 + 2 * 4, ops=80),
    # B-A1 (alpha0 != 0, clt4): B + 8 B/cell for lap, + the second pair
    # of 18-neighbour gradients (216) and the square-gradient terms
    "b_a1": dict(bytes=2 * 19 * 4 * 2 + 2 * 4 + 2 * 4, ops=3030),
}
# the ext modes (K7) move the same bytes per cell of their region; the
# windows of a step cover the interior once; the strips add the bytes of
# the strips K writes (_kernel_ms_22)
KERNELS.update(a_ext=KERNELS["a"], l_ext=KERNELS["l"], k_ext=KERNELS["b"],
               k_window=KERNELS["b"], k_ystrips=KERNELS["b"])
SRC = "bflbm_tpu_torch/kernels/csrc/"
TPU_KERNEL = "bflbm_tpu/kernels/fused_step.py:1956"
# the probe kernels (phase 15): source and the TPU probe each replaces
PROBE_KERNELS = {
    "copy": ("probe_copy.cu", "benchmarks/tpu_probe.py:75"),
    "transform": ("probe_transform.cu", "benchmarks/tpu_probe.py:162"),
    "noise": ("probe_noise.cu", "benchmarks/tpu_noise_micro.py:294"),
    "launch": ("probe_launch.cu", "benchmarks/tpu_overlap_r5.py:87"),
}


def _maxdiff(a, b):
    return float((a - b).abs().max())


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _work_cells(key, cells):
    """Cells a kernel works on at the main path's shape: the ext pre-passes
    of mesh (2, 1, 1) compute one ring beyond each block on x (A's 2-deep
    pads less 1; L's 3-deep pads less 2)."""
    if key in ("a_ext", "l_ext"):
        return cells * (SHAPE[0] + 4) // SHAPE[0]
    return cells


def _bound_ms(key, cells, extra_bytes=0):
    """The least time for the kernel's work at `cells` cells (and
    `extra_bytes` more to move), and what sets it: the larger of the
    bytes over the memory rate, the float operations over the float32
    rate and the integer ALU ones (`int_ops`, where counted apart) over
    the INT32 rate."""
    k = KERNELS[key]
    t_bytes = (k["bytes"] * cells + extra_bytes) / HBM_BPS * 1e3
    t_ops = max(k["ops"] / F32_OPS, k.get("int_ops", 0) / INT32_OPS) \
        * cells * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_finite(*ts):
    import torch

    for t in ts:
        _check(bool(torch.isfinite(t).all()), "non-finite values")


def _kernel_vs_plain(shape, params, word, step, device):
    """One uncoupled K through the kernel and through k_step_reference;
    returns (max |delta|, kernel outputs, inputs)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models.binary_fluid import perturbed_populations

    f, g = perturbed_populations(shape, 7, device=device)
    before = fused_step.launches
    fo, go = fused_step.fused_stream_collide(f, g, word, step, params,
                                             noise_dist="u8")
    torch.cuda.synchronize()
    _check(fused_step.launches == before + 1,
           f"launches went {before} -> {fused_step.launches}, expected +1")
    fr, gr = fused_step.k_step_reference(f, g, word, step, params, "u8")
    _check_finite(fo, go)
    err = max(_maxdiff(fo, fr), _maxdiff(go, gr))
    print(f"[phase 2] K at {shape} kBT={params.kBT}: max|kernel - plain| = "
          f"{err:.3e} (tol {TOL})", flush=True)
    _check(err <= TOL, f"kernel disagrees with plain K: {err} > {TOL}")
    return err, (fo, go), (f, g)


def _session_vs_chain(params, f, g, noise_dist, tag):
    """32^3 slice end to end: enter + advance(4) + advance(5) + exit with
    injected words against the plain model chain of 10 steps (no mass
    restore on either side)."""
    import torch

    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.state import init_state

    words = [int(w) for w in torch.randint(-2 ** 31, 2 ** 31 - 1, (10,),
                                           generator=torch.Generator()
                                           .manual_seed(3)).tolist()]
    ref = model.nsteps(init_state(f.clone(), g.clone(), 0), params, 10, words,
                       noise_dist=noise_dist)
    sess = FusedSession(params, SMALL, noise_dist=noise_dist,
                        mass_restore_int=0)
    pc = sess.enter(init_state(f, g, 0), words[0])
    pc = sess.advance(pc, 4, words[1:5])
    pc = sess.advance(pc, 5, words[5:])
    got = sess.exit(pc)
    torch.cuda.synchronize()
    err = max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g))
    print(f"[{tag}] 32^3 session (1+4+5 steps) vs plain chain: "
          f"max|delta| = {err:.3e}", flush=True)
    _check(err <= TOL, f"session disagrees with plain chain: {err}")
    return err


def _masses(s):
    """The total masses (f, g) in float64 of a state, or of a decomposed
    one's block interiors."""
    import torch

    if hasattr(s, "blocks"):
        from bflbm_tpu_torch.parallel import mesh as mesh_lib

        return tuple(sum(float(mesh_lib.interior(b[k], s.pad)
                               .sum(dtype=torch.float64)) for b in s.blocks)
                     for k in (0, 1))
    return (float(s.f.sum(dtype=torch.float64)),
            float(s.g.sum(dtype=torch.float64)))


def _run_session(sess, state, tag, keep=None):
    """enter + NCHUNKS x advance(CHUNK) + exit_view with the launch
    counts set to 0 just before, checking the step, finiteness and the
    masses; returns (view, (K launches, pre-pass launches), advance
    seconds, enter seconds).  keep: a dict whose keys are steps at which
    the exit view is stored into it (outside the timed advances)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step

    m0f, m0g = _masses(state)

    def rel_mass(s):
        mf, mg = _masses(s)
        return abs(mf - m0f) / m0f, abs(mg - m0g) / m0g

    torch.cuda.synchronize()
    fused_step.reset_launch_counts()
    t0 = time.perf_counter()
    pc = sess.enter(state)
    torch.cuda.synchronize()
    t_enter = time.perf_counter() - t0
    masses = {}
    t_adv = 0.0
    for _ in range(NCHUNKS):
        t0 = time.perf_counter()
        pc = sess.advance(pc, CHUNK)
        torch.cuda.synchronize()
        t_adv += time.perf_counter() - t0
        if pc.step in (901, 1001):
            masses[pc.step] = rel_mass(pc)
        if keep is not None and pc.step in keep:
            keep[pc.step] = sess.exit_view(pc)
    view = sess.exit_view(pc)
    torch.cuda.synchronize()
    counts = (fused_step.launches, fused_step.density_launches)
    del pc
    masses["end"] = rel_mass(view)
    n_k = CHUNK * NCHUNKS
    print(f"[{tag}] step {view.step}, launches K {counts[0]}, density "
          f"pre-pass {counts[1]}", flush=True)
    _check(view.step == 1 + n_k and tuple(view.f.shape) == (19,) + SHAPE,
           f"bad result: step {view.step}, shape {tuple(view.f.shape)}")
    _check_finite(view.f, view.g)
    print(f"[{tag}] relative mass defect (f, g): step 901 "
          f"{masses[901][0]:.3e} {masses[901][1]:.3e}; after the restore at "
          f"step 1000 (step 1001) {masses[1001][0]:.3e} "
          f"{masses[1001][1]:.3e}; step {view.step} {masses['end'][0]:.3e} "
          f"{masses['end'][1]:.3e} (tol {MASS_RTOL} after the restore)",
          flush=True)
    _check(max(masses[1001] + masses["end"]) <= MASS_RTOL,
           "mass not conserved to the tolerance")
    return view, counts, t_adv, t_enter


def _time_ms(run, cells, n):
    from bflbm_tpu_torch.utils.timing import time_steps

    return time_steps(run, cells, n)["best_s"] / n * 1e3


def _perturbed_droplet(shape, params, seed, device, **init):
    from bflbm_tpu_torch.models import binary_fluid as model

    base = model.init_droplet(shape, params, device="cpu", **init)
    return model.perturbed_populations(shape, seed, base=base, device=device)


def _coupled_vs_plain(f, g, params, dist, tag, errs):
    """Kernels A and B (through fused_stream_collide) against the plain
    pre-pass and K on one input; appends to errs["a"], errs["b"] and
    returns the kernel outputs."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step

    before = (fused_step.launches, fused_step.density_launches)
    psi = fused_step.density_psi(f, g, params)
    fo, go = fused_step.fused_stream_collide(f, g, 24680, 1357, params,
                                             noise_dist=dist)
    torch.cuda.synchronize()
    _check((fused_step.launches, fused_step.density_launches)
           == (before[0] + 1, before[1] + 2),
           "coupled K did not launch the pre-pass and K once each")
    _check_finite(psi, fo, go)
    err_a = _maxdiff(psi, fused_step.density_psi_reference(f, g, params))
    fr, gr = fused_step.k_step_reference(f, g, 24680, 1357, params, dist)
    err_b = max(_maxdiff(fo, fr), _maxdiff(go, gr))
    del fr, gr
    print(f"[phase 4] {tag}: max|A - plain| = {err_a:.3e}, "
          f"max|K - plain| = {err_b:.3e} (tol {TOL})", flush=True)
    _check(err_a <= TOL and err_b <= TOL,
           f"coupled kernels disagree with plain: {err_a}, {err_b}")
    errs["a"].append(err_a)
    errs["b"].append(err_b)
    return psi, (fo, go)


def _library_density(f, g, device):
    """The pre-pass as one library call: a circular 3x3x3 convolution of
    the 38 populations with one-hot taps at -c_i (its time is a
    yardstick; the port never calls it).  Returns (module, input)."""
    import torch

    from bflbm_tpu_torch.lattice import C, Q

    conv = torch.nn.Conv3d(2 * Q, 2, 3, padding=1, padding_mode="circular",
                           bias=False, device=device)
    w = torch.zeros_like(conv.weight)
    for s in range(2):
        for i in range(Q):
            cx, cy, cz = (int(v) for v in C[i])
            w[s, s * Q + i, 1 - cx, 1 - cy, 1 - cz] = 1.0
    with torch.no_grad():
        conv.weight.copy_(w)
    return conv, torch.cat([f, g])[None]


# -- phase 6: the K modes of the driver's flags ------------------------------

def _mode_vs_plain(f, g, params, dist, ref, tag):
    """One K (pre-pass included when coupled) through the kernels and
    through the plain K in the same mode; returns max |delta|."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step

    before = fused_step.launches
    fo, go = fused_step.fused_stream_collide(f, g, 13579, 2468, params,
                                             noise_dist=dist, ref=ref)
    torch.cuda.synchronize()
    _check(fused_step.launches == before + 1, f"{tag}: K did not launch")
    _check_finite(fo, go)
    fr, gr = fused_step.k_step_reference(f, g, 13579, 2468, params, dist,
                                         ref)
    err = max(_maxdiff(fo, fr), _maxdiff(go, gr))
    print(f"[phase 6] {tag}: max|K - plain| = {err:.3e} (tol {TOL})",
          flush=True)
    _check(err <= TOL, f"{tag}: kernel disagrees with plain K: {err}")
    return err


def _ref_operand(f, g, shift):
    """A (2, X, Y, Z) USE_REF_STATE operand: the state's densities rolled
    by `shift` (what the session passes: rolled stored densities)."""
    import torch

    return torch.stack([f.sum(0), g.sum(0)]).roll(shift, (1, 2, 3)) \
        .contiguous()


def _modes_small(dev, errs):
    """The new modes on perturbed 32^3 droplets, against the plain K."""
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.ops import collide as collide_ops

    droplet = dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0)
    for kbt in (0.0, KBT):
        p = LBMParams(**dict(droplet, rho_lo=0.1, tau_f=0.7, tau_g=0.6,
                             kBT=kbt))
        f, g = _perturbed_droplet(SMALL, p, 31, dev, radius=0.3)
        errs["k1d"].append(_mode_vs_plain(
            f, g, p, "clt4", None, f"32^3 general tau 0.7/0.6 kBT={kbt}"))
    p = LBMParams(**dict(droplet, kBT=KBT))
    f, g = _perturbed_droplet(SMALL, p, 32, dev, radius=0.3)
    collide_ops.FORCE_GENERAL_RELAX = True
    try:
        errs["k1d"].append(_mode_vs_plain(
            f, g, p, "clt4", None, "32^3 FORCE_GENERAL_RELAX at tau 1/2"))
    finally:
        collide_ops.FORCE_GENERAL_RELAX = False
    ref = _ref_operand(f, g, (3, -2, 5))
    for dist in ("clt4", "u8"):
        errs["k1e"].append(_mode_vs_plain(f, g, p, dist, ref,
                                          f"32^3 ref operand, {dist}"))
    for dist in ("clt2", "bm"):
        for a0 in (0.0, 1.5):
            q = LBMParams(**dict(droplet, kBT=KBT, alpha0=a0))
            errs[dist].append(_mode_vs_plain(
                f, g, q, dist, None, f"32^3 {dist}, alpha0={a0}"))
            if dist == "bm":
                errs["bm_ref"].append(_mode_vs_plain(
                    f, g, q, dist, ref, f"32^3 bm + ref, alpha0={a0}"))
    for kbt in (0.0, KBT):
        q = LBMParams(**dict(droplet, rho_lo=0.1, alpha0=0.0, tau_f=0.7,
                             tau_g=0.6, kBT=kbt))
        errs["k1d_u"].append(_mode_vs_plain(
            f, g, q, "clt4", None, f"32^3 uncoupled general tau kBT={kbt}"))
    _bm_deviates(dev)


def _bm_deviates(dev):
    """Box-Muller's deviates in K's draw order (``fused_step.bm_normals``)
    against the plain ``bm_pair`` over the same hash uniforms, within
    1e-6 absolute, at 32^3 and 128^3."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import noise as noise_ops

    for shape in (SMALL, (128, 128, 128)):
        got = fused_step.bm_normals(-97531, 12, shape, dev)
        want = noise_ops.hash_normal_stack(-97531, 12, shape, torch.float32,
                                           "bm", device=dev)
        err = _maxdiff(got, want)
        print(f"[phase 6] Box-Muller deviates at {shape} (33 a cell): "
              f"max|kernel - plain bm_pair| = {err:.3e} (tol 1e-6)",
              flush=True)
        _check(err <= 1e-6, f"Box-Muller deviates off by {err}")
        del got, want


def _ref_session_crossing(dev):
    """The transactional ref session through a COM cell-boundary crossing
    against the plain chain that re-rolls every step."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.observables import stats

    params = LBMParams(alpha0=0.0, kBT=1e-8)
    shape = (8, 8, 128)
    state, rho, phi = model.boosted_state(shape, (0.0, 0.0, 0.35),
                                         device=dev)
    com = stats.center_of_mass(rho)
    words = [11 * k + 5 for k in range(8)]
    ref = model.nsteps(state.replace(f=state.f.clone(), g=state.g.clone()),
                       params, 8, words, ref_state=(rho, phi, com))
    sess = FusedSession(params, shape, mass_restore_int=0,
                        ref_fields=(rho, phi, com))
    pc = sess.enter(state, words[0])
    pc = sess.advance(pc, 7, words[1:])
    got = sess.exit(pc)
    torch.cuda.synchronize()
    err = max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g))
    print(f"[phase 6] ref session 8x8x128 boosted blob (1+7 steps): "
          f"crossings {sess.ref_violations()}, steps rerun "
          f"{sess.ref_retry_steps}; max|session - plain chain| = "
          f"{err:.3e} (tol {TOL})", flush=True)
    _check(sess.ref_violations() > 0, "no COM crossing in the ref session")
    _check(err <= TOL, f"ref session disagrees with the plain chain: {err}")
    return err


def _ptxas(lib, entry):
    """The ``-Xptxas -v`` registers and spills of one instantiation
    (``_build.ptxas_summary``), or "?"."""
    from bflbm_tpu_torch.kernels import _build

    return next((ln.split(": ", 1)[1] for ln in _build.ptxas_summary()
                 if ln.startswith(f"{lib} {entry}:")), "?")


# phase 6's modes of B at 256^3: key -> (K library, k_step_kernel template
# arguments <NOISE, DIST, FORCE, GENERAL, REF, A1, EXT>); the modes timed
# from a CUDA graph besides eagerly
GRAPH_MODES = {
    "k1d": ("fused_step_general_force", "<1,1,1,1,0,0,0>"),
    "k1d_u": ("fused_step_general", "<1,1,0,1,0,0,0>"),
    "bm": ("fused_step_force", "<1,3,1,0,0,0,0>"),
    "bm_ref": ("fused_step_force", "<1,3,1,0,1,0,0>"),
}


def _modes_256(dcfg, dev, cells, errs):
    """The new modes of B on the 256^3 droplet one step in: max |delta|
    against the plain K, kernel B timed in each mode beside the plain K,
    B's present coupled clt4 time on the same input, and Box-Muller with
    the ref operand; general tau also uncoupled (K without psi).  General
    tau and Box-Muller (with and without ref) are timed from a CUDA graph
    too (the device's time) and printed with their bound, its share and
    the ptxas registers and spills of their instantiation.  Returns key ->
    (ms, plain ms, eager ms): ms from the graph where there is one."""
    import dataclasses

    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.utils.timing import graph_ms

    dparams = dcfg.params
    pc = FusedSession(dparams, SHAPE).enter(
        model.make_initial_state(dcfg, device=dev))
    f, g = pc.f, pc.g
    del pc
    psi = fused_step.density_psi(f, g, dparams)
    fo, go = torch.empty_like(f), torch.empty_like(g)
    ref = _ref_operand(f, g, (1, -1, 2))
    general = dataclasses.replace(dparams, tau_f=0.7, tau_g=0.6)
    uncoupled = dataclasses.replace(general, alpha0=0.0)
    out = {}
    for key, p, dist, r, ps in (("b", dparams, "clt4", None, psi),
                                ("clt2", dparams, "clt2", None, psi),
                                ("bm", dparams, "bm", None, psi),
                                ("k1e", dparams, "clt4", ref, psi),
                                ("k1d", general, "clt4", None, psi),
                                ("k1d_u", uncoupled, "clt4", None, None),
                                ("bm_ref", dparams, "bm", ref, psi)):
        if key != "b":
            errs[key].append(_mode_vs_plain(f, g, p, dist, r,
                                            f"256^3 droplet, {key}"))

        def run():
            return [fused_step.launch_k(f, g, 1, i, p, (fo, go), ps, dist, r)
                    for i in range(NREP)]

        ms = _time_ms(run, cells, NREP)
        plain_ms = _time_ms(lambda: fused_step.k_step_reference(
            f, g, 1, 0, p, dist, r), cells, 1)
        out[key] = (graph_ms(run, NREP) if key in GRAPH_MODES else ms,
                    plain_ms, ms)
    print("[phase 6] B at 256^3 by mode, same input (kernel ms / plain "
          "ms): " + ", ".join(f"{k} {v[2]:.4f} / {v[1]:.2f}"
                             for k, v in out.items()), flush=True)
    for key, (lib, args) in GRAPH_MODES.items():
        ms, _, eager = out[key]
        bound, by = _bound_ms(key, cells)
        print(f"[phase 6] {key}: {ms:.4f} ms from a CUDA graph ({eager:.4f} "
              f"eager) against a bound of {bound:.4f} ms ({by}), "
              f"{bound / ms:.1%} of it; {lib} k_step_kernel{args}: "
              f"{_ptxas(lib, 'k_step_kernel' + args)}", flush=True)
    return out


# -- phase 7: the run driver -------------------------------------------------

def _metrics(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


def _print_split(tag, stats):
    print(f"[{tag}] wall split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stats.items()), flush=True)


def _npz_masses(path):
    import numpy as np

    with np.load(path) as d:
        return (float(d["f"].sum(dtype=np.float64)),
                float(d["g"].sum(dtype=np.float64)))


def _driver_eq(tmp, cells):
    """(1) droplet-eq at 256^3 through the CLI."""
    import os

    import torch

    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.kernels import fused_step

    eq = os.path.join(tmp, "eq")
    fused_step.reset_launch_counts()
    t0 = time.perf_counter()
    run_mod.main(["--preset", "droplet-eq", "--shape",
                  *(str(n) for n in SHAPE), "--nsteps", "400", "--plot-int",
                  "200", "--print-int", "100", "--out", eq])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fused_step.launches, fused_step.density_launches)
    print(f"[phase 7] equilibration (main, 400 steps) in {wall:.2f} s; "
          f"launches K {counts[0]}, pre-pass {counts[1]}", flush=True)
    _print_split("phase 7", run_mod.last_run_stats)
    _check(counts == (399, 399), f"launches {counts} != (399, 399)")
    need = ["checkpoint0000400.npz", "checkpoint0000400.json",
            "equilibrium.npz", "convergence.json", "metrics.jsonl"] + [
        f"plt{s:07d}.bflbm" for s in (0, 200, 400)]
    missing = [n for n in need if not os.path.exists(os.path.join(eq, n))]
    _check(not missing, f"equilibration did not write {missing}")
    with open(os.path.join(eq, "convergence.json")) as fh:
        conv = json.load(fh)
    recs = _metrics(os.path.join(eq, "metrics.jsonl"))
    drops = [r for r in recs if "droplet_R_mass" in r]
    print(f"[phase 7] convergence {conv}; droplet records at steps "
          f"{[r['step'] for r in drops]}, R_mass "
          f"{[round(r['droplet_R_mass'], 4) for r in drops]}", flush=True)
    _check(conv["window_frames"] == 2 and len(drops) == 4,
           "equilibrium window or droplet records wrong")
    return eq, os.path.join(eq, "checkpoint0000400")


def _driver_fluct(tmp, eq, ckpt, cells):
    """(2) droplet-fluct continuation with USE_REF_STATE through run()."""
    import os

    import numpy as np
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.kernels import fused_step

    m0 = _npz_masses(ckpt + ".npz")
    cfg = config.preset("droplet-fluct").replace(
        shape=SHAPE, checkpoint_path=ckpt, step_continue=400, nsteps=1100,
        use_ref_state=True, ref_state_path=os.path.join(eq,
                                                        "equilibrium.npz"),
        plot_int=0, print_int=100, droplet_int=200,
        out_dir=os.path.join(tmp, "fluct"))
    fused_step.reset_launch_counts()
    t0 = time.perf_counter()
    state = run_mod.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(run_mod.last_run_stats)
    counts = (fused_step.launches, fused_step.density_launches)
    modes = dict(fused_step.mode_launches)
    retry = int(st["ref_retry_steps"])
    print(f"[phase 7] continuation (run, ref + clt4, 1100 steps) in "
          f"{wall:.2f} s: step {state.step}; launches K {counts[0]}, "
          f"pre-pass {counts[1]}, by mode {modes}; steps rerun after a "
          f"crossing {retry}", flush=True)
    _print_split("phase 7", st)
    _check(state.step == 1500, f"final step {state.step} != 1500")
    _check(counts == (1099 + retry, 1099 + retry)
           and modes.get("ref") == counts[0]
           and modes.get("clt4") == counts[0],
           f"launches {counts}, modes {modes}")
    _check_finite(state.f, state.g)
    recs = _metrics(os.path.join(cfg.out_dir, "metrics.jsonl"))
    prints = [r for r in recs if "mass_f" in r]
    _check(prints and all("ref_roll_violations" in r for r in prints),
           "ref_roll_violations missing from the metrics")
    defect = max(max(abs(r["mass_f"] - m0[0]) / m0[0],
                     abs(r["mass_g"] - m0[1]) / m0[1])
                 for r in prints if r["step"] >= 1000)
    drops = [r for r in recs if "droplet_com" in r]
    com = np.asarray([r["droplet_com"] for r in drops])
    drift = float(np.linalg.norm(com[-1] - com[0]))
    r_mass = [r["droplet_R_mass"] for r in drops]
    r_dev = max(abs(r / r_mass[0] - 1.0) for r in r_mass)
    mlups = prints[-1]["mlups"]
    print(f"[phase 7] relative mass defect after the restore at step 1000 "
          f"{defect:.3e} (tol {MASS_RTOL}); droplet COM drift {drift:.4e} "
          f"cells (tol {COM_TOL}) over {len(drops)} records; R_mass "
          f"{r_mass[0]:.4f} -> {r_mass[-1]:.4f} (max deviation "
          f"{r_dev:.4f}, tol 0.02); ref_roll_violations "
          f"{prints[-1]['ref_roll_violations']}", flush=True)
    print(f"[phase 7] driver MLUPS over the loop {mlups:.1f} (session "
          f"advance alone {1100 * cells / st['advance'] / 1e6:.1f}); ref "
          f"backup copies {st['ref_backup']:.3f} s", flush=True)
    _check(defect <= MASS_RTOL, f"mass defect {defect}")
    _check(drift <= COM_TOL, f"droplet drifted {drift} cells")
    _check(r_dev <= 0.02, f"droplet radius moved {r_dev}")
    _check(os.path.exists(os.path.join(cfg.out_dir,
                                       "checkpoint0001500.npz")),
           "no end checkpoint")
    return counts[0], mlups


def _driver_flag_modes(tmp, eq, ckpt):
    """(3) short continuations with the flags' other K modes: general tau
    (coupled; uncoupled on the mixture), clt2, Box-Muller (with and
    without the ref operand); returns each mode's launches."""
    import os
    import shutil

    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.kernels import fused_step

    drop = dict(shape=SHAPE, checkpoint_path=ckpt, step_continue=400)
    launches = {}
    for key, tag, params, dist, preset, where in (
            ("k1d", "general", dict(tau_f=0.7, tau_g=0.6), "clt4",
             "droplet-fluct", drop),
            ("k1d_u", "general", dict(tau_f=0.7, tau_g=0.6), "clt4",
             "mixture-fluct", dict(shape=SHAPE, init="mixture",
                                   step_continue=0)),
            ("clt2", "clt2", {}, "clt2", "droplet-fluct", drop),
            ("bm", "bm", {}, "bm", "droplet-fluct", drop),
            ("bm_ref", "ref", {}, "bm", "droplet-fluct", dict(
                drop, use_ref_state=True,
                ref_state_path=os.path.join(eq, "equilibrium.npz")))):
        cfg = config.preset(preset).replace(
            nsteps=50, plot_int=0, print_int=50, droplet_int=0,
            sf_window=0, out_dir=os.path.join(tmp, key),
            **where).with_params(**params)
        fused_step.reset_launch_counts()
        t0 = time.perf_counter()
        state = run_mod.run(cfg, noise_dist=dist, block=1)
        torch.cuda.synchronize()
        modes = dict(fused_step.mode_launches)
        rec = _metrics(os.path.join(cfg.out_dir, "metrics.jsonl"))[-1]
        n = fused_step.launches
        retry = int(run_mod.last_run_stats["ref_retry_steps"])
        print(f"[phase 7] continuation {key} ({preset} through run, {dist}, "
              f"50 steps) in {time.perf_counter() - t0:.2f} s: launches K "
              f"{n}, by mode {modes}, steps rerun after a crossing {retry}; "
              f"rho min {rec['min']:.4e} max {rec['max']:.4f}", flush=True)
        _check(state.step == cfg.step_continue + 50 and n == 49 + retry
               and modes.get(tag) == n and modes.get(dist) == n,
               f"{key}: launches {n}, modes {modes}")
        _check_finite(state.f, state.g)
        launches[key] = n
        del state
        shutil.rmtree(cfg.out_dir)
    return launches


def _driver_structfact(tmp):
    """(4) S(k) through the driver: the 64^3 mixture's density structure
    factor, off k = 0, over kBT / cs^2."""
    import os

    import numpy as np

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod

    cfg = config.preset("mixture-fluct").replace(
        shape=(64, 64, 64), init="mixture", step_continue=0, nsteps=600,
        sf_window=400, sf_every=10, out_dir=os.path.join(tmp, "sk"))
    t0 = time.perf_counter()
    run_mod.run(cfg)
    with np.load(os.path.join(cfg.out_dir, "structfact0000600.npz")) as d:
        s_k = d["s_k"][0].real
    centre = tuple(n // 2 for n in s_k.shape)
    off = np.ones(s_k.shape, bool)
    off[centre] = False
    ratio = float(s_k[off].mean()) / (cfg.params.kBT / CS2)
    print(f"[phase 7] S(k) through the driver, 64^3 mixture, 40 frames "
          f"over steps 210-600, in {time.perf_counter() - t0:.2f} s: "
          f"mean Re S_rho,rho(k != 0) / (kBT / cs^2) = {ratio:.4f} "
          f"(tol 0.05)", flush=True)
    _check(abs(ratio - 1.0) <= 0.05, f"S(k) ratio {ratio}")
    return ratio


# -- phase 8: the alpha1 path -------------------------------------------------

ALPHA1 = dict(alpha0=1.2, alpha1=0.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0)


def _alpha1_vs_plain(f, g, params, dist, ref, tag, errs):
    """A, L and B-A1 through fused_stream_collide against the plain
    pre-passes and K in the same mode; appends to errs["l"], errs["b_a1"]
    and returns (psi, lap, outputs)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step

    before = (fused_step.density_launches, fused_step.laplacian_launches,
              fused_step.launches, fused_step.mode_launches.get("alpha1", 0))
    psi = torch.empty((2,) + tuple(f.shape[1:]), device=f.device)
    lap = torch.empty_like(psi)
    fo, go = fused_step.fused_stream_collide(f, g, 86420, 753, params,
                                             noise_dist=dist, psi=psi,
                                             ref=ref, lap=lap)
    torch.cuda.synchronize()
    after = (fused_step.density_launches, fused_step.laplacian_launches,
             fused_step.launches, fused_step.mode_launches.get("alpha1", 0))
    _check(after == tuple(b + 1 for b in before),
           f"{tag}: launches {before} -> {after}, expected one each")
    _check_finite(lap, fo, go)
    err_l = _maxdiff(lap, fused_step.laplacian_psi_reference(psi))
    fr, gr = fused_step.k_step_reference(f, g, 86420, 753, params, dist, ref)
    err_b = max(_maxdiff(fo, fr), _maxdiff(go, gr))
    del fr, gr
    print(f"[phase 8] {tag}: max|L - plain| = {err_l:.3e}, max|B-A1 - "
          f"plain| = {err_b:.3e} (tol {TOL})", flush=True)
    _check(err_l <= TOL and err_b <= TOL,
           f"{tag}: alpha1 kernels disagree with plain: {err_l}, {err_b}")
    errs["l"].append(err_l)
    errs["b_a1"].append(err_b)
    return psi, lap, (fo, go)


def _alpha1_small(dev, errs):
    """L and B-A1 against plain on perturbed 32^3 droplets in every mode
    B-A1 has, and on 20 x 12 x 40, which no tile divides."""
    from bflbm_tpu_torch.config import LBMParams

    general = dict(tau_f=0.7, tau_g=0.6)
    for tag, kw, dist, with_ref in (
            ("no noise", dict(), "u8", False),
            ("no noise, alpha0 = 0", dict(alpha0=0.0), "u8", False),
            ("u8", dict(kBT=KBT), "u8", False),
            ("clt4", dict(kBT=KBT), "clt4", False),
            ("clt2", dict(kBT=KBT), "clt2", False),
            ("Box-Muller", dict(kBT=KBT), "bm", False),
            ("clt4, alpha0 = 0", dict(kBT=KBT, alpha0=0.0), "clt4", False),
            ("clt4, pseudopotential", dict(kBT=KBT, use_sc_pseudo=True),
             "clt4", False),
            ("general tau, no noise, alpha0 = 0",
             dict(general, alpha0=0.0), "u8", False),
            ("general tau, clt4", dict(general, kBT=KBT), "clt4", False),
            ("clt4, ref", dict(kBT=KBT), "clt4", True),
            ("general tau, u8, ref, alpha0 = 0",
             dict(general, kBT=KBT, alpha0=0.0), "u8", True)):
        p = LBMParams(**dict(ALPHA1, **kw))
        f, g = _perturbed_droplet(SMALL, p, 41, dev, radius=0.3)
        ref = _ref_operand(f, g, (2, 3, -1)) if with_ref else None
        _alpha1_vs_plain(f, g, p, dist, ref, f"32^3 droplet, {tag}", errs)
    for tag, kw in (("clt4", dict(kBT=KBT)),
                    ("general tau, clt4", dict(general, kBT=KBT))):
        p = LBMParams(**dict(ALPHA1, **kw))
        f, g = _perturbed_droplet((20, 12, 40), p, 43, dev, radius=0.3)
        _alpha1_vs_plain(f, g, p, "clt4", None,
                         f"20 x 12 x 40 droplet, {tag}", errs)


def _library_laplacian(psi):
    """Kernel L's function as one library call: a circular 3x3x3
    convolution of each psi field with the 19 laplacian taps (its time is
    a yardstick; the port never calls it).  Returns the module."""
    import torch

    from bflbm_tpu_torch.lattice import C, CS2, Q, W

    conv = torch.nn.Conv3d(2, 2, 3, padding=1, padding_mode="circular",
                           groups=2, bias=False, device=psi.device)
    w = torch.zeros_like(conv.weight)
    for i in range(1, Q):
        cx, cy, cz = (int(v) for v in C[i])
        w[:, 0, 1 + cx, 1 + cy, 1 + cz] = float(2.0 / CS2 * W[i])
    w[:, 0, 1, 1, 1] = -float(2.0 / CS2 * W[1:].sum())
    with torch.no_grad():
        conv.weight.copy_(w)
    return conv


def _alpha1_256(dev, cells, errs):
    """L and B-A1 against plain on the 256^3 alpha1 droplet one step in;
    A, L, B-A1, the triple, the plain versions and the Conv3d timed.
    Returns the times."""
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.utils.timing import graph_ms

    acfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=KBT, **ALPHA1)
    ap = acfg.params
    pc = FusedSession(ap, SHAPE).enter(
        model.make_initial_state(acfg, device=dev))
    f, g = pc.f, pc.g
    del pc
    psi, lap, (fo, go) = _alpha1_vs_plain(f, g, ap, "clt4", None,
                                          "256^3 droplet (clt4)", errs)
    t = {}
    t["a"] = _time_ms(lambda: [fused_step.density_psi(f, g, ap, out=psi)
                               for _ in range(NREP)], cells, NREP)
    t["l"] = _time_ms(lambda: [fused_step.laplacian_psi(psi, out=lap)
                               for _ in range(NREP)], cells, NREP)
    t["b_a1"] = _time_ms(
        lambda: [fused_step.launch_k(f, g, 1, i, ap, (fo, go), psi, "clt4",
                                     lap=lap) for i in range(NREP)],
        cells, NREP)
    t["b"] = _time_ms(
        lambda: [fused_step.launch_k(f, g, 1, i, dataclasses.replace(
            ap, alpha1=0.0), (fo, go), psi, "clt4") for i in range(NREP)],
        cells, NREP)
    bufs = [(f, g), (fo, go)]

    def triple_run():
        for i in range(NREP):
            fused_step.fused_stream_collide(*bufs[i % 2], 1, i, ap,
                                            out=bufs[(i + 1) % 2],
                                            noise_dist="clt4", psi=psi,
                                            lap=lap)

    t["triple"] = _time_ms(triple_run, cells, NREP)
    # the device's time of L and B-A1, replayed from a CUDA graph: the
    # launches back to back, without the gaps the host's enqueue leaves
    # between short launches
    t["l_graph"] = graph_ms(lambda: [fused_step.laplacian_psi(psi, out=lap)
                                     for _ in range(NREP)], NREP)
    t["b_a1_graph"] = graph_ms(
        lambda: [fused_step.launch_k(f, g, 1, i, ap, (fo, go), psi, "clt4",
                                     lap=lap) for i in range(NREP)], NREP)
    t["a_plain"] = _time_ms(
        lambda: fused_step.density_psi_reference(f, g, ap), cells, 1)
    t["l_plain"] = _time_ms(
        lambda: fused_step.laplacian_psi_reference(psi), cells, 1)
    t["b_a1_plain"] = _time_ms(
        lambda: fused_step.k_step_reference(f, g, 1, 0, ap, "clt4"),
        cells, 1)
    conv = _library_laplacian(psi)
    with torch.no_grad():
        lib_err = _maxdiff(conv(psi[None])[0],
                           fused_step.laplacian_psi(psi, out=lap))
        t["l_lib"] = _time_ms(lambda: conv(psi[None]), cells, 1)
    print(f"[phase 8] 256^3 alpha1 droplet: A {t['a']:.4f} ms, L "
          f"{t['l']:.4f} ms, B-A1 {t['b_a1']:.4f} ms (B without alpha1 on "
          f"the same input {t['b']:.4f} ms), triple {t['triple']:.4f} ms "
          f"({cells / t['triple'] / 1e3:.1f} MLUPS); plain A "
          f"{t['a_plain']:.2f} ms, plain L {t['l_plain']:.2f} ms, plain K "
          f"{t['b_a1_plain']:.2f} ms; library Conv3d laplacian "
          f"{t['l_lib']:.3f} ms (max|conv - L| {lib_err:.3e})", flush=True)
    for kind in ("l", "b_a1"):
        ty, tz, xc = fused_step.stencil_tile(kind)
        smem = fused_step.stencil_smem_bytes(
            (ty, tz), fused_step.stencil_fields(kind, ap))
        bound, by = _bound_ms(kind, cells)
        ms = t[kind + "_graph"]
        print(f"[phase 8] {kind}: tiles of {ty} x {tz} (y, z) marching "
              f"{xc} x planes, {smem} B of shared memory a block; "
              f"{ms:.4f} ms from a CUDA graph ({t[kind]:.4f} eager) against "
              f"a bound of {bound:.4f} ms ({by}), {bound / ms:.1%} of it",
              flush=True)
    return t


def _alpha1_session(dev, cells):
    """The 256^3 alpha1 droplet session: 1 + 1100 steps, clt4, restore at
    step 1000; returns (K launches, L launches, MLUPS)."""
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import make_session
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.observables import stats

    acfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=KBT, **ALPHA1)
    state = model.make_initial_state(acfg, device=dev)
    com0 = stats.center_of_mass(state.f.sum(0))
    sess = make_session(acfg.params, SHAPE, noise_dist="clt4")
    view, counts, t_adv, t_enter = _run_session(sess, state, "phase 8")
    del state
    n_k = CHUNK * NCHUNKS
    lap_launches = fused_step.laplacian_launches
    modes = dict(fused_step.mode_launches)
    _check(counts == (n_k, n_k) and lap_launches == n_k
           and modes.get("alpha1") == n_k,
           f"launches K, A {counts}, L {lap_launches}, modes {modes}")
    rho = view.f.sum(0)
    drift = float((stats.center_of_mass(rho) - com0).norm())
    mlups = cells * n_k / t_adv / 1e6
    print(f"[phase 8] alpha1 session: launches A {counts[1]}, L "
          f"{lap_launches}, K {counts[0]} (by mode {modes}); droplet COM "
          f"drift {drift:.4e} cells (tol {COM_TOL}); rho min "
          f"{float(rho.min()):.4e} max {float(rho.max()):.4f}; enter "
          f"{t_enter * 1e3:.1f} ms; {n_k} steps in {t_adv:.3f} s = "
          f"{mlups:.1f} MLUPS", flush=True)
    _check(drift <= COM_TOL, f"droplet drifted {drift} cells")
    del view, rho, sess
    torch.cuda.empty_cache()
    return counts[0], lap_launches, mlups


def _alpha1_driver(tmp):
    """run(cfg) with alpha1 at 256^3: 300 steps, frames at 0 and 300
    (fmt="auto": .bflbm, the second through the AsyncFieldWriter), read
    back and held against the plain hydro of the final state."""
    import os

    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.io import fields as fields_io
    from bflbm_tpu_torch.io import native
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.ops import hydro as hydro_ops
    from bflbm_tpu_torch.state import peek_words

    submitted = []

    class Writer(native.AsyncFieldWriter):
        def submit(self, path, names, arrays):
            submitted.append(path)
            super().submit(path, names, arrays)

    cfg = config.preset("droplet-eq").replace(
        shape=SHAPE, nsteps=300, plot_int=300, print_int=100,
        droplet_int=0, plot_fmt="auto",
        out_dir=os.path.join(tmp, "alpha1")).with_params(kBT=KBT, **ALPHA1)
    real = native.AsyncFieldWriter
    native.AsyncFieldWriter = Writer
    try:
        fused_step.reset_launch_counts()
        t0 = time.perf_counter()
        state = run_mod.run(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        native.AsyncFieldWriter = real
    modes = dict(fused_step.mode_launches)
    frame = os.path.join(cfg.out_dir, "plt0000300.bflbm")
    print(f"[phase 8] run(cfg) alpha1, 300 steps, in {wall:.2f} s: step "
          f"{state.step}; launches A {fused_step.density_launches}, L "
          f"{fused_step.laplacian_launches}, K {fused_step.launches}, by "
          f"mode {modes}; async submits {submitted}", flush=True)
    _print_split("phase 8", run_mod.last_run_stats)
    _check(state.step == 300, f"final step {state.step} != 300")
    _check(modes.get("alpha1") == fused_step.launches == 299,
           f"alpha1 launches {modes}, K {fused_step.launches} != 299")
    _check(submitted == [frame], f"async writer took {submitted}")
    _check(os.path.exists(os.path.join(cfg.out_dir, "plt0000000.bflbm")),
           "frame 0 is not a .bflbm")
    _check_finite(state.f, state.g)
    got = fields_io.read_frame(frame)
    (word,) = peek_words(state.gen, 1)
    want = hydro_ops.pack(model.prelude(state, cfg.params, word)[0]).cpu()
    err = max(float(abs(got[n] - want[i].numpy()).max())
              for i, n in enumerate(hydro_ops.HYDRO_NAMES))
    print(f"[phase 8] frame {os.path.basename(frame)} read back: step "
          f"{int(got['step'])}, max|frame - plain hydro of the final state| "
          f"= {err:.3e} (tol {TOL})", flush=True)
    _check(int(got["step"]) == 300 and err <= TOL,
           f"frame disagrees with the final state: {err}")
    return fused_step.launches


# -- phase 9: the decomposed path (K7 ext mode) -------------------------------

EXT_MESHES = ((2, 1, 1), (1, 2, 2), (2, 2, 1))
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)
EXT_MODES = (
    ("u8 uncoupled", dict(kBT=KBT), "u8", False),
    ("clt4 alpha0", dict(_DROP, alpha0=1.5, kBT=KBT), "clt4", False),
    ("alpha1", dict(ALPHA1, kBT=KBT), "clt4", False),
    ("general tau", dict(_DROP, alpha0=1.5, kBT=KBT, tau_f=0.7, tau_g=0.6),
     "clt4", False),
    ("ref", dict(_DROP, alpha0=1.5, kBT=KBT), "clt4", True),
)
EXT_WORD, EXT_STEP = 97531, 864


def _padded_blocks(f, g, mesh, params, block=1):
    """(f, g) decomposed over `mesh` in the padded layout of the
    configuration's stencil depth sd (sd T at block T), pads exchanged;
    returns (state, the blocks' Ext)."""
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.state import init_state

    pad = mesh.pads(fused_step.sd_depth(params) * block)
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    return ss, halo.block_exts(mesh, tuple(f.shape[1:]), pad)


def _cells(ext, shape):
    """The global index of an Ext's interior."""
    return tuple(slice(o, o + n)
                 for o, n in zip(ext.origin, ext.interior(shape)))


def _ext_vs_plain(f, g, params, dist, ref, mesh, tag, errs):
    """A, L and K in ext mode on every block of (f, g) decomposed over
    `mesh`, each launched once, against the plain ext versions (max
    |delta| into errs["a_ext"], ["l_ext"], ["k_ext"]); K's interior
    against the whole-domain kernel's cells and each block's hash words
    against the whole domain's, bitwise.  Returns (K bitwise, words
    bitwise)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    whole = fused_step.fused_stream_collide(f, g, EXT_WORD, EXT_STEP, params,
                                            noise_dist=dist, ref=ref)
    words = fused_step.hash_words(EXT_WORD, EXT_STEP, f.shape[1:], 3,
                                  f.device)
    ss, exts = _padded_blocks(f, g, mesh, params)
    refs = (mesh_lib.shard_field(ref, mesh, ss.pad) if ref is not None
            else [None] * mesh.size)
    coupled = fused_step.is_coupled(params)
    alpha1 = fused_step.has_alpha1(params)
    k_bits = w_bits = True
    err = {"a_ext": 0.0, "l_ext": 0.0, "k_ext": 0.0}
    for b, ext in enumerate(exts):
        fb, gb = ss.blocks[b][0], ss.blocks[b][1]
        psi = torch.zeros((2,) + tuple(fb.shape[1:]), device=f.device)
        lap = torch.zeros_like(psi)
        before = (fused_step.density_launches, fused_step.laplacian_launches,
                  fused_step.launches, fused_step.mode_launches.get("ext", 0))
        fo, go = fused_step.fused_stream_collide(
            fb, gb, EXT_WORD, EXT_STEP, params, noise_dist=dist, psi=psi,
            lap=lap, ref=refs[b], ext=ext)
        torch.cuda.synchronize()
        after = (fused_step.density_launches, fused_step.laplacian_launches,
                 fused_step.launches, fused_step.mode_launches.get("ext", 0))
        _check(after == (before[0] + coupled, before[1] + alpha1,
                         before[2] + 1, before[3] + 1),
               f"{tag}: launches {before} -> {after}")
        _check_finite(ext.region(fo), ext.region(go))
        fr, gr = fused_step.k_step_reference(fb, gb, EXT_WORD, EXT_STEP,
                                             params, dist, refs[b], ext)
        err["k_ext"] = max(err["k_ext"], _maxdiff(ext.region(fo), fr),
                           _maxdiff(ext.region(go), gr))
        del fr, gr
        cells = _cells(ext, fb.shape)
        k_bits &= (torch.equal(ext.region(fo), whole[0][(slice(None),)
                                                        + cells])
                   and torch.equal(ext.region(go),
                                   whole[1][(slice(None),) + cells]))
        bw = fused_step.hash_words(EXT_WORD, EXT_STEP, ext.interior(fb.shape),
                                   3, f.device, ext.origin, ext.domain)
        w_bits &= all(torch.equal(x, y[cells]) for x, y in zip(bw, words))
        if coupled:
            err["a_ext"] = max(err["a_ext"], _maxdiff(
                ext.region(psi, 1),
                fused_step.density_psi_reference(fb, gb, params, ext)))
        if alpha1:
            err["l_ext"] = max(err["l_ext"], _maxdiff(
                ext.region(lap, 2),
                fused_step.laplacian_psi_reference(psi, ext)))
    print(f"[phase 9] {tag}: max|ext - plain ext| A {err['a_ext']:.3e}, L "
          f"{err['l_ext']:.3e}, K {err['k_ext']:.3e} (tol {TOL}); K interior "
          f"== whole-domain K bitwise: {k_bits}; hash words of the blocks == "
          f"the domain's bitwise: {w_bits}", flush=True)
    _check(max(err.values()) <= TOL, f"{tag}: ext kernels disagree: {err}")
    _check(w_bits, f"{tag}: the blocks' hash words differ from the domain's")
    for k, v in err.items():
        errs[k].append(v)
    return k_bits, w_bits


def _ext_small(dev, errs):
    """Phase 9a at 32^3: every mode of EXT_MODES on every mesh of
    EXT_MESHES, the blocks on one card."""
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    k_bits = w_bits = True
    for tag, kw, dist, with_ref in EXT_MODES:
        p = LBMParams(**kw)
        f, g = _perturbed_droplet(SMALL, p, 51, dev, radius=0.3)
        ref = _ref_operand(f, g, (2, -3, 1)) if with_ref else None
        for ms in EXT_MESHES:
            kb, wb = _ext_vs_plain(f, g, p, dist, ref,
                                   mesh_lib.make_mesh(ms, dev),
                                   f"32^3 {tag}, mesh {ms}", errs)
            k_bits &= kb
            w_bits &= wb
    return k_bits, w_bits


def _ext_256(dcfg, dev, cells, errs):
    """Phase 9a at the main path's shapes: the 256^3 droplet one step in
    on mesh (2, 1, 1), blocks 128 x 256 x 256 on one card with 2-deep x
    pads (3-deep with alpha1).  The ext kernels against the plain ext
    versions and, K, against the whole-domain kernel bitwise; A, K, L
    and B-A1 timed per step (both blocks) beside the plain versions and
    the whole-domain kernels on the same input; the exchange timed.  Then
    one 256^3 block: the whole droplet with its own periodic x wrap as
    pads, through ext A and K, against the whole-domain kernels."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.ops.blocked import Ext
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.utils.timing import graph_ms

    dparams = dcfg.params
    pc = FusedSession(dparams, SHAPE).enter(
        model.make_initial_state(dcfg, device=dev))
    f, g = pc.f, pc.g
    del pc
    mesh = mesh_lib.make_mesh((2, 1, 1), dev)
    t = {}
    k_bits = True
    a1p = dataclasses.replace(dparams, **ALPHA1)
    for params, key in ((dparams, "k"), (a1p, "k_a1")):
        whole = fused_step.fused_stream_collide(f, g, EXT_WORD, EXT_STEP,
                                                params, noise_dist="clt4")
        ss, exts = _padded_blocks(f, g, mesh, params)
        fgs = [(b[0], b[1]) for b in ss.blocks]
        outs = [(torch.empty_like(b[0]), torch.empty_like(b[1]))
                for b in ss.blocks]
        psis = [torch.zeros((2,) + tuple(b.shape[2:]), device=dev)
                for b in ss.blocks]
        laps = [torch.zeros_like(p) for p in psis]
        lap_b = [lp if fused_step.has_alpha1(params) else None
                 for lp in laps]
        for b, ext in enumerate(exts):
            fused_step.fused_stream_collide(
                *fgs[b], EXT_WORD, EXT_STEP, params, out=outs[b],
                noise_dist="clt4", psi=psis[b], lap=lap_b[b], ext=ext)
            idx = (slice(None),) + _cells(ext, fgs[b][0].shape)
            k_bits &= (torch.equal(ext.region(outs[b][0]), whole[0][idx])
                       and torch.equal(ext.region(outs[b][1]), whole[1][idx]))
        del whole
        ext0 = exts[0]
        fr, gr = fused_step.k_step_reference(*fgs[0], EXT_WORD, EXT_STEP,
                                             params, "clt4", None, ext0)
        err_k = max(_maxdiff(ext0.region(outs[0][0]), fr),
                    _maxdiff(ext0.region(outs[0][1]), gr))
        del fr, gr
        err_a = _maxdiff(ext0.region(psis[0], 1),
                         fused_step.density_psi_reference(*fgs[0], params,
                                                          ext0))
        errs["k_ext"].append(err_k)
        errs["a_ext"].append(err_a)
        t[key] = _time_ms(lambda: [
            fused_step.launch_k(*fgs[b], 1, i, params, outs[b], psis[b],
                                "clt4", lap=lap_b[b], ext=exts[b])
            for i in range(NREP) for b in range(2)], cells, NREP)
        t[key + "_plain"] = _time_ms(lambda: [
            fused_step.k_step_reference(*fgs[b], 1, 0, params, "clt4", None,
                                        exts[b]) for b in range(2)],
            cells, 1)
        msg = (f"[phase 9] 256^3 on mesh (2, 1, 1), {key}: max|ext - plain "
               f"ext| K {err_k:.3e}, A {err_a:.3e}")
        if key == "k":
            t["a"] = _time_ms(lambda: [
                fused_step.density_psi(*fgs[b], params, out=psis[b],
                                       ext=exts[b])
                for _ in range(NREP) for b in range(2)], cells, NREP)
            t["a_plain"] = _time_ms(lambda: [
                fused_step.density_psi_reference(*fgs[b], params, exts[b])
                for b in range(2)], cells, 1)
            plan = halo.halo_plan(ss.blocks, mesh, ss.pad)
            t["exchange"] = _time_ms(lambda: [halo.run_plan(plan)
                                              for _ in range(NREP)],
                                     cells, NREP)
        else:
            err_l = _maxdiff(ext0.region(laps[0], 2),
                             fused_step.laplacian_psi_reference(psis[0],
                                                                ext0))
            errs["l_ext"].append(err_l)
            msg += f", L {err_l:.3e}"
            t["l"] = _time_ms(lambda: [
                fused_step.laplacian_psi(psis[b], out=laps[b], ext=exts[b])
                for _ in range(NREP) for b in range(2)], cells, NREP)
            # the device's time, as phase 8 takes it
            t["l_graph"] = graph_ms(lambda: [
                fused_step.laplacian_psi(psis[b], out=laps[b], ext=exts[b])
                for _ in range(NREP) for b in range(2)], NREP)
            t["l_plain"] = _time_ms(lambda: [
                fused_step.laplacian_psi_reference(psis[b], exts[b])
                for b in range(2)], cells, 1)
        print(msg + f" (tol {TOL}); K interiors == whole-domain K bitwise: "
              f"{k_bits}", flush=True)
        _check(max(err_k, err_a) <= TOL and max(errs["l_ext"] or [0.0])
               <= TOL, "256^3 ext kernels disagree with plain ext")
        del ss, fgs, outs, psis, laps, lap_b
        torch.cuda.empty_cache()
    # the same input through the whole-domain kernels
    psi = fused_step.density_psi(f, g, dparams)
    fo, go = torch.empty_like(f), torch.empty_like(g)
    t["a_whole"] = _time_ms(lambda: [fused_step.density_psi(
        f, g, dparams, out=psi) for _ in range(NREP)], cells, NREP)
    t["k_whole"] = _time_ms(lambda: [fused_step.launch_k(
        f, g, 1, i, dparams, (fo, go), psi, "clt4")
        for i in range(NREP)], cells, NREP)
    # one 256^3 block: the domain with its own periodic x wrap as pads
    whole = fused_step.fused_stream_collide(f, g, EXT_WORD, EXT_STEP,
                                            dparams, noise_dist="clt4")
    ext = Ext((2, 0, 0), (0, 0, 0), SHAPE)
    fp = torch.cat([f[:, -2:], f, f[:, :2]], dim=1)
    gp = torch.cat([g[:, -2:], g, g[:, :2]], dim=1)
    del f, g, fo, go
    bo = fused_step.fused_stream_collide(fp, gp, EXT_WORD, EXT_STEP, dparams,
                                         noise_dist="clt4", ext=ext)
    torch.cuda.synchronize()
    block_bits = (torch.equal(ext.region(bo[0]), whole[0])
                  and torch.equal(ext.region(bo[1]), whole[1]))
    del whole
    fr, gr = fused_step.k_step_reference(fp, gp, EXT_WORD, EXT_STEP, dparams,
                                         "clt4", None, ext)
    err = max(_maxdiff(ext.region(bo[0]), fr), _maxdiff(ext.region(bo[1]),
                                                        gr))
    del fr, gr, fp, gp, bo
    errs["k_ext"].append(err)
    print(f"[phase 9] one 256^3 block (x wrap as 2-deep pads): max|ext K - "
          f"plain ext| {err:.3e} (tol {TOL}); == whole-domain K bitwise: "
          f"{block_bits}", flush=True)
    _check(err <= TOL, f"256^3 block: ext K disagrees: {err}")
    print(f"[phase 9] 256^3 on mesh (2, 1, 1), per step (both blocks): ext A "
          f"{t['a']:.4f} ms (whole-domain A {t['a_whole']:.4f}), ext K "
          f"{t['k']:.4f} ms (whole-domain K {t['k_whole']:.4f}), ext L "
          f"{t['l']:.4f} ms ({t['l_graph']:.4f} from a CUDA graph), ext "
          f"B-A1 {t['k_a1']:.4f} ms, exchange "
          f"{t['exchange']:.4f} ms; plain ext A {t['a_plain']:.2f} ms, K "
          f"{t['k_plain']:.2f} ms, L {t['l_plain']:.2f} ms", flush=True)
    return t, k_bits and block_bits


def _sharded_sessions(dcfg, dev, cells, phase5_views, phase5_mlups):
    """Phase 9b: the 256^3 droplet-fluct configuration of phase 5 through
    ShardedSession (make_session with a mesh of cuda:0 repeated, the
    serial exchange) on meshes (2, 1, 1) and (2, 2, 1): 1 + 11 x 100
    steps with the restore at step 1000, held against phase 5's
    FusedSession (the same seed, so the same words) at step 901 (the last
    chunk boundary before the restore) and at 1101.  Returns {mesh: (K,
    A, ext launches, MLUPS, exchange ms, {901: view, 1101: view})}."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import ShardedSession, make_session
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    n_k = CHUNK * NCHUNKS
    for ms in ((2, 1, 1), (2, 2, 1)):
        mesh = mesh_lib.make_mesh(ms)
        state = model.make_initial_state(dcfg, device=dev)
        sess = make_session(dcfg.params, SHAPE, noise_dist="clt4", mesh=mesh,
                            y_exchange="serial", block=1)
        _check(isinstance(sess, ShardedSession), f"{type(sess)}")
        torch.cuda.synchronize()
        fused_step.reset_launch_counts()
        pc = sess.enter(state)
        del state
        cmp = {}
        views = {}
        t_adv = 0.0
        for _ in range(NCHUNKS):
            t0 = time.perf_counter()
            pc = sess.advance(pc, CHUNK)
            torch.cuda.synchronize()
            t_adv += time.perf_counter() - t0
            if pc.step == 901:
                v = views[901] = sess.exit_view(pc)
                w = phase5_views[901]
                cmp[901] = (max(_maxdiff(v.f, w.f), _maxdiff(v.g, w.g)),
                            torch.equal(v.f, w.f) and torch.equal(v.g, w.g))
                del v
        counts = (fused_step.launches, fused_step.density_launches,
                  fused_step.mode_launches.get("ext", 0))
        v = sess.exit_view(pc)
        w = phase5_views[1101]
        cmp[1101] = (max(_maxdiff(v.f, w.f), _maxdiff(v.g, w.g)),
                     torch.equal(v.f, w.f) and torch.equal(v.g, w.g))
        _check_finite(v.f, v.g)
        _check(v.step == 1 + n_k, f"final step {v.step}")
        views[1101] = v
        del v
        plan = halo.halo_plan(pc.blocks, mesh, pc.pad)
        ex_ms = _time_ms(lambda: [halo.run_plan(plan) for _ in range(NREP)],
                         cells, NREP)
        mlups = cells * n_k / t_adv / 1e6
        print(f"[phase 9] ShardedSession mesh {ms} ({mesh.size} blocks on "
              f"{len(set(mesh.devices))} card): launches K {counts[0]}, A "
              f"{counts[1]}, ext {counts[2]}; vs phase 5's FusedSession: step "
              f"901 max|delta| {cmp[901][0]:.3e} (bitwise {cmp[901][1]}), "
              f"step 1101 {cmp[1101][0]:.3e} (bitwise {cmp[1101][1]}) (tol "
              f"{TOL}); {n_k} steps in {t_adv:.3f} s = {mlups:.1f} MLUPS "
              f"(FusedSession, phase 5: {phase5_mlups:.1f}); exchange "
              f"{ex_ms:.4f} ms a step", flush=True)
        _check(counts == (mesh.size * n_k,) * 3, f"launches {counts}")
        _check(max(cmp[901][0], cmp[1101][0]) <= TOL,
               f"sharded session disagrees with FusedSession: {cmp}")
        out[ms] = counts + (mlups, ex_ms, views)
        del pc, sess, plan, views
        torch.cuda.empty_cache()
    return out


def _sharded_driver(tmp):
    """Phase 9c: run(cfg, mesh=(2, 1, 1)) with alpha1 at 256^3 for 100
    steps, its final frame read back and held against the frame of the
    same run without a mesh; returns the mesh run's (A, L, K) launches."""
    import os

    import numpy as np
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.io import fields as fields_io
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import hydro as hydro_ops

    cfg = config.preset("droplet-eq").replace(
        shape=SHAPE, nsteps=100, plot_int=100, print_int=100,
        droplet_int=0, plot_fmt="auto").with_params(kBT=KBT, **ALPHA1)
    frames = {}
    for tag, mesh in (("mesh", (2, 1, 1)), ("single", None)):
        out = os.path.join(tmp, tag)
        fused_step.reset_launch_counts()
        t0 = time.perf_counter()
        state = run_mod.run(cfg.replace(out_dir=out), mesh=mesh, block=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fused_step.density_launches, fused_step.laplacian_launches,
                  fused_step.launches)
        modes = dict(fused_step.mode_launches)
        print(f"[phase 9] run(cfg) alpha1 {tag} (mesh {mesh}), 100 steps, in "
              f"{wall:.2f} s: step {state.step}; launches A {counts[0]}, L "
              f"{counts[1]}, K {counts[2]}, by mode {modes}", flush=True)
        _check(state.step == 100, f"final step {state.step}")
        if mesh is not None:
            launches = counts
            _check(counts == (198, 198, 198) and modes.get("ext") == 198,
                   f"mesh run launches {counts}, {modes}")
        del state
        frames[tag] = fields_io.read_frame(os.path.join(out,
                                                        "plt0000100.bflbm"))
    err = max(float(np.abs(frames["mesh"][n] - frames["single"][n]).max())
              for n in hydro_ops.HYDRO_NAMES)
    same = all(np.array_equal(frames["mesh"][n], frames["single"][n])
               for n in hydro_ops.HYDRO_NAMES)
    print(f"[phase 9] frame plt0000100.bflbm with mesh (2, 1, 1) vs without: "
          f"max|delta| over the 22 fields {err:.3e} (tol {TOL}), bitwise "
          f"{same}", flush=True)
    _check(int(frames["mesh"]["step"]) == 100 and err <= TOL,
           f"mesh frame disagrees with the single-device frame: {err}")
    return launches


# -- phase 10: the rest of K7 (windows and the overlap split, y strips) ------

WIN_MODES = tuple(m for m in EXT_MODES
                  if m[0] in ("u8 uncoupled", "clt4 alpha0", "alpha1", "ref"))
WIN_MESHES = ((2, 1, 1), (2, 2, 1))
# the sweeps of phase 10b: (mesh, ShardedSession options)
SWEEPS = (((2, 1, 1), dict(overlap=True)), ((2, 2, 1), dict(overlap=True)),
          ((2, 2, 1), dict(y_exchange="strips")))
SPAN_STEPS = 20


def _window_check(got, want, plain, win, bounds):
    """A launch into a NaN-filled `got` on window `win`: (it wrote exactly
    the window, finite; its cells equal `want`'s bitwise; max |got -
    plain| there, plain covering the launch's whole region `bounds`)."""
    import torch

    from bflbm_tpu_torch.ops import blocked

    v = blocked.box_view(got, win)
    only = (int(torch.isnan(got).sum()) == got.numel() - v.numel()
            and bool(torch.isfinite(v).all()))
    rel = tuple((a - s, b - s) for (a, b), (s, _) in zip(win, bounds))
    return (only, torch.equal(v, blocked.box_view(want, win)),
            _maxdiff(v, blocked.box_view(plain, rel)))


def _nan_outside(t, box):
    """A copy of t with every cell outside `box` NaN."""
    import torch

    from bflbm_tpu_torch.ops import blocked

    out = torch.full_like(t, float("nan"))
    blocked.box_view(out, box).copy_(blocked.box_view(t, box))
    return out


def _windows_vs_plain(f, g, params, dist, ref, mesh, tag, errs):
    """Phase 10a (at 32^3, and at 256^3 in phase 10b): A, L and K launched
    on every window of the overlap split (the interior window and the
    seam bands) of every block of (f, g) decomposed over `mesh`, into
    NaN-filled outputs: each must write exactly its window, bitwise the
    whole-block ext launch's cells there, within TOL of the plain
    versions (max |delta| into errs["window"]).  Then the interior
    window's A, L and K once more on a copy of the block whose pads are
    all NaN (what the split's side stream fills meanwhile), from NaN psi
    and lap: the window must come out bitwise the same, so it read no
    pad."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    lay = kernel_par.layout(mesh, tuple(f.shape[1:]), params, True)
    _check(any(lay.split), f"{tag}: the split is not feasible")
    ss, exts = _padded_blocks(f, g, mesh, params)
    _check(tuple(ss.pad) == lay.pad, f"{tag}: pads {ss.pad} != {lay.pad}")
    refs = (mesh_lib.shard_field(ref, mesh, ss.pad) if ref is not None
            else [None] * mesh.size)
    inner, bands = kernel_par.split_windows(lay, ss.blocks[0].shape,
                                            fused_step.sd_depth(params))
    only = bits = blind = True
    err = 0.0
    before = fused_step.mode_launches.get("window", 0)
    for b, ext in enumerate(exts):
        fb, gb = ss.blocks[b][0], ss.blocks[b][1]

        def nan(lead):
            return torch.full((lead,) + tuple(fb.shape[1:]), float("nan"),
                              device=fb.device)

        psi = lap = None
        if fused_step.is_coupled(params):
            psi = fused_step.density_psi(fb, gb, params, ext=ext)
            psi_r = fused_step.density_psi_reference(fb, gb, params, ext)
            if fused_step.has_alpha1(params):
                lap = fused_step.laplacian_psi(psi, ext=ext)
                lap_r = fused_step.laplacian_psi_reference(psi, ext)
        whole = fused_step.fused_stream_collide(
            fb, gb, EXT_WORD, EXT_STEP, params, noise_dist=dist,
            ref=refs[b], ext=ext)
        plain = fused_step.k_step_reference(fb, gb, EXT_WORD, EXT_STEP,
                                            params, dist, refs[b], ext)
        checks = []
        for win in (inner,) + tuple(bands):
            out = (nan(19), nan(19))
            fused_step.launch_k(fb, gb, EXT_WORD, EXT_STEP, params, out, psi,
                                dist, refs[b], lap=lap, ext=ext, window=win)
            for o, w, p in zip(out, whole, plain):
                checks.append(_window_check(o, w, p, win,
                                            ext.bounds(fb.shape)))
            if psi is None:
                continue
            a_win, l_win = fused_step.prepass_windows(params, ext, fb.shape,
                                                      win)
            o = fused_step.density_psi(fb, gb, params, out=nan(2), ext=ext,
                                       window=a_win)
            checks.append(_window_check(o, psi, psi_r, a_win,
                                        ext.bounds(fb.shape, 1)))
            if lap is not None:
                o = fused_step.laplacian_psi(psi, out=nan(2), ext=ext,
                                             window=l_win)
                checks.append(_window_check(o, lap, lap_r, l_win,
                                            ext.bounds(fb.shape, 2)))
        # the interior window with every pad NaN
        box = ext.bounds(fb.shape)
        bf, bg = _nan_outside(fb, box), _nan_outside(gb, box)
        bref = None if refs[b] is None else _nan_outside(refs[b], box)
        bpsi = blap = None
        if psi is not None:
            a_win, l_win = fused_step.prepass_windows(params, ext, fb.shape,
                                                      inner)
            bpsi = fused_step.density_psi(bf, bg, params, out=nan(2),
                                          ext=ext, window=a_win)
            blind &= torch.equal(blocked.box_view(bpsi, a_win),
                                 blocked.box_view(psi, a_win))
            if lap is not None:
                blap = fused_step.laplacian_psi(bpsi, out=nan(2), ext=ext,
                                                window=l_win)
                blind &= torch.equal(blocked.box_view(blap, l_win),
                                     blocked.box_view(lap, l_win))
        out = (nan(19), nan(19))
        fused_step.launch_k(bf, bg, EXT_WORD, EXT_STEP, params, out, bpsi,
                            dist, bref, lap=blap, ext=ext, window=inner)
        blind &= all(torch.equal(blocked.box_view(o, inner),
                                 blocked.box_view(w, inner))
                     for o, w in zip(out, whole))
        torch.cuda.synchronize()
        only &= all(c[0] for c in checks)
        bits &= all(c[1] for c in checks)
        err = max([err] + [c[2] for c in checks])
        del bf, bg, bref, bpsi, blap, out, whole, plain
    n = fused_step.mode_launches.get("window", 0) - before
    print(f"[phase 10] {tag}: {n} window K launches ({1 + len(bands)} "
          f"windows a block, and the interior window on NaN pads; A, L in "
          f"front); each wrote exactly its window: {only}; == the "
          f"whole-block ext launch there bitwise: {bits}; the interior "
          f"window on NaN pads, from NaN psi and lap, bitwise the same: "
          f"{blind}; max|window - plain ext| {err:.3e} (tol {TOL})",
          flush=True)
    _check(only and bits and blind and err <= TOL and n == mesh.size
           * (2 + len(bands)), f"{tag}: window launches failed")
    errs["window"].append(err)


def _strips_vs_plain(f, g, params, dist, ref, tag, errs):
    """Phase 10a: A and K fed by the exchanged y strips on mesh (2, 2, 1),
    the blocks' y pads NaN: within TOL of the plain versions (max |delta|
    into errs["ystrips"]) and bitwise the pad-fed ext launch; the strips
    K writes equal its edge rows bitwise."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((2, 2, 1), f.device)
    lay = kernel_par.layout(mesh, tuple(f.shape[1:]), params,
                            y_exchange="strips")
    ss, exts = _padded_blocks(f, g, mesh, params)
    _check(lay.strips and tuple(ss.pad) == lay.pad, f"{tag}: {lay}")
    refs = (mesh_lib.shard_field(ref, mesh, ss.pad) if ref is not None
            else [None] * mesh.size)
    coupled = fused_step.is_coupled(params)
    padfed = [fused_step.fused_stream_collide(
        b[0], b[1], EXT_WORD, EXT_STEP, params, noise_dist=dist, ref=r,
        ext=e) for b, r, e in zip(ss.blocks, refs, exts)]
    psi_pad = [fused_step.density_psi(b[0], b[1], params, ext=e)
               if coupled else None for b, e in zip(ss.blocks, exts)]
    sent = kernel_par.strip_buffers(ss.blocks, ss.pad)
    received = [torch.empty_like(t) for t in sent]
    halo.run_plan(halo.strip_plan(sent, received, mesh, ss.pad))
    px, py = ss.pad[0], ss.pad[1]
    bits = edge = True
    err = 0.0
    before = fused_step.mode_launches.get("ystrips", 0)
    for b, (blk, ext) in enumerate(zip(ss.blocks, exts)):
        blk[..., :py, :] = float("nan")
        blk[..., blk.shape[-2] - py:, :] = float("nan")
        written = torch.full_like(sent[b], float("nan"))
        fo, go = fused_step.fused_stream_collide(
            blk[0], blk[1], EXT_WORD, EXT_STEP, params, noise_dist=dist,
            ref=refs[b], ext=ext, strips=received[b], strips_out=written)
        fr, gr = fused_step.k_step_reference(blk[0], blk[1], EXT_WORD,
                                             EXT_STEP, params, dist, refs[b],
                                             ext, received[b])
        err = max(err, _maxdiff(ext.region(fo), fr),
                  _maxdiff(ext.region(go), gr))
        bits &= (torch.equal(ext.region(fo), ext.region(padfed[b][0]))
                 and torch.equal(ext.region(go), ext.region(padfed[b][1])))
        for s, o in enumerate((fo, go)):
            inner = o[:, px:o.shape[1] - px]
            ny = inner.shape[2] - 2 * py
            edge &= (torch.equal(written[0, s][:, px:o.shape[1] - px],
                                 inner[:, :, py:2 * py])
                     and torch.equal(written[1, s][:, px:o.shape[1] - px],
                                     inner[:, :, ny:ny + py]))
        if coupled:
            psi = fused_step.density_psi(blk[0], blk[1], params, ext=ext,
                                         strips=received[b])
            err = max(err, _maxdiff(ext.region(psi, 1),
                                    fused_step.density_psi_reference(
                                        blk[0], blk[1], params, ext,
                                        received[b])))
            bits &= torch.equal(ext.region(psi, 1),
                                ext.region(psi_pad[b], 1))
        torch.cuda.synchronize()
    n = fused_step.mode_launches.get("ystrips", 0) - before
    print(f"[phase 10] {tag}: {n} strip-fed K launches (y pads NaN): max|"
          f"strip-fed - plain| A, K {err:.3e} (tol {TOL}); == the pad-fed "
          f"ext launch bitwise: {bits}; strips written == K's edge rows "
          f"bitwise: {edge}", flush=True)
    _check(err <= TOL and bits and edge and n == mesh.size,
           f"{tag}: strip-fed launches failed")
    errs["ystrips"].append(err)


def _sweep_sessions_small(dev):
    """Phase 10a: 1 + 2 + 3 steps of a 32^3 alpha1 droplet (kBT 1e-5, the
    restore every 3 steps) through the split and the strips
    ShardedSession on mesh (2, 2, 1), against the serial one, bitwise."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels.session import ShardedSession
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.state import init_state

    params = LBMParams(**dict(ALPHA1, kBT=KBT))
    f, g = _perturbed_droplet(SMALL, params, 53, dev, radius=0.3)
    mesh = mesh_lib.make_mesh((2, 2, 1), dev)
    words = [7919 * k - 5 for k in range(6)]
    got = {}
    for tag, opts in (("serial", dict(y_exchange="serial")),
                      ("split", dict(overlap=True)),
                      ("strips", dict(y_exchange="strips"))):
        sess = ShardedSession(mesh, params, SMALL, mass_restore_int=3,
                              block=1, **opts)
        pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
        pc = sess.advance(pc, 2, words[1:3])
        got[tag] = sess.exit(sess.advance(pc, 3, words[3:]))
    torch.cuda.synchronize()
    same = {t: torch.equal(got[t].f, got["serial"].f)
            and torch.equal(got[t].g, got["serial"].g)
            for t in ("split", "strips")}
    print(f"[phase 10] 32^3 alpha1 sessions on mesh (2, 2, 1), 1 + 5 steps "
          f"through a restore: split == serial bitwise {same['split']}, "
          f"strips == serial bitwise {same['strips']}", flush=True)
    _check(all(same.values()), f"sweep sessions differ: {same}")


def _kernel_ms_22(dcfg, dev, cells, errs):
    """Phase 10b: at the main path's shapes, the 256^3 droplet on mesh
    (2, 2, 1) (four 128 x 128 x 256 blocks on the card): the window
    launches of A, L and K on every block (phase 10a's checks: exactly
    the window, bitwise the whole-block launch, within TOL of plain, the
    interior window on NaN pads) and the strip-fed A and K (within TOL of
    plain, bitwise the pad-fed launch, the strips written), in the clt4
    configuration and with alpha1, errors into errs.  Then the K launches
    of one step timed: on the split's five windows of every block,
    strip-fed (writing the strips), and on the whole blocks (pad-fed, the
    ext mode), beside the plain versions (one run each; the plain window
    is the plain ext K of each block, once, cut to the windows).  Returns
    ms per step."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.utils.timing import time_steps

    params = dcfg.params
    pc = FusedSession(params, SHAPE).enter(
        model.make_initial_state(dcfg, device=dev))
    f, g = pc.f, pc.g
    del pc
    mesh = mesh_lib.make_mesh((2, 2, 1), dev)
    for p, tag in ((params, "clt4"),
                   (dataclasses.replace(params, **ALPHA1), "alpha1")):
        _windows_vs_plain(f, g, p, "clt4", None, mesh,
                          f"256^3 {tag}, mesh (2, 2, 1)", errs)
        torch.cuda.empty_cache()
        _strips_vs_plain(f, g, p, "clt4", None,
                         f"256^3 {tag}, mesh (2, 2, 1)", errs)
        torch.cuda.empty_cache()
    ss, exts = _padded_blocks(f, g, mesh, params)
    del f, g
    lay = kernel_par.layout(mesh, SHAPE, params, True)
    inner, bands = kernel_par.split_windows(lay, ss.blocks[0].shape,
                                            fused_step.sd_depth(params))
    wins = (inner,) + tuple(bands)
    fg = [(b[0], b[1]) for b in ss.blocks]
    outs = [(torch.empty_like(b[0]), torch.empty_like(b[1]))
            for b in ss.blocks]
    psis = [fused_step.density_psi(*fg[b], params, ext=exts[b])
            for b in range(4)]
    sent = kernel_par.strip_buffers(ss.blocks, ss.pad)
    received = [torch.empty_like(t) for t in sent]
    halo.run_plan(halo.strip_plan(sent, received, mesh, ss.pad))
    t = {}
    t["window"] = _time_ms(lambda: [
        fused_step.launch_k(*fg[b], 1, i, params, outs[b], psis[b], "clt4",
                            ext=exts[b], window=w)
        for i in range(NREP) for b in range(4) for w in wins], cells, NREP)
    t["ystrips"] = _time_ms(lambda: [
        fused_step.launch_k(*fg[b], 1, i, params, outs[b], psis[b], "clt4",
                            ext=exts[b], strips=received[b],
                            strips_out=sent[b])
        for i in range(NREP) for b in range(4)], cells, NREP)
    t["ext"] = _time_ms(lambda: [
        fused_step.launch_k(*fg[b], 1, i, params, outs[b], psis[b], "clt4",
                            ext=exts[b])
        for i in range(NREP) for b in range(4)], cells, NREP)

    def once(run):
        return time_steps(run, cells, 1, warmup=0, repeats=1)["best_s"] * 1e3

    t["window_plain"] = once(lambda: [
        [blocked.box_view(o, w) for o in fused_step.k_step_reference(
            *fg[b], 1, 0, params, "clt4", None, exts[b]) for w in wins]
        for b in range(4)])
    t["ystrips_plain"] = once(lambda: [
        fused_step.k_step_reference(*fg[b], 1, 0, params, "clt4", None,
                                    exts[b], received[b])
        for b in range(4)])
    # bytes the strips add: K writes 2 sides x 2 species x 19 x Xp x sd x Z
    t["strip_bytes"] = sum(int(s.numel()) * 4 for s in sent)
    print(f"[phase 10] 256^3 on mesh (2, 2, 1), K per step (four blocks): "
          f"on the split's {len(wins)} windows a block {t['window']:.4f} ms, "
          f"strip-fed {t['ystrips']:.4f} ms (+{t['strip_bytes'] / 1e6:.1f} "
          f"MB of strips written), whole blocks pad-fed {t['ext']:.4f} ms; "
          f"plain: the ext K of each block cut to its windows "
          f"{t['window_plain']:.1f} ms, strip-fed {t['ystrips_plain']:.1f} "
          f"ms", flush=True)
    return t


def _span_split(mesh_shape, params, opts, pc_whole, words, block=1,
                dist="clt4"):
    """CUDA-event split of SPAN_STEPS decomposed steps of the post-collide
    state pc_whole in the sweep of `opts` at `block` (ms an exchange, a
    step at block 1 and a sweep of `block` steps above: exchange,
    interior, exposed, bands) and the host's enqueue time a step (µs)."""
    import torch

    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(mesh_shape, pc_whole.f.device)
    lay = kernel_par.layout(mesh, SHAPE, params, block=block, **opts)
    ss = kernel_par.pad_state(pc_whole, mesh, lay.pad)
    spans = []
    run_k = kernel_par.make_kernel_ksteps(mesh, params, SPAN_STEPS,
                                          noise_dist=dist, spans=spans,
                                          block=block, **opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss = run_k(ss, words)
    host_us = (time.perf_counter() - t0) / SPAN_STEPS * 1e6
    torch.cuda.synchronize()
    out = kernel_par.span_ms(spans[2:])
    out["host_us"] = host_us
    del ss
    return out


def _sweep_sessions_256(dcfg, dev, cells, serial):
    """Phase 10b: the phase-5 droplet through the split ShardedSession on
    meshes (2, 1, 1) and (2, 2, 1) and the strips one on (2, 2, 1), 1 +
    1100 steps with the restore at step 1000, against phase 9b's serial
    sessions at steps 901 (bitwise printed) and 1101 (within TOL), with
    MLUPS, launches by mode and the host's enqueue time; then every sweep
    and the serial ones split into exchange, interior kernels, exposed
    exchange and bands over SPAN_STEPS steps by CUDA events.  Returns
    {(mesh, sweep): (launches by mode, MLUPS)} and the splits."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession, make_session
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    n_k = CHUNK * NCHUNKS
    for ms, opts in SWEEPS:
        key = (ms, "split" if opts.get("overlap") else "strips")
        mesh = mesh_lib.make_mesh(ms)
        sess = make_session(dcfg.params, SHAPE, noise_dist="clt4", mesh=mesh,
                            block=1, **opts)
        _check(any(sess.layout.split) == (key[1] == "split")
               and sess.layout.strips == (key[1] == "strips"),
               f"{key}: layout {sess.layout}")
        state = model.make_initial_state(dcfg, device=dev)
        torch.cuda.synchronize()
        fused_step.reset_launch_counts()
        pc = sess.enter(state)
        del state
        cmp = {}
        t_adv = t_host = 0.0
        for _ in range(NCHUNKS):
            t0 = time.perf_counter()
            pc = sess.advance(pc, CHUNK)
            t_host += time.perf_counter() - t0
            torch.cuda.synchronize()
            t_adv += time.perf_counter() - t0
            if pc.step in (901, 1 + n_k):
                v = sess.exit_view(pc)
                w = serial[ms][5][pc.step]
                cmp[pc.step] = (max(_maxdiff(v.f, w.f), _maxdiff(v.g, w.g)),
                                torch.equal(v.f, w.f)
                                and torch.equal(v.g, w.g))
                if pc.step == 1 + n_k:
                    _check_finite(v.f, v.g)
                    _check(v.step == 1 + n_k, f"final step {v.step}")
                del v
        modes = dict(fused_step.mode_launches)
        counts = (fused_step.launches, fused_step.density_launches)
        mlups = cells * n_k / t_adv / 1e6
        print(f"[phase 10] ShardedSession {key[1]} on mesh {ms} (layout "
              f"{sess.layout}): launches K {counts[0]}, A {counts[1]}, by "
              f"mode {modes}; vs phase 9b's serial session: step 901 "
              f"max|delta| {cmp[901][0]:.3e} (bitwise {cmp[901][1]}), step "
              f"1101 {cmp[1101][0]:.3e} (bitwise {cmp[1101][1]}) (tol {TOL})"
              f"; {n_k} steps in {t_adv:.3f} s = {mlups:.1f} MLUPS (serial, "
              f"phase 9b: {serial[ms][3]:.1f}); host enqueue "
              f"{t_host / n_k * 1e6:.1f} us a step", flush=True)
        wins = 1 + 2 * sum(sess.layout.split)
        want = ({"window": mesh.size * n_k * wins} if key[1] == "split"
                else {"ystrips": mesh.size * n_k})
        _check(all(modes.get(k) == v for k, v in want.items()),
               f"{key}: launches {modes}, expected {want}")
        _check(max(cmp[901][0], cmp[1101][0]) <= TOL,
               f"{key}: the sweep disagrees with the serial session: {cmp}")
        out[key] = (modes, mlups)
        del pc, sess
        torch.cuda.empty_cache()
    # the per-step split of every sweep, from one post-collide state
    pc = FusedSession(dcfg.params, SHAPE).enter(
        model.make_initial_state(dcfg, device=dev))
    words = [104729 * k + 1 for k in range(SPAN_STEPS)]
    spans = {}
    for ms, tag, opts in (((2, 1, 1), "serial", dict(y_exchange="serial")),
                          ((2, 1, 1), "split", dict(overlap=True)),
                          ((2, 2, 1), "serial", dict(y_exchange="serial")),
                          ((2, 2, 1), "split", dict(overlap=True)),
                          ((2, 2, 1), "strips", dict(y_exchange="strips"))):
        sp = spans[(ms, tag)] = _span_split(ms, dcfg.params, opts, pc, words)
        print(f"[phase 10] per step, mesh {ms} {tag} (CUDA events, "
              f"{SPAN_STEPS - 2} steps): exchange {sp['exchange']:.4f} ms, "
              f"interior kernels {sp['interior']:.4f} ms, exchange exposed "
              f"{sp['exposed']:.4f} ms, bands {sp['bands']:.4f} ms; host "
              f"enqueue {sp['host_us']:.1f} us a step", flush=True)
        torch.cuda.empty_cache()
    del pc
    return out, spans


# -- phase 11: K4, T steps a launch (temporal blocking) ------------------------

K4_BLOCKS = (2, 3, 4)
# uncoupled modes: tag, LBMParams keywords, generator, with the ref operand
K4_MODES = (
    ("off", dict(kBT=0.0), "u8", False),
    ("u8", dict(kBT=KBT), "u8", False),
    ("clt4", dict(kBT=KBT), "clt4", False),
    ("clt2", dict(kBT=KBT), "clt2", False),
    ("bm", dict(kBT=KBT), "bm", False),
    ("ref", dict(kBT=KBT), "clt4", True),
    ("general", dict(kBT=KBT, tau_f=0.7, tau_g=0.6), "clt4", False),
)
K4_ODD = (20, 12, 40)   # a shape no blocked tile divides
# the 256^3 mixture sessions: (block, generator)
K4_SESSIONS = ((1, "u8"), (2, "u8"), (3, "u8"), (4, "u8"), (3, "clt4"))
# a launch of T steps moves the bytes of one step and does the operations
# of T (the recomputed ring cells are the design's, not the function's)
for _t in K4_BLOCKS:
    KERNELS[f"k4_{_t}"] = dict(bytes=KERNELS["k1a"]["bytes"],
                               ops=KERNELS["k1a"]["ops"] * _t)


def _k4_ref(shape, dev, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return (1.0 + 0.1 * torch.rand((2,) + tuple(shape), generator=gen)).to(dev)


def _k4_layout(params, dist, with_ref, T):
    """A K4 launch's layout at 256^3 in a mode: its sub-tile, cluster,
    warp groups, shared memory a block and the registers of its
    instantiation (``-Xptxas -v``)."""
    from bflbm_tpu_torch.kernels import _build, fused_step

    sd = fused_step.sd_depth(params)
    tile = fused_step.launch_tile(T, SHAPE, sd)
    cl = fused_step.launch_cluster(T, SHAPE, sd)
    lib = ("blocked_step" + ("_general" if fused_step.general_relax(params)
                             else "") + ("_force" if sd >= 2 else "")
           + ("_a1" if sd == 3 else ""))
    noise = params.noise_on
    args = (f"<{int(noise)},{fused_step.NOISE_DISTS[dist][0] if noise else 0}"
            f",{int(fused_step.general_relax(params))},"
            f"{int(bool(with_ref) and noise)},0,0>")
    regs = next((ln.split(": ", 1)[1].split(",")[0]
                 for ln in _build.ptxas_summary()
                 if ln.startswith(f"{lib} blocked_kernel{args}")), "?")
    return (f"tile {tile[1]}x{tile[2]}, cluster {cl[0]}x{cl[1]}, threads "
            f"{'+'.join(map(str, fused_step.blocked_threads(T, tile, sd, cl)))}"
            f", {fused_step.blocked_smem_bytes(T, tile, sd)} B shared a "
            f"block, {regs}")


def _k4_vs_plain(f, g, params, dist, ref, T, tag, errs, plain_tile=None,
                 phase=11):
    """One K4 launch of T steps against its plain version (the plain sweep
    on one whole-domain tile, or on `plain_tile`: any tiling gives the
    same cells bitwise, tests/test_torch_blocked.py) and against T one-step
    launches (K, or A + K, or A + L + K) with the same words; the K4
    launch must launch no pre-pass.  Appends the larger error to errs[T]
    and returns (bitwise to plain, bitwise to the one-step launches,
    seconds of the plain version)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import blocked

    words = [104729 * (k + 1) - 2 ** 30 for k in range(T)]
    before = (fused_step.blocked_launches, fused_step.density_launches,
              fused_step.laplacian_launches)
    fo, go = fused_step.blocked_stream_collide(f, g, words, 77, params, T,
                                               noise_dist=dist, ref=ref)
    torch.cuda.synchronize()
    after = (fused_step.blocked_launches, fused_step.density_launches,
             fused_step.laplacian_launches)
    _check(after == (before[0] + 1,) + before[1:],
           f"{tag}: K4, A, L launches went {before} -> {after}, expected "
           "one K4 launch only")
    _check_finite(fo, go)
    t0 = time.perf_counter()
    fr, gr = blocked.blocked_sweep_reference(
        f, g, words, 77, params, T,
        plain_tile or tuple(f.shape[1:]), dist, ref)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    e_plain = max(_maxdiff(fo, fr), _maxdiff(go, gr))
    bit_plain = bool(torch.equal(fo, fr) and torch.equal(go, gr))
    del fr, gr
    fa, ga = f, g
    for s, w in enumerate(words):
        fa, ga = fused_step.fused_stream_collide(fa, ga, w, 77 + s, params,
                                                 noise_dist=dist, ref=ref)
    torch.cuda.synchronize()
    e_k1 = max(_maxdiff(fo, fa), _maxdiff(go, ga))
    bit_k1 = bool(torch.equal(fo, fa) and torch.equal(go, ga))
    print(f"[phase {phase}] {tag} T={T}: max|K4 - plain| = {e_plain:.3e} "
          f"(bitwise {bit_plain}), max|K4 - {T} x K| = {e_k1:.3e} (bitwise "
          f"{bit_k1}) (tol {TOL})", flush=True)
    _check(max(e_plain, e_k1) <= TOL,
           f"{tag} T={T}: K4 disagrees: {e_plain}, {e_k1} > {TOL}")
    errs[T].append(max(e_plain, e_k1))
    return bit_plain, bit_k1, plain_s


def _k4_small(dev, errs):
    """11a: K4 in every uncoupled mode at T = 2, 3, 4 on 32^3 and on a
    shape no tile divides, against plain and against T x K."""
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.models import binary_fluid as model

    bits = []
    for shape in (SMALL, K4_ODD):
        f, g = model.perturbed_populations(shape, 71, device=dev)
        for tag, kw, dist, with_ref in K4_MODES:
            ref = _k4_ref(shape, dev, 72) if with_ref else None
            for T in K4_BLOCKS:
                bits.append(_k4_vs_plain(f, g, LBMParams(**kw), dist, ref, T,
                                         f"{shape} {tag}", errs)[:2])
    print(f"[phase 11] 11a: {len(bits)} launches; bitwise to plain "
          f"{sum(b[0] for b in bits)}, bitwise to T one-step launches "
          f"{sum(b[1] for b in bits)}", flush=True)


def _k4_256(f, g, errs):
    """11b: K4 (u8) at 256^3 on (f, g) against the plain sweep on one
    whole-domain tile and against T one-step launches; returns the plain
    version's ms a launch per T."""
    import torch

    from bflbm_tpu_torch.config import LBMParams

    plain_ms = {}
    for T in K4_BLOCKS:
        _, _, plain_s = _k4_vs_plain(f, g, LBMParams(kBT=KBT), "u8", None, T,
                                     "256^3 u8", errs, plain_tile=SHAPE)
        plain_ms[T] = plain_s * 1e3
        torch.cuda.empty_cache()
    return plain_ms


def _k4_times(f, g, cells):
    """11b: the K launch (T = 1) and the K4 launch (T = 2, 3, 4) timed at
    256^3 on (f, g) in every uncoupled mode (NREP launches, NREP // T for
    K4, at least 5); prints ms a launch and a step and which T gives the
    fastest step (the sessions' default block is 1)."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step

    out = (torch.empty_like(f), torch.empty_like(g))
    ref = _k4_ref(SHAPE, f.device, 73)
    table = {}
    for tag, kw, dist, with_ref in K4_MODES:
        p = LBMParams(**kw)
        r = ref if with_ref else None
        row = {}
        for T in (1,) + K4_BLOCKS:
            if T == 1:
                def run(p=p, dist=dist, r=r):
                    for i in range(NREP):
                        fused_step.fused_stream_collide(
                            f, g, 1, i, p, out=out, noise_dist=dist, ref=r)
            else:
                def run(p=p, dist=dist, r=r, T=T):
                    for i in range(max(5, NREP // T)):
                        fused_step.blocked_stream_collide(
                            f, g, [1] * T, i, p, T, out=out,
                            noise_dist=dist, ref=r)
            row[T] = _time_ms(run, cells, NREP if T == 1
                              else max(5, NREP // T))
        best = min(row, key=lambda t: row[t] / t)
        table[tag] = row
        print(f"[phase 11] 256^3 {tag}: ms a launch / a step: " + ", ".join(
            f"T={t} {v:.4f} / {v / t:.4f}" for t, v in row.items())
            + f"; fastest step at T = {best} (the sessions take 1); "
            + "; ".join(
                f"T={t}: {_k4_layout(p, dist, with_ref, t)}"
                for t in K4_BLOCKS), flush=True)
    return table


def _k4_sessions(dev, cells):
    """11c: phase 3's 256^3 mixture session (chunks of 100, restore every
    1000 steps) at each block of K4_SESSIONS: launches, masses, density
    variance and MLUPS."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model

    params = LBMParams(kBT=KBT)
    n_k = CHUNK * NCHUNKS
    res = {}
    for T, dist in K4_SESSIONS:
        tag = f"phase 11 session T={T} {dist}"
        state = model.init_mixture(SHAPE, params, device=dev)
        view, counts, t_adv, _ = _run_session(
            FusedSession(params, SHAPE, noise_dist=dist, block=T), state, tag)
        del state
        nb = fused_step.blocked_launches
        want = ((NCHUNKS * (CHUNK // T), NCHUNKS * (CHUNK % T)) if T > 1
                else (0, n_k))
        _check((nb, counts[0]) == want and counts[1] == 0,
               f"{tag}: launches K4 {nb}, K {counts[0]} != {want}")
        rho_t = view.f.sum(0) + view.g.sum(0)
        var_ratio = float(rho_t.var()) / (float(rho_t.mean()) * KBT / CS2)
        mlups = cells * n_k / t_adv / 1e6
        print(f"[{tag}] K4 launches {nb}, K launches {counts[0]}; var / "
              f"(rho kBT / cs^2) = {var_ratio:.4f} (tol {VAR_RTOL}); "
              f"{mlups:.1f} MLUPS", flush=True)
        _check(abs(var_ratio - 1.0) <= VAR_RTOL,
               f"{tag}: density fluctuations off equipartition: {var_ratio}")
        res[(T, dist)] = (mlups, nb)
        del view, rho_t
        torch.cuda.empty_cache()
    return res


def _k4_driver(tmp, sk_block1):
    """11d: the mixture's two phases through the CLI at 64^3, the
    fluctuating one with ``--block 2``: S(k) within 5% of kBT / cs^2,
    beside phase 7's block-1 run."""
    import os

    import numpy as np

    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.kernels import fused_step

    eq = os.path.join(tmp, "k4_eq")
    out = os.path.join(tmp, "k4_sk")
    t0 = time.perf_counter()
    run_mod.main(["--preset", "mixture-eq", "--shape", "64", "64", "64",
                  "--nsteps", "500", "--plot-int", "100", "--out", eq])
    fused_step.reset_launch_counts()
    run_mod.main(["--preset", "mixture-fluct", "--shape", "64", "64", "64",
                  "--checkpoint", os.path.join(eq, "checkpoint0000500"),
                  "--nsteps", "600", "--sf-window", "400", "--sf-every",
                  "10", "--plot-int", "0", "--block", "2", "--out", out])
    nb, nk = fused_step.blocked_launches, fused_step.launches
    with np.load(os.path.join(out, "structfact0001100.npz")) as d:
        s_k = d["s_k"][0].real
    centre = tuple(n // 2 for n in s_k.shape)
    off = np.ones(s_k.shape, bool)
    off[centre] = False
    ratio = float(s_k[off].mean()) / (KBT / CS2)
    print(f"[phase 11] run --preset mixture-fluct --block 2 (64^3, steps "
          f"500-1100, from a mixture-eq checkpoint) in "
          f"{time.perf_counter() - t0:.2f} s: K4 launches {nb}, K launches "
          f"{nk}; mean Re S_rho,rho(k != 0) / (kBT / cs^2) = {ratio:.4f} "
          f"(tol 0.05; phase 7, block auto: {sk_block1:.4f})", flush=True)
    _check(nb > 0, "run --block 2 launched no K4 sweep")
    _check(abs(ratio - 1.0) <= 0.05, f"S(k) ratio {ratio} at --block 2")


# -- phase 12: K4 with the force (coupled, alpha1) ----------------------------

# (stencil depth tag, T) of every block the port takes with a force
K4F_CASES = (("coupled", 2), ("coupled", 3), ("alpha1", 2))
# the force of each depth: the droplet of phases 4-5, the alpha1 droplet
K4F_FORCE = {"coupled": dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0),
             "alpha1": ALPHA1}
# Operations a cell of one coupled step by mode, counted as above: B's
# 2800 (clt4) with u8's words (~170) in place of clt4's (~560), and less
# the noise moments and amplitudes (~240) and the words with the noise
# off; the other modes' B entries; plus the density pre-pass's 40 and,
# under alpha1, B-A1's extra 230 and the laplacian's 80.
_K4F_OPS = {"off": 2000, "u8": 2410, "clt4": KERNELS["b"]["ops"],
            "clt2": KERNELS["clt2"]["ops"], "bm": KERNELS["bm"]["ops"],
            "ref": KERNELS["k1e"]["ops"], "general": KERNELS["k1d"]["ops"]}
# a launch of T steps moves the 304 bytes a cell of one step (psi and the
# laplacian never leave the chip) and does the operations of T steps
for (_d, _t) in K4F_CASES:
    for _m, _ops in _K4F_OPS.items():
        KERNELS[f"k4_{_d}_{_t}_{_m}"] = dict(
            bytes=KERNELS["k1a"]["bytes"],
            ops=_t * (_ops + 40 + (310 if _d == "alpha1" else 0)))


def _k4f_params(depth, kw):
    from bflbm_tpu_torch.config import LBMParams

    return LBMParams(**dict(K4F_FORCE[depth], **kw))


def _k4f_small(dev, errs):
    """12a: K4 with the force at every (depth, T) in every mode on 32^3
    droplets and on a shape no tile divides, against plain and against T
    one-step launches; the ref operand is the droplet's own densities,
    rolled, as the session passes them (phases 6-10)."""
    bits = []
    for shape in (SMALL, K4_ODD):
        for depth, T in K4F_CASES:
            f, g = _perturbed_droplet(shape, _k4f_params(depth, {}), 81, dev,
                                      radius=0.3)
            ref = _ref_operand(f, g, (1, 2, -2))
            for tag, kw, dist, with_ref in K4_MODES:
                bits.append(_k4_vs_plain(
                    f, g, _k4f_params(depth, kw), dist,
                    ref if with_ref else None, T, f"{shape} {depth} {tag}",
                    errs[depth], phase=12)[:2])
    print(f"[phase 12] 12a: {len(bits)} launches; bitwise to plain "
          f"{sum(b[0] for b in bits)}, bitwise to T one-step launches "
          f"{sum(b[1] for b in bits)}", flush=True)


def _k4f_state(depth, dev):
    """The 256^3 droplet (alpha1 droplet) of phase 5 (8), one step in."""
    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model

    cfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=KBT, **K4F_FORCE[depth])
    pc = FusedSession(cfg.params, SHAPE, noise_dist="clt4", block=1).enter(
        model.make_initial_state(cfg, device=dev))
    return pc.f, pc.g


def _k4f_256(dev, errs, cells):
    """12a at 256^3 and 12b: on the 256^3 droplet (alpha1 droplet) one
    step in, K4 in every mode at every T against the plain sweep on one
    whole-domain tile (timed for clt4) and against T one-step launches;
    then K4 timed in every mode (ms a launch and a step) beside the
    one-step pair A + B (triple A + L + B-A1).  Returns ({(depth, T):
    plain ms a launch, clt4}, {depth: {mode: {T: ms a launch}}})."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step

    plain_ms, table = {}, {}
    for depth in ("coupled", "alpha1"):
        f, g = _k4f_state(depth, dev)
        blocks = [t for d, t in K4F_CASES if d == depth]
        ref = _ref_operand(f, g, (1, 2, -2))
        for tag, kw, dist, with_ref in K4_MODES:
            for T in blocks:
                _, _, plain_s = _k4_vs_plain(
                    f, g, _k4f_params(depth, kw), dist,
                    ref if with_ref else None, T, f"256^3 {depth} {tag}",
                    errs[depth], plain_tile=SHAPE, phase=12)
                if tag == "clt4":
                    plain_ms[(depth, T)] = plain_s * 1e3
                torch.cuda.empty_cache()
        out = (torch.empty_like(f), torch.empty_like(g))
        psi = torch.empty((2,) + SHAPE, dtype=f.dtype, device=dev)
        lap = torch.empty_like(psi) if depth == "alpha1" else None
        table[depth] = {}
        for tag, kw, dist, with_ref in K4_MODES:
            p = _k4f_params(depth, kw)
            r = ref if with_ref else None
            row = {}
            for T in (1,) + tuple(blocks):
                if T == 1:
                    def run(p=p, dist=dist, r=r):
                        for i in range(NREP):
                            fused_step.fused_stream_collide(
                                f, g, 1, i, p, out=out, noise_dist=dist,
                                psi=psi, lap=lap, ref=r)
                else:
                    def run(p=p, dist=dist, r=r, T=T):
                        for i in range(max(5, NREP // T)):
                            fused_step.blocked_stream_collide(
                                f, g, [1] * T, i, p, T, out=out,
                                noise_dist=dist, ref=r)
                row[T] = _time_ms(run, cells, NREP if T == 1
                                  else max(5, NREP // T))
            best = min(row, key=lambda t: row[t] / t)
            table[depth][tag] = row
            bounds = ", ".join(
                f"T={t} "
                f"{_bound_ms(f'k4_{depth}_{t}_{tag}', cells)[0] / t:.4f}"
                for t in blocks)
            steps = "pair A + B" if depth == "coupled" else "triple"
            print(f"[phase 12] 256^3 {depth} {tag}: ms a launch / a step: "
                  + ", ".join(f"T={t} {v:.4f} / {v / t:.4f}"
                              for t, v in row.items())
                  + f" (T = 1: the one-step {steps}); bound a step "
                  f"{bounds}; fastest step at T = {best} "
                  "(the sessions take 1); " + "; ".join(
                      f"T={t}: {_k4_layout(p, dist, with_ref, t)}"
                      for t in blocks), flush=True)
        del f, g, out, psi, lap, ref
        torch.cuda.empty_cache()
    return plain_ms, table


def _k4f_ref_amplitudes(dev):
    """12a, ROADMAP Queue 3's ref case, printed (no gate: it is recorded
    as a divergence of the guarded divisions): the 256^3 droplet one step
    in (rho_lo = 0) with random ref amplitudes 1 + 0.1 U.  One-step
    kernel against the plain step, step by step; the K4 launch at T = 2
    against the two one-step launches; at the cell of the largest
    difference, the streamed densities (rho, phi) that the second step's
    guards |x| > eps read, on either side."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import moments, stream

    f, g = _k4f_state("coupled", dev)
    p = _k4f_params("coupled", dict(kBT=KBT))
    ref = _k4_ref(SHAPE, dev, 73)
    words = [104729 * (k + 1) - 2 ** 30 for k in range(2)]
    k1 = fused_step.fused_stream_collide(f, g, words[0], 77, p, ref=ref)
    p1 = fused_step.k_step_reference(f, g, words[0], 77, p, "clt4", ref)
    e1 = max(_maxdiff(k1[0], p1[0]), _maxdiff(k1[1], p1[1]))
    k2 = fused_step.fused_stream_collide(*k1, words[1], 78, p, ref=ref)
    p2 = fused_step.k_step_reference(*p1, words[1], 78, p, "clt4", ref)
    d = torch.maximum((k2[0] - p2[0]).abs().amax(0),
                      (k2[1] - p2[1]).abs().amax(0))
    cell = tuple(int(i) for i in torch.unravel_index(torch.argmax(d),
                                                     SHAPE))
    # the streamed densities the second step's guards read there
    dens = {side: tuple(float(moments.density(stream.stream(t))[cell])
                        for t in pair)
            for side, pair in (("kernel", k1), ("plain", p1))}
    e2 = max(_maxdiff(k2[0], p2[0]), _maxdiff(k2[1], p2[1]))
    del p1, p2
    torch.cuda.empty_cache()
    fo, go = fused_step.blocked_stream_collide(f, g, words, 77, p, 2,
                                               ref=ref)
    bit = bool(torch.equal(fo, k2[0]) and torch.equal(go, k2[1]))
    eps = p.div_eps
    flips = [name for i, name in enumerate(("rho", "phi"))
             if (abs(dens["kernel"][i]) > eps)
             != (abs(dens["plain"][i]) > eps)]
    print(f"[phase 12] ref case, random amplitudes 1 + 0.1 U on the 256^3 "
          f"rho_lo = 0 droplet: max|K - plain| step 1 {e1:.3e}, step 2 "
          f"{e2:.3e} (K4 T = 2 bitwise the two K launches: {bit}); at the "
          f"worst cell {cell} the second step's streamed (rho, phi) are "
          f"{dens['kernel']!r} (kernel) / {dens['plain']!r} (plain), eps "
          f"{eps!r}: guards that differ {flips or 'none'} (printed, not "
          "gated: ROADMAP Queue 3)", flush=True)
    del f, g, k1, k2, fo, go, ref
    torch.cuda.empty_cache()


def _k4f_sessions(dev, cells, phase5_901, phase5_mlups):
    """12c: phase 5's 256^3 droplet session (clt4) at the default block
    (1), at T = 2 and at T = 3, and phase 8's alpha1 session at T = 2: launches
    (K4 sweeps, and A, L and K only in the single steps), masses after
    the restore, the droplet's centre of mass and volume ratio, MLUPS;
    the coupled ones at step 901 (before any restore) against phase 5's
    block-1 session.  Returns {(depth, T): (MLUPS, K4 launches)} and the
    coupled block-2 session's views at steps 901 and 1101 (on the host),
    which phase 13 holds its decomposed sessions against."""
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.observables import stats

    res, views = {}, {}
    for depth, block in (("coupled", None), ("coupled", 2), ("coupled", 3),
                         ("alpha1", 2)):
        cfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
            kBT=KBT, **K4F_FORCE[depth])
        sess = FusedSession(cfg.params, SHAPE, noise_dist="clt4",
                            block=block)
        T = sess.block_for(CHUNK)
        tag = f"phase 12 session {depth} block={block} (T = {T})"
        state = model.make_initial_state(cfg, device=dev)
        com0 = stats.center_of_mass(state.f.sum(0))
        keep = {901: None}
        view, counts, t_adv, _ = _run_session(sess, state, tag, keep)
        del state
        nb, nl = fused_step.blocked_launches, fused_step.laplacian_launches
        ncl = fused_step.mode_launches.get("blocked cluster", 0)
        singles = NCHUNKS * (CHUNK % T if T > 1 else CHUNK)
        want_b = NCHUNKS * (CHUNK // T) if T > 1 else 0
        sd = fused_step.sd_depth(cfg.params)
        clustered = T > 1 and fused_step.launch_cluster(T, SHAPE, sd) != (
            1, 1)
        _check((nb, counts[0], counts[1]) == (want_b, singles, singles)
               and nl == (singles if depth == "alpha1" else 0)
               and ncl == (nb if clustered else 0),
               f"{tag}: launches K4 {nb} (on clusters {ncl}), K "
               f"{counts[0]}, A {counts[1]}, L {nl}")
        if (depth, T) == ("coupled", 2):
            _check(ncl > 0, f"{tag}: no cluster launch at coupled T = 2")
        rho = view.f.sum(0)
        drift = float((stats.center_of_mass(rho) - com0).norm())
        r0 = cfg.init_radius * SHAPE[0]
        vol = float(stats.droplet_volume_ratio(rho, 1.5, r0))
        mlups = cells * CHUNK * NCHUNKS / t_adv / 1e6
        vs5 = ""
        if depth == "coupled":
            v = keep[901]
            e = max(_maxdiff(v.f, phase5_901[0].to(dev)),
                    _maxdiff(v.g, phase5_901[1].to(dev)))
            bit = bool(torch.equal(v.f.cpu(), phase5_901[0])
                       and torch.equal(v.g.cpu(), phase5_901[1]))
            vs5 = (f"; step 901 vs phase 5's block-1 session: max|delta| "
                   f"{e:.3e} (bitwise {bit}, tol {TOL}); phase 5 "
                   f"{phase5_mlups:.1f} MLUPS")
            _check(e <= TOL, f"{tag}: step 901 differs from phase 5: {e}")
        print(f"[{tag}] launches K4 {nb} (on clusters of more than one "
              f"block {ncl}), K {counts[0]}, A {counts[1]}, L "
              f"{nl} (A and L only in the single steps); droplet COM drift "
              f"{drift:.4e} cells (tol {COM_TOL}); volume ratio {vol:.4f} "
              f"(range {VOL_RANGE}); {mlups:.1f} MLUPS{vs5}", flush=True)
        _check(drift <= COM_TOL, f"{tag}: droplet drifted {drift} cells")
        if depth == "coupled":
            _check(VOL_RANGE[0] <= vol <= VOL_RANGE[1],
                   f"{tag}: volume ratio {vol}")
        res[(depth, block)] = (mlups, nb)
        if (depth, block) == ("coupled", 2):
            views = {901: (keep[901].f.cpu(), keep[901].g.cpu()),
                     1101: (view.f.cpu(), view.g.cpu())}
        del view, rho, keep, sess
        torch.cuda.empty_cache()
    return res, views


def _droplet_campaign(tmp, tag, mesh):
    """The droplet campaign at 64^3 through the driver at block 2:
    droplet-eq through ``run.main --block 2`` (400 steps, frames every
    200), then the USE_REF_STATE droplet-fluct continuation through
    ``run(cfg, block=2)`` (700 steps, frames every 175), on `mesh`
    (``--mesh`` and ``run(cfg, mesh=)``) or on one card.  Returns (the
    final state, the launch counts of each run, the frames read back,
    the continuation's config, the equilibration's directory)."""
    import os

    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.io import fields as fields_io
    from bflbm_tpu_torch.kernels import fused_step

    def counts():
        return dict(k4=fused_step.blocked_launches,
                    k4_ext=fused_step.mode_launches.get("blocked ext", 0),
                    k=fused_step.launches, a=fused_step.density_launches)

    eq = os.path.join(tmp, f"{tag}_eq")
    fused_step.reset_launch_counts()
    run_mod.main(["--preset", "droplet-eq", "--shape", "64", "64", "64",
                  "--nsteps", "400", "--plot-int", "200", "--print-int",
                  "100", "--block", "2", "--out", eq]
                 + (["--mesh"] + [str(m) for m in mesh] if mesh else []))
    eq_counts = counts()
    cfg = config.preset("droplet-fluct").replace(
        shape=(64, 64, 64), checkpoint_path=os.path.join(
            eq, "checkpoint0000400"), step_continue=400, nsteps=700,
        use_ref_state=True, ref_state_path=os.path.join(eq,
                                                        "equilibrium.npz"),
        plot_int=175, print_int=100, droplet_int=100,
        out_dir=os.path.join(tmp, f"{tag}_fluct"))
    fused_step.reset_launch_counts()
    state = run_mod.run(cfg, mesh=mesh, block=2)
    torch.cuda.synchronize()
    frames = {f"{kind}/{name}": fields_io.read_frame(os.path.join(d, name))
              for kind, d in (("eq", eq), ("fluct", cfg.out_dir))
              for name in sorted(os.listdir(d)) if name.startswith("plt")}
    return state, (eq_counts, counts()), frames, cfg, eq


def _k4f_driver(tmp):
    """12d: the droplet campaign at 64^3 through the driver at block 2
    (:func:`_droplet_campaign` on one card): K4 launches, A only in
    single steps, masses after the restore at step 1000, the droplet's
    drift.  Returns the campaign's frames (phase 13d holds the same
    campaign on a mesh against them)."""
    import os

    import numpy as np

    from bflbm_tpu_torch import run as run_mod

    t0 = time.perf_counter()
    state, (eq_c, fl_c), frames, cfg, eq = _droplet_campaign(tmp, "k4f",
                                                             None)
    m0 = _npz_masses(os.path.join(eq, "checkpoint0000400.npz"))
    st = dict(run_mod.last_run_stats)
    recs = _metrics(os.path.join(cfg.out_dir, "metrics.jsonl"))
    prints = [r for r in recs if "mass_f" in r]
    defect = max(max(abs(r["mass_f"] - m0[0]) / m0[0],
                     abs(r["mass_g"] - m0[1]) / m0[1])
                 for r in prints if r["step"] >= 1001)
    drops = [r for r in recs if "droplet_com" in r]
    com = np.asarray([r["droplet_com"] for r in drops])
    drift = float(np.linalg.norm(com[-1] - com[0]))
    print(f"[phase 12] droplet-eq (main --block 2, 64^3, 400 steps): "
          f"launches K4 {eq_c['k4']}, K {eq_c['k']}, A {eq_c['a']}; "
          f"droplet-fluct (run(cfg, block=2), ref + clt4, 700 steps) in "
          f"{time.perf_counter() - t0:.2f} s with the equilibration: step "
          f"{state.step}; launches K4 {fl_c['k4']}, K {fl_c['k']}, A "
          f"{fl_c['a']}; steps rerun after a crossing "
          f"{int(st['ref_retry_steps'])}; relative mass defect after the "
          f"restore {defect:.3e} (tol {MASS_RTOL}); droplet COM drift "
          f"{drift:.4e} cells (tol {COM_TOL}); ref_roll_violations "
          f"{prints[-1]['ref_roll_violations']}", flush=True)
    _check(state.step == 1100, f"final step {state.step} != 1100")
    _check(eq_c["k4"] > 0 and eq_c["k"] == eq_c["a"] and fl_c["k4"] > 0
           and fl_c["k"] == fl_c["a"], "K4 not on the driver's path, or A "
                                       "launched inside a sweep")
    _check_finite(state.f, state.g)
    _check(defect <= MASS_RTOL, f"mass defect {defect}")
    _check(drift <= COM_TOL, f"droplet drifted {drift} cells")
    return frames


# -- phase 13: K4 on the decomposed path (blocks at block T) -----------------

# (stencil depth, T) of every block the port takes, and each depth's force
K4X_CASES = ((1, 2), (1, 3), (2, 2), (2, 3), (3, 2))
K4X_FORCE = {1: {}, 2: K4F_FORCE["coupled"], 3: ALPHA1}
# the ext K4 launches of a sweep (T = 2) on every block do the work of
# the whole-domain launch on the blocks' interiors, each cell once: the
# coupled rows of phase 12, and uncoupled with the noise off K1a's
# operations less its noise (~300) twice
KERNELS.update(k4x_clt4=KERNELS["k4_coupled_2_clt4"],
               k4x_off=dict(bytes=KERNELS["k1a"]["bytes"],
                            ops=2 * (KERNELS["k1a"]["ops"] - 300)))


def _k4x_params(sd, kw):
    from bflbm_tpu_torch.config import LBMParams

    return LBMParams(**dict(K4X_FORCE[sd], **kw))


def _one_step_sweep(blocks, refs, exts, mesh, words, step0, params, dist):
    """T steps of one exchange and one one-step ext launch (A, L, K) a
    block, on copies of the padded blocks: what a blocked sweep replaces."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.parallel import halo

    cur = [b.clone() for b in blocks]
    for s, w in enumerate(words):
        halo.exchange_halo(cur, mesh, exts[0].pad)
        nxt = [torch.empty_like(b) for b in cur]
        for b, o, ext, r in zip(cur, nxt, exts, refs):
            fused_step.fused_stream_collide(b[0], b[1], w, step0 + s, params,
                                            out=(o[0], o[1]),
                                            noise_dist=dist, ref=r, ext=ext)
        cur = nxt
    return cur


def _k4x_vs_plain(f, g, params, dist, ref, T, mesh, whole=None):
    """One ext K4 launch a block of (f, g) over `mesh` (pads sd T deep,
    exchanged once, the ref operand's too) against the plain ext sweep on
    the block (one tile: the interior), against T one-step ext launches
    with an exchange before each, and against the whole-domain K4 launch
    (`whole`, launched here when None) on the block's cells.  Each launch
    must be one blocked launch and nothing else.  Returns (max |delta| to
    plain, max |delta| to the one-step launches, bitwise to the one-step
    launches, bitwise to the whole-domain launch, plain seconds)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import blocked

    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    words = [104729 * (k + 1) - 2 ** 30 for k in range(T)]
    ss, exts = _padded_blocks(f, g, mesh, params, T)
    blocks, refs = ss.blocks, [None] * mesh.size
    if ref is not None:   # its pads filled too: the ring cells read them
        refs = mesh_lib.shard_field(ref, mesh, ss.pad)
        halo.exchange_halo(refs, mesh, ss.pad)
    if whole is None:
        whole = fused_step.blocked_stream_collide(f, g, words, 77, params, T,
                                                  noise_dist=dist, ref=ref)
    k1 = _one_step_sweep(blocks, refs, exts, mesh, words, 77, params, dist)
    e_plain = e_k1 = plain_s = 0.0
    bit_k1 = bit_whole = True
    for b, (blk, ext, r) in enumerate(zip(blocks, exts, refs)):
        before = (fused_step.blocked_launches, fused_step.launches,
                  fused_step.density_launches,
                  fused_step.mode_launches.get("blocked ext", 0))
        fo, go = fused_step.blocked_stream_collide(
            blk[0], blk[1], words, 77, params, T, noise_dist=dist, ref=r,
            ext=ext)
        torch.cuda.synchronize()
        after = (fused_step.blocked_launches, fused_step.launches,
                 fused_step.density_launches,
                 fused_step.mode_launches.get("blocked ext", 0))
        _check(after == (before[0] + 1, before[1], before[2],
                         before[3] + 1),
               f"ext K4 launches went {before} -> {after}")
        got = (ext.region(fo), ext.region(go))
        _check_finite(*got)
        t0 = time.perf_counter()
        fr, gr = blocked.blocked_sweep_reference(
            blk[0], blk[1], words, 77, params, T, ext.interior(blk.shape),
            dist, r, ext)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        e_plain = max(e_plain, _maxdiff(got[0], fr), _maxdiff(got[1], gr))
        del fr, gr
        want = (ext.region(k1[b][0]), ext.region(k1[b][1]))
        e_k1 = max(e_k1, _maxdiff(got[0], want[0]),
                   _maxdiff(got[1], want[1]))
        bit_k1 &= bool(torch.equal(got[0], want[0])
                       and torch.equal(got[1], want[1]))
        cells = (slice(None),) + _cells(ext, blk.shape)
        bit_whole &= bool(torch.equal(got[0], whole[0][cells])
                          and torch.equal(got[1], whole[1][cells]))
        del fo, go, got, want
    return e_plain, e_k1, bit_k1, bit_whole, plain_s


def _k4x_small(dev, errs):
    """13a: one ext K4 launch a block at every (sd, T) in every mode on
    meshes (2, 1, 1), (1, 2, 2) and (2, 2, 1), at 32^3 and at 20 x 12 x
    40 (no tile divides it), against plain (<= TOL) and against T
    one-step ext launches and the whole-domain K4 launch (bitwise,
    printed).  The ref operand is the droplet's own densities, rolled."""
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    n = b_k1 = b_whole = 0
    for shape in (SMALL, K4_ODD):
        for sd, T in K4X_CASES:
            f, g = _perturbed_droplet(shape, _k4x_params(sd, {}), 91, dev,
                                      radius=0.3)
            ref = _ref_operand(f, g, (1, 2, -2))
            row = []
            for tag, kw, dist, with_ref in K4_MODES:
                e = 0.0
                for ms in EXT_MESHES:
                    ep, ek, bk, bw, _ = _k4x_vs_plain(
                        f, g, _k4x_params(sd, kw), dist,
                        ref if with_ref else None, T,
                        mesh_lib.make_mesh(ms, dev))
                    _check(max(ep, ek) <= TOL,
                           f"{shape} sd={sd} T={T} {tag} mesh {ms}: ext K4 "
                           f"disagrees: {ep}, {ek}")
                    e = max(e, ep, ek)
                    n += 1
                    b_k1 += bk
                    b_whole += bw
                errs.append(e)
                row.append(f"{tag} {e:.2e}")
            print(f"[phase 13] {shape} sd={sd} T={T}, meshes {EXT_MESHES}: "
                  f"max|ext K4 - plain, T one-step ext| by mode: "
                  + ", ".join(row), flush=True)
    print(f"[phase 13] 13a: {n} (mesh, mode) cases of one ext K4 launch a "
          f"block; bitwise T one-step ext launches {b_k1}, bitwise the "
          f"whole-domain K4 on the block {b_whole} (tol {TOL})", flush=True)
    return n, b_k1, b_whole


def _k4x_256(dev, cells, errs):
    """13b: the 256^3 droplet one step in on mesh (2, 1, 1) (two 128 x 256
    x 256 blocks, x pads sd T = 4 deep), T = 2: the ext K4 launches held
    against plain (one whole-interior tile), the one-step ext launches and
    the whole-domain K4 (clt4 and general tau), then timed per sweep
    beside the exchange, the whole-domain K4 and block 1's ext A + B for
    the same two steps; and the uncoupled mixture with the noise off (sd
    = 1: x pads 2 deep) the same way beside block 1's ext K.  Returns
    {mode: {key: ms a sweep}}."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((2, 1, 1), dev)
    out = {}
    f, g = _k4f_state("coupled", dev)
    for tag, kw in (("clt4", dict(kBT=KBT)),
                    ("general", dict(kBT=KBT, tau_f=0.7, tau_g=0.6)),
                    ("off", None)):
        if kw is None:   # the uncoupled mixture, noise off
            del f, g
            torch.cuda.empty_cache()
            p = LBMParams(kBT=0.0)
            f, g = model.perturbed_populations(SHAPE, 7, device=dev)
        else:
            p = _k4x_params(2, kw)
        sd = fused_step.sd_depth(p)
        ep, ek, bk, bw, plain_s = _k4x_vs_plain(f, g, p, "clt4", None, 2,
                                                mesh)
        torch.cuda.empty_cache()
        _check(max(ep, ek) <= TOL, f"256^3 {tag}: ext K4 disagrees: {ep}, "
                                   f"{ek}")
        errs.append(max(ep, ek))
        ss, exts = _padded_blocks(f, g, mesh, p, 2)
        blocks = ss.blocks
        spare = [torch.empty_like(b) for b in blocks]
        plan = halo.halo_plan(blocks, mesh, exts[0].pad)
        n = max(5, NREP // 2)

        def ext_k4():
            for i in range(n):
                for b, o, ext in zip(blocks, spare, exts):
                    fused_step.blocked_stream_collide(
                        b[0], b[1], [1, 2], i, p, 2, out=(o[0], o[1]),
                        noise_dist="clt4", ext=ext)

        def exchange():
            for _ in range(n):
                halo.run_plan(plan)

        wout = (torch.empty_like(f), torch.empty_like(g))

        def whole_k4():
            for i in range(n):
                fused_step.blocked_stream_collide(f, g, [1, 2], i, p, 2,
                                                  out=wout,
                                                  noise_dist="clt4")

        row = {"ext_k4": _time_ms(ext_k4, cells, n),
               "exchange": _time_ms(exchange, cells, n),
               "whole_k4": _time_ms(whole_k4, cells, n),
               "plain_ms": plain_s * 1e3}
        del ss, blocks, spare, plan, wout
        torch.cuda.empty_cache()
        # block 1: sd-deep pads, two steps of ext A + B (K) a block
        ss, exts = _padded_blocks(f, g, mesh, p)
        blocks = ss.blocks
        spare = [torch.empty_like(b) for b in blocks]
        psi = [torch.empty((2,) + tuple(b.shape[2:]), device=dev)
               for b in blocks] if sd > 1 else [None] * 2

        def ext_pair():
            for i in range(n):
                for _ in range(2):
                    for b, o, ext, q in zip(blocks, spare, exts, psi):
                        fused_step.fused_stream_collide(
                            b[0], b[1], 1, i, p, out=(o[0], o[1]),
                            noise_dist="clt4", psi=q, ext=ext)

        row["ext_block1"] = _time_ms(ext_pair, cells, n)
        del ss, blocks, spare, psi
        torch.cuda.empty_cache()
        out[tag] = row
        steps = "ext A + B" if sd > 1 else "ext K"
        print(f"[phase 13] 256^3 on mesh (2, 1, 1), T = 2, {tag}: ms a sweep "
              f"(two steps): ext K4 (both blocks) {row['ext_k4']:.4f}, "
              f"exchange (x pads {sd * 2} deep) {row['exchange']:.4f}, "
              f"whole-domain K4 {row['whole_k4']:.4f}; block 1's {steps} "
              f"(two steps, both blocks) {row['ext_block1']:.4f}; plain ext "
              f"sweep {row['plain_ms']:.2f}; max|ext K4 - plain, one-step| "
              f"{max(ep, ek):.3e}, bitwise one-step {bk}, whole-domain "
              f"{bw}", flush=True)
    del f, g
    torch.cuda.empty_cache()
    return out


def _k4x_sessions(dev, cells, k4f_views):
    """13c: phase 5's 256^3 droplet (clt4) through ShardedSession(block=2)
    on (2, 1, 1) and (2, 2, 1), 1 + 1100 steps with the restore at step
    1000 (after the sweep to step 1001), against phase 12's
    FusedSession(block=2) at steps 901 (bitwise printed) and 1101 (within
    TOL); launches a block, MLUPS and the exchange's ms a step.  Then the
    uncoupled mixture with the noise off on (2, 1, 1) at T = 2 and T = 1.
    Returns {(mesh, tag): (MLUPS, blocked launches)} and, for phase 14b,
    the views at steps 901 and 1101 (on the host) of the T = 2 droplet on
    (2, 2, 1) and mixture on (2, 1, 1), keyed (mesh, tag)."""
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import ShardedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    res, views = {}, {}
    n_k = CHUNK * NCHUNKS
    cfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=KBT, **K4F_FORCE["coupled"])
    mix = LBMParams(kBT=0.0)
    for ms, tag, block in (((2, 1, 1), "droplet", 2),
                           ((2, 2, 1), "droplet", 2),
                           ((2, 1, 1), "mixture off", 2),
                           ((2, 1, 1), "mixture off", 1)):
        mesh = mesh_lib.make_mesh(ms)
        if tag == "droplet":
            sess = ShardedSession(mesh, cfg.params, SHAPE,
                                  noise_dist="clt4", block=block)
            state = model.make_initial_state(cfg, device=dev)
        else:
            sess = ShardedSession(mesh, mix, SHAPE, noise_dist="u8",
                                  block=block)
            state = model.init_mixture(SHAPE, mix, device=dev)
        keep = {901: None}
        name = f"phase 13 session {tag} mesh {ms} block={block}"
        view, counts, t_adv, _ = _run_session(sess, state, name, keep)
        del state
        nb = fused_step.mode_launches.get("blocked ext", 0)
        want = (mesh.size * NCHUNKS * (CHUNK // block) if block > 1 else 0,
                0 if block > 1 else mesh.size * n_k)
        _check((nb, counts[0]) == want,
               f"{name}: launches ext K4 {nb}, K {counts[0]} != {want}")
        mlups = cells * n_k / t_adv / 1e6
        vs = ""
        if tag == "droplet":
            cmp = {}
            for step, v in ((901, keep[901]), (1101, view)):
                w = k4f_views[step]
                cmp[step] = (max(_maxdiff(v.f.cpu(), w[0]),
                                 _maxdiff(v.g.cpu(), w[1])),
                             bool(torch.equal(v.f.cpu(), w[0])
                                  and torch.equal(v.g.cpu(), w[1])))
            vs = (f"; vs phase 12's FusedSession(block=2): step 901 "
                  f"max|delta| {cmp[901][0]:.3e} (bitwise {cmp[901][1]}), "
                  f"step 1101 {cmp[1101][0]:.3e} (bitwise {cmp[1101][1]}) "
                  f"(tol {TOL})")
            _check(max(cmp[901][0], cmp[1101][0]) <= TOL,
                   f"{name} disagrees with FusedSession(block=2): {cmp}")
        ss = _padded_blocks(view.f, view.g, mesh, sess.params, block)[0]
        plan = halo.halo_plan(ss.blocks, mesh, ss.pad)
        ex_ms = _time_ms(lambda: [halo.run_plan(plan) for _ in range(NREP)],
                         cells, NREP)
        del ss, plan
        print(f"[{name}] pads {sess.pad}; launches a block: ext K4 "
              f"{nb // mesh.size}, K {counts[0] // mesh.size}, A "
              f"{counts[1] // mesh.size}; {mlups:.1f} MLUPS; exchange "
              f"{ex_ms:.4f} ms ({ex_ms / block:.4f} ms a step){vs}",
              flush=True)
        res[(ms, tag, block)] = (mlups, nb)
        if block == 2 and (ms, tag) in (((2, 2, 1), "droplet"),
                                        ((2, 1, 1), "mixture off")):
            views[(ms, tag)] = {s: (v.f.cpu(), v.g.cpu()) for s, v in
                                ((901, keep[901]), (1 + n_k, view))}
        del view, keep, sess
        torch.cuda.empty_cache()
    return res, views


def _k4x_driver(tmp, single):
    """13d: phase 12d's droplet campaign at 64^3 on mesh (2, 1, 1)
    (:func:`_droplet_campaign`: ``run.main --mesh 2 1 1 --block 2``,
    then ``run(cfg, mesh=(2, 1, 1), block=2)`` with USE_REF_STATE), every
    frame read back against phase 12d's (`single`, the same campaign on
    one card).  Returns the ext K4 launches of both runs."""
    import numpy as np

    from bflbm_tpu_torch.ops import hydro as hydro_ops

    t0 = time.perf_counter()
    state, (eq_c, fl_c), frames, _, _ = _droplet_campaign(tmp, "k4x",
                                                          (2, 1, 1))
    _check(state.step == 1100, f"final step {state.step}")
    _check_finite(state.f, state.g)
    names = sorted(single)
    _check(names == sorted(frames) and len(names) >= 6,
           f"frames {sorted(frames)} / {names}")
    err = max(float(np.abs(frames[n][k] - single[n][k]).max())
              for n in names for k in hydro_ops.HYDRO_NAMES)
    same = all(np.array_equal(frames[n][k], single[n][k])
               for n in names for k in hydro_ops.HYDRO_NAMES)
    print(f"[phase 13] droplet campaign 64^3 at block 2 on mesh (2, 1, 1): "
          f"main --mesh 2 1 1 --block 2 (400 steps) then run(cfg, mesh=(2, "
          f"1, 1), block=2) with USE_REF_STATE (700 steps) in "
          f"{time.perf_counter() - t0:.2f} s: launches eq {eq_c}, fluct "
          f"{fl_c}; {len(names)} frames read back vs phase 12d's run "
          f"without a mesh: max|delta| over the 22 fields {err:.3e} (tol "
          f"{TOL}), bitwise {same}", flush=True)
    _check(eq_c["k4_ext"] > 0 and fl_c["k4_ext"] > 0
           and eq_c["k"] == eq_c["a"] and fl_c["k"] == fl_c["a"],
           "ext K4 not on the driver's path, or A launched inside a sweep")
    _check(err <= TOL, f"mesh frames disagree: {err}")
    return eq_c["k4_ext"] + fl_c["k4_ext"]


# -- phase 14: K4 in the overlap split and the y strips ----------------------

# the sweeps of 14a: (tag, mesh, ShardedSession options)
K4S_SWEEPS = (("split", (2, 2, 1), dict(overlap=True)),
              ("split", (2, 1, 1), dict(overlap=True)),
              ("force", (1, 1, 1), dict(overlap="force")),
              ("strips", (2, 2, 1), dict(y_exchange="strips")),
              ("strips", (2, 1, 1), dict(y_exchange="strips")))
K4S_MODES = tuple(m for m in K4_MODES
                  if m[0] in ("off", "u8", "ref", "general"))
# the windowed launches of a sweep cover each interior cell once, so they
# do the work of the serial ext K4 launches (phase 13's k4x rows); the
# strip-fed ones too, plus the bytes of the strips they write (_k4s_times)
KERNELS.update(k4_window=KERNELS["k4x_clt4"], k4_ystrips=KERNELS["k4x_clt4"])


def _nan_pads(t, pad, axes=(0, 1, 2)):
    """A copy of a padded block tensor with NaN in the pads of `axes`."""
    out = t.clone()
    for d in axes:
        if pad[d]:
            ax = out.dim() - 3 + d
            out.narrow(ax, 0, pad[d]).fill_(float("nan"))
            out.narrow(ax, out.shape[ax] - pad[d], pad[d]).fill_(float("nan"))
    return out


def _k4s_layout(f, g, params, ref, T, mesh, opts):
    """(f, g) and the ref operand decomposed over `mesh` in the layout of
    the sweep `opts` at block T, pads exchanged (and, under the strips, the
    strips of the exchanged blocks exchanged into NaN-filled received
    strips); None when that sweep does not run there (no axis splits)."""
    import torch

    from bflbm_tpu_torch.parallel import halo
    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.state import init_state

    shape = tuple(f.shape[1:])
    lay = kernel_par.layout(mesh, shape, params, block=T, **opts)
    if not (any(lay.split) or lay.strips):
        return None
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, lay.pad)
    halo.exchange_halo(ss.blocks, mesh, lay.pad)
    refs = [None] * mesh.size
    if ref is not None:
        refs = mesh_lib.shard_field(ref, mesh, lay.pad)
        halo.exchange_halo(refs, mesh, lay.pad)
    received = [None] * mesh.size
    if lay.strips:
        sent = kernel_par.strip_buffers(ss.blocks, lay.pad)
        received = [torch.full_like(t, float("nan")) for t in sent]
        halo.run_plan(halo.strip_plan(sent, received, mesh, lay.pad))
    return (lay, ss.blocks, refs, received,
            halo.block_exts(mesh, shape, lay.pad))


def _k4s_vs_serial(f, g, params, dist, ref, T, mesh, opts, words):
    """Phase 14a: the K4 launches of one sweep at block T on every block of
    (f, g) over `mesh` in the sweep of `opts`.  Split: the interior window
    (the interior shrunk by sd T on each split axis) on a copy of the
    block whose pads, the ref operand's too, are NaN, into a NaN-filled
    output: it must write exactly its window, finite; then the seam bands
    on the exchanged block.  Strips: one launch on a copy whose y pads are
    NaN, fed by the received strips, writing its edge rows into NaN-filled
    strips.  Each launch must be one blocked launch of its mode.  Returns
    None where the sweep does not run, else (launches, blocks bitwise the
    serial ext K4 launch, blocks, max |delta| to the plain ext sweep (one
    tile) of every launch's cells, strips written bitwise the edge rows),
    the plain version of a strip-fed launch being the plain strip-fed
    sweep."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import kernel as kernel_par

    got = _k4s_layout(f, g, params, ref, T, mesh, opts)
    if got is None:
        return None
    lay, blocks, refs, received, exts = got
    sd = fused_step.sd_depth(params)
    if not lay.strips:
        inner, bands = kernel_par.split_windows(lay, blocks[0].shape, sd * T)
    n = n_bit = n_strips = 0
    err = 0.0
    tag = "blocked ystrips" if lay.strips else "blocked window"
    for blk, ext, r, st in zip(blocks, exts, refs, received):
        want = fused_step.blocked_stream_collide(
            blk[0], blk[1], words, 77, params, T, noise_dist=dist, ref=r,
            ext=ext)
        out = (torch.full_like(blk[0], float("nan")),
               torch.full_like(blk[1], float("nan")))
        before = (fused_step.blocked_launches, fused_step.launches,
                  fused_step.mode_launches.get(tag, 0))
        if lay.strips:
            src = _nan_pads(blk, lay.pad, (1,))
            st_out = torch.full_like(st, float("nan"))
            fused_step.blocked_stream_collide(
                src[0], src[1], words, 77, params, T, out=out,
                noise_dist=dist, ref=r, ext=ext, strips=st,
                strips_out=st_out)
            k = 1
            px, py = lay.pad[0], lay.pad[1]
            x1, y1 = blk.shape[2] - px, blk.shape[3] - py
            n_strips += all(
                torch.equal(st_out[0, s][:, px:x1], o[:, px:x1, py:2 * py])
                and torch.equal(st_out[1, s][:, px:x1],
                                o[:, px:x1, y1 - py:y1])
                for s, o in enumerate(out))
            plain = blocked.blocked_sweep_reference(
                src[0], src[1], words, 77, params, T,
                ext.interior(blk.shape), dist, r, ext, strips=st)
        else:
            src = _nan_pads(blk, lay.pad)
            fused_step.blocked_stream_collide(
                src[0], src[1], words, 77, params, T, out=out,
                noise_dist=dist, ext=ext, window=inner,
                ref=None if r is None else _nan_pads(r, lay.pad))
            torch.cuda.synchronize()
            for o in out:
                v = blocked.box_view(o, inner)
                _check(int(torch.isnan(o).sum()) == o.numel() - v.numel()
                       and bool(torch.isfinite(v).all()),
                       f"the interior window's launch wrote outside its "
                       f"window {inner} or read a pad")
            for band in bands:
                fused_step.blocked_stream_collide(
                    blk[0], blk[1], words, 77, params, T, out=out,
                    noise_dist=dist, ref=r, ext=ext, window=band)
            k = 1 + len(bands)
            plain = blocked.blocked_sweep_reference(
                blk[0], blk[1], words, 77, params, T,
                ext.interior(blk.shape), dist, r, ext)
        torch.cuda.synchronize()
        after = (fused_step.blocked_launches, fused_step.launches,
                 fused_step.mode_launches.get(tag, 0))
        _check(after == (before[0] + k, before[1], before[2] + k),
               f"{tag} launches went {before} -> {after}, expected {k}")
        n += k
        res = (ext.region(out[0]), ext.region(out[1]))
        _check_finite(*res)
        n_bit += bool(torch.equal(res[0], ext.region(want[0]))
                      and torch.equal(res[1], ext.region(want[1])))
        err = max(err, _maxdiff(res[0], plain[0]), _maxdiff(res[1], plain[1]))
        del want, out, src, plain, res
    return n, n_bit, len(blocks), err, (n_strips if lay.strips else None)


def _k4s_small(dev, errs):
    """14a: the K4 launches of a sweep of the split (meshes (2, 2, 1) and
    (2, 1, 1), and overlap="force" on (1, 1, 1)) and of the strips
    ((2, 2, 1), (2, 1, 1)) at every (sd, T) of phase 13, in the modes off,
    u8, ref and general tau, at 32^3 and 20 x 12 x 40 (where the split
    does not fit, the case is counted as skipped): bitwise the serial ext
    K4 launch, within TOL of plain.  Returns (launches, bitwise blocks,
    blocks, strips bitwise) by sweep kind."""
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    tot = {"window": [0, 0, 0, 0], "ystrips": [0, 0, 0, 0]}
    skipped = set()
    for shape in (SMALL, K4_ODD):
        for sd, T in K4X_CASES:
            f, g = _perturbed_droplet(shape, _k4x_params(sd, {}), 93, dev,
                                      radius=0.3)
            ref = _ref_operand(f, g, (1, 2, -2))
            words = [104729 * (k + 3) - 2 ** 29 for k in range(T)]
            row = []
            for tag, kw, dist, with_ref in K4S_MODES:
                e = 0.0
                for sweep, ms, opts in K4S_SWEEPS:
                    r = _k4s_vs_serial(f, g, _k4x_params(sd, kw), dist,
                                       ref if with_ref else None, T,
                                       mesh_lib.make_mesh(ms, dev), opts,
                                       words)
                    if r is None:
                        skipped.add((shape, sd, T, ms))
                        continue
                    n, bit, nb, ep, st = r
                    _check(ep <= TOL and bit == nb and st in (None, nb),
                           f"{shape} sd={sd} T={T} {tag} {sweep} {ms}: "
                           f"bitwise {bit} of {nb} blocks, strips {st}, "
                           f"max|delta| to plain {ep}")
                    t = tot["ystrips" if sweep == "strips" else "window"]
                    t[0] += n
                    t[1] += bit
                    t[2] += nb
                    t[3] += nb if st is not None else 0
                    e = max(e, ep)
                errs.append(e)
                row.append(f"{tag} {e:.2e}")
            print(f"[phase 14] {shape} sd={sd} T={T}: max|K4 (windows, "
                  f"strips) - plain| by mode: " + ", ".join(row), flush=True)
            del f, g, ref
    w, s = tot["window"], tot["ystrips"]
    print(f"[phase 14] 14a: {w[0]} window launches on {w[2]} blocks, "
          f"{w[1]} blocks bitwise the serial ext K4 launch; {s[0]} strip-fed "
          f"launches, {s[1]} of {s[2]} bitwise, strips written bitwise the "
          f"edge rows {s[3]} of {s[2]}; max|delta| to plain {max(errs):.3e} "
          f"(tol {TOL}); {len(skipped)} (shape, case, mesh) without a split "
          f"(an axis of 2 sd T + 1 cells needed): "
          + ", ".join(f"{sh} sd={a} T={b} {m}"
                      for sh, a, b, m in sorted(skipped)), flush=True)
    return tot


def _k4s_times(dev, cells):
    """14b: the K4 launches of a sweep (T = 2) of the phase-5 droplet one
    step in on (2, 2, 1) at 256^3: the windows (interior window and four
    seam bands on each of the four blocks), the strip-fed launches, and
    the serial ext K4 launches.  The windowed and strip-fed launches of
    one sweep at step 0 are held bitwise against the serial ones and
    within TOL of the plain windowed and strip-fed sweeps (one tile a
    window) at step 0 on the same blocks and words, every window's cells
    and the strips written; then each is timed a sweep, beside the plain
    sweep.  Returns {key: ms}, {kind}_err (max |delta| to plain) and the
    strips' bytes."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import kernel as kernel_par
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((2, 2, 1), dev)
    f, g = _k4f_state("coupled", dev)
    p = _k4x_params(2, dict(kBT=KBT))
    words = [3, 4]
    n = max(5, NREP // 2)
    out = {}
    for kind, opts in (("window", dict(overlap=True)),
                       ("ystrips", dict(y_exchange="strips"))):
        lay, blocks, _, received, exts = _k4s_layout(f, g, p, None, 2, mesh,
                                                     opts)
        outs = [(torch.empty_like(b[0]), torch.empty_like(b[1]))
                for b in blocks]
        serial = [fused_step.blocked_stream_collide(
            b[0], b[1], words, 0, p, 2, noise_dist="clt4", ext=e)
            for b, e in zip(blocks, exts)]
        if kind == "window":
            inner, bands = kernel_par.split_windows(lay, blocks[0].shape, 4)
            wins = [inner] + bands

            def run(reps=n):
                for i in range(reps):
                    for b, o, e in zip(blocks, outs, exts):
                        for w in wins:
                            fused_step.blocked_stream_collide(
                                b[0], b[1], words, i, p, 2, out=o,
                                noise_dist="clt4", ext=e, window=w)

            def plain():
                return [blocked.blocked_sweep_reference(
                    b[0], b[1], words, 0, p, 2, [hi - lo for lo, hi in w],
                    "clt4", None, e, window=w)
                    for b, e in zip(blocks, exts) for w in wins]

            def plain_err(got):
                return max(_maxdiff(blocked.box_view(o[k], w), r[k])
                           for (o, w), r in zip(
                               ((o, w) for o in outs for w in wins), got)
                           for k in (0, 1))
        else:
            st_out = [torch.empty_like(t) for t in received]

            def run(reps=n):
                for i in range(reps):
                    for b, o, e, st, so in zip(blocks, outs, exts, received,
                                               st_out):
                        fused_step.blocked_stream_collide(
                            b[0], b[1], words, i, p, 2, out=o,
                            noise_dist="clt4", ext=e, strips=st,
                            strips_out=so)

            def plain():
                return [blocked.blocked_sweep_reference(
                    b[0], b[1], words, 0, p, 2, e.interior(b.shape), "clt4",
                    None, e, strips=st)
                    for b, e, st in zip(blocks, exts, received)]

            def plain_err(got):
                # the cells, and the strips written: the first and last
                # sd T interior rows of the plain sweep
                px, py = lay.pad[0], lay.pad[1]
                err = 0.0
                for o, e, so, r in zip(outs, exts, st_out, got):
                    x1 = o[0].shape[1] - px
                    for k in (0, 1):
                        err = max(err, _maxdiff(e.region(o[k]), r[k]),
                                  _maxdiff(so[0, k][:, px:x1],
                                           r[k][:, :, :py]),
                                  _maxdiff(so[1, k][:, px:x1],
                                           r[k][:, :, -py:]))
                return err
            loc = mesh.local_shape(SHAPE)
            out["strip_bytes"] = (mesh.size * 2 * 2 * 19 * loc[0]
                                  * lay.pad[1] * loc[2] * 4)
        # one sweep at step 0, held bitwise against the serial launches
        run(1)
        torch.cuda.synchronize()
        bit = all(torch.equal(e.region(o[k]), e.region(s[k]))
                  for o, s, e in zip(outs, serial, exts) for k in (0, 1))
        _check(bit, f"256^3 {kind} K4 launches differ from the serial ones")
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        out[f"{kind}_plain"] = (time.perf_counter() - t0) * 1e3
        err = out[f"{kind}_err"] = plain_err(want)
        _check(err <= TOL, f"256^3 {kind} K4 launches: max|delta| to the "
                           f"plain sweep {err} > {TOL}")
        del want
        torch.cuda.empty_cache()

        def serial_run():
            for i in range(n):
                for b, o, e in zip(blocks, outs, exts):
                    fused_step.blocked_stream_collide(
                        b[0], b[1], words, i, p, 2, out=o,
                        noise_dist="clt4", ext=e)

        out[kind] = _time_ms(run, cells, n)
        out[f"{kind}_serial"] = _time_ms(serial_run, cells, n)
        what = ("windows (interior and 4 bands a block)" if kind == "window"
                else "strip-fed launches")
        print(f"[phase 14] 256^3 on (2, 2, 1), T = 2, coupled clt4, the "
              f"{what} of a sweep: {out[kind]:.4f} ms (serial ext K4 on "
              f"the same blocks {out[f'{kind}_serial']:.4f}), plain "
              f"{out[f'{kind}_plain']:.2f} ms; bitwise the serial launches "
              f"{bit}; max|delta| to plain at step 0 {err:.3e} (tol {TOL})",
              flush=True)
        del lay, blocks, received, exts, outs, serial
        torch.cuda.empty_cache()
    del f, g
    torch.cuda.empty_cache()
    return out


def _k4s_sessions(dev, cells, serial_views, serial_mlups):
    """14b: phase 5's 256^3 droplet (clt4) through ShardedSession(block=2)
    on (2, 2, 1) with overlap=True and with y_exchange="strips", and the
    uncoupled mixture with the noise off on (2, 1, 1) with overlap=True,
    1 + 1100 steps (the restore after the sweep to step 1001), against
    phase 13c's serial T = 2 sessions at steps 901 (bitwise) and 1101
    (within TOL); launches a block by mode, MLUPS, and each sweep's time
    split by CUDA events into exchange, interior, exposed exchange and
    bands beside the serial sweep's.  Returns {(mesh, tag, sweep): (MLUPS,
    launches of the sweep's mode)}."""
    import torch

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession, ShardedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    res = {}
    n_k = CHUNK * NCHUNKS
    cfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=KBT, **K4F_FORCE["coupled"])
    mix = LBMParams(kBT=0.0)
    for ms, tag, sweep, opts in (
            ((2, 2, 1), "droplet", "split", dict(overlap=True)),
            ((2, 2, 1), "droplet", "strips", dict(y_exchange="strips")),
            ((2, 1, 1), "mixture off", "split", dict(overlap=True))):
        mesh = mesh_lib.make_mesh(ms)
        droplet = tag == "droplet"
        params, dist = (cfg.params, "clt4") if droplet else (mix, "u8")
        sess = ShardedSession(mesh, params, SHAPE, noise_dist=dist, block=2,
                              **opts)
        _check(sess.block == 2 and (sess.layout.strips
                                    or any(sess.layout.split)),
               f"{ms} {sweep}: layout {sess.layout}")

        def initial():
            return (model.make_initial_state(cfg, device=dev) if droplet
                    else model.init_mixture(SHAPE, mix, device=dev))

        keep = {901: None}
        name = f"phase 14 session {tag} {sweep} mesh {ms} block=2"
        view, counts, t_adv, _ = _run_session(sess, initial(), name, keep)
        modes = dict(fused_step.mode_launches)
        mode = "blocked ystrips" if sess.layout.strips else "blocked window"
        per = 1 + 2 * sum(sess.layout.split)
        want = mesh.size * NCHUNKS * (CHUNK // 2) * per
        _check(modes.get(mode) == want and counts[0] == 0,
               f"{name}: launches {modes}, K {counts[0]}; expected {mode} "
               f"{want}, no K")
        cmp = {}
        for step, v in ((901, keep[901]), (1 + n_k, view)):
            w = serial_views[(ms, tag)][step]
            cmp[step] = (max(_maxdiff(v.f.cpu(), w[0]),
                             _maxdiff(v.g.cpu(), w[1])),
                         bool(torch.equal(v.f.cpu(), w[0])
                              and torch.equal(v.g.cpu(), w[1])))
        _check(cmp[901][1] and cmp[1 + n_k][0] <= TOL,
               f"{name} disagrees with phase 13c's serial session: {cmp}")
        mlups = cells * n_k / t_adv / 1e6
        del view, keep
        torch.cuda.empty_cache()
        # the time split of a sweep (2 steps), the serial sweep's beside it
        pc = FusedSession(params, SHAPE, noise_dist=dist, block=1).enter(
            initial())
        words = [104729 * k + 1 for k in range(SPAN_STEPS)]
        sp = {k: _span_split(ms, params, o, pc, words, block=2, dist=dist)
              for k, o in (("serial", dict(y_exchange="serial")),
                           (sweep, opts))}
        del pc
        torch.cuda.empty_cache()
        print(f"[{name}] layout {sess.layout}; launches a block: {mode} "
              f"{modes.get(mode) // mesh.size} ({per} a sweep); {mlups:.1f} "
              f"MLUPS (phase 13c's serial T = 2: "
              f"{serial_mlups[(ms, tag)]:.1f}); vs phase 13c: step 901 "
              f"max|delta| {cmp[901][0]:.3e} (bitwise {cmp[901][1]}), step "
              f"{1 + n_k} {cmp[1 + n_k][0]:.3e} (bitwise {cmp[1 + n_k][1]}) "
              f"(tol {TOL}); ms a sweep (CUDA events, "
              f"{SPAN_STEPS // 2 - 2} sweeps): " + "; ".join(
                  f"{k} exchange {v['exchange']:.4f}, interior "
                  f"{v['interior']:.4f}, exposed {v['exposed']:.4f}, bands "
                  f"{v['bands']:.4f}, host enqueue {v['host_us'] * 2:.1f} us"
                  for k, v in sp.items()), flush=True)
        res[(ms, tag, sweep)] = (mlups, modes.get(mode))
        del sess
        torch.cuda.empty_cache()
    return res


def _probes(dev):
    """Phase 15: the platform probes at 256^3 through ``probes.run`` with
    the probe launch counters zeroed just before and read just after, then
    every probe kernel held against its plain version again on other
    inputs (these launches are not counted).  Adds the probes' bytes and
    operations a cell to KERNELS.  Returns (records, counts, the second
    checks' max |delta| by kernel)."""
    import torch

    from bflbm_tpu_torch import probes
    from bflbm_tpu_torch.probes import launch, noise_micro, platform

    per_cell = dict(bytes=platform.BYTES_PER_CELL, ops=0)
    KERNELS.update({f"copy {v}": per_cell for v in platform.COPY_VARIANTS})
    KERNELS.update({f"transform {v}": dict(bytes=platform.BYTES_PER_CELL,
                                           ops=platform.TRANSFORM_OPS)
                    for v in platform.TRANSFORM_VARIANTS})
    KERNELS.update({f"noise {c}": dict(bytes=4, int_ops=n_int, ops=n_float)
                    for c, (n_int, n_float) in noise_micro.OPS.items()})
    # 4 B read and 4 B written an element; the true floor is launch latency
    KERNELS["launch"] = dict(bytes=8, ops=1)

    probes.reset_launch_counts()
    recs = probes.run(probes.PROBES, device=dev, shape=SHAPE,
                      out=lambda ln: print(f"[phase 15] {ln}", flush=True))
    counts = probes.launch_counts()
    for rec in recs:
        if rec["key"] is not None:
            _check(counts.get(rec["key"], 0) > 0,
                   f"{rec['key']} was not launched by probes.run")

    errs = {}
    gen = torch.Generator(device=dev).manual_seed(777)
    f = torch.empty((19,) + SHAPE, device=dev).uniform_(0.5, 1.5,
                                                        generator=gen)
    out = torch.empty_like(f)
    for variant in platform.COPY_VARIANTS:
        errs[f"copy {variant}"] = 0.0
        for n, s in platform.copy_configs():
            out.fill_(float("nan"))
            platform.chunk_copy(f, n, variant, out=out, stages=s)
            _check(torch.equal(out, f),
                   f"copy {variant} at {n} x {s} stages: not bitwise")
            errs[f"copy {variant}"] = max(errs[f"copy {variant}"],
                                          _maxdiff(out, f))
    want = platform.transform_reference(f)
    for variant in platform.TRANSFORM_VARIANTS:
        out.fill_(float("nan"))
        platform.moment_transform(f, variant, out=out)
        errs[f"transform {variant}"] = _maxdiff(out, want)
    del f, out, want
    torch.cuda.empty_cache()
    noise = torch.empty(SHAPE, device=dev)
    for case in noise_micro.CASES:
        seed = (-424242, 99)
        noise_micro.run_case(case, seed, noise)
        errs[f"noise {case}"] = _maxdiff(
            noise, noise_micro.run_case_reference(case, seed, SHAPE,
                                                  device=dev))
    a = torch.zeros(launch.SHAPE, device=dev)
    res = launch.chain(lambda x, y: launch.add_one(x, out=y), a,
                       torch.empty_like(a))
    errs["launch"] = _maxdiff(res, torch.full_like(a, 400.0))
    torch.cuda.synchronize()
    for key, err in errs.items():
        _check(err <= (0.0 if key.startswith(("copy", "launch")) else TOL),
               f"{key}: max|delta| {err:.3e} against its plain version")
    for rec in recs:
        if rec["key"] is None:
            continue
        bound, by = _bound_ms(rec["key"], rec["cells"])
        if rec["key"] == "launch":
            rate = (f"from a graph; eager {rec['eager_ms']:.5f} ms, "
                    f"torch.add eager {rec['library_eager_ms']:.5f} ms")
        elif rec.get("ns_per_cell") is not None:
            rate = f"{rec['ns_per_cell']:.4f} ns a cell"
        else:
            rate = f"{rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s"
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f} ms")
        print(f"[phase 15] {rec['key']}: {rec['ms']:.4f} ms ({rate}), bound "
              f"{bound:.6f} ms ({by}, {bound / rec['ms']:.1%} of the time), "
              f"plain {rec['plain_ms']:.4f} ms, "
              f"library {lib}, launches {counts[rec['key']]}, max|delta| "
              f"{rec['max_abs_err']:.3e} (again on other inputs "
              f"{errs[rec['key']]:.3e})", flush=True)
    return recs, counts, errs


# -- phase 16: the analysis path ----------------------------------------------

# keys of the analysis JSON that come out of a scipy or numpy fit: card and
# CPU within 1e-6 relative there, 1e-9 for every other number
FITTED = {"R_mean", "R_std", "W_mean", "R", "gamma_laplace", "intercept",
          "interface_z0", "interface_width", "gamma_capillary",
          "D_measured", "ratio", "gamma_20", "gamma_22"}
DIRECT_RTOL, FITTED_RTOL = 1e-9, 1e-6
# theory at G = 1.5, rho_t = 3.1 (surface_tension_predict.ipynb cells 2,
# 5), with the JAX package's tolerances (tests/test_observables.py)
THEORY_PINNED = {"rho_lo_binodal": (0.03231825314438495, 1e-6),
                 "rho_hi_binodal": (3.067681746855615, 1e-6),
                 "gamma_quadrature": (0.9032199309615522, 1e-3)}


def _json_agree(card, cpu, tag, key=""):
    """The card's JSON within DIRECT_RTOL (FITTED_RTOL for fitted keys)
    of the CPU's, NaN where the CPU's is NaN; returns the largest relative
    difference."""
    import math

    if isinstance(cpu, dict):
        _check(set(card) == set(cpu), f"{tag}: keys differ")
        return max([_json_agree(card[k], cpu[k], tag, k) for k in cpu],
                   default=0.0)
    if isinstance(cpu, list):
        _check(len(card) == len(cpu), f"{tag}.{key}: lengths differ")
        return max([_json_agree(a, b, tag, key) for a, b in zip(card, cpu)],
                   default=0.0)
    if isinstance(cpu, float) and math.isnan(cpu):
        _check(isinstance(card, float) and math.isnan(card),
               f"{tag}.{key}: {card} where the CPU gives NaN")
        return 0.0
    if isinstance(cpu, (int, float)) and not isinstance(cpu, bool):
        rel = abs(card - cpu) / abs(cpu) if cpu else abs(card)
        rtol = FITTED_RTOL if key in FITTED else DIRECT_RTOL
        _check(rel <= rtol, f"{tag}.{key}: card {card!r}, CPU {cpu!r} "
                            f"(relative {rel:.3e} > {rtol})")
        return rel
    _check(card == cpu, f"{tag}.{key}: card {card!r}, CPU {cpu!r}")
    return 0.0


def _analysis_card_vs_cpu(tag, argv, walls, frames=None):
    """One subcommand through ``analysis.main`` on the card, then with
    ``--device cpu``, the JSON compared; prints both walls (and a frame's,
    given the frame count); returns the card's JSON."""
    import contextlib
    import io

    import torch

    from bflbm_tpu_torch import analysis

    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = analysis.main(argv + ["--device", where])
        torch.cuda.synchronize()
        out[where] = (res, time.perf_counter() - t0)
    rel = _json_agree(out["cuda"][0], out["cpu"][0], tag)
    walls[tag] = (out["cuda"][1], out["cpu"][1], frames)
    each = ("" if not frames else
            f" ({out['cuda'][1] / frames:.3f} / {out['cpu'][1] / frames:.3f}"
            f" s a frame)")
    shown = out["cuda"][0]
    if argv[0] == "noise":
        means = [v["mean"] for k, v in shown.items() if k[1:3] == "_a"]
        shown = {"n_frames": shown["n_frames"],
                 "mode ratio means": [min(means), max(means)],
                 "momentum_anticorr": shown["momentum_anticorr"]}
    print(f"[phase 16] {tag}: card {out['cuda'][1]:.3f} s, CPU "
          f"{out['cpu'][1]:.3f} s{each}; largest card / CPU relative "
          f"difference {rel:.3e}; {json.dumps(shown, default=float)}",
          flush=True)
    return out["cuda"][0]


def _analysis_frames(eq, walls):
    """Phase 16 on phase 7's three 256^3 droplet-eq frames (.bflbm), run
    before phase 7 deletes them: droplet, convergence and msd through the
    CLI, card against CPU; marching cubes with the solid-angle harmonics
    and the ray map with its harmonics on the last frame, card against
    CPU.  Returns the card's results."""
    import glob
    import os

    import numpy as np
    import torch

    from bflbm_tpu_torch.io import fields as fields_io
    from bflbm_tpu_torch.observables import droplet as drop_obs
    from bflbm_tpu_torch.observables import marching_cubes as mc

    res = {}
    res["droplet"] = _analysis_card_vs_cpu("droplet 256^3",
                                           ["droplet", "--dir", eq], walls, 3)
    res["convergence"] = _analysis_card_vs_cpu(
        "convergence 256^3", ["convergence", "--dir", eq], walls, 3)
    res["msd"] = _analysis_card_vs_cpu("msd 256^3", ["msd", "--dir", eq],
                                       walls, 3)
    r0 = 0.2 * SHAPE[0]
    _check(res["droplet"]["n_frames"] == 3 and abs(
        res["droplet"]["R_mean"] / r0 - 1.0) < 0.1,
        f"droplet R_mean {res['droplet']['R_mean']} against {r0}")
    _check(res["convergence"]["n_frames"] == 3
           and np.isfinite(res["convergence"]["dev_linf"]),
           "convergence report")
    _check(abs(res["msd"]["R_mean"] / r0 - 1.0) < 0.1,
           f"msd R_mean {res['msd']['R_mean']}")

    last = sorted(glob.glob(os.path.join(eq, "plt*.bflbm")))[-1]
    rho_np = fields_io.read_frame(last, ("rho",))["rho"]
    surf = {}
    for where in ("cuda", "cpu"):
        rho = torch.as_tensor(rho_np, device=where)
        com = drop_obs.center_of_mass(rho - rho[0, 0, 0])
        level = 0.5 * (float(rho.min()) + float(rho.max()))
        t0 = time.perf_counter()
        amps, diag = mc.mc_surface_amplitudes(rho, com + np.asarray(
            SHAPE) / 2.0 - 0.5)
        torch.cuda.synchronize()
        t_mc = time.perf_counter() - t0
        verts, faces = mc._marching_cubes(rho.double(), level)
        t0 = time.perf_counter()
        rmap = drop_obs.surface_radius_map(rho, com, level)
        ray = drop_obs.spherical_harmonic_amplitudes(rmap, lmax=2)
        t_ray = time.perf_counter() - t0
        surf[where] = dict(verts=verts.cpu(), faces=faces.cpu(), amps=amps,
                           diag=diag, rmap=rmap, ray=ray, t_mc=t_mc,
                           t_ray=t_ray)
    c, h = surf["cuda"], surf["cpu"]
    _check(torch.equal(c["faces"], h["faces"]), "marching cubes: faces "
           "differ between card and CPU")
    v_err = float((c["verts"] - h["verts"]).abs().max())
    _check(v_err <= 1e-12, f"marching cubes: vertices differ by {v_err}")
    amp_rel = max(abs(c["amps"][k] - h["amps"][k]) / abs(h["amps"][(0, 0)])
                  for k in h["amps"])
    ray_rel = max(float(np.abs(c["rmap"] - h["rmap"]).max()
                        / np.abs(h["rmap"]).max()),
                  max(abs(c["ray"][k] - h["ray"][k]) / abs(h["ray"][(0, 0)])
                      for k in h["ray"]))
    _check(amp_rel <= DIRECT_RTOL and ray_rel <= DIRECT_RTOL,
           f"surface harmonics: card / CPU {amp_rel:.3e}, {ray_rel:.3e}")
    diag = c["diag"]
    r_mc = c["amps"][(0, 0)].real / np.sqrt(4 * np.pi)
    r_ray = c["ray"][(0, 0)].real / np.sqrt(4 * np.pi)
    walls["marching cubes 256^3"] = (c["t_mc"], h["t_mc"], 1)
    walls["radius map 256^3"] = (c["t_ray"], h["t_ray"], 1)
    print(f"[phase 16] marching cubes on the last 256^3 frame (verts "
          f"{diag['n_verts']}, faces {diag['n_faces']}, boundary edges "
          f"{diag['boundary_edges']}, area {diag['area']:.2f}, sum_w / 4 pi "
          f"{diag['sum_w'] / (4 * np.pi):.6f}): card {c['t_mc']:.3f} s, CPU "
          f"{h['t_mc']:.3f} s; faces equal, vertices within {v_err:.1e}, "
          f"zeta_lm within {amp_rel:.3e} of zeta_00; zeta_00 / sqrt(4 pi) "
          f"{r_mc:.4f}, |zeta_20| {abs(c['amps'][(2, 0)]):.3e}", flush=True)
    print(f"[phase 16] ray map + harmonics on the last 256^3 frame: card "
          f"{c['t_ray']:.3f} s, CPU {h['t_ray']:.3f} s; card / CPU within "
          f"{ray_rel:.3e}; zeta_00 / sqrt(4 pi) {r_ray:.4f} (marching "
          f"cubes {r_mc:.4f}), |zeta_20| {abs(c['ray'][(2, 0)]):.3e}",
          flush=True)
    _check(abs(diag["sum_w"] / (4 * np.pi) - 1.0) < 0.01
           and diag["boundary_edges"] <= 0.001 * 3 * diag["n_faces"],
           f"marching cubes surface {diag}")
    _check(abs(r_mc / r_ray - 1.0) < 0.01 and abs(r_mc / r0 - 1.0) < 0.1,
           f"zeta_00 radii {r_mc}, {r_ray} against {r0}")
    res["mc"], res["ray"] = c["amps"], c["ray"]
    return res


def _analysis_runs(tmp):
    """The small runs phase 16 analyses, through ``run.run`` on the card:
    a 64^3 mixture (kBT 1e-5, 20 steps, a noise dump every 10), the
    interface-fluct physics at (8, 256, 64) from a stripe (300 steps, a
    frame every 50) and two 64^3 fluctuating droplets of radius 0.2 and
    0.25 of the box (300 steps, a frame and a droplet record every 100).
    Returns their directories."""
    import os

    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod

    dirs = {k: os.path.join(tmp, k) for k in ("noise", "iface", "r20",
                                              "r25")}
    quiet = dict(print_int=0, sf_window=0, plot_fmt="native")
    runs = [
        config.preset("mixture-fluct").replace(
            shape=(64, 64, 64), init="mixture", step_continue=0, nsteps=20,
            plot_int=0, out_noise_int=10, out_dir=dirs["noise"], **quiet),
        config.preset("interface-fluct").replace(
            shape=INTERFACE, init="stripe", step_continue=0, nsteps=300,
            plot_int=50, out_dir=dirs["iface"], **quiet)]
    for key, radius in (("r20", 0.2), ("r25", 0.25)):
        runs.append(config.preset("droplet-fluct").replace(
            shape=(64, 64, 64), init="droplet", init_radius=radius,
            step_continue=0, nsteps=300, plot_int=100, droplet_int=100,
            out_dir=dirs[key], **quiet))
    t0 = time.perf_counter()
    for cfg in runs:
        run_mod.run(cfg)
    print(f"[phase 16] the small runs (64^3 mixture noise dumps, the "
          f"(8, 256, 64) interface, two 64^3 droplets) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return dirs


def _analysis_small(keep, walls):
    """Phase 16 on small inputs: radius on phase 7's continuation
    metrics, sk on its 64^3 structure factors, noise, interface, laplace
    and msd on the runs of :func:`_analysis_runs`, theory; card against
    CPU.  Returns the card's results."""
    import math
    import os

    dirs = _analysis_runs(keep)
    res = {}
    res["radius"] = _analysis_card_vs_cpu(
        "radius", ["radius", "--dir", os.path.join(keep, "fluct")], walls)
    res["sk"] = _analysis_card_vs_cpu(
        "sk 64^3", ["sk", "--dir", os.path.join(keep, "sk")], walls)
    res["noise"] = _analysis_card_vs_cpu(
        "noise 64^3", ["noise", "--dir", dirs["noise"]], walls, 2)
    res["interface"] = _analysis_card_vs_cpu(
        "interface (8, 256, 64)", ["interface", "--dir", dirs["iface"]],
        walls, 7)
    res["laplace"] = _analysis_card_vs_cpu(
        "laplace 64^3", ["laplace", "--dirs", dirs["r20"], dirs["r25"]],
        walls, 2)
    res["msd"] = _analysis_card_vs_cpu(
        "msd 64^3", ["msd", "--dir", dirs["r25"]], walls, 4)
    res["theory"] = _analysis_card_vs_cpu("theory", ["theory"], walls)
    # phase 7's continuation: a droplet record every 200 steps, 600-1400
    _check(res["radius"]["n_records"] == 5
           and res["radius"]["n_fit_converged"] == 5, f"radius {res['radius']}")
    _check(abs(res["sk"]["rho*rho"]["mean_ratio"] - 1.0) < 0.05,
           f"sk {res['sk']['rho*rho']}")
    means = [v["mean"] for k, v in res["noise"].items() if k[1:3] == "_a"]
    _check(res["noise"]["n_frames"] == 2
           and all(abs(m - 1.0) < 0.03 for m in means)
           and abs(res["noise"]["momentum_anticorr"] + 1.0) < 0.03,
           f"noise ratios {min(means)}-{max(means)}, anticorrelation "
           f"{res['noise']['momentum_anticorr']}")
    it = res["interface"]
    _check(it["n_frames"] == 7 and math.isfinite(it["gamma_capillary"])
           and 0 < it["interface_z0"] < INTERFACE[2]
           and it["interface_width"] > 0, f"interface {it}")
    runs = res["laplace"]["runs"]
    _check(all(r["delta_p"] > 0 for r in runs)
           and abs(runs[0]["R"] / 12.8 - 1.0) < 0.1
           and abs(runs[1]["R"] / 16.0 - 1.0) < 0.1
           and math.isfinite(res["laplace"]["gamma_laplace"]),
           f"laplace {res['laplace']}")
    _check(math.isfinite(res["msd"]["D_measured"])
           and res["msd"]["n_frames"] == 4, f"msd {res['msd']}")
    _check(all(abs(res["theory"][k] / v - 1.0) <= tol
               for k, (v, tol) in THEORY_PINNED.items()),
           f"theory {res['theory']}")
    return res


# -- phase 17: the physics acceptance phases ----------------------------------

# ACCEPTANCE.md's phase D of the JAX package (R / L at init r = 0.2, 0.23,
# 0.25, 0.28, 0.3 and the Delta P vs 1 / (R / L) slope): droplet-eq has
# kBT = 0, so the port's radii must agree closely
D_ACCEPTED = (0.176089, 0.210017, 0.231134, 0.262425, 0.283115)
D_SLOPE_ACCEPTED = 0.021617
D_RTOL, D_SLOPE_RTOL = 0.005, 0.01
SK_RATIO_TOL = 0.03        # b-kernel cut to a 10,000-step window
E_R_MASS, E_R_RTOL = 5.05, 0.10   # the JAX runs' 1M-step means 5.04-5.14
F_R0, F_R0_RTOL = 7.53, 0.03
MASS_DRIFT_TOL = 5e-7      # the restored 256^3 mixture after 3000 steps
F_GAMMAS = ("gamma_20_axes_sum", "gamma_22_axes_sum", "gamma_20_axes_mean",
            "gamma_22_axes_mean", "gamma_zeta20", "gamma_zeta20_mc")


# the phases of each worker process, in order (f and f-static read d's
# r = 0.25 droplet): the 32^3-64^3 protocols are host-bound (~125 us a
# coupled 32^3 step, the driver's observables between chunks), so four
# processes share the card
ACC_GROUPS = (
    (("d", []), ("f", ["--steps", "50000"]), ("f-static", [])),
    (("e", ["--size", "32", "--steps", "100000", "--n-runs", "1"]),),
    (("c", ["--steps", "20000"]),),
    (("b-kernel", ["--steps", "20000", "--noise-dist", "u8"]),
     ("massdrift", ["--shape", "256", "256", "256", "--steps", "3000"])),
)
# a worker: zero the launch counts, run its phases through
# acceptance.main, print one JSON line with each phase's result, wall
# seconds and the launch counts read after it
ACC_WORKER = """
import contextlib, io, json, sys, time
from bflbm_tpu_torch import acceptance
from bflbm_tpu_torch.kernels import fused_step

out, group = sys.argv[1], json.loads(sys.argv[2])
fused_step.reset_launch_counts()
done = []
for name, argv in group:
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = acceptance.main([name, "--out", out] + argv)
    done.append({"phase": name, "argv": argv, "result": res,
                 "wall_s": time.perf_counter() - t0,
                 "launches": fused_step.launches,
                 "density_launches": fused_step.density_launches,
                 "mode_launches": dict(fused_step.mode_launches)})
print(json.dumps(done), flush=True)
"""


def _acceptance_workers(out):
    """ACC_GROUPS in four processes on the card (two host threads each);
    returns {phase: its record}, each with its worker's launch counts
    read after it (cumulative over the worker's phases)."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", ACC_WORKER, out, json.dumps(group)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for group in ACC_GROUPS]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = {}
    for p, (so, se), group in zip(procs, outputs, ACC_GROUPS):
        _check(p.returncode == 0, f"phase 17 worker {[g[0] for g in group]}"
                                  f" exited {p.returncode}: {se[-3000:]}")
        for rec in json.loads(so.strip().splitlines()[-1]):
            records[rec["phase"]] = rec
    return records


# -- phase 18: the plain engine and the bulk noise source ---------------------

PLAIN_STEPS = 2000
PLAIN_GRAPH_CASES = (("threefry", "clt4"), ("hash", "clt4"), ("hash", "u8"))
BULK_VAR_RTOL = 0.02     # 131,072 cells a channel: sampling error 0.4%


def _plain_engine(tmp):
    """Phase 18: the interface-fluct physics from its stripe through
    ``run(cfg, engine="jnp")`` (the bulk source), with the plain engine's
    counters zeroed just before and read just after; the frames, the
    mass, the bulk normals' variances and a graph replay against the
    eager steps.  Returns a summary dict."""
    import os

    import torch

    from bflbm_tpu_torch import run as run_mod
    from bflbm_tpu_torch.config import preset
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.models import plain_session
    from bflbm_tpu_torch.ops import noise as noise_ops
    from bflbm_tpu_torch.state import generator_from_state

    dev = torch.device("cuda", 0)
    cfg = preset("interface-fluct").replace(
        init="stripe", nsteps=PLAIN_STEPS, step_continue=0, plot_int=500,
        plot_save=False, print_int=0, out_dir=os.path.join(tmp, "plain"))
    init = model.make_initial_state(cfg, device=dev)
    m0 = _masses(init)
    frames = []
    plain_session.reset_counts()
    t0 = time.perf_counter()
    state = run_mod.run(cfg, device=dev, engine="jnp",
                        on_frame=lambda s, p: frames.append((s, p.clone())))
    wall = time.perf_counter() - t0
    counts = dict(plain_session.counts)
    us = run_mod.last_run_stats["advance"] / PLAIN_STEPS * 1e6
    m1 = _masses(state)
    drift = max(abs(b / a - 1.0) for a, b in zip(m0, m1))
    _check([s for s, _ in frames] == list(range(0, PLAIN_STEPS + 1, 500))
           and all(p.shape == (22,) + INTERFACE
                   and bool(torch.isfinite(p).all()) for _, p in frames),
           f"plain engine frames {[(s, tuple(p.shape)) for s, p in frames]}")
    _check(drift <= MASS_RTOL, f"plain engine mass drift {drift:.3e}")
    _check(counts["graph replays"] == (PLAIN_STEPS - 1) // 10
           and state.step == PLAIN_STEPS,
           f"plain engine counts {counts}, step {state.step}")
    bulk = noise_ops.bulk_normal_stack(123456789, 1000, INTERFACE,
                                       device=dev)
    var = bulk.double().reshape(33, -1).var(dim=1)
    worst_var = float((var - 1.0).abs().max())
    _check(worst_var <= BULK_VAR_RTOL,
           f"bulk normals: per-channel variance off 1 by {worst_var:.4f}")
    # keyed by (step, word): the same word a step later, another draw
    _check(not torch.equal(bulk, noise_ops.bulk_normal_stack(
        123456789, 1001, INTERFACE, device=dev)),
        "bulk normals: one word at two steps drew the same normals")
    del bulk

    def fresh():
        return init.replace(f=init.f.clone(), g=init.g.clone(),
                            gen=generator_from_state(init.gen.get_state()))

    # 23 steps (2 chunks of 10 and 3 eager) from graphs against the eager
    # steps, for each way a graph takes its noise: the bulk normals'
    # buffer, and the hash stream computed in the graph from its keys
    p = cfg.params
    bitwise = {}
    for source, dist in PLAIN_GRAPH_CASES:
        kw = dict(noise_source=source, noise_dist=dist, device=dev)
        eager = plain_session.PlainSession(p, INTERFACE, graph=False, **kw)
        graph = plain_session.PlainSession(p, INTERFACE, **kw)
        a = eager.advance(eager.enter(fresh()), 22)
        b = graph.exit(graph.advance(graph.enter(fresh()), 22))
        case = f"{source}/{dist}"
        bitwise[case] = bool(torch.equal(a.f, b.f) and torch.equal(a.g, b.g))
        _check(bitwise[case] and graph.graph_replays == 2
               and graph.eager_steps == 3 and b.step == 23,
               f"graph replay vs eager ({case}): max|delta| "
               f"{float((a.f - b.f).abs().max()):.3e}, replays "
               f"{graph.graph_replays}, eager steps {graph.eager_steps}")
        del eager, graph, a, b
    print(f"[phase 18] run(cfg, engine='jnp'), interface-fluct 8 x 256 x 64 "
          f"from its stripe, bulk noise, {PLAIN_STEPS} steps in {wall:.2f} "
          f"s ({us:.1f} us a step in the loop's advance): counts {counts}; "
          f"{len(frames)} frames finite; relative mass drift {drift:.3e} "
          f"(tol {MASS_RTOL}, no restore); bulk normals' variance off 1 by "
          f"at most {worst_var:.4f} (tol {BULK_VAR_RTOL}), another draw a "
          f"step later; 23 steps from "
          f"CUDA graphs (2 replays + 3 eager) bitwise the eager steps: "
          f"{bitwise}", flush=True)
    return {"us_per_step": us, "drift": drift, "counts": counts,
            "bitwise": bitwise}


def _acceptance(tmp):
    """Phase 17: ``python -m bflbm_tpu_torch.acceptance`` through its main
    on the card, cut where its protocol is long: d at its full protocol
    (5 radii x 20,000 steps at 32^3), b-kernel u8 (20,000 steps, a
    10,000-step S(k) window), e at 32^3 (one 100,000-step run), c (3000 +
    20,000 steps), f (50,000 steps) then f-static on its artifacts, and
    massdrift at 256^3 (3000 steps), in four worker processes.  Each gate
    raises; each phase's JSON and wall seconds are printed.  Returns the
    kernels' launch counts, summed over the workers (massdrift's apart)."""
    import math
    import os

    import numpy as np

    from bflbm_tpu_torch import acceptance

    out = os.path.join(tmp, "acceptance")
    t0 = time.perf_counter()
    recs = _acceptance_workers(out)
    for rec in recs.values():
        print(f"[phase 17] {rec['phase']} {' '.join(rec['argv'])}: "
              f"{rec['wall_s']:.2f} s; {json.dumps(rec['result'])}",
              flush=True)
    res = {k: v["result"] for k, v in recs.items()}
    d = res["d"]
    for run, want in zip(d["runs"], D_ACCEPTED):
        _check(abs(run["R_over_L"] / want - 1.0) <= D_RTOL,
               f"d: R/L {run['R_over_L']} at init r {run['init_r']}, "
               f"accepted {want}")
    _check(abs(d["slope_ref_convention"] / D_SLOPE_ACCEPTED - 1.0)
           <= D_SLOPE_RTOL, f"d: slope {d['slope_ref_convention']}")
    b = res["b-kernel"]
    ratios = {k: v for k, v in b.items() if k in acceptance.SK_NORM}
    _check(len(ratios) == 11 and b["sf_frames"] == 100
           and all(abs(v - 1.0) <= SK_RATIO_TOL for v in ratios.values()),
           f"b-kernel u8 ratios {ratios}")
    e = res["e"]
    rows = np.load(os.path.join(out, "droplet-msd-fluct32", "msd_rows.npy"))
    _check(rows.shape == (999, 5) and bool(np.isfinite(rows).all()),
           f"e: rows {rows.shape}, finite {bool(np.isfinite(rows).all())}")
    _check(abs(e["R_mass_mean"] / E_R_MASS - 1.0) <= E_R_RTOL
           and math.isfinite(e["D_fit"]), f"e: R_mass_mean "
           f"{e['R_mass_mean']}, D_fit {e['D_fit']}")
    c = res["c"]
    _check(math.isfinite(c["gamma_capillary"]) and c["gamma_capillary"] > 0,
           f"c: gamma {c['gamma_capillary']}")
    f = res["f"]
    _check(abs(f["R0"] / F_R0 - 1.0) <= F_R0_RTOL
           and all(math.isfinite(f[k]) for k in F_GAMMAS),
           f"f: R0 {f['R0']}, gammas {[f[k] for k in F_GAMMAS]}")
    fs = res["f-static"]
    _check(all(math.isfinite(v) for v in fs.values()
               if isinstance(v, float)), f"f-static {fs}")
    m = res["massdrift"]
    on = m["restore_on"]["end_rel_drift"]
    _check(abs(on) <= MASS_DRIFT_TOL, f"massdrift: restored drift {on}")
    print(f"[phase 17] gates held: d R/L "
          f"{[r['R_over_L'] for r in d['runs']]} (accepted {D_ACCEPTED}), "
          f"slope {d['slope_ref_convention']} ({D_SLOPE_ACCEPTED}); "
          f"b-kernel u8 worst |ratio - 1| {b['worst_abs_dev']}; e R_mass "
          f"{e['R_mass_mean']}, D_fit {e['D_fit']:.4e} (D_se "
          f"{e['D_se']:.4e}); c gamma {c['gamma_capillary']}; f R0 "
          f"{f['R0']}, <zeta_20^2> {f['zeta20_var']:.4e}; massdrift end "
          f"relative drift restored {on:.3e}, unrestored "
          f"{m['restore_off']['end_rel_drift']:.3e}, MLUPS "
          f"{m['restore_on']['mlups']:.1f} / "
          f"{m['restore_off']['mlups']:.1f} (beside three workers); "
          f"{time.perf_counter() - t0:.2f} s in four workers", flush=True)
    # each worker's counts after its last phase; massdrift's K launches
    # are those after b-kernel's
    last = [recs["f-static"], recs["e"], recs["c"], recs["massdrift"]]
    counts = {"launches": sum(r["launches"] for r in last),
              "density_launches": sum(r["density_launches"] for r in last),
              "mode_launches": {},
              "massdrift": (recs["massdrift"]["launches"]
                            - recs["b-kernel"]["launches"])}
    for r in last:
        for k, v in r["mode_launches"].items():
            counts["mode_launches"][k] = counts["mode_launches"].get(k, 0) + v
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import _build, fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession, make_session
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.observables import stats
    from bflbm_tpu_torch.parallel import mesh as mesh_lib
    from bflbm_tpu_torch.utils.timing import time_steps

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # plain float32 contractions must not run in TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    clock = [time.perf_counter()]

    def phase_done(n):
        now = time.perf_counter()
        print(f"[phase {n}] wall {now - clock[0]:.2f} s", flush=True)
        clock[0] = now

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name, dev)
    print(f"[phase 1] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc per library, started "
          f"together: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                    _build.build_seconds.items())
          + f"): {[str(_build.library_path(n)) for n in _build.SOURCES]}",
          flush=True)
    for ln in _build.ptxas_summary():
        print(f"[phase 1] ptxas: {ln}", flush=True)

    phase_done(1)

    # -- phase 2: uncoupled kernel vs plain ----------------------------------
    errs_k1a = []
    for kbt in (0.0, KBT):
        err, _, _ = _kernel_vs_plain(SMALL, LBMParams(kBT=kbt),
                                     -123456789, 5, dev)
        errs_k1a.append(err)
    params = LBMParams(kBT=KBT)
    err, (fo, go), (f, g) = _kernel_vs_plain(SHAPE, params, 987654321,
                                             1234, dev)
    errs_k1a.append(err)

    # kernel, plain K and copy times: best of 3 runs between synchronize
    # barriers (the kernel ping-pongs two pairs over NREP launches a run)
    bufs = [(f, g), (fo, go)]

    def kernel_run():
        for i in range(NREP):
            fused_step.fused_stream_collide(*bufs[i % 2], 1, i, params,
                                            out=bufs[(i + 1) % 2],
                                            noise_dist="u8")

    k1a_ms = _time_ms(kernel_run, cells, NREP)
    k1a_plain_ms = _time_ms(
        lambda: fused_step.k_step_reference(f, g, 1, 0, params, "u8"),
        cells, 1)
    # device copy rate of one population array (read + write)
    dst = torch.empty_like(f)
    copy_s = time_steps(lambda: [dst.copy_(f) for _ in range(10)],
                        cells, 10)["best_s"]
    copy_gbs = 2 * f.numel() * 4 * 10 / copy_s / 1e9
    k1a_gbs = KERNELS["k1a"]["bytes"] * cells / (k1a_ms * 1e-3) / 1e9
    print(f"[phase 2] K at 256^3: kernel {k1a_ms:.4f} ms "
          f"({cells / k1a_ms / 1e3:.1f} MLUPS, {k1a_gbs:.1f} GB/s at "
          f"{KERNELS['k1a']['bytes']} B/cell), plain torch "
          f"{k1a_plain_ms:.2f} ms; torch copy {copy_gbs:.1f} GB/s",
          flush=True)
    del f, g, fo, go, bufs, dst
    small_f, small_g = model.perturbed_populations(SMALL, 11, device=dev)
    errs_k1a.append(_session_vs_chain(params, small_f, small_g, "u8",
                                      "phase 2"))
    torch.cuda.empty_cache()

    phase_done(2)

    # -- phase 3: the mixture path ------------------------------------------
    state = model.init_mixture(SHAPE, params, device=dev)
    view, counts, t_adv, t_enter = _run_session(
        FusedSession(params, SHAPE, noise_dist="u8", block=1), state,
        "phase 3")
    del state
    n_k = CHUNK * NCHUNKS
    _check(counts == (n_k, 0), f"launches {counts} != ({n_k}, 0)")
    k1a_launches = counts[0]
    # equation-of-state equipartition: the equal-time density structure
    # factor of the ideal mixture is flat, var(rho_t) = rho_t kBT / cs^2
    rho_t = view.f.sum(0) + view.g.sum(0)
    var_ratio = float(rho_t.var()) / (float(rho_t.mean()) * KBT / CS2)
    print(f"[phase 3] total density mean {float(rho_t.mean()):.7f}, "
          f"var / (rho kBT / cs^2) = {var_ratio:.4f} "
          f"(tol {VAR_RTOL})", flush=True)
    _check(abs(var_ratio - 1.0) <= VAR_RTOL,
           f"density fluctuations off equipartition: {var_ratio}")
    print(f"[phase 3] enter {t_enter * 1e3:.1f} ms; "
          f"session: {n_k} K steps at 256^3 in {t_adv:.3f} s = "
          f"{cells * n_k / t_adv / 1e6:.1f} MLUPS (plain-torch K: "
          f"{k1a_plain_ms:.2f} ms/step = "
          f"{cells / k1a_plain_ms / 1e3:.1f} MLUPS)", flush=True)
    del view, rho_t
    torch.cuda.empty_cache()

    phase_done(3)

    # -- phase 4: coupled kernels vs plain ----------------------------------
    errs = {"a": [], "b": []}
    droplet = dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0)
    for tag, kw, dist in (
            ("32^3 droplet kBT=0", dict(), "u8"),
            ("32^3 droplet kBT=1e-5 u8", dict(kBT=KBT), "u8"),
            ("32^3 droplet kBT=1e-5 clt4", dict(kBT=KBT), "clt4"),
            ("32^3 droplet pseudopotential clt4",
             dict(kBT=KBT, use_sc_pseudo=True), "clt4")):
        p = LBMParams(**dict(droplet, **kw))
        f, g = _perturbed_droplet(SMALL, p, 21, dev, radius=0.3)
        _coupled_vs_plain(f, g, p, dist, tag, errs)
    icfg = config.preset("interface-fluct").replace(shape=INTERFACE)
    stripe = model.init_stripe(INTERFACE, icfg.params, device="cpu")
    f, g = model.perturbed_populations(INTERFACE, 22, base=stripe, device=dev)
    _coupled_vs_plain(f, g, icfg.params, "clt4",
                      "interface 8x256x64 (interface-fluct, clt4)", errs)

    # 256^3: the main path's own post-collide state, one step in
    dcfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=KBT)
    dparams = dcfg.params
    pc = FusedSession(dparams, SHAPE, noise_dist="clt4").enter(
        model.make_initial_state(dcfg, device=dev))
    f, g = pc.f, pc.g
    del pc
    psi, (fo, go) = _coupled_vs_plain(f, g, dparams, "clt4",
                                      "256^3 droplet (clt4)", errs)
    a_ms = _time_ms(lambda: [fused_step.density_psi(f, g, dparams, out=psi)
                             for _ in range(NREP)], cells, NREP)
    b_ms = _time_ms(lambda: [fused_step.launch_k(f, g, 1, i, dparams,
                                                 (fo, go), psi, "clt4")
                             for i in range(NREP)], cells, NREP)
    bufs = [(f, g), (fo, go)]

    def pair_run():
        for i in range(NREP):
            fused_step.fused_stream_collide(*bufs[i % 2], 1, i, dparams,
                                            out=bufs[(i + 1) % 2],
                                            noise_dist="clt4", psi=psi)

    pair_ms = _time_ms(pair_run, cells, NREP)
    # kernel B's time in its other modes on the same input: what the
    # force and the generator cost
    modes = {"coupled clt4": b_ms}
    for tag, p, dist in (
            ("coupled u8", dparams, "u8"),
            ("coupled kBT=0", dataclasses.replace(dparams, kBT=0.0), "u8"),
            ("uncoupled clt4", dataclasses.replace(dparams, alpha0=0.0),
             "clt4"),
            ("uncoupled u8", dataclasses.replace(dparams, alpha0=0.0),
             "u8")):
        q = psi if fused_step.is_coupled(p) else None
        modes[tag] = _time_ms(
            lambda: [fused_step.launch_k(f, g, 1, i, p, (fo, go), q, dist)
                     for i in range(NREP)], cells, NREP)
    print("[phase 4] K at 256^3 by mode, same input: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in modes.items()), flush=True)
    a_plain_ms = _time_ms(
        lambda: fused_step.density_psi_reference(f, g, dparams), cells, 1)
    b_plain_ms = _time_ms(
        lambda: fused_step.k_step_reference(f, g, 1, 0, dparams, "clt4"),
        cells, 1)
    conv, conv_in = _library_density(f, g, dev)
    with torch.no_grad():
        lib_err = _maxdiff(conv(conv_in)[0],
                           fused_step.density_psi(f, g, dparams))
        a_lib_ms = _time_ms(lambda: conv(conv_in), cells, 1)
    del conv, conv_in
    a_bytes, b_bytes = KERNELS["a"]["bytes"], KERNELS["b"]["bytes"]
    print(f"[phase 4] 256^3 coupled: pre-pass A {a_ms:.4f} ms "
          f"({a_bytes * cells / a_ms / 1e6:.1f} GB/s at {a_bytes} B/cell), "
          f"K B {b_ms:.4f} ms ({b_bytes * cells / b_ms / 1e6:.1f} GB/s at "
          f"{b_bytes} B/cell), pair {pair_ms:.4f} ms "
          f"({cells / pair_ms / 1e3:.1f} MLUPS, "
          f"{(a_bytes + b_bytes) * cells / pair_ms / 1e6:.1f} GB/s); "
          f"plain pre-pass {a_plain_ms:.2f} ms, plain coupled K "
          f"{b_plain_ms:.2f} ms; library Conv3d pre-pass {a_lib_ms:.3f} ms "
          f"(max|conv - A| {lib_err:.3e})", flush=True)
    del f, g, fo, go, psi, bufs
    torch.cuda.empty_cache()
    sp = LBMParams(**dict(droplet, kBT=KBT))
    f, g = _perturbed_droplet(SMALL, sp, 23, dev, radius=0.3)
    errs["b"].append(_session_vs_chain(sp, f, g, "clt4", "phase 4"))
    del f, g

    phase_done(4)

    # -- phase 5: the coupled path -------------------------------------------
    state = model.make_initial_state(dcfg, device=dev)
    com0 = stats.center_of_mass(state.f.sum(0))
    sess = make_session(dparams, SHAPE, noise_dist="clt4", block=1)
    phase5_views = {901: None}
    view, counts, t_adv, t_enter = _run_session(sess, state, "phase 5",
                                                phase5_views)
    del state
    _check(counts == (n_k, n_k), f"launches {counts} != ({n_k}, {n_k})")
    rho = view.f.sum(0)
    drift = float((stats.center_of_mass(rho) - com0).norm())
    r0 = dcfg.init_radius * SHAPE[0]
    vol = float(stats.droplet_volume_ratio(rho, 1.5, r0))
    print(f"[phase 5] droplet centre of mass {com0.tolist()} -> drift "
          f"{drift:.4e} cells (tol {COM_TOL}); volume ratio at rho = 1.5 "
          f"{vol:.4f} (range {VOL_RANGE}); rho min {float(rho.min()):.3e}, "
          f"phi min {float(view.g.sum(0).min()):.3e}", flush=True)
    _check(drift <= COM_TOL, f"droplet drifted {drift} cells")
    _check(VOL_RANGE[0] <= vol <= VOL_RANGE[1], f"volume ratio {vol}")
    phase5_mlups = cells * n_k / t_adv / 1e6
    print(f"[phase 5] enter {t_enter * 1e3:.1f} ms; session: {n_k} coupled "
          f"steps at 256^3 in {t_adv:.3f} s = {phase5_mlups:.1f} MLUPS",
          flush=True)
    phase5_views[1101] = view
    del rho, sess
    torch.cuda.empty_cache()
    phase_done(5)

    # -- phase 6: the K modes of the driver's flags vs plain ----------------
    new_errs = {k: [] for k in ("k1d", "k1d_u", "k1e", "clt2", "bm",
                                "bm_ref")}
    _modes_small(dev, new_errs)
    new_errs["k1e"].append(_ref_session_crossing(dev))
    torch.cuda.empty_cache()
    mode_ms = _modes_256(dcfg, dev, cells, new_errs)
    torch.cuda.empty_cache()
    phase_done(6)

    # -- phase 7: the run driver at 256^3 -------------------------------------
    import os
    import shutil
    import tempfile
    from pathlib import Path

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    keep16 = tempfile.mkdtemp(prefix="chip_smoke_analysis_", dir=scratch)
    walls16 = {}
    try:
        eq, ckpt = _driver_eq(tmp, cells)
        torch.cuda.empty_cache()
        # phase 16's 256^3 part reads these frames; 1.47 GB each, they go
        # before the rest of phase 7
        t0 = time.perf_counter()
        frames16 = _analysis_frames(eq, walls16)
        print(f"[phase 16] the 256^3 frame analyses (within phase 7) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for step in (0, 200, 400):
            os.remove(os.path.join(eq, f"plt{step:07d}.bflbm"))
        torch.cuda.empty_cache()
        k1e_launches, driver_mlups = _driver_fluct(tmp, eq, ckpt, cells)
        print(f"[phase 7] driver MLUPS {driver_mlups:.1f} beside the bare "
              f"session's {phase5_mlups:.1f} (phase 5)", flush=True)
        torch.cuda.empty_cache()
        flag_launches = _driver_flag_modes(tmp, eq, ckpt)
        torch.cuda.empty_cache()
        sk_phase7 = _driver_structfact(tmp)
        for sub, name in (("fluct", "metrics.jsonl"),
                          ("sk", "structfact0000600.npz")):
            os.makedirs(os.path.join(keep16, sub))
            shutil.copy(os.path.join(tmp, sub, name),
                        os.path.join(keep16, sub, name))
    except BaseException:
        shutil.rmtree(keep16, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done(7)

    # -- phase 8: the alpha1 path ---------------------------------------------
    a1_errs = {"l": [], "b_a1": []}
    _alpha1_small(dev, a1_errs)
    torch.cuda.empty_cache()
    a1_ms = _alpha1_256(dev, cells, a1_errs)
    torch.cuda.empty_cache()
    a1_k_launches, a1_l_launches, a1_mlups = _alpha1_session(dev, cells)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        _alpha1_driver(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done(8)

    # -- phase 9: the decomposed path (K7 ext mode) ---------------------------
    ext_errs = {"a_ext": [], "l_ext": [], "k_ext": []}
    k_bits, w_bits = _ext_small(dev, ext_errs)
    torch.cuda.empty_cache()
    ext_ms, big_bits = _ext_256(dcfg, dev, cells, ext_errs)
    torch.cuda.empty_cache()
    print(f"[phase 9] 9a: every ext K interior == the whole-domain K "
          f"bitwise: {k_bits and big_bits}; every block's hash words == the "
          f"domain's: {w_bits}", flush=True)
    sharded = _sharded_sessions(dcfg, dev, cells, phase5_views, phase5_mlups)
    phase5_901 = (phase5_views[901].f.cpu(), phase5_views[901].g.cpu())
    del phase5_views
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        a1_ext_launches = _sharded_driver(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done(9)

    # -- phase 10: the rest of K7 (windows / the overlap split, y strips) ---
    k7_errs = {"window": [], "ystrips": []}
    for tag, kw, dist, with_ref in WIN_MODES:
        p = LBMParams(**kw)
        f, g = _perturbed_droplet(SMALL, p, 61, dev, radius=0.3)
        ref = _ref_operand(f, g, (1, 2, -2)) if with_ref else None
        for ms in WIN_MESHES:
            _windows_vs_plain(f, g, p, dist, ref,
                              mesh_lib.make_mesh(ms, dev),
                              f"32^3 {tag}, mesh {ms}", k7_errs)
        _strips_vs_plain(f, g, p, dist, ref, f"32^3 {tag}, mesh (2, 2, 1)",
                         k7_errs)
        del f, g, ref
    _sweep_sessions_small(dev)
    torch.cuda.empty_cache()
    k7_ms = _kernel_ms_22(dcfg, dev, cells, k7_errs)
    torch.cuda.empty_cache()
    sweeps, spans = _sweep_sessions_256(dcfg, dev, cells, sharded)
    for ms in ((2, 1, 1), (2, 2, 1)):
        row = [f"serial {sharded[ms][3]:.1f}"] + [
            f"{k[1]} {v[1]:.1f}" for k, v in sweeps.items() if k[0] == ms]
        print(f"[phase 10] 256^3 MLUPS on mesh {ms}: " + ", ".join(row)
              + f"; exchange exposed a step: serial "
              f"{spans[(ms, 'serial')]['exposed']:.4f} ms, split "
              f"{spans[(ms, 'split')]['exposed']:.4f} ms", flush=True)
    for ms in sharded:   # the views are no longer needed
        sharded[ms] = sharded[ms][:5]
    torch.cuda.empty_cache()
    phase_done(10)

    # -- phase 11: K4, T steps a launch ---------------------------------------
    k4_errs = {t: [] for t in K4_BLOCKS}
    _k4_small(dev, k4_errs)
    torch.cuda.empty_cache()
    f, g = model.perturbed_populations(SHAPE, 7, device=dev)
    k4_plain_ms = _k4_256(f, g, k4_errs)
    k4_ms = _k4_times(f, g, cells)
    del f, g
    torch.cuda.empty_cache()
    k4_sessions = _k4_sessions(dev, cells)
    for (t, dist), (mlups, _) in k4_sessions.items():
        ms = k4_ms[dist][t]
        bound = _bound_ms("k1a" if t == 1 else f"k4_{t}", cells)[0]
        print(f"[phase 11] 256^3 mixture {dist} T={t}: {mlups:.1f} MLUPS; "
              f"launch {ms:.4f} ms = {ms / t:.4f} ms a step against a bound "
              f"of {bound / t:.4f} ms a step", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        _k4_driver(tmp, sk_phase7)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done(11)

    # -- phase 12: K4 with the force (coupled, alpha1) ------------------------
    k4f_errs = {d: {t: [] for dd, t in K4F_CASES if dd == d}
                for d in K4F_FORCE}
    _k4f_small(dev, k4f_errs)
    torch.cuda.empty_cache()
    k4f_plain_ms, k4f_ms = _k4f_256(dev, k4f_errs, cells)
    _k4f_ref_amplitudes(dev)
    k4f_sessions, k4f_views = _k4f_sessions(dev, cells, phase5_901,
                                            phase5_mlups)
    del phase5_901
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        k4f_frames = _k4f_driver(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done(12)

    # -- phase 13: K4 on the decomposed path ---------------------------------
    k4x_errs = []
    _k4x_small(dev, k4x_errs)
    torch.cuda.empty_cache()
    k4x_ms = _k4x_256(dev, cells, k4x_errs)
    k4x_sessions, k4x_views = _k4x_sessions(dev, cells, k4f_views)
    del k4f_views
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=scratch)
    try:
        _k4x_driver(tmp, k4f_frames)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done(13)

    # -- phase 14: K4 in the overlap split and the y strips ------------------
    k4s_errs = []
    _k4s_small(dev, k4s_errs)
    torch.cuda.empty_cache()
    k4s_ms = _k4s_times(dev, cells)
    k4s_sessions = _k4s_sessions(
        dev, cells, k4x_views,
        {(ms, tag): k4x_sessions[(ms, tag, 2)][0]
         for ms, tag in k4x_views})
    del k4x_views
    torch.cuda.empty_cache()
    phase_done(14)

    # -- phase 15: the platform probes ---------------------------------------
    probe_recs, probe_counts, probe_errs = _probes(dev)
    torch.cuda.empty_cache()
    phase_done(15)

    # -- phase 16: the analysis path (its 256^3 part ran in phase 7) -------
    try:
        small16 = _analysis_small(keep16, walls16)
    finally:
        shutil.rmtree(keep16, ignore_errors=True)
    print("[phase 16] wall seconds card / CPU: " + "; ".join(
        f"{k} {c:.3f} / {h:.3f}" for k, (c, h, _) in walls16.items()),
        flush=True)
    print(f"[phase 16] results: droplet 256^3 R_mean "
          f"{frames16['droplet']['R_mean']:.4f}, laplace gamma "
          f"{small16['laplace']['gamma_laplace']:.5f}, sk rho*rho "
          f"{small16['sk']['rho*rho']['mean_ratio']:.4f}, msd 64^3 D "
          f"{small16['msd']['D_measured']:.4e}", flush=True)
    phase_done(16)

    # -- phase 17: the physics acceptance phases (no kernel of their own) --
    tmp = tempfile.mkdtemp(prefix="chip_smoke_acceptance_", dir=scratch)
    try:
        acc_counts = _acceptance(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the counts read after the phases: K in u8 (b-kernel, massdrift) and
    # clt4 (c, e, f), A (d, c, e, f)
    _check(acc_counts["mode_launches"].get("u8", 0) > 0
           and acc_counts["mode_launches"].get("clt4", 0) > 0
           and acc_counts["density_launches"] > 0
           and acc_counts["massdrift"] > 0,
           f"phase 17 launches {acc_counts}")
    print(f"[phase 17] launches over d, b-kernel, e, c, f: K "
          f"{acc_counts['launches']}, A {acc_counts['density_launches']}, "
          f"by mode {acc_counts['mode_launches']}; massdrift K "
          f"{acc_counts['massdrift']}", flush=True)
    torch.cuda.empty_cache()
    phase_done(17)

    # -- phase 18: the plain engine and the bulk noise source --------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plain_", dir=scratch)
    try:
        _plain_engine(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done(18)

    record = []
    for key, name, src, ms, plain_ms, lib_ms, launches, err, mode in (
            ("k1a", "k_step_kernel (uncoupled, u8)", "fused_step.cu",
             k1a_ms, k1a_plain_ms, None, k1a_launches, max(errs_k1a),
             "K1a: alpha0 = alpha1 = 0, tau 1/2, hash u8"),
            ("a", "density_psi_kernel", "density_psi.cu", a_ms, a_plain_ms,
             a_lib_ms, counts[1], max(errs["a"]),
             "K1b density_ext + psi (fused_step.py:753-783)"),
            ("b", "k_step_kernel (coupled, clt4)", "fused_step.cu", b_ms,
             b_plain_ms, None, counts[0], max(errs["b"]),
             "K1b: alpha0 != 0, tau 1/2, hash clt4 (_clt4_normal :607)"),
            ("k1d", "k_step_kernel (coupled, general tau, clt4)",
             "fused_step.cu", *mode_ms["k1d"][:2], None,
             flag_launches["k1d"], max(new_errs["k1d"]),
             "K1d: general relaxation (:843-851, :1051-1064), tau_f 0.7, "
             "tau_g 0.6, in population space"),
            ("k1d_u", "k_step_kernel (uncoupled, general tau, clt4)",
             "fused_step.cu", *mode_ms["k1d_u"][:2], None,
             flag_launches["k1d_u"], max(new_errs["k1d_u"]),
             "K1d uncoupled: general relaxation, tau_f 0.7, tau_g 0.6, "
             "alpha0 = 0 (launches: the 256^3 mixture)"),
            ("k1e", "k_step_kernel (coupled, USE_REF_STATE, clt4)",
             "fused_step.cu", *mode_ms["k1e"][:2], None, k1e_launches,
             max(new_errs["k1e"]),
             "K1e: ref_rp amplitudes from the rolled (2,X,Y,Z) equilibrium "
             "(:944-951, :1808-1817)"),
            ("clt2", "k_step_kernel (coupled, clt2)", "fused_step.cu",
             *mode_ms["clt2"][:2], None, flag_launches["clt2"],
             max(new_errs["clt2"]), "K3: _clt2_pair :633"),
            ("bm", "k_step_kernel (coupled, Box-Muller)", "fused_step.cu",
             *mode_ms["bm"][:2], None, flag_launches["bm"],
             max(new_errs["bm"]),
             "K3: _bm_normals :668 over hash_uniforms :535"),
            ("bm_ref", "k_step_kernel (coupled, Box-Muller, USE_REF_STATE)",
             "fused_step.cu", *mode_ms["bm_ref"][:2], None,
             flag_launches["bm_ref"], max(new_errs["bm_ref"]),
             "K3 with K1e: _bm_normals :668, amplitudes from the ref "
             "operand"),
            ("l", "laplacian_tile_kernel", "laplacian_psi.cu",
             a1_ms["l_graph"], a1_ms["l_plain"], a1_ms["l_lib"],
             a1_l_launches, max(a1_errs["l"]), "K1c lap_ext1 (:810-826)"),
            ("b_a1", "a1_tile_kernel (coupled, alpha1, clt4)",
             "fused_step.cu", a1_ms["b_a1_graph"], a1_ms["b_a1_plain"],
             None, a1_k_launches, max(a1_errs["b_a1"]),
             "K1c: alpha1 square-gradient force (:827-832, :927-934)"),
            ("a_ext", "density_psi_kernel (ext)", "density_psi.cu",
             ext_ms["a"], ext_ms["a_plain"], None, sharded[(2, 1, 1)][1],
             max(ext_errs["a_ext"]),
             "K7 ext_mode (:1155-1160, 1290, 1348): psi on the block and "
             "sd - 1 cells beyond; 256^3 on mesh (2,1,1), both blocks"),
            ("l_ext", "laplacian_tile_kernel (ext)", "laplacian_psi.cu",
             ext_ms["l_graph"], ext_ms["l_plain"], None, a1_ext_launches[1],
             max(ext_errs["l_ext"]),
             "K7 ext_mode with K1c: the laplacian sd - 2 cells beyond the "
             "block; 256^3 on mesh (2,1,1), both blocks"),
            ("k_ext", "k_step_kernel (ext, coupled, clt4)", "fused_step.cu",
             ext_ms["k"], ext_ms["k_plain"], None, sharded[(2, 1, 1)][0],
             max(ext_errs["k_ext"]),
             "K7 ext_mode + shard origin in the seed (:1878-1880): K on the "
             "padded block, interior written at the pad offset; 256^3 on "
             "mesh (2,1,1), both blocks"),
            ("k_window", "k_step_kernel (ext window, coupled, clt4)",
             "fused_step.cu", k7_ms["window"], k7_ms["window_plain"], None,
             sweeps[((2, 2, 1), "split")][0]["window"],
             max(k7_errs["window"]),
             "K7 window (overlap split): win/odomain/owin/out_alias "
             "(:1167-1187, 1215-1218, 1886-1910), parallel/kernel.py:646-729;"
             " K on the interior window and the seam bands of the four "
             "blocks of 256^3 on mesh (2,2,1), a step"),
            ("k_ystrips", "k_step_kernel (ext ystrips, coupled, clt4)",
             "fused_step.cu", k7_ms["ystrips"], k7_ms["ystrips_plain"], None,
             sweeps[((2, 2, 1), "strips")][0]["ystrips"],
             max(k7_errs["ystrips"]),
             "K7 ystrips (:1233-1245, 1501-1530, 1913-1919), parallel/"
             "kernel.py:205-250, 575-605: K fed by the received y strips, "
             "writing its edge rows into the strips; the four blocks of "
             "256^3 on mesh (2,2,1), a step")):
        extra = k7_ms["strip_bytes"] if key == "k_ystrips" else 0
        bound, by = _bound_ms(key, _work_cells(key, cells), extra)
        record.append({
            "name": name, "route": "cuda", "source": SRC + src,
            "replaces": TPU_KERNEL, "mode": mode, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
        if key in ("l", "b_a1", "l_ext") or key in GRAPH_MODES:
            record[-1].update(
                eager_ms=(ext_ms["l"] if key == "l_ext" else
                          mode_ms[key][2] if key in GRAPH_MODES else
                          a1_ms[key]),
                note="ms replayed from a CUDA graph of 20 launches (the "
                     "device's time); eager_ms through the wrapper")
    for t in K4_BLOCKS:
        key = f"k4_{t}"
        bound, by = _bound_ms(key, cells)
        record.append({
            "name": f"blocked_kernel (K4, T = {t}, uncoupled, u8)",
            "route": "cuda", "source": SRC + "blocked_step.cu",
            "replaces": TPU_KERNEL,
            "mode": f"K4: block = {t} (:1142-1867, phases :1799-1823), "
                    "the intermediate phases in shared memory; 256^3",
            "launches": k4_sessions[(t, "u8")][1],
            "max_abs_err": max(k4_errs[t]), "ms": k4_ms["u8"][t],
            "plain_ms": k4_plain_ms[t], "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    for depth, t in K4F_CASES:
        key = f"k4_{depth}_{t}_clt4"
        bound, by = _bound_ms(key, cells)
        record.append({
            "name": f"blocked_kernel (K4, T = {t}, {depth}, clt4)",
            "route": "cuda", "source": SRC + "blocked_step.cu",
            "replaces": TPU_KERNEL,
            "mode": f"K4: block = {t} with the force (sd = "
                    f"{2 if depth == 'coupled' else 3}; phases :1790-1823, "
                    "density_ext, psi, gradient, laplacian :753-832 inside "
                    "every phase); 256^3 droplet",
            "launches": k4f_sessions[(depth, t)][1],
            "max_abs_err": max(k4f_errs[depth][t]),
            "ms": k4f_ms[depth]["clt4"][t],
            "plain_ms": k4f_plain_ms[(depth, t)], "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    for tag, mode, key, launches in (
            ("clt4", "coupled (sd = 2), clt4", "k4x_clt4",
             k4x_sessions[((2, 1, 1), "droplet", 2)][1]),
            ("off", "uncoupled (sd = 1), noise off", "k4x_off",
             k4x_sessions[((2, 1, 1), "mixture off", 2)][1])):
        bound, by = _bound_ms(key, cells)
        record.append({
            "name": f"blocked_kernel (K4 EXT, T = 2, {mode})",
            "route": "cuda", "source": SRC + "blocked_step.cu",
            "replaces": TPU_KERNEL,
            "mode": "K4 on halo-extended blocks: ext_mode at block = 2 "
                    "(:1142-1867, seed origin :1878-1880; parallel/"
                    "kernel.py:737-770), pads sd * T; 256^3 on mesh "
                    "(2,1,1), both blocks, a launch of 2 steps",
            "launches": launches, "max_abs_err": max(k4x_errs),
            "ms": k4x_ms[tag]["ext_k4"], "plain_ms": k4x_ms[tag]["plain_ms"],
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    for kind, sweep, what in (
            ("window", "split", "the overlap split (win/odomain/owin/"
             "out_alias at block = 2, parallel/kernel.py:466-481, 646-729):"
             " the interior window and the four seam bands of each block"),
            ("ystrips", "strips", "the y strips (ystrips at block = 2, "
             "parallel/kernel.py:205-250, 541-569): fed by the received "
             "strips sd T rows deep, writing its edge rows into strips")):
        bound, by = _bound_ms(f"k4_{kind}", cells,
                              k4s_ms["strip_bytes"] if kind == "ystrips"
                              else 0)
        record.append({
            "name": f"blocked_kernel (K4 EXT {kind}, T = 2, coupled (sd = "
                    f"2), clt4)",
            "route": "cuda", "source": SRC + "blocked_step.cu",
            "replaces": TPU_KERNEL,
            "mode": f"K4 in {what}; 256^3 on mesh (2,2,1), a sweep of 2 "
                    "steps on the four blocks",
            "launches": k4s_sessions[((2, 2, 1), "droplet", sweep)][1],
            "max_abs_err": max(k4s_errs + [k4s_ms[f"{kind}_err"]]),
            "ms": k4s_ms[kind],
            "plain_ms": k4s_ms[f"{kind}_plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    for rec in probe_recs:
        if rec["key"] is None:
            continue
        kind = rec["key"].split()[0]
        src, tpu = PROBE_KERNELS[kind]
        bound, by = _bound_ms(rec["key"], rec["cells"])
        row = {
            "name": f"probe {rec['key']}", "route": "cuda",
            "source": SRC + src, "replaces": tpu,
            "mode": f"platform probe ({rec['probe']}); 256^3"
                    if kind != "launch" else
                    "platform probe (launch), (8, 128); ms a launch replayed "
                    "from a CUDA graph of 400, eager_ms through the wrapper",
            "launches": probe_counts[rec["key"]],
            "max_abs_err": max(rec["max_abs_err"], probe_errs[rec["key"]]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": rec["library_ms"]}
        if kind == "copy":
            row["ms_by_chunk_x_stages"] = rec["ms_by_config"]
        if kind == "launch":
            row.update(eager_ms=rec["eager_ms"],
                       library_eager_ms=rec["library_eager_ms"],
                       note="bound by launch latency, not by its 8 KB or "
                            "its operations")
        record.append(row)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
