#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``bflbm_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

0. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; no CUDA device -> exit 1 with no result;
1. build the fused K-step CUDA kernel and print the build time and the
   ptxas register / spill counts;
2. hold the kernel against its plain PyTorch version on the card: one K
   on a perturbed state at 32^3 (kBT = 0 and 1e-5) and at 256^3, max
   |delta| <= 2e-5; time both at 256^3; a 32^3 session (enter + 4 + 5 K
   steps + exit) against the plain step chain with the same words;
3. the main path: a 256^3 uniform mixture at kBT = 1e-5 driven by
   FusedSession — enter, 11 x advance(100) (crossing the mass restore at
   step 1000), exit_view — with the launch count, finiteness and the
   total masses and the density equipartition checked, and the session
   rate in MLUPS.

The line before the last is a JSON object with the per-kernel record;
the last line is the status JSON.
"""

import json
import subprocess
import sys
import time

TOL = 2e-5            # f32 kernel vs plain torch: 1/x vs divide, FMA
MASS_RTOL = 1e-6
VAR_RTOL = 0.02       # 16.7M cells: sampling error ~1e-3
CS2 = 1.0 / 3.0
SMALL = (32, 32, 32)
SHAPE = (256, 256, 256)
KBT = 1e-5
CHUNK, NCHUNKS = 100, 11
BYTES_PER_CELL = 2 * 19 * 4 * 2   # read + write 19 f32 per species


def _maxdiff(a, b):
    return float((a - b).abs().max())


def _kernel_vs_plain(shape, params, word, step, device):
    """One K through the kernel and through k_step_reference; returns
    (max |delta|, kernel outputs, plain outputs, inputs)."""
    import torch

    from bflbm_tpu_torch.kernels import fused_step
    from bflbm_tpu_torch.models.binary_fluid import perturbed_populations

    f, g = perturbed_populations(shape, 7, device=device)
    before = fused_step.launches
    fo, go = fused_step.fused_stream_collide(f, g, word, step, params)
    torch.cuda.synchronize()
    if fused_step.launches != before + 1:
        raise AssertionError(f"launches went {before} -> "
                             f"{fused_step.launches}, expected +1")
    fr, gr = fused_step.k_step_reference(f, g, word, step, params)
    for t in (fo, go):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("kernel output not finite")
    err = max(_maxdiff(fo, fr), _maxdiff(go, gr))
    print(f"[phase 2] K at {shape} kBT={params.kBT}: max|kernel - plain| = "
          f"{err:.3e} (tol {TOL})", flush=True)
    if not err <= TOL:
        raise AssertionError(f"kernel disagrees with plain K: {err} > {TOL}")
    return err, (fo, go), (f, g)


def _session_vs_chain(device):
    """32^3 slice end to end: enter + advance(4) + advance(5) + exit with
    injected words against the plain model chain of 10 steps (no mass
    restore on either side)."""
    import torch

    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.state import init_state

    params = LBMParams(kBT=KBT)
    words = [int(w) for w in torch.randint(-2 ** 31, 2 ** 31 - 1, (10,),
                                           generator=torch.Generator()
                                           .manual_seed(3)).tolist()]
    f, g = model.perturbed_populations(SMALL, 11, device=device)
    ref = model.nsteps(init_state(f.clone(), g.clone(), 0), params, 10, words)
    sess = FusedSession(params, SMALL, mass_restore_int=0)
    pc = sess.enter(init_state(f, g, 0), words[0])
    pc = sess.advance(pc, 4, words[1:5])
    pc = sess.advance(pc, 5, words[5:])
    got = sess.exit(pc)
    torch.cuda.synchronize()
    err = max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g))
    print(f"[phase 2] 32^3 session (1+4+5 steps) vs plain chain: "
          f"max|delta| = {err:.3e}", flush=True)
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    from bflbm_tpu_torch.config import LBMParams
    from bflbm_tpu_torch.kernels import _build, fused_step
    from bflbm_tpu_torch.kernels.session import FusedSession
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.utils.timing import time_steps

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[phase 0] {smi}", flush=True)
    print(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # plain float32 contractions must not run in TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.load(dev)
    print(f"[phase 1] kernel built and loaded in "
          f"{time.perf_counter() - t0:.2f} s: {_build.library_path()}",
          flush=True)
    for ln in _build.ptxas_summary():
        print(f"[phase 1] ptxas: {ln}", flush=True)

    # -- phase 2: kernel vs plain --------------------------------------------
    errs = []
    for kbt in (0.0, KBT):
        err, _, _ = _kernel_vs_plain(SMALL, LBMParams(kBT=kbt),
                                     -123456789, 5, dev)
        errs.append(err)
    params = LBMParams(kBT=KBT)
    err, (fo, go), (f, g) = _kernel_vs_plain(SHAPE, params, 987654321,
                                             1234, dev)
    errs.append(err)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]

    # kernel, plain K and copy times: best of 3 runs between synchronize
    # barriers (the kernel ping-pongs two pairs over 20 launches a run)
    nrep = 20
    bufs = [(f, g), (fo, go)]

    def kernel_run():
        for i in range(nrep):
            fused_step.fused_stream_collide(*bufs[i % 2], 1, i, params,
                                            out=bufs[(i + 1) % 2])

    kernel_ms = time_steps(kernel_run, cells, nrep)["best_s"] / nrep * 1e3
    plain_ms = time_steps(
        lambda: fused_step.k_step_reference(f, g, 1, 0, params),
        cells, 1)["best_s"] * 1e3
    # device copy rate of one population array (read + write)
    dst = torch.empty_like(f)
    copy_s = time_steps(lambda: [dst.copy_(f) for _ in range(10)],
                        cells, 10)["best_s"]
    copy_gbs = 2 * f.numel() * 4 * 10 / copy_s / 1e9
    kernel_gbs = BYTES_PER_CELL * cells / (kernel_ms * 1e-3) / 1e9
    print(f"[phase 2] K at 256^3: kernel {kernel_ms:.4f} ms "
          f"({cells / kernel_ms / 1e3:.1f} MLUPS, {kernel_gbs:.1f} GB/s at "
          f"{BYTES_PER_CELL} B/cell), plain torch {plain_ms:.2f} ms; "
          f"torch copy {copy_gbs:.1f} GB/s", flush=True)
    del f, g, fo, go, bufs, dst
    errs.append(_session_vs_chain(dev))
    if not max(errs) <= TOL:
        raise AssertionError(f"session disagrees with plain chain: {errs}")
    torch.cuda.empty_cache()

    # -- phase 3: the main path ---------------------------------------------
    state = model.init_mixture(SHAPE, params, device=dev)
    m0f = float(state.f.sum(dtype=torch.float64))
    m0g = float(state.g.sum(dtype=torch.float64))
    sess = FusedSession(params, SHAPE)
    torch.cuda.synchronize()
    fused_step.launches = 0
    t0 = time.perf_counter()
    pc = sess.enter(state)
    torch.cuda.synchronize()
    t_enter = time.perf_counter() - t0
    del state

    def rel_mass(s):
        return (abs(float(s.f.sum(dtype=torch.float64)) - m0f) / m0f,
                abs(float(s.g.sum(dtype=torch.float64)) - m0g) / m0g)

    t_adv = 0.0
    for _ in range(NCHUNKS):
        t0 = time.perf_counter()
        pc = sess.advance(pc, CHUNK)
        torch.cuda.synchronize()
        t_adv += time.perf_counter() - t0
        if pc.step == 901:
            before_restore = rel_mass(pc)
        elif pc.step == 1001:
            after_restore = rel_mass(pc)
    view = sess.exit_view(pc)
    torch.cuda.synchronize()
    launches = fused_step.launches
    n_k = CHUNK * NCHUNKS
    print(f"[phase 3] step {view.step}, launches {launches} "
          f"(expected {n_k})", flush=True)
    if launches != n_k:
        raise AssertionError(f"launches {launches} != {n_k}")
    if view.step != 1 + n_k or tuple(view.f.shape) != (19,) + SHAPE:
        raise AssertionError(f"bad result: step {view.step}, "
                             f"shape {tuple(view.f.shape)}")
    for t in (view.f, view.g):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("main path produced non-finite values")
    final = rel_mass(view)
    print(f"[phase 3] relative mass defect (f, g): step 901 "
          f"{before_restore[0]:.3e} {before_restore[1]:.3e}; after the "
          f"restore at step 1000 (step 1001) {after_restore[0]:.3e} "
          f"{after_restore[1]:.3e}; step {view.step} {final[0]:.3e} "
          f"{final[1]:.3e} (tol {MASS_RTOL} after the restore)", flush=True)
    if not max(after_restore + final) <= MASS_RTOL:
        raise AssertionError("mass not conserved to the tolerance")
    # equation-of-state equipartition: the equal-time density structure
    # factor of the ideal mixture is flat, var(rho_t) = rho_t kBT / cs^2
    rho_t = view.f.sum(0) + view.g.sum(0)
    var_ratio = float(rho_t.var()) / (float(rho_t.mean()) * KBT / CS2)
    print(f"[phase 3] total density mean {float(rho_t.mean()):.7f}, "
          f"var / (rho kBT / cs^2) = {var_ratio:.4f} "
          f"(tol {VAR_RTOL})", flush=True)
    if not abs(var_ratio - 1.0) <= VAR_RTOL:
        raise AssertionError(f"density fluctuations off equipartition: "
                             f"{var_ratio}")
    mlups = cells * n_k / t_adv / 1e6
    print(f"[phase 3] enter {t_enter * 1e3:.1f} ms; "
          f"session: {n_k} K steps at 256^3 in {t_adv:.3f} s = "
          f"{mlups:.1f} MLUPS (plain-torch K: {plain_ms:.2f} ms/step = "
          f"{cells / plain_ms / 1e3:.1f} MLUPS)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_stream_collide",
        "route": "cuda",
        "source": "bflbm_tpu_torch/kernels/csrc/fused_step.cu",
        "replaces": "bflbm_tpu/kernels/fused_step.py:1956",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
