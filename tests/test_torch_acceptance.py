"""The port's acceptance phases (``python -m bflbm_tpu_torch.acceptance``)
against the JAX package's scripts (``benchmarks/acceptance.py`` and
``benchmarks/acceptance_c2.py``, imported by path), on the CPU.

Both packages' ``run`` are replaced by one stub that writes the same
artifacts, made from a numpy seed keyed by the run's directory name and
seed, at small shapes: frames (npz, float64, through the port's writer,
which both packages read), the ``on_frame`` calls (a numpy array for
JAX, a tensor for the port), ``structfact*.npz``, checkpoints, and a
returned state with ``f`` and ``g``.  ``multiprocessing.Pool`` becomes a
serial map.  Each phase's JSON is compared key by key, wall seconds
excluded: within 1e-9 relative, 1e-6 for numbers that come out of a fit
(scipy's curve_fit, np.polyfit) and 1e-5 for phase e, whose per-frame
rows are float32 sums (XLA's order against torch's).

Then the port's phases run for real on the CPU at cut steps (a, d,
massdrift at 16^3 with the restore every 10 steps).
"""

import importlib.util
import json
import math
import multiprocessing
import os
import runpy
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from bflbm_tpu_torch import acceptance
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.io import fields as fields_io
from bflbm_tpu_torch.observables import structfact as sf_lib
from bflbm_tpu_torch.ops.hydro import HYDRO_NAMES

ROOT = Path(__file__).resolve().parents[1]
RTOL, FIT_RTOL, E_RTOL = 1e-9, 1e-6, 1e-5
# keys whose numbers come out of a fit (and what is computed from them)
FITTED = {"R_over_L", "R_over_L_binned", "gamma_laplace_slope_lat",
          "laplace_intercept", "slope_ref_convention", "slope_rel_dev",
          "radius_max_rel_dev", "slope", "intercept", "gamma_quoted",
          "R_over_L_refinit", "R_rel_dev", "dp_rel_dev", "ray_sq", "mc_sq"}
DROPLET = (20, 20, 20)       # the droplet phases' stub shape
INTERFACE = (6, 32, 12)      # the flat interface's (x slice 4, 16 k > 0)
MIXTURE = (10, 8, 6)         # the structure factors'
INTERFACE_FRAMES = 12        # frames a stub interface run writes at most


def _load_jax_script(name):
    path = ROOT / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jacc():
    return _load_jax_script("acceptance")


# -- the stub run ----------------------------------------------------------

def _rng(cfg):
    key = zlib.crc32(os.path.basename(cfg.out_dir).encode()) ^ int(cfg.seed)
    return np.random.default_rng(key)


def _droplet_rho(shape, radius, com, lo, hi, rng, aniso=(1.0, 1.0, 1.0),
                 width=1.2, noise=1e-3):
    """A tanh droplet (float64) of `radius` cells about `com` (box-centre
    coordinates, minimum image), stretched by `aniso`, with noise."""
    c = [np.arange(n) - n / 2.0 + 0.5 for n in shape]
    d = [((x - x0 + n / 2) % n - n / 2) / a
         for x, x0, n, a in zip(c, com, shape, aniso)]
    r = np.sqrt(d[0][:, None, None] ** 2 + d[1][None, :, None] ** 2
                + d[2][None, None, :] ** 2)
    rho = lo + 0.5 * (hi - lo) * (1 + np.tanh((radius - r) / width))
    return rho + noise * rng.normal(size=shape)


def _stripe_rho(shape, rng):
    """A flat stripe between z = 3 and a rough upper interface near
    z = 8.5 (rho_lo 0.1, rho_hi 3)."""
    y = np.arange(shape[1])
    h = (8.5 + 0.03 * np.sin(2 * np.pi * (y / shape[1] + rng.uniform())))
    h = h[None, :] + 0.02 * rng.normal(size=shape[:2])
    z = np.arange(shape[2])[None, None, :]
    return 0.1 + 1.45 * (np.tanh(z - 3.0) - np.tanh(z - h[..., None]))


class _Stub:
    """What the phases see of a run: frames at plot_int (written when
    plot_save, passed to on_frame), structure factors, the end-of-run
    checkpoint, the final state.  The fields depend on the kind of run
    (from the config) and on a numpy generator keyed by its directory
    name and seed only, so the two packages get the same artifacts."""

    def __init__(self, dtype_e=np.float32):
        self.calls = []
        self.dtype_e = dtype_e

    def _kind(self, cfg):
        p = cfg.params
        if p.alpha0 == 0.0:
            return "mixture"
        if tuple(cfg.shape[1:]) == (256, 64):
            return "interface"
        if p.alpha0 == 4.0:
            return "msd"
        return "droplet"

    def fields(self, cfg, kind, rng, state):
        """(rho, phi) float64 of the next frame; `state` carries a
        random walk between frames."""
        p = cfg.params
        if kind == "interface":
            rho = _stripe_rho(INTERFACE, rng)
            return rho, 3.1 - rho
        if kind == "mixture":
            rho = 1.0 + 1e-3 * rng.normal(size=MIXTURE)
            return rho, 2.0 - rho
        if kind == "msd":
            state["com"] = state.get("com", np.zeros(3)) \
                + 0.15 * rng.normal(size=3)
            n = cfg.shape
            rho = _droplet_rho(n, cfg.init_radius * n[0], state["com"], 0.001,
                               1.0, rng, width=0.8, noise=1e-4)
            return rho, 1.001 - rho
        radius = cfg.init_radius * DROPLET[0]
        aniso = (1.0, 1.0, 1.0)
        if p.kBT > 0:       # a fluctuating droplet: shape and COM noise
            e = 0.02 * rng.normal(size=2)
            aniso = (1 + e[0], 1 + e[1], 1 / ((1 + e[0]) * (1 + e[1])))
        com = 0.2 * rng.normal(size=3) if p.kBT > 0 else (0.1, -0.05, 0.02)
        rho = _droplet_rho(DROPLET, radius, com, p.rho_lo + 0.02, p.rho_hi,
                           rng, aniso)
        return rho, p.rho_lo + p.rho_hi - rho

    def packed(self, rho, phi, rng, dtype):
        out = 1e-4 * rng.normal(size=(len(HYDRO_NAMES),) + rho.shape)
        out[0], out[1] = rho, phi
        return out.astype(dtype)

    def __call__(self, cfg, on_frame, wrap):
        self.calls.append(os.path.basename(cfg.out_dir))
        rng = _rng(cfg)
        kind = self._kind(cfg)
        dtype = self.dtype_e if kind == "msd" else np.float64
        os.makedirs(cfg.out_dir, exist_ok=True)
        first, last = cfg.step_continue, cfg.step_continue + cfg.nsteps
        walk = {}
        if cfg.plot_int > 0:
            steps = list(range(first + cfg.plot_int, last + 1, cfg.plot_int))
            if first == 0:
                steps = [0] + steps
            if kind == "interface":
                steps = steps[:INTERFACE_FRAMES]
            for s in steps:
                packed = self.packed(*self.fields(cfg, kind, rng, walk), rng,
                                     dtype)
                if cfg.plot_save:
                    fields_io.write_frame(cfg.out_dir, s, packed, fmt="npz")
                if on_frame is not None:
                    on_frame(s, wrap(packed))
        if kind == "mixture" and cfg.params.kBT > 0 and cfg.sf_window:
            names = sf_lib.pair_names()
            norm = [acceptance.SK_NORM.get(n, 1e-5) for n in names]
            s_k = np.asarray(norm)[:, None, None, None] * (
                1 + 0.02 * rng.normal(size=(len(names),) + MIXTURE)
                + 0.01j * rng.normal(size=(len(names),) + MIXTURE))
            np.savez(os.path.join(cfg.out_dir, f"structfact{last:07d}.npz"),
                     s_k=np.fft.fftshift(s_k, axes=(-3, -2, -1)),
                     pairs=np.asarray(sf_lib.REFERENCE_PAIRS),
                     names=np.asarray(names))
        rho, phi = self.fields(cfg, kind, rng, walk)
        w = np.full((19, 1, 1, 1), 1.0 / 19) * (
            1 + 1e-3 * rng.normal(size=(19,) + rho.shape))
        f, g = w * rho / w.sum(axis=0), w[::-1] * phi / w.sum(axis=0)
        np.savez(os.path.join(cfg.out_dir, f"checkpoint{last:07d}.npz"),
                 f=f, g=g, step=np.asarray(last))
        return types.SimpleNamespace(f=wrap(f), g=wrap(g), step=last)


class _SerialPool:
    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, it, chunksize=None):
        return [fn(x) for x in it]


@pytest.fixture
def stubs(monkeypatch):
    """Both packages' run replaced by one stub; returns it."""
    import bflbm_tpu.run as jrun

    stub = _Stub()

    def jax_run(cfg, *, mesh=None, engine="auto", on_frame=None,
                kernel_opts=None):
        return stub(cfg, on_frame, np.asarray)

    def torch_run(cfg, *, device="cuda", on_frame=None, **kw):
        assert torch.device(device).type == "cpu"
        return stub(cfg, on_frame, torch.as_tensor)

    monkeypatch.setattr(jrun, "run", jax_run)
    monkeypatch.setattr(trun, "run", torch_run)
    monkeypatch.setattr(multiprocessing, "Pool", _SerialPool)
    return stub


def _agree(port, jax, rtol, key=""):
    """The port's JSON against JAX's, key by key (wall seconds and the
    out directory excluded); returns the largest relative difference."""
    if isinstance(jax, dict):
        keys = set(jax) - {"wall_s", "out"}
        assert keys == set(port) - {"wall_s", "out"}, (key, set(jax),
                                                       set(port))
        return max([_agree(port[k], jax[k], rtol, k) for k in keys],
                   default=0.0)
    if isinstance(jax, (list, tuple)):
        assert len(port) == len(jax), key
        return max([_agree(a, b, rtol, key) for a, b in zip(port, jax)],
                   default=0.0)
    if isinstance(jax, bool) or jax is None or isinstance(jax, str):
        assert port == jax, (key, port, jax)
        return 0.0
    if math.isnan(jax):
        assert math.isnan(port), (key, port)
        return 0.0
    tol = max(rtol, FIT_RTOL) if key in FITTED else rtol
    rel = abs(port - jax) / abs(jax) if jax else abs(port)
    assert rel <= tol, (key, port, jax, rel)
    return rel


@pytest.fixture
def both(jacc, stubs, tmp_path, monkeypatch, capsys):
    """phase, argv -> the phase through the JAX script's main (its own
    --out) and through the port's (--device cpu), the two JSONs compared
    (`rtol`); returns the port's."""
    def run(phase, argv, rtol=RTOL):
        monkeypatch.setattr("sys.argv", ["acceptance.py", phase, "--out",
                                         str(tmp_path / "jax")] + argv)
        jacc.main()
        jax_res = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        port = acceptance.main([phase, "--out", str(tmp_path / "port"),
                                "--device", "cpu"] + argv)
        _agree(port, jax_res, rtol)
        return port

    return run


def test_jax_script_flags_are_the_ports(jacc):
    """The port's CLI keeps every flag and default of the JAX script's
    (its parser read from its source) and its phases, plus c2 and
    massdrift."""
    src = (ROOT / "benchmarks" / "acceptance.py").read_text()
    args = acceptance.parse_args(["d"])
    for flag, default in (("--steps", None), ("--n-runs", 8),
                          ("--alpha0", 1.7), ("--seed-base", 20_000),
                          ("--size", 32), ("--out", "out/acceptance"),
                          ("--noise-dist", None)):
        assert f'"{flag}"' in src
        assert getattr(args, flag[2:].replace("-", "_")) == default
    phases = src.split('choices=[')[1].split(']')[0]
    jphases = {p.strip().strip('"') for p in phases.split(",")}
    assert jphases | {"c2", "massdrift"} == set(acceptance.PHASES)
    assert args.device == "cuda"


def test_cli_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        acceptance.main(["a", "--out", str(tmp_path)])


@pytest.mark.parametrize("phase, argv", [
    ("a", []),
    ("b", ["--steps", "2000"]),
    ("b-kernel", ["--steps", "2000", "--noise-dist", "u8"]),
    ("b-kernel", ["--steps", "2000", "--noise-dist", "clt2",
                  "--seed-base", "5"]),
    ("c", ["--steps", "4000"]),
    ("c-ens", ["--steps", "4000", "--n-runs", "2"]),
])
def test_phase_matches_jax(both, tmp_path, phase, argv):
    res = both(phase, argv)
    assert res["phase"][0].upper() == phase[0].upper()
    if phase in ("c", "c-ens"):
        out = {"c": "interface-fluct", "c-ens": "interface-ens-20000-1"}
        d = tmp_path / "port" / out[phase]
        if phase == "c-ens":
            for name in ("spectrum.npy", "hk_series.npy"):
                np.testing.assert_allclose(
                    np.load(d / name),
                    np.load(tmp_path / "jax" / out[phase] / name),
                    rtol=RTOL, atol=1e-12)


def test_phase_d_matches_jax(both):
    res = both("d", ["--steps", "100"])
    assert [r["init_r"] for r in res["runs"]] == acceptance.D_RADII
    # the stub's droplets have the radii they were made with
    for r in res["runs"]:
        assert abs(r["R_over_L"] - r["init_r"]) < 0.02


@pytest.mark.parametrize("alpha0", [2.0, 0.8])
def test_phase_d_sweep_matches_jax(both, alpha0):
    res = both("d-sweep", ["--steps", "100", "--alpha0", str(alpha0)])
    assert (res["width_check"] is None) == (alpha0 != 2.0)


def test_phase_e_matches_jax(both, tmp_path):
    """The float32 frame reduction (XLA's sums against torch's): 1e-5;
    150 frames of a 16^3 droplet on a random walk, two runs."""
    res = both("e", ["--steps", "15000", "--size", "16", "--n-runs", "2"],
               rtol=E_RTOL)
    assert res["n_runs"] == 2 and len(res["runs"]) == 2
    rows = [np.load(tmp_path / pkg / "droplet-msd-fluct16-1" /
                    "msd_rows.npy") for pkg in ("port", "jax")]
    assert rows[0].shape == rows[1].shape == (149, 5)
    np.testing.assert_allclose(rows[0], rows[1], rtol=E_RTOL,
                               atol=E_RTOL * 16)


def test_phase_f_and_f_static_match_jax(both, tmp_path):
    """f on 20^3 frames (both surface extractors), then f-static on each
    package's own artifacts."""
    both("f", ["--steps", "3000"])
    for pkg in ("port", "jax"):
        assert (tmp_path / pkg / "droplet-shapefluct" /
                "shapefluct.npz").exists()
    both("f-static", [])


def test_phase_c2_matches_jax(jacc, stubs, tmp_path, monkeypatch, capsys):
    """acceptance_c2.py reads out/acceptance2/interface-fluct under the
    working directory; the port reads --out's interface-fluct."""
    from bflbm_tpu_torch.config import preset

    jroot, proot = tmp_path / "jax", tmp_path / "port"
    for root in (jroot / "out" / "acceptance2", proot):
        cfg = preset("interface-fluct").replace(
            nsteps=2000, plot_int=0, out_dir=str(root / "interface-fluct"))
        stubs(cfg, None, np.asarray)
    monkeypatch.chdir(jroot)
    runpy.run_path(str(ROOT / "benchmarks" / "acceptance_c2.py"))
    jax_res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = acceptance.main(["c2", "--out", str(proot), "--device", "cpu"])
    _agree(port, jax_res, RTOL)
    assert port["from_step"] == 5000 and port["n_frames"] == INTERFACE_FRAMES


# -- the port's phases for real, on the CPU ------------------------------

def test_phase_a_runs_on_the_cpu(tmp_path):
    res = acceptance.main(["a", "--steps", "20", "--out", str(tmp_path),
                           "--device", "cpu"])
    assert res == {"phase": "A", "final_step": 20,
                   "out": f"{tmp_path}/mixture-eq"}
    assert (tmp_path / "mixture-eq" / "checkpoint0000020.npz").exists()


def test_phase_d_runs_on_the_cpu(tmp_path):
    """Five 32^3 droplets, 20 steps each: the fits find radii near the
    initial ones (the droplets have barely moved)."""
    res = acceptance.main(["d", "--steps", "20", "--out", str(tmp_path),
                           "--device", "cpu"])
    for r in res["runs"]:
        assert abs(r["R_over_L"] - r["init_r"]) < 0.02 * r["init_r"] + 0.01
        assert math.isfinite(r["delta_p"])
    assert math.isfinite(res["gamma_laplace_slope_lat"])


def test_massdrift_restores_the_mass_on_the_cpu(tmp_path):
    """The u8 mixture at 16^3, 50 steps, the restore every 10: the mass
    read at the end (after the restore at step 50) within 1e-6 of the
    start; the unrestored run's reading is written beside it."""
    res = acceptance.main(["massdrift", "--steps", "50", "--shape", "16",
                           "16", "16", "--mass-restore-int", "10", "--out",
                           str(tmp_path), "--device", "cpu"])
    on, off = res["restore_on"], res["restore_off"]
    assert len(on["rel_mass_series_per_10k"]) == 1
    assert abs(on["end_rel_drift"]) <= 1e-6
    assert math.isfinite(off["end_rel_drift"])
    assert on["mlups"] > 0 and off["mlups"] > 0
    with open(tmp_path / "massdrift.json") as fh:
        assert json.load(fh)["restore_on"] == on
