"""The port's run driver (``bflbm_tpu_torch.run``) against the JAX
package's (``bflbm_tpu.run``), and its own invariances, on the CPU.

- ``run(cfg, device="cpu")`` against JAX's ``run(cfg, engine="jnp")``:
  droplet-eq at 16^3, kBT = 0, 12 steps.  End checkpoints atol 2e-5 (f32
  on both sides, different summation order, as the session tests); frame
  densities atol 2e-5, velocities and forces rtol 1e-4 with atol 2e-5
  where both densities exceed 0.05 (they divide by a density, and with
  rho_lo = 0 a density of 1e-7 turns the populations' rounding into
  velocity differences of 1%); the equilibrium artifact atol 2e-5;
  metrics and droplet records rtol 1e-5.
- Cadence and restart invariance, noise on: bitwise (one word per
  physical step, views only peek).
- S(k): ``accumulate``/``finalize`` against JAX's on the same frames,
  rtol 1e-5 with atol 1e-5 of the largest entry (FFT against a matmul
  DFT, both f32).
- The CLIs: the same argv gives the same RunConfig and run options.
- Artifacts written by the JAX package load in the port and back.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturbed_pops, to_np

from bflbm_tpu import config as jconfig
from bflbm_tpu import run as jrun
from bflbm_tpu.io import checkpoint as jckpt
from bflbm_tpu.observables import structfact as jsf
from bflbm_tpu.parallel import mesh as jmesh_lib
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch import config as tconfig
from bflbm_tpu_torch import interop
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.io import checkpoint as tckpt
from bflbm_tpu_torch.io import fields as tfields
from bflbm_tpu_torch.observables import structfact as tsf
from bflbm_tpu_torch.parallel import mesh as tmesh_lib
from bflbm_tpu_torch.state import draw_words, init_state, make_generator

ATOL = 2e-5


def _read_metrics(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


def _eq_cfg(preset_mod, out):
    return preset_mod.preset("droplet-eq").replace(
        shape=(16, 16, 16), nsteps=12, plot_int=4, print_int=4,
        droplet_int=4, t_window=8, out_dir=str(out))


@pytest.fixture(scope="module")
def eq_runs(tmp_path_factory):
    """The same droplet-eq run through both drivers."""
    root = tmp_path_factory.mktemp("eq")
    jrun.run(_eq_cfg(jconfig, root / "jax"), engine="jnp")
    final = trun.run(_eq_cfg(tconfig, root / "port"), device="cpu")
    return root / "jax", root / "port", final


def test_run_matches_jax_checkpoint(eq_runs):
    jdir, tdir, final = eq_runs
    assert final.step == 12
    with np.load(jdir / "checkpoint0000012.npz") as j, \
            np.load(tdir / "checkpoint0000012.npz") as t:
        assert int(t["step"]) == int(j["step"]) == 12
        for k in ("f", "g"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(t["f"], to_np(final.f))
    meta = json.loads((tdir / "checkpoint0000012.json").read_text())
    assert meta["step"] == 12 and meta["shape"] == [16, 16, 16]
    assert interop.run_config_from_dict(meta["config"]) == _eq_cfg(
        tconfig, tdir)


def test_run_matches_jax_frames(eq_runs):
    jdir, tdir, _ = eq_runs
    names = sorted(p.name for p in jdir.glob("plt*.npz"))
    assert names == sorted(p.name for p in tdir.glob("plt*.npz"))
    assert names == [f"plt{s:07d}.npz" for s in (0, 4, 8, 12)]
    for name in names:
        j = tfields.read_frame(str(jdir / name))
        t = tfields.read_frame(str(tdir / name))
        assert sorted(j) == sorted(t)
        assert int(t["step"]) == int(j["step"])
        # velocities and forces divide by a density: compare them where
        # both species are present (the interface), densities everywhere
        both = (j["rho"] > 0.05) & (j["phi"] > 0.05)
        assert both.sum() > 100
        for k in j:
            if k == "step":
                continue
            dense = k in ("rho", "phi", "p_bulk")
            np.testing.assert_allclose(
                t[k] if dense else t[k][both], j[k] if dense else j[k][both],
                rtol=1e-4, atol=ATOL, err_msg=f"{name}:{k}")


def test_run_matches_jax_equilibrium(eq_runs):
    jdir, tdir, _ = eq_runs
    for a, b in zip(tckpt.load_equilibrium(str(tdir / "equilibrium")),
                    jckpt.load_equilibrium(str(jdir / "equilibrium"))):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    jc = json.loads((jdir / "convergence.json").read_text())
    tc = json.loads((tdir / "convergence.json").read_text())
    assert sorted(jc) == sorted(tc) and tc["window_frames"] == 3
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-3, atol=1e-7)


def test_run_matches_jax_metrics(eq_runs):
    jdir, tdir, _ = eq_runs
    jm = _read_metrics(jdir / "metrics.jsonl")
    tm = _read_metrics(tdir / "metrics.jsonl")
    assert [r["step"] for r in tm] == [r["step"] for r in jm]
    assert [sorted(r) for r in tm] == [sorted(r) for r in jm]
    drops = 0
    for j, t in zip(jm, tm):
        for k in j:
            if k.startswith("droplet_") or k in ("mean", "max", "min"):
                np.testing.assert_allclose(t[k], j[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        drops += "droplet_R_mass" in t
        if "mass_f" in t:
            # the port sums in float64, JAX in float32 (1e-4 off at 16^3):
            # hold the port to the float64 sum of JAX's density frame
            fr = tfields.read_frame(str(jdir / f"plt{t['step']:07d}.npz"))
            for k, n in (("mass_f", "rho"), ("mass_g", "phi")):
                np.testing.assert_allclose(
                    t[k], fr[n].sum(dtype=np.float64), rtol=1e-6)
                np.testing.assert_allclose(t[k], j[k], rtol=1e-3)
    assert drops == 3


def _noisy_cfg(out, **kw):
    base = dict(shape=(8, 8, 8), nsteps=9, plot_int=0, print_int=0,
                droplet_int=0, t_window=0, out_dir=str(out))
    return tconfig.preset("droplet-eq").replace(
        **dict(base, **kw)).with_params(kBT=1e-5)


def test_run_cadence_invariance(tmp_path):
    """Views peek the next word without drawing it: observing every 3
    steps leaves the trajectory bitwise unchanged."""
    a = trun.run(_noisy_cfg(tmp_path / "a"), device="cpu")
    b = trun.run(_noisy_cfg(tmp_path / "b", plot_int=3, print_int=3),
                 device="cpu")
    assert a.step == b.step == 9
    assert len(list((tmp_path / "b").glob("plt*.npz"))) == 4
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    assert draw_words(a.gen, 3) == draw_words(b.gen, 3)


def test_run_restart_invariance(tmp_path):
    """10 steps == 5 steps, then 5 more from the port checkpoint: the
    checkpoint carries the generator."""
    whole = trun.run(_noisy_cfg(tmp_path / "w", nsteps=10), device="cpu")
    trun.run(_noisy_cfg(tmp_path / "h1", nsteps=5), device="cpu")
    resumed = trun.run(_noisy_cfg(
        tmp_path / "h2", nsteps=5, step_continue=5, init="checkpoint",
        checkpoint_path=str(tmp_path / "h1" / "checkpoint0000005")),
        device="cpu")
    assert whole.step == resumed.step == 10
    assert torch.equal(whole.f, resumed.f) and torch.equal(whole.g,
                                                           resumed.g)
    # the noise matters: a reseeded restart ends elsewhere
    other = trun.run(_noisy_cfg(
        tmp_path / "h3", nsteps=5, step_continue=5, init="checkpoint",
        reseed=True, checkpoint_path=str(tmp_path / "h1" /
                                         "checkpoint0000005")),
        device="cpu")
    assert float((other.f - whole.f).abs().max()) > 1e-6


def test_run_noise_dump_and_structfact(tmp_path):
    """out_noise_int dumps the draw the re-entry step consumes; S(k)
    accumulates over the trailing window; the dumps and a re-entry at
    every dump leave the trajectory bitwise that of an unobserved run."""
    base = _noisy_cfg(tmp_path / "a", nsteps=8)
    a = trun.run(base, device="cpu")
    b = trun.run(base.replace(out_dir=str(tmp_path / "b"), out_noise_int=4,
                              sf_window=4, sf_every=2), device="cpu")
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    with np.load(tmp_path / "b" / "noise0000004.npz") as d:
        assert d["xi_f"].shape == (19, 8, 8, 8) and np.abs(
            d["xi_f"]).max() > 0
    with np.load(tmp_path / "b" / "structfact0000008.npz") as d:
        assert d["s_k"].shape == (len(tsf.REFERENCE_PAIRS), 8, 8, 8)
        assert list(d["names"]) == list(jsf.pair_names())


def test_structfact_matches_jax():
    rng = np.random.default_rng(81)
    shape = (8, 6, 10)
    frames = rng.standard_normal((3, 22) + shape).astype(np.float32)
    js = jsf.init_structfact(len(jsf.REFERENCE_PAIRS), shape)
    ts = tsf.init_structfact(len(tsf.REFERENCE_PAIRS), shape, device="cpu")
    for fr in frames:
        js = jsf.accumulate(js, jnp.asarray(fr))
        ts = tsf.accumulate(ts, torch.from_numpy(fr))
    assert ts.count == int(js.count) == 3
    assert tsf.REFERENCE_PAIRS == jsf.REFERENCE_PAIRS
    assert tsf.pair_names() == jsf.pair_names()
    for kw in (dict(), dict(zero_avg=False, shift=False)):
        want = jsf.finalize(js, **kw)
        got = tsf.finalize(ts, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


_ARGVS = [
    [],
    ["--preset", "droplet-fluct", "--out", "o", "--nsteps", "7",
     "--shape", "8", "8", "16", "--kBT", "2e-5", "--alpha0", "1.2",
     "--seed", "3", "--plot-int", "2", "--print-int", "5", "--plot-fmt",
     "npz", "--sf-window", "4", "--sf-every", "2", "--out-noise-int", "6",
     "--init-width", "1.5", "--radius", "0.3", "--rho-lo", "0.1",
     "--rho-hi", "2.5", "--kappa", "0.2", "--tau-f", "0.7", "--tau-g",
     "0.6", "--ref-state", "eq.npz", "--checkpoint", "ck", "--noise-dist",
     "clt2", "--mass-restore-int", "50"],
    ["--preset", "droplet-eq", "--plot-fmt", "native"],
    ["--preset", "interface-eq", "--plot-fmt", "amrex"],
    ["--preset", "droplet-eq", "--mesh", "2", "1", "1"],
    ["--preset", "mixture-fluct", "--block", "2", "--noise-dist", "u8"],
    ["--preset", "droplet-fluct", "--block", "2"],
    ["--preset", "interface-fluct", "--engine", "jnp"],
    ["--preset", "interface-fluct", "--noise-source", "hash",
     "--noise-dist", "u8"],
]


@pytest.mark.parametrize("argv", _ARGVS)
def test_cli_matches_jax(monkeypatch, capsys, argv):
    """Both CLIs parse argv to the same RunConfig, options, engine and
    mesh shape (each package's make_mesh is replaced by one that records
    the shape: JAX's wants that many devices, the port's a card)."""
    seen = {}

    def fake_jax(cfg, **kw):
        seen["jax"] = (cfg, dict(kw.get("kernel_opts") or {},
                                 engine=kw.get("engine")), kw.get("mesh"))
        return types.SimpleNamespace(step=np.int32(cfg.step_continue))

    def fake_port(cfg, **kw):
        seen["port"] = (cfg, kw, kw.pop("mesh", None))
        return types.SimpleNamespace(step=cfg.step_continue)

    monkeypatch.setattr(jrun, "run", fake_jax)
    monkeypatch.setattr(trun, "run", fake_port)
    monkeypatch.setattr(jmesh_lib, "make_mesh", lambda shape: tuple(shape))
    monkeypatch.setattr(tmesh_lib, "make_mesh", lambda shape: tuple(shape))
    jrun.main(argv)
    jline = capsys.readouterr().out
    trun.main(argv)
    assert capsys.readouterr().out == jline
    jcfg, jopts, jmesh = seen["jax"]
    tcfg, topts, tmesh = seen["port"]
    assert tcfg == interop.run_config_from_dict(dataclasses.asdict(jcfg))
    assert topts == jopts
    assert tmesh == jmesh


def test_artifacts_cross_packages(tmp_path):
    rng = np.random.default_rng(82)
    rho, phi, rt = (rng.random((4, 5, 6)).astype(np.float32)
                    for _ in range(3))
    jckpt.save_equilibrium(str(tmp_path / "jeq"), rho, phi, rt)
    for a, b in zip(tckpt.load_equilibrium(str(tmp_path / "jeq.npz")),
                    (rho, phi, rt)):
        np.testing.assert_array_equal(a, b)
    tckpt.save_equilibrium(str(tmp_path / "teq"), rho, phi, rt)
    for a, b in zip(jckpt.load_equilibrium(str(tmp_path / "teq")),
                    (rho, phi, rt)):
        np.testing.assert_array_equal(np.asarray(a), b)

    f, g = perturbed_pops((4, 4, 6), 83)
    key = jax.random.PRNGKey(17)
    jckpt.save_state(str(tmp_path / "jck"),
                     jinit(jnp.asarray(f), jnp.asarray(g), 17, step=21))
    st = tckpt.load_state(str(tmp_path / "jck"), device="cpu")
    assert st.step == 21
    np.testing.assert_array_equal(to_np(st.f), f)
    np.testing.assert_array_equal(to_np(st.g), g)
    want = make_generator(interop.seed_from_key(np.asarray(key)))
    assert draw_words(st.gen, 3) == draw_words(want, 3)


def test_port_checkpoint_continues_the_generator(tmp_path):
    f, g = (torch.from_numpy(a) for a in perturbed_pops((4, 4, 4), 84))
    st = init_state(f, g, 99, step=3)
    draw_words(st.gen, 5)
    tckpt.save_state(str(tmp_path / "ck"), st, extra={"note": 1})
    back = tckpt.load_state(str(tmp_path / "ck.npz"), device="cpu")
    assert back.step == 3 and torch.equal(back.f, f)
    assert draw_words(back.gen, 4) == draw_words(st.gen, 4)
    meta = json.loads((tmp_path / "ck.json").read_text())
    assert meta == {"step": 3, "shape": [4, 4, 4], "dtype": "float32",
                    "note": 1}


def test_frame_formats(tmp_path):
    arr = np.arange(22 * 2 * 3 * 4, dtype=np.float32).reshape(22, 2, 3, 4)
    path = tfields.write_frame(str(tmp_path), 5, torch.from_numpy(arr))
    assert path.endswith("plt0000005.npz")
    d = tfields.read_frame(path)
    assert int(d["step"]) == 5
    np.testing.assert_array_equal(d["ufx"], arr[2])
    for fmt in ("native", "h5", "amrex"):
        back = tfields.read_frame(tfields.write_frame(str(tmp_path), 5, arr,
                                                      fmt=fmt))
        assert int(back["step"]) == 5
        np.testing.assert_array_equal(back["ufx"], arr[2])
    with pytest.raises(ValueError, match="unknown frame format"):
        tfields.write_frame(str(tmp_path), 5, arr, fmt="vtk")
