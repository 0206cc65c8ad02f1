"""The port's offline analysis CLI (``python -m bflbm_tpu_torch.analysis``)
against the JAX package's (``bflbm_tpu.analysis``) on the same run
directories, on the CPU (``--device cpu``).

The directories hold what the port's writers write, at 16^3: droplet
frames (npz) with a drifting, breathing droplet and a metrics.jsonl of
droplet records, a second droplet for the Laplace sweep, stripe frames,
a structfact*.npz, two noise*.npz dumps and a frame-less run's
checkpoint.  The fields are float64: the JAX package's numpy then
computes in float64 too (on float32 frames it sums in float32, which
the port does not).  Every number of the JSON within 1e-6 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

from bflbm_tpu import analysis as janalysis
from bflbm_tpu_torch import analysis as tanalysis
from bflbm_tpu_torch.io import checkpoint as ckpt
from bflbm_tpu_torch.io import fields as fields_io
from bflbm_tpu_torch.io.metrics import MetricsWriter
from bflbm_tpu_torch.observables import structfact as sf_lib
from bflbm_tpu_torch.ops.hydro import HYDRO_NAMES
from bflbm_tpu_torch.state import init_state

RTOL = 1e-6
SHAPE = (16, 16, 16)
LO, HI = 0.05, 3.0


def _droplet(radius, com, seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    c = [np.arange(n) - n / 2.0 + 0.5 for n in shape]
    d = [(x - x0 + n / 2) % n - n / 2 for x, x0, n in zip(c, com, shape)]
    r = np.sqrt(d[0][:, None, None] ** 2 + d[1][None, :, None] ** 2
                + d[2][None, None, :] ** 2)
    rho = LO + 0.5 * (HI - LO) * (1 + np.tanh((radius - r) / 1.1))
    return rho + 1e-3 * rng.normal(size=shape)


def _packed(rho, phi, seed):
    """A (22, X, Y, Z) float64 frame: the densities and small random
    velocity-like components."""
    out = 1e-3 * np.random.default_rng(seed).normal(
        size=(len(HYDRO_NAMES),) + rho.shape)
    out[0], out[1] = rho, phi
    return out


def _stripe(seed, shape=(16, 24, 20)):
    rng = np.random.default_rng(seed)
    y = np.arange(shape[1])
    h = 13.0 + 0.4 * np.sin(2 * np.pi * y / shape[1])[None, :] \
        + 0.3 * rng.normal(size=shape[:2])
    z = np.arange(shape[2])[None, None, :]
    rho = LO + 0.5 * (HI - LO) * (np.tanh(z - 5.0) - np.tanh(z - h[..., None]))
    return rho + 1e-3 * rng.normal(size=shape)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis")
    out = {k: str(root / k) for k in ("drop", "drop2", "stripe", "mix",
                                      "ckpt")}
    metrics = MetricsWriter(os.path.join(out["drop"], "metrics.jsonl"))
    for i in range(6):
        rho = _droplet(4.2 + 0.05 * np.sin(i), (0.3 * i, -0.1 * i, 0.05),
                       i)
        fields_io.write_frame(out["drop"], 20 * i,
                              _packed(rho, LO + HI - rho, 50 + i), "npz")
        metrics.log(20 * i, mass_f=1.0, mass_g=1.0)
        rec = {"droplet_com": [0.3 * i, -0.1 * i, 0.05],
               "droplet_R_mass": 4.0 + 0.01 * i}
        if i != 2:   # a fit that did not converge logs no R, W
            rec.update(droplet_R=4.2 + 0.03 * np.cos(i),
                       droplet_W=0.6 + 0.01 * i)
        metrics.log(20 * i, **rec)
    metrics.close()
    for i in range(2):
        rho = _droplet(5.5, (0.2, 0.0, -0.3), 10 + i)
        fields_io.write_frame(out["drop2"], 100 * i,
                              _packed(rho, LO + HI - rho, 60 + i), "npz")
    for i in range(4):
        rho = _stripe(20 + i)
        fields_io.write_frame(out["stripe"], 10 * i,
                              _packed(rho, LO + HI - rho, 70 + i), "npz")
    rng = np.random.default_rng(30)
    sf = sf_lib.init_structfact(len(sf_lib.REFERENCE_PAIRS), SHAPE,
                                dtype=torch.float64, device="cpu")
    for _ in range(3):
        packed = rng.normal(size=(len(HYDRO_NAMES),) + SHAPE) * 3e-3
        packed[0] += 1.0
        sf = sf_lib.accumulate(sf, torch.as_tensor(packed))
    os.makedirs(out["mix"])
    np.savez(os.path.join(out["mix"], "structfact0000300.npz"),
             s_k=sf_lib.finalize(sf),
             pairs=np.asarray(sf_lib.REFERENCE_PAIRS),
             names=np.asarray(sf_lib.pair_names()))
    for i in range(2):
        xi = rng.normal(size=(2, 19) + SHAPE) * 3e-3
        xi[:, 0] = 0.0
        xi[1, 1:4] = -xi[0, 1:4] * (1 + 0.1 * rng.normal(size=(3,) + SHAPE))
        fields_io.write_noise_frame(out["mix"], 10 * (i + 1), xi[0], xi[1])
    pops = np.full((19,) + SHAPE, 1.0 / 19)
    rho = _droplet(4.0, (0.5, 0.2, -0.4), 40)
    f = pops * rho * (1 + 1e-3 * rng.normal(size=pops.shape))
    g = pops * (LO + HI - rho)
    ckpt.save_state(os.path.join(out["ckpt"], "checkpoint0000500"),
                    init_state(torch.as_tensor(f), torch.as_tensor(g), 0,
                               step=500))
    return out


CASES = {
    "sk": lambda d: ["sk", "--dir", d["mix"], "--kBT", "3e-5"],
    "sk_from_frames": lambda d: ["sk", "--dir", d["drop"], "--skip", "1"],
    "interface": lambda d: ["interface", "--dir", d["stripe"], "--kmax",
                            "2.5"],
    "droplet": lambda d: ["droplet", "--dir", d["drop"], "--alpha0", "1.5"],
    "droplet_checkpoint": lambda d: ["droplet", "--dir", d["ckpt"]],
    "laplace": lambda d: ["laplace", "--dirs", d["drop"], d["drop2"]],
    "msd": lambda d: ["msd", "--dir", d["drop"], "--tau", "0.3"],
    "noise": lambda d: ["noise", "--dir", d["mix"], "--kBT", "1e-5",
                        "--tau", "0.6", "--rho", "1.2"],
    "convergence": lambda d: ["convergence", "--dir", d["drop"], "--comp",
                              "phi", "--window", "4"],
    "radius": lambda d: ["radius", "--dir", d["drop"], "--series"],
    "theory": lambda d: ["theory", "--alpha0", "1.4", "--rho-t", "3.0"],
}


def _json_close(got, want, path="json"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert abs(got - want) <= RTOL * abs(want), (path, got, want)
    else:
        assert got == want, path


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_cli_matches_jax(cmd, dirs, capsys):
    argv = CASES[cmd](dirs)
    want = _run(janalysis.main, argv, capsys)
    got = _run(tanalysis.main, argv + ["--device", "cpu"], capsys)
    assert want, cmd
    _json_close(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_read_any_checkpoint_sums_like_numpy(dtype, tmp_path):
    """A frame-less run's densities: the population sums in the
    checkpoint's dtype (float32 as the driver writes it), bitwise
    numpy's."""
    rng = np.random.default_rng(31)
    f, g = (rng.uniform(0.0, 0.3, size=(19,) + SHAPE).astype(dtype)
            for _ in range(2))
    ckpt.save_state(str(tmp_path / "checkpoint0000500"),
                    init_state(torch.as_tensor(f), torch.as_tensor(g), 0,
                               step=500))
    path = tanalysis._frames(str(tmp_path))[0]
    assert path == janalysis._frames(str(tmp_path))[0]
    want = janalysis._read_any(path)
    got = tanalysis._read_any(path, torch.device("cpu"))
    for k in ("rho", "phi"):
        assert got[k].numpy().dtype == want[k].dtype == dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert int(got["step"]) == int(want["step"]) == 500


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_cli_refuses_the_host_unless_asked(dirs):
    """--device defaults to cuda: without a card every subcommand raises
    rather than computing on the host."""
    for cmd in ("theory", "droplet"):
        argv = CASES[cmd](dirs)
        with pytest.raises(RuntimeError, match="--device cpu"):
            tanalysis.main(argv)


@pytest.mark.parametrize("fmt", ["npz", "native", "amrex"])
def test_read_frame_reads_the_named_fields(fmt, tmp_path):
    """read_frame(path, names): the named arrays and the step, bitwise
    those of a whole read (a .bflbm or npz frame reads no other field)."""
    rho = _droplet(4.0, (0.0, 0.0, 0.0), 3)
    path = fields_io.write_frame(str(tmp_path), 40,
                                 _packed(rho, LO + HI - rho, 4), fmt)
    whole = fields_io.read_frame(path)
    part = fields_io.read_frame(path, ("phi", "ufx"))
    assert set(part) == {"phi", "ufx", "step"}
    assert int(part["step"]) == 40
    for k in ("phi", "ufx"):
        np.testing.assert_array_equal(part[k], whole[k])
