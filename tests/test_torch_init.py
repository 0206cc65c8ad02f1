"""The port's run configuration, presets, initializers and scalar
observables against the JAX package, and the entry points' default
device.

Initial populations agree to 2e-7: XLA:CPU's float32 tanh is a rational
approximation that differs from torch's by an ulp or two (populations
are <= 3 w_0 = 1).
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturbed_pops, to_np, to_torch

from bflbm_tpu import config as jconfig
from bflbm_tpu.io import checkpoint as jckpt
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.observables import stats as jstats
from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch import config as tconfig
from bflbm_tpu_torch import interop
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.io import checkpoint as tckpt
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.kernels import session as tsession
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.ops import noise as tnoise
from bflbm_tpu_torch.observables import stats as tstats
from bflbm_tpu_torch.state import draw_words, make_generator

ODD = (6, 8, 10)
POP_ATOL = 2e-7


def _same_pops(tst, jst, atol=POP_ATOL):
    np.testing.assert_allclose(to_np(tst.f), np.asarray(jst.f), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(to_np(tst.g), np.asarray(jst.g), rtol=0,
                               atol=atol)


def _params(**kw):
    base = dict(alpha0=1.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
    base.update(kw)
    return jconfig.LBMParams(**base), tconfig.LBMParams(**base)


@pytest.mark.parametrize("width", [0.0, 1.0])
def test_init_stripe_matches_jax(width):
    jp, tp = _params()
    jst = jmodel.init_stripe(ODD, jp, seed=3, dtype=jnp.float32, frac=0.4,
                             width=width)
    tst = tmodel.init_stripe(ODD, tp, seed=3, frac=0.4, width=width,
                             device="cpu")
    assert tst.step == 0 and tst.f.dtype == torch.float32
    _same_pops(tst, jst)
    # a stripe: rho varies along z only
    rho = to_np(tst.f.sum(0))
    assert np.ptp(rho, axis=(0, 1)).max() == 0 and np.ptp(rho) > 1.0


@pytest.mark.parametrize("width", [0.0, 1.0])
@pytest.mark.parametrize("rho_lo", [0.0, 0.1])
def test_init_droplet_matches_jax(width, rho_lo):
    jp, tp = _params(rho_lo=rho_lo)
    jst = jmodel.init_droplet(ODD, jp, dtype=jnp.float32, radius=0.3,
                              width=width)
    tst = tmodel.init_droplet(ODD, tp, radius=0.3, width=width,
                              device="cpu")
    _same_pops(tst, jst)


@pytest.mark.parametrize("name", ["mixture-eq", "interface-eq",
                                  "droplet-eq", "droplet-a2.5-eq"])
def test_make_initial_state_matches_jax(name):
    jcfg = jconfig.preset(name).replace(shape=ODD, dtype=jnp.float32)
    tcfg = tconfig.preset(name).replace(shape=ODD)
    jst = jmodel.make_initial_state(jcfg)
    tst = tmodel.make_initial_state(tcfg, device="cpu")
    assert tst.shape == ODD and tst.step == 0
    _same_pops(tst, jst)


@pytest.mark.parametrize("reseed", [False, True])
def test_make_initial_state_from_checkpoint(tmp_path, reseed):
    f, g = perturbed_pops((4, 4, 8), 71)
    jckpt.save_state(str(tmp_path / "ck"),
                     jinit(jnp.asarray(f), jnp.asarray(g), 9, step=33))
    cfg = tconfig.preset("droplet-fluct").replace(
        shape=(4, 4, 8), checkpoint_path=str(tmp_path / "ck"), seed=5,
        reseed=reseed)
    a = tmodel.make_initial_state(cfg, device="cpu")
    b = tmodel.make_initial_state(cfg, device="cpu")
    assert a.step == 33
    np.testing.assert_array_equal(to_np(a.f), f)
    np.testing.assert_array_equal(to_np(a.g), g)
    wa, wb = draw_words(a.gen, 4), draw_words(b.gen, 4)
    assert wa == wb                       # a resume is reproducible
    assert (wa == draw_words(make_generator(5), 4)) == reseed
    with pytest.raises(ValueError, match="checkpoint_path"):
        tmodel.make_initial_state(cfg.replace(checkpoint_path=None),
                                  device="cpu")


def test_preset_names_match_jax():
    assert tconfig.preset_names() == jconfig.preset_names()
    with pytest.raises(KeyError, match="unknown preset"):
        tconfig.preset("no-such-preset")


@pytest.mark.parametrize("name", jconfig.preset_names())
def test_preset_matches_jax(name):
    """Field by field, through run_config_from_dict of the JAX preset."""
    want = interop.run_config_from_dict(
        dataclasses.asdict(jconfig.preset(name)))
    assert tconfig.preset(name) == want
    assert want.dtype == torch.float32


def test_run_config_defaults_and_helpers():
    want = interop.run_config_from_dict(dataclasses.asdict(
        jconfig.RunConfig()))
    got = tconfig.RunConfig()
    assert got == want and got.noise_dist == "clt4"
    cfg = got.with_params(kBT=1e-5).replace(shape=(4, 4, 4))
    assert cfg.params.kBT == 1e-5 and cfg.shape == (4, 4, 4)
    with pytest.raises(ValueError, match="unknown RunConfig"):
        interop.run_config_from_dict({"shape": (2, 2, 2), "tile": 1})


def test_stats_match_jax():
    rng = np.random.default_rng(72)
    rho = (rng.random(ODD) * 3.0).astype(np.float32)
    np.testing.assert_allclose(to_np(tstats.center_of_mass(to_torch(rho))),
                               np.asarray(jstats.center_of_mass(
                                   jnp.asarray(rho))), rtol=1e-6)
    jf = jstats.density_fluctuation(jnp.asarray(rho))
    tf = tstats.density_fluctuation(to_torch(rho))
    for k in ("mean", "sigma"):
        np.testing.assert_allclose(float(tf[k]), float(jf[k]), rtol=1e-6)
    for mid in (0.5, 1.5, 2.5):
        assert float(tstats.droplet_volume_ratio(to_torch(rho), mid, 2.0)) \
            == pytest.approx(float(jstats.droplet_volume_ratio(
                jnp.asarray(rho), mid, 2.0)), rel=1e-6)


def test_center_of_mass_of_a_droplet():
    """The droplet initializer's centre (X/2, Y/2, X//2) comes back."""
    _, tp = _params(rho_lo=0.0)
    st = tmodel.init_droplet((16, 20, 24), tp, radius=0.25, device="cpu")
    com = tstats.center_of_mass(st.f.sum(0))
    assert com.dtype == torch.float64
    np.testing.assert_allclose(com.numpy(), [8.0, 10.0, 8.0], atol=1e-9)


@pytest.mark.parametrize("fn", [
    tmodel.init_mixture, tmodel.init_stripe, tmodel.init_droplet,
    tmodel.init_checkpoint, tmodel.make_initial_state,
    interop.state_from_arrays, interop.load_jax_checkpoint,
    tckpt.load_state, trun.run,
])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _default(fn, name="noise_dist"):
    return inspect.signature(fn).parameters[name].default


@pytest.mark.parametrize("fn", [
    tmodel.prelude, tmodel.step, tmodel.nsteps, tfs.k_step_reference,
    tfs.launch_k, tfs.fused_stream_collide, tfs.make_ksteps,
    tsession.FusedSession, tsession.make_session,
    tnoise.thermal_noise_hash,
])
def test_noise_dist_defaults_match_jax(fn):
    """Every generator default of the port is JAX's: the model step
    (bflbm_tpu/models/binary_fluid.py:38), the kernel's K loop
    (fused_step.py:2098) and RunConfig (config.py:132)."""
    want = {_default(jmodel.prelude), _default(jmodel.step),
            _default(jfs.make_ksteps),
            _default(jnoise.thermal_noise_hash, "dist"),
            _default(jnoise.hash_normal_stack, "dist"),
            jconfig.RunConfig().noise_dist}
    assert want == {"clt4"}
    name = "dist" if fn is tnoise.thermal_noise_hash else "noise_dist"
    assert _default(fn, name) == "clt4"
    assert _default(tnoise.hash_normal_stack, "dist") == "clt4"

