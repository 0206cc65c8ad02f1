"""The PyTorch port's plain ops against the JAX package's, on the same
float32 arrays.

Tolerance: atol 1e-6 on O(1) populations and moments — both run in f32
on the CPU, with sums and contractions taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import perturbed_pops, to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.ops import collide as jcollide
from bflbm_tpu.ops import hydro as jhydro
from bflbm_tpu.ops import moments as jmoments
from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu.ops import stencil as jstencil
from bflbm_tpu.ops import stream as jstream
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.ops import collide as tcollide
from bflbm_tpu_torch.ops import hydro as thydro
from bflbm_tpu_torch.ops import moments as tmoments
from bflbm_tpu_torch.ops import noise as tnoise
from bflbm_tpu_torch.ops import stencil as tstencil
from bflbm_tpu_torch.ops import stream as tstream

ATOL = 1e-6
SHAPE = (6, 8, 10)   # non-cubic: an axis mix-up cannot pass


def _params(**kw):
    return JParams(**kw), TParams(**kw)


def _xi(shape, seed, scale=3e-3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = (scale * rng.standard_normal((19,) + shape)).astype(np.float32)
        a[0] = 0.0
        out.append(a)
    return out


def _close(got, want, atol=ATOL, name=""):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=name)


def test_stream_exact():
    f, _ = perturbed_pops(SHAPE, 1)
    np.testing.assert_array_equal(to_np(tstream.stream(to_torch(f))),
                                  np.asarray(jstream.stream(jnp.asarray(f))))


@pytest.mark.parametrize("fn", ["moments", "populations"])
def test_transforms(fn):
    f, _ = perturbed_pops(SHAPE, 2)
    _close(getattr(tmoments, fn)(to_torch(f)),
           getattr(jmoments, fn)(jnp.asarray(f)))


@pytest.mark.parametrize("use_sc", [False, True])
def test_gradient(use_sc):
    rho = perturbed_pops(SHAPE, 3)[0].sum(0)
    _close(tstencil.gradient(to_torch(rho), use_sc, 1.3),
           jstencil.gradient(jnp.asarray(rho), use_sc, 1.3))


def test_hydrovars_bar():
    f, g = perturbed_pops(SHAPE, 4)
    jp, tp = _params()
    got = thydro.hydrovars_bar(to_torch(f), to_torch(g), tp)
    want = jhydro.hydrovars_bar(jnp.asarray(f), jnp.asarray(g), jp)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("alpha0", [0.0, 1.2])
def test_hydrovars(alpha0):
    f, g = perturbed_pops(SHAPE, 5)
    xf, xg = _xi(SHAPE, 6)
    jp, tp = _params(alpha0=alpha0, kBT=1e-5)
    got = thydro.hydrovars(to_torch(f), to_torch(g), to_torch(xf),
                           to_torch(xg), tp)
    want = jhydro.hydrovars(jnp.asarray(f), jnp.asarray(g), jnp.asarray(xf),
                            jnp.asarray(xg), jp)
    for name, a, b in zip(jhydro.Hydro._fields, got, want):
        _close(a, b, name=name)
    _close(thydro.pack(got), jhydro.pack(want))


def test_accelerations_alpha1_not_ported():
    """alpha1 alone (alpha0 = 0): the square-gradient force against the
    JAX package's, and far from the alpha1 = 0 force."""
    f, g = perturbed_pops(SHAPE, 7)
    rho, phi = f.sum(0), g.sum(0)
    jp, tp = _params(alpha1=0.5)
    got = thydro.accelerations(to_torch(rho), to_torch(phi), tp)
    want = jhydro.accelerations(jnp.asarray(rho), jnp.asarray(phi), jp)
    for a, b in zip(got, want):
        _close(a, b)
    assert float(got[0].abs().max()) > 100 * ATOL


def test_equilibrium_and_force_moments():
    rng = np.random.default_rng(8)
    n = (1.0 + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32)
    u = (0.05 * rng.standard_normal((3,) + SHAPE)).astype(np.float32)
    a = (0.01 * rng.standard_normal((3,) + SHAPE)).astype(np.float32)
    _close(tcollide.equilibrium_moments(to_torch(n), to_torch(u)),
           jcollide.equilibrium_moments(jnp.asarray(n), jnp.asarray(u)))
    _close(tcollide.force_moments(to_torch(n), to_torch(u), to_torch(a), 0.7),
           jcollide.force_moments(jnp.asarray(n), jnp.asarray(u),
                                  jnp.asarray(a), 0.7))


@pytest.mark.parametrize("taus,alpha0", [
    ((0.5, 0.5), 0.0),      # exact relaxation (the main path)
    ((0.5, 0.5), 1.2),      # exact relaxation with Shan-Chen forcing
    ((0.8, 0.7), 0.0),      # general tau
    ((0.8, 0.7), 1.2),
])
def test_collide(taus, alpha0):
    f, g = perturbed_pops(SHAPE, 9)
    xf, xg = _xi(SHAPE, 10)
    jp, tp = _params(tau_f=taus[0], tau_g=taus[1], alpha0=alpha0, kBT=1e-5)
    th = thydro.hydrovars(to_torch(f), to_torch(g), to_torch(xf),
                          to_torch(xg), tp)
    jh = jhydro.hydrovars(jnp.asarray(f), jnp.asarray(g), jnp.asarray(xf),
                          jnp.asarray(xg), jp)
    got = tcollide.collide(to_torch(f), to_torch(g), th, to_torch(xf),
                           to_torch(xg), tp)
    want = jcollide.collide(jnp.asarray(f), jnp.asarray(g), jh,
                            jnp.asarray(xf), jnp.asarray(xg), jp)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # the telescoped rest population pins the cell mass to the moment
    _close(got[0].sum(0), np.asarray(jh.rho), atol=2e-6)


@pytest.mark.parametrize("taus", [(0.5, 0.5), (0.8, 0.7)])
def test_noise_amplitudes(taus):
    f, g = perturbed_pops(SHAPE, 11)
    rho, phi = f.sum(0), g.sum(0)
    jp, tp = _params(tau_f=taus[0], tau_g=taus[1], kBT=1e-5)
    got = tnoise.noise_amplitudes(to_torch(rho), to_torch(phi), tp)
    want = jnoise.noise_amplitudes(jnp.asarray(rho), jnp.asarray(phi), jp)
    for a, b in zip(got, want):
        _close(a, b, atol=1e-9)
