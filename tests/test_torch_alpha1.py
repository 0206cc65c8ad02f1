"""The port's alpha1 path (the square-gradient force, the JAX kernel's K1c
mode) against the JAX package, on the CPU.

- ``ops.stencil.laplacian`` / ``grad_laplacian`` and
  ``ops.hydro.accelerations`` against JAX's, atol 1e-6 (f32 on both
  sides; the pseudopotential's exp differs by an ulp between XLA and
  torch).
- ``fused_step.laplacian_psi_reference`` (the plain version of kernel L)
  against JAX's stencil composition on the streamed densities.
- The plain K with alpha1 against the Pallas kernel in interpret mode
  (one 8^3 tile, block 1, hash noise), the port's session and K loop
  against JAX's jnp step chain at 8x8x128 (as
  tests/test_session.py::test_fused_session_alpha1_matches_jnp), and
  ``run`` against JAX's ``run(engine="jnp")``: atol 2e-5, the JAX
  package's own tolerance for its alpha1 kernel
  (test_fused_matches_jnp_alpha1).

The configuration is the JAX package's alpha1 session test's: alpha0 =
1.2, alpha1 = 0.5, kappa = 0.1, rho_lo = 0.1, rho_hi = 3.0.  The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu
from torch_parity import jax_words, to_np, to_torch

from bflbm_tpu import config as jconfig
from bflbm_tpu import run as jrun
from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.ops import hydro as jhydro
from bflbm_tpu.ops import stencil as jstencil
from bflbm_tpu.ops import stream as jstream
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch import config as tconfig
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.io import checkpoint as tckpt
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.kernels.session import FusedSession
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.ops import hydro as thydro
from bflbm_tpu_torch.ops import stencil as tstencil
from bflbm_tpu_torch.ops import stream as tstream
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-5
SEED = 4
A1 = dict(alpha0=1.2, alpha1=0.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=atol)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.3 * rng.standard_normal(shape)).astype(np.float32)


def _droplet_pops(shape, kw, seed):
    """Perturbed droplet populations (numpy float32), radius 0.3 of X."""
    base = tmodel.init_droplet(shape, TParams(**kw), radius=0.3,
                               device="cpu")
    f, g = tmodel.perturbed_populations(shape, seed, base=base)
    return f.numpy(), g.numpy()


@pytest.mark.parametrize("sc", [False, True])
def test_laplacian_and_grad_laplacian_match_jax(sc):
    x = _field((16, 16, 16), 91)
    for name in ("laplacian", "grad_laplacian"):
        got = getattr(tstencil, name)(to_torch(x), sc, 1.5)
        want = getattr(jstencil, name)(jnp.asarray(x), sc, 1.5)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, atol=1e-6)


@pytest.mark.parametrize("alpha0", [0.0, 1.2])
def test_accelerations_alpha1_match_jax(alpha0):
    rho, phi = _field((16, 16, 16), 92), _field((16, 16, 16), 93)
    kw = dict(A1, alpha0=alpha0)
    got = thydro.accelerations(to_torch(rho), to_torch(phi), TParams(**kw))
    want = jhydro.accelerations(jnp.asarray(rho), jnp.asarray(phi),
                                JParams(**kw))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-6)
    # the square-gradient term is far above the tolerance
    free = thydro.accelerations(to_torch(rho), to_torch(phi),
                                TParams(**dict(kw, alpha1=0.0)))
    assert float((free[0] - got[0]).abs().max()) > 1e3 * 1e-6


@pytest.mark.parametrize("sc", [False, True])
def test_laplacian_psi_reference_matches_jax(sc):
    shape = (6, 8, 10)
    kw = dict(A1, use_sc_pseudo=sc, sc_ref_density=1.5)
    f, g = _droplet_pops(shape, kw, 94)
    psi = tfs.density_psi_reference(to_torch(f), to_torch(g), TParams(**kw))
    before = tfs.laplacian_launches
    got = tfs.laplacian_psi(psi)     # the wrapper runs the plain version
    assert tfs.laplacian_launches == before
    assert tuple(got.shape) == (2,) + shape
    for k, pops in enumerate((f, g)):
        dens = jnp.sum(jstream.stream(jnp.asarray(pops)), axis=0)
        want = jstencil.laplacian(jstencil.pseudopotential(dens, sc, 1.5))
        _close(got[k], want, atol=1e-5)


@pytest.mark.parametrize("alpha0,kBT,dist", [
    (1.2, 0.0, "u8"),
    (0.0, 1e-5, "clt4"),
])
def test_alpha1_k_matches_pallas_interpret(alpha0, kBT, dist):
    shape = (8, 8, 8)
    kw = dict(A1, alpha0=alpha0, kBT=kBT)
    f, g = _droplet_pops(shape, kw, 95)
    jp, tp = JParams(**kw), TParams(**kw)
    word, step = 123456789, 17
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            jp, shape, (8, 8), jp.noise_on,
            jnp.array([word, step], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=1, noise_impl="hash", noise_dist=dist)
    got_f, got_g = tfs.fused_stream_collide(to_torch(f), to_torch(g), word,
                                            step, tp, noise_dist=dist)
    _close(got_f, fo)
    _close(got_g, go)
    free = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                dataclasses.replace(tp, alpha1=0.0), dist)
    assert float((free[0] - got_f).abs().max()) > 50 * ATOL


@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_alpha1_session_matches_jax_chain(kBT):
    """The plain model step chain, enter + advance(2) + exit and the K
    loop (make_ksteps) against JAX's jnp chain of 3 steps (hash clt4
    noise with the same words)."""
    shape, n = (8, 8, 128), 3
    kw = dict(A1, kBT=kBT)
    jst = jmodel.init_droplet(shape, JParams(**kw), dtype=jnp.float32,
                              radius=0.3)
    f, g = np.asarray(jst.f), np.asarray(jst.g)
    _, words = jax_words(jax.random.PRNGKey(SEED), n)
    one = jax.jit(lambda s: jmodel.step(s, JParams(**kw), noise_source="hash",
                                        noise_dist="clt4")[0])
    want = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    for _ in range(n):
        want = one(want)
    tp = TParams(**kw)
    plain = tmodel.nsteps(tinit(to_torch(f), to_torch(g), SEED), tp, n,
                          words, noise_dist="clt4")
    _close(plain.f, want.f)
    _close(plain.g, want.g)
    sess = FusedSession(tp, shape, noise_dist="clt4", mass_restore_int=0)
    pc = sess.enter(tinit(to_torch(f), to_torch(g), SEED), words[0])
    loop = tfs.make_ksteps(tp, n - 1, noise_dist="clt4")(
        pc.replace(f=pc.f.clone(), g=pc.g.clone()), words[1:])
    got = sess.exit(sess.advance(pc, n - 1, words[1:]))
    assert got.step == loop.step == n == int(want.step)
    _close(got.f, want.f)
    _close(got.g, want.g)
    _close(tstream.stream(loop.f), want.f)


def _a1_cfg(preset_mod, out):
    return preset_mod.preset("droplet-eq").replace(
        shape=(16, 16, 16), nsteps=6, plot_int=3, print_int=3,
        droplet_int=0, t_window=0, out_dir=str(out)).with_params(**A1)


def test_run_alpha1_matches_jax(tmp_path):
    jrun.run(_a1_cfg(jconfig, tmp_path / "jax"), engine="jnp")
    final = trun.run(_a1_cfg(tconfig, tmp_path / "port"), device="cpu")
    assert final.step == 6
    want = np.load(tmp_path / "jax" / "checkpoint0000006.npz")
    got = tckpt.load_state(str(tmp_path / "port" / "checkpoint0000006"),
                           device="cpu")
    _close(got.f, want["f"])
    _close(got.g, want["g"])
    for s in (0, 3, 6):
        with np.load(tmp_path / "jax" / f"plt{s:07d}.npz") as j, \
                np.load(tmp_path / "port" / f"plt{s:07d}.npz") as t:
            for k in ("rho", "phi", "afx", "agz"):
                _close(t[k], j[k])
