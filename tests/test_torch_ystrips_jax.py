"""The PyTorch port's y-strip exchange (``make_kernel_ksteps(...,
y_exchange="strips")``) at block 1 and block 2 against the JAX package's
strips sweeps in interpret mode, on a CPU mesh, in a file of its own: the
JAX side's lowering dominates its time, and ``--dist loadfile`` then gives
it a worker of its own.  Both cases start from JAX's post-collide coupled
droplet with kBT = 1e-5 (16 x 32 x 128) and its key, built once for the
module.  Tolerance TOL = 2e-5, chip_smoke.py's kernel tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.ops import collide as jcollide
from bflbm_tpu.parallel import kernel as jkernel_par
from bflbm_tpu.parallel import mesh as jmesh_lib
from bflbm_tpu.state import SimState as JState
from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.parallel import kernel as kernel_par
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.state import init_state

TOL = 2e-5
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


@pytest.fixture(scope="module")
def droplet():
    """(LBMParams keywords, shape, JAX's post-collide state pc): the
    coupled droplet with kBT = 1e-5 one prelude + collide in."""
    kw = dict(_DROP, alpha0=1.5, kBT=1e-5)
    jp = JParams(**kw)
    shape = (16, 32, 128)
    state = jmodel.init_droplet(shape, jp, dtype=jnp.float32, radius=0.3)
    h, xi_f, xi_g, key = jmodel.prelude(state, jp)
    f1, g1 = jcollide.collide(state.f, state.g, h, xi_f, xi_g, jp)
    return kw, shape, JState(f=f1, g=g1, key=key, step=state.step + 1)


def _words(key, n):
    """JAX's per-step words of n K steps from the state's key."""
    words = []
    k = key
    for _ in range(n):
        k, sub = jax.random.split(k)
        words.append(int(jax.random.randint(
            sub, (), minval=jnp.iinfo(jnp.int32).min,
            maxval=jnp.iinfo(jnp.int32).max, dtype=jnp.int32)))
    return words


def test_strips_match_jax_ystrips(droplet):
    """The port's strips sweep against JAX's (make_kernel_ksteps(...,
    y_exchange="strips"), block 1, hash noise, interpret mode) on the
    same post-collide droplet with kBT = 1e-5: 16 x 32 x 128 on (2, 2, 1),
    3 K steps with JAX's per-step words, atol TOL."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    kw, shape, pc = droplet
    jp = JParams(**kw)
    n = 3
    jmesh = jmesh_lib.make_mesh((2, 2, 1), jax.devices()[:4])
    want = jax.jit(jkernel_par.make_kernel_ksteps(
        jmesh, jp, n, block=1, noise_impl="hash", transform="mxu",
        interpret=True, y_exchange="strips"))(pc)
    words = _words(pc.key, n)
    params = LBMParams(**kw)
    mesh = _cpu_mesh((2, 2, 1))
    lay = kernel_par.layout(mesh, shape, params, "auto", "strips")
    ss = kernel_par.pad_state(init_state(to_torch(pc.f), to_torch(pc.g), 0,
                                         1), mesh, lay.pad)
    got = mesh_lib.gather_state(kernel_par.make_kernel_ksteps(
        mesh, params, n, y_exchange="strips")(ss, words))
    assert got.step == int(want.step) == 1 + n
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=TOL)


def test_block2_strips_match_jax_ystrips(droplet):
    """The port's strips sweep at block 2 against JAX's
    (make_kernel_ksteps(..., block=2, y_exchange="strips"), hash noise,
    interpret mode) on the same post-collide droplet with kBT = 1e-5:
    16 x 32 x 128 on (2, 2, 1), 5 K steps (two sweeps and a single step)
    with JAX's per-step words, atol TOL."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    kw, shape, pc = droplet
    jp = JParams(**kw)
    n = 5
    jmesh = jmesh_lib.make_mesh((2, 2, 1), jax.devices()[:4])
    want = jax.jit(jkernel_par.make_kernel_ksteps(
        jmesh, jp, n, block=2, noise_impl="hash", transform="mxu",
        interpret=True, y_exchange="strips"))(pc)
    words = _words(pc.key, n)
    params = LBMParams(**kw)
    mesh = _cpu_mesh((2, 2, 1))
    lay = kernel_par.layout(mesh, shape, params, "auto", "strips", block=2)
    assert lay.strips and lay.pad == (4, 4, 0)
    ss = kernel_par.pad_state(init_state(to_torch(pc.f), to_torch(pc.g), 0,
                                         1), mesh, lay.pad)
    got = mesh_lib.gather_state(kernel_par.make_kernel_ksteps(
        mesh, params, n, y_exchange="strips", block=2)(ss, words))
    assert got.step == int(want.step) == 1 + n
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=TOL)
