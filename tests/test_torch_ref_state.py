"""USE_REF_STATE (the JAX kernel's K1e mode, ``ref_rp``,
``bflbm_tpu/kernels/fused_step.py:944-951, 1808-1817``) in the port: the
noise amplitudes read a stored (rho_eq, phi_eq) rolled into the
instantaneous centre-of-mass frame instead of the live densities.

- The plain K with a ``ref`` operand against the Pallas kernel with
  ``ref`` in interpret mode (atol 2e-5, as the coupled tests), and the
  properties of ``test_kernel_ref_zero_amplitude_region_bitwise`` and
  ``test_kernel_ref_amplitude_scaling`` on the plain K.
- The session's per-sub-chunk COM-roll guard (``test_session_ref_roll_
  guard``).
- The transactional ref session on a boosted blob, through a COM
  cell-boundary crossing, against the JAX per-step chain
  ``model.step(ref_state=..., noise_source="hash")`` fed the same words
  (atol 2e-5; the COM is float64 in the port and float32 in JAX, which
  decides a crossing differently only within ~1e-6 cell of a half
  cell).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu
from torch_parity import jax_words, to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.observables import stats as jstats
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.kernels.session import FusedSession, make_session
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.observables import stats as tstats
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-5
SEED = 8


def _ref2(shape, seed):
    """A positive (2, X, Y, Z) ref operand, float32 numpy."""
    rng = np.random.default_rng(seed)
    rho = 0.2 + 2.5 * rng.random(shape)
    return np.stack([rho, 3.2 - rho]).astype(np.float32)


@pytest.mark.parametrize("alpha0", [0.0, 1.5])
def test_ref_k_matches_pallas_interpret(alpha0):
    shape = (8, 8, 8)
    kw = dict(alpha0=alpha0, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=1e-5)
    base = tmodel.init_droplet(shape, TParams(**kw), radius=0.3,
                               device="cpu")
    f, g = (t.numpy() for t in tmodel.perturbed_populations(shape, 111,
                                                            base=base))
    ref = _ref2(shape, 112)
    word, step = 55555, 3
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            JParams(**kw), shape, (8, 8), True,
            jnp.array([word, step], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=1, noise_impl="hash", noise_dist="clt4",
            ref=jnp.asarray(ref))
    got = tfs.fused_stream_collide(to_torch(f), to_torch(g), word, step,
                                   TParams(**kw), ref=to_torch(ref))
    np.testing.assert_allclose(to_np(got[0]), np.asarray(fo), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(go), rtol=0,
                               atol=ATOL)
    # the operand is read: the live amplitudes give another step at a
    # noise level where the amplitudes dominate
    loud = TParams(**dict(kw, kBT=1e-2))
    a = tfs.k_step_reference(to_torch(f), to_torch(g), word, step, loud,
                             ref=to_torch(ref))
    b = tfs.k_step_reference(to_torch(f), to_torch(g), word, step, loud)
    assert float((a[0] - b[0]).abs().max()) > 100 * ATOL


def test_ref_k_on_zero_density_droplet_matches_pallas_interpret():
    """ROADMAP Queue 3's ref case: the rho_lo = 0 droplet one step in,
    with ref amplitudes 1 + 0.1 U from a numpy seed, at 16^3.  Two plain
    K steps with the ref operand against two steps of the Pallas kernel
    with ``ref`` in interpret mode, whose divisions are guarded
    reciprocal products (``safe_inv``, fused_step.py:948-949) where the
    plain step divides: atol 2e-5."""
    shape = (16, 16, 16)
    kw = dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=1e-5)
    params = TParams(**kw)
    base = tmodel.init_droplet(shape, params, radius=0.3, device="cpu")
    pc = FusedSession(params, shape, block=1).enter(base, 12345)
    ref = (1.0 + 0.1 * np.random.default_rng(5).random((2,) + shape)
           ).astype(np.float32)
    jf, jg = jnp.asarray(to_np(pc.f)), jnp.asarray(to_np(pc.g))
    tf_, tg = pc.f, pc.g
    for s, word in enumerate((104729 - 2 ** 30, 209458 - 2 ** 30)):
        with pltpu.force_tpu_interpret_mode():
            jf, jg = jfs._fused_step_call(
                JParams(**kw), shape, (16, 16), True,
                jnp.array([word, 77 + s], jnp.int32), jf, jg, block=1,
                noise_impl="hash", noise_dist="clt4", ref=jnp.asarray(ref))
        tf_, tg = tfs.k_step_reference(tf_, tg, word, 77 + s, params,
                                       "clt4", to_torch(ref))
    assert float(to_np(tf_).sum(0).min()) < 1e-4   # cells of ~zero density
    np.testing.assert_allclose(to_np(tf_), np.asarray(jf), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=0, atol=ATOL)


def _mixture_ks(params, n, ref=None, shape=(16, 16, 16)):
    st = tmodel.init_mixture(shape, params, device="cpu")
    return tfs.make_ksteps(params, n)(st, list(range(7, 7 + n)),
                                      None if ref is None else to_torch(ref))


def test_ref_zero_amplitude_region_bitwise():
    """Cells whose ref densities are zero draw zero noise: the ref run
    equals the kBT = 0 run bitwise on the zero region eroded by one cell
    a step (the streaming light cone), and differs outside it."""
    shape, n = (16, 16, 16), 3
    zero = np.zeros(shape, bool)
    zero[2:10, 2:12, :] = True
    rho = np.where(zero, 0.0, 1.0).astype(np.float32)
    got = _mixture_ks(TParams(kBT=1e-5), n, np.stack([rho, rho]))
    base = _mixture_ks(TParams(kBT=0.0), n)
    df = to_np(got.f) - to_np(base.f)
    interior = np.zeros(shape, bool)
    interior[2 + n:10 - n, 2 + n:12 - n, :] = True
    outside = np.ones(shape, bool)
    outside[2 - n:10 + n, 2 - n:12 + n, :] = False
    assert np.all(df[:, interior] == 0.0)
    assert np.abs(df[:, outside]).max() > 1e-5


def test_ref_amplitude_scaling():
    """Ref densities scaled by 4 scale every amplitude by exactly 2: the
    perturbation of the state doubles to first order in the noise."""
    shape, n = (8, 8, 16), 2
    ones = np.ones((2,) + shape, np.float32)
    base = _mixture_ks(TParams(kBT=0.0), n, shape=shape)
    a = _mixture_ks(TParams(kBT=1e-5), n, ones, shape)
    b = _mixture_ks(TParams(kBT=1e-5), n, 4.0 * ones, shape)
    d1 = to_np(a.f) - to_np(base.f)
    d2 = to_np(b.f) - to_np(base.f)
    resid = np.linalg.norm(d2 - 2.0 * d1) / np.linalg.norm(d1)
    assert resid < 2e-2, resid
    assert np.linalg.norm(d1) > 1e-4


def _boosted(shape, u3):
    """numpy float32 (f, g, rho, phi) of the port's boosted blob."""
    st, rho, phi = tmodel.boosted_state(shape, u3)
    return st.f.numpy(), st.g.numpy(), rho.numpy(), phi.numpy()


@pytest.mark.parametrize("uz,expect_viol", [(0.0, False), (0.3, True)])
def test_session_ref_roll_guard(uz, expect_viol):
    """A blob drifting across a cell boundary is caught and the crossing
    isolated to a one-step sub-chunk (counted); a static one is not."""
    params = TParams(alpha0=0.0, kBT=1e-8)
    shape = (8, 8, 128)
    f, g, rho, phi = _boosted(shape, (0.0, 0.0, uz))
    com = tstats.center_of_mass(to_torch(rho))
    sess = make_session(params, shape, ref_fields=(rho, phi, com))
    pc = sess.enter(tinit(to_torch(f), to_torch(g), SEED))
    pc = sess.advance(pc, 6)   # uz = 0.3: the COM moves ~1.8 cells
    assert pc.step == 7
    assert (sess.ref_violations() > 0) == expect_viol


def test_ref_session_matches_jax_per_step_chain():
    params_kw = dict(alpha0=0.0, kBT=1e-8)
    shape, n = (8, 8, 128), 8
    f, g, rho, phi = _boosted(shape, (0.0, 0.0, 0.35))
    _, words = jax_words(jax.random.PRNGKey(SEED), n)

    jref = (jnp.asarray(rho), jnp.asarray(phi),
            np.asarray(jstats.center_of_mass(jnp.asarray(rho))))
    one = jax.jit(lambda s: jmodel.step(s, JParams(**params_kw), jref,
                                        noise_source="hash",
                                        noise_dist="clt4")[0])
    want = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    for _ in range(n):
        want = one(want)

    tp = TParams(**params_kw)
    com = tstats.center_of_mass(to_torch(rho))
    sess = FusedSession(tp, shape, mass_restore_int=0,
                        ref_fields=(rho, phi, com))
    pc = sess.enter(tinit(to_torch(f), to_torch(g), SEED), words[0])
    pc = sess.advance(pc, n - 1, words[1:])
    got = sess.exit(pc)
    assert got.step == n
    assert sess.ref_violations() > 0          # a crossing happened
    err = float(np.abs(to_np(got.f) - np.asarray(want.f)).max())
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=ATOL)

    # power check: one stale roll over the whole chunk deviates more
    stale_sess = FusedSession(tp, shape, mass_restore_int=0,
                              ref_fields=(rho, phi, com))
    pc = stale_sess.enter(tinit(to_torch(f), to_torch(g), SEED), words[0])
    shift = stale_sess._ref_shift(pc.f)
    pc = stale_sess._ksteps(n - 1)(pc, words[1:],
                                   stale_sess._rolled_ref(shift))
    stale = stale_sess.exit(pc)
    assert float(np.abs(to_np(stale.f) - np.asarray(want.f)).max()) > err
