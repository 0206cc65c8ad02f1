"""General relaxation (tau != 1/2, the JAX kernel's K1d mode,
``bflbm_tpu/kernels/fused_step.py:843-851, 1051-1064``) in the port
against the JAX package, at tau_f = 0.7, tau_g = 0.6 with the Shan-Chen
force (alpha0 = 1.5, rho_lo = 0.1).

- The plain K against the Pallas kernel in interpret mode (one 8^3 tile,
  block 1, hash clt4 noise).
- A 1 + 2 + 3-step session against ``make_nsteps(force=True)`` in
  interpret mode at kBT = 0 (``test_fused_matches_jnp_general_tau``),
  and against the JAX all-hash step chain with noise, fed the same words.
- The ``FORCE_GENERAL_RELAX`` hook at tau 1/2 against JAX with its own
  hook set: the general and exact branches differ at round-off
  (``tests/test_relax_invariance.py``), so like is compared with like.

Tolerance atol 2e-5, the JAX package's own for its kernel against its
jnp step (1/x multiplies against divides, summation order, FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import jax_words, to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.ops import collide as jcollide
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.kernels.session import FusedSession
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.ops import collide as tcollide
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-5
SHAPE = (8, 8, 8)
SEED = 6


def _kw(kBT=0.0, **extra):
    kw = dict(alpha0=1.5, kappa=0.1, tau_f=0.7, tau_g=0.6, rho_lo=0.1,
              rho_hi=3.0, kBT=kBT)
    kw.update(extra)
    return kw


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def _droplet_np(kw, seed=None):
    st = tmodel.init_droplet(SHAPE, TParams(**kw), radius=0.3, device="cpu")
    if seed is None:
        return st.f.numpy(), st.g.numpy()
    f, g = tmodel.perturbed_populations(SHAPE, seed, base=st)
    return f.numpy(), g.numpy()


def test_general_tau_k_matches_pallas_interpret():
    kw = _kw(1e-5)
    f, g = _droplet_np(kw, 101)
    word, step = 192837465, 12
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            JParams(**kw), SHAPE, (8, 8), True,
            jnp.array([word, step], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=1, noise_impl="hash", noise_dist="clt4")
    tp = TParams(**kw)
    assert tfs.general_relax(tp)
    got_f, got_g = tfs.fused_stream_collide(to_torch(f), to_torch(g), word,
                                            step, tp)
    _close(got_f, fo)
    _close(got_g, go)
    # tau is tested: the exact relaxation ends elsewhere
    half = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                TParams(**_kw(1e-5, tau_f=0.5, tau_g=0.5)))
    assert float((half[0] - got_f).abs().max()) > 50 * ATOL


def _session(params, f, g, words):
    """enter + advance(2) + advance(3), without the mass restore."""
    sess = FusedSession(params, SHAPE, mass_restore_int=0)
    pc = sess.enter(tinit(to_torch(f), to_torch(g), SEED), words[0])
    pc = sess.advance(pc, 2, words[1:3])
    pc = sess.advance(pc, 3, words[3:6])
    return sess.exit(pc)


def test_general_tau_session_matches_make_nsteps():
    kw = _kw(0.0)
    f, g = _droplet_np(kw)
    state = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    with pltpu.force_tpu_interpret_mode():
        want = jfs.make_nsteps(JParams(**kw), 6, force=True,
                               tile=(SHAPE[0], SHAPE[1]), block=1)(state)
    got = _session(TParams(**kw), f, g, list(range(6)))
    assert got.step == int(want.step) == 6
    _close(got.f, want.f)
    _close(got.g, want.g)


def test_general_tau_session_matches_jax_hash_chain():
    kw = _kw(1e-5)
    f, g = _droplet_np(kw, 102)
    _, words = jax_words(jax.random.PRNGKey(SEED), 6)
    one = jax.jit(lambda s: jmodel.step(s, JParams(**kw), noise_source="hash",
                                        noise_dist="clt4")[0])
    want = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    for _ in range(6):
        want = one(want)
    got = _session(TParams(**kw), f, g, words)
    _close(got.f, want.f)
    _close(got.g, want.g)


@pytest.fixture
def force_general(monkeypatch):
    """Both packages' hooks: JAX's collide and kernel, the port's
    collide (which its kernel wrapper reads too)."""
    monkeypatch.setattr(jcollide, "FORCE_GENERAL_RELAX", True)
    monkeypatch.setattr(jfs, "FORCE_GENERAL_RELAX", True)
    monkeypatch.setattr(tcollide, "FORCE_GENERAL_RELAX", True)


@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_force_general_relax_matches_jax(force_general, kBT):
    """At tau 1/2 with the hooks set, the port's plain K runs the general
    branch (the CUDA wrapper picks its general library) and agrees with
    JAX's general jnp step over 4 steps."""
    kw = _kw(kBT, tau_f=0.5, tau_g=0.5)
    tp, jp = TParams(**kw), JParams(**kw)
    assert tfs.general_relax(tp)
    f, g = _droplet_np(kw, 103)
    _, words = jax_words(jax.random.PRNGKey(SEED), 4)
    want = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    for _ in range(4):
        want, _ = jmodel.step(want, jp, noise_source="hash",
                              noise_dist="clt4")
    got = tmodel.nsteps(tinit(to_torch(f), to_torch(g), SEED), tp, 4, words)
    _close(got.f, want.f)
    _close(got.g, want.g)


def test_force_general_relax_is_not_bitwise_exact():
    """The hook changes the arithmetic: after a few steps the general
    branch differs from the exact one at round-off, not above it."""
    kw = _kw(1e-5, tau_f=0.5, tau_g=0.5)
    tp = TParams(**kw)
    f, g = (to_torch(a) for a in _droplet_np(kw, 104))
    words = [3, 1, 4, 1, 5, 9]
    exact = tmodel.nsteps(tinit(f.clone(), g.clone(), 0), tp, 6, words)
    tcollide.FORCE_GENERAL_RELAX = True
    try:
        general = tmodel.nsteps(tinit(f.clone(), g.clone(), 0), tp, 6, words)
    finally:
        tcollide.FORCE_GENERAL_RELAX = False
    d = float((exact.f - general.f).abs().max())
    assert 0.0 < d < 1e-5, d
    assert not tfs.general_relax(tp)
    assert torch.isfinite(general.g).all()
