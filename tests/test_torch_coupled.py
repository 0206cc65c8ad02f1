"""The port's coupled path (alpha0 != 0, the Shan-Chen force) and its
clt4 generator against the JAX package.

On the CPU the K wrapper runs its plain version, held here against the
Pallas kernel in its coupled mode (interpret mode, one 8^3 tile, block 1,
hash noise) and against the JAX model step; the density pre-pass's plain
version against JAX's streamed densities and pseudopotential; the
coupled session against JAX's all-hash step chain.  Inputs are droplets
with rho_lo = 0.1 and rho_lo = 0 (where phi is exactly 0 in the core and
the guarded divisions matter), perturbed so that every term is live.
Tolerance atol 2e-5, the JAX package's own for its coupled kernel
(test_fused_matches_jnp_deterministic): 1/x multiplies against divides,
another gradient summation order, FMA contraction.  The CUDA kernels are
held against these plain versions on the card (tests/test_torch_gpu.py
and chip_smoke.py).
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
from bflbm_tpu.ops import stencil as jstencil
from bflbm_tpu.ops import stream as jstream
from bflbm_tpu.state import SimState as JState
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.kernels.session import FusedSession, make_session
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.ops import stream as tstream
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-5
SEED = 4


def _kw(rho_lo, kBT=0.0, **extra):
    return dict(alpha0=1.5, kappa=0.1, rho_lo=rho_lo, rho_hi=3.0, kBT=kBT,
                **extra)


def _droplet_pops(shape, kw, seed):
    """Perturbed droplet populations (numpy float32), radius 0.3 of X."""
    base = tmodel.init_droplet(shape, TParams(**kw), radius=0.3,
                               device="cpu")
    f, g = tmodel.perturbed_populations(shape, seed, base=base)
    return f.numpy(), g.numpy()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("rho_lo,kBT,dist,sc", [
    (0.1, 0.0, "u8", False),
    (0.0, 0.0, "u8", False),
    (0.1, 1e-5, "u8", False),
    (0.0, 1e-5, "clt4", False),
    (0.1, 1e-5, "clt4", True),
])
def test_coupled_k_matches_pallas_interpret(rho_lo, kBT, dist, sc):
    shape = (8, 8, 8)
    kw = _kw(rho_lo, kBT, use_sc_pseudo=sc)
    f, g = _droplet_pops(shape, kw, 61)
    jp, tp = JParams(**kw), TParams(**kw)
    word, step = 987654321, 23
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            jp, shape, (8, 8), jp.noise_on,
            jnp.array([word, step], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=1, noise_impl="hash", noise_dist=dist)
    before = (tfs.launches, tfs.density_launches)
    got_f, got_g = tfs.fused_stream_collide(to_torch(f), to_torch(g), word,
                                            step, tp, noise_dist=dist)
    assert (tfs.launches, tfs.density_launches) == before   # plain on CPU
    _close(got_f, fo)
    _close(got_g, go)
    # the force is far above the tolerance: the coupled terms are tested
    free = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                TParams(**dict(kw, alpha0=0.0)), dist)
    assert float((free[0] - got_f).abs().max()) > 50 * ATOL


@pytest.mark.parametrize("dist", ["u8", "clt4"])
def test_coupled_k_matches_model_step_composed(dist):
    """stream(K(pc)) == model.step(stream(pc)) with the force and hash
    noise, on an odd shape."""
    shape = (6, 8, 10)
    kw = _kw(0.0, 1e-5)
    f, g = _droplet_pops(shape, kw, 62)
    key = jax.random.PRNGKey(5)
    _, (word,) = jax_words(key, 1)
    step = 9
    js = JState(f=jstream.stream(jnp.asarray(f)),
                g=jstream.stream(jnp.asarray(g)), key=key,
                step=jnp.asarray(step, jnp.int32))
    want, _ = jmodel.step(js, JParams(**kw), noise_source="hash",
                          noise_dist=dist)
    kf, kg = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                  TParams(**kw), dist)
    _close(tstream.stream(kf), want.f)
    _close(tstream.stream(kg), want.g)


@pytest.mark.parametrize("sc", [False, True])
def test_density_psi_reference_matches_jax(sc):
    shape = (5, 7, 9)
    kw = _kw(0.0, use_sc_pseudo=sc, sc_ref_density=1.5)
    f, g = _droplet_pops(shape, kw, 63)
    got = tfs.density_psi_reference(to_torch(f), to_torch(g), TParams(**kw))
    assert tuple(got.shape) == (2,) + shape
    for k, pops in enumerate((f, g)):
        dens = jnp.sum(jstream.stream(jnp.asarray(pops)), axis=0)
        want = jstencil.pseudopotential(dens, sc, 1.5)
        _close(got[k], want, atol=1e-6)


def test_density_psi_wrapper_on_cpu():
    f, g = (to_torch(a) for a in _droplet_pops((4, 6, 8), _kw(0.1), 64))
    p = TParams(**_kw(0.1))
    before = tfs.density_launches
    out = torch.empty((2, 4, 6, 8))
    got = tfs.density_psi(f, g, p, out=out)
    assert got is out and tfs.density_launches == before
    assert torch.equal(out, tfs.density_psi_reference(f, g, p))
    with pytest.raises(ValueError, match="no density pre-pass"):
        tfs.density_psi(f.to("meta"), g.to("meta"), p)


def test_coupled_make_ksteps_is_the_reference_chain():
    """Bitwise on the CPU: the coupled launch loop is a chain of plain K
    steps with consecutive step labels, one word per step and the
    chosen generator."""
    f, g = (to_torch(a) for a in _droplet_pops((4, 6, 8), _kw(0.0), 65))
    tp = TParams(**_kw(0.0, 1e-5))
    words = [11, -22, 33]
    rf, rg = f.clone(), g.clone()
    for k, w in enumerate(words):
        rf, rg = tfs.k_step_reference(rf, rg, w, 5 + k, tp, "clt4")
    got = tfs.make_ksteps(tp, 3, noise_dist="clt4")(tinit(f, g, 0, step=5),
                                                   words)
    assert got.step == 8
    assert torch.equal(got.f, rf) and torch.equal(got.g, rg)
    # the generator matters: u8 gives another trajectory
    u8 = tfs.make_ksteps(tp, 3, noise_dist="u8")(
        tinit(f.clone(), g.clone(), 0, step=5), words)
    assert float((u8.f - rf).abs().max()) > 50 * ATOL


def _session_run(params, f, g, words, chunks, dist, shape):
    sess = FusedSession(params, shape, noise_dist=dist, mass_restore_int=0)
    pc = sess.enter(tinit(to_torch(f), to_torch(g), SEED), words[0])
    used = 1
    for c in chunks:
        pc = sess.advance(pc, c, words[used:used + c])
        used += c
    assert used == len(words)
    return sess.exit(pc)


@pytest.mark.parametrize("rho_lo,dist", [(0.1, "u8"), (0.0, "clt4")])
def test_coupled_session_matches_jax_hash_chain(rho_lo, dist):
    """The 8^3 droplet of test_fluctuating_cross_engine_parity_hash: the
    port's session (enter + 4 + 5) against JAX's all-hash chain of 10
    steps fed the same words."""
    shape, n = (8, 8, 8), 10
    kw = _kw(rho_lo, 1e-5)
    jst = jmodel.init_droplet(shape, JParams(**kw), dtype=jnp.float32,
                              radius=0.3)
    f, g = np.asarray(jst.f), np.asarray(jst.g)
    _, words = jax_words(jax.random.PRNGKey(SEED), n)
    one = jax.jit(lambda s: jmodel.step(s, JParams(**kw), noise_source="hash",
                                        noise_dist=dist)[0])
    want = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    for _ in range(n):
        want = one(want)
    got = _session_run(TParams(**kw), f, g, words, (4, 5), dist, shape)
    assert got.step == n == int(want.step)
    _close(got.f, want.f)
    _close(got.g, want.g)


def test_coupled_session_chunk_split_invariance():
    """1+9 == 1+4+5 bitwise with alpha0 = 1.5 and clt4."""
    shape = (8, 8, 8)
    kw = _kw(0.0, 1e-5)
    f, g = _droplet_pops(shape, kw, 66)
    words = list(range(-5, 5))
    p = TParams(**kw)
    a = _session_run(p, f, g, words, (9,), "clt4", shape)
    b = _session_run(p, f, g, words, (4, 5), "clt4", shape)
    assert a.step == b.step == 10
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)


@pytest.mark.parametrize("kw,dist,exc,item", [
    (dict(), "normal", ValueError, "unknown noise_dist"),
])
def test_make_session_refuses(kw, dist, exc, item):
    """Only an unknown generator name is refused."""
    with pytest.raises(exc, match=item):
        make_session(TParams(**_kw(0.1, 1e-5, **kw)), (4, 4, 4),
                     noise_dist=dist)


@pytest.mark.parametrize("kw,dist", [
    (dict(tau_f=0.8), "u8"),
    (dict(), "clt2"),
    (dict(), "bm"),
    (dict(alpha1=0.3), "u8"),
    (dict(alpha1=0.3, tau_f=0.8), "clt2"),
])
def test_make_session_accepts_the_ported_modes(kw, dist):
    """General tau (K1d), the clt2 / Box-Muller generators (K3) and
    alpha1 (K1c)."""
    s = make_session(TParams(**_kw(0.1, 1e-5, **kw)), (4, 4, 4),
                     noise_dist=dist)
    assert isinstance(s, FusedSession) and s.noise_dist == dist


def test_make_session_returns_a_fused_session():
    p = TParams(**_kw(0.0, 1e-5, use_sc_pseudo=True))
    s = make_session(p, (4, 4, 4), noise_dist="clt4", mass_restore_int=7)
    assert isinstance(s, FusedSession)
    assert s.noise_dist == "clt4" and s.mass_restore_int == 7
    assert s.params == p and s.shape == (4, 4, 4)


@pytest.mark.parametrize("dist", ["clt2", "bm", "normal"])
def test_k_step_refuses_unported_dist(dist):
    """clt2 and bm run (the plain K on CPU tensors); an unknown name is
    refused."""
    f = torch.ones((19, 2, 2, 2))
    if dist == "normal":
        with pytest.raises(ValueError, match="unknown noise_dist"):
            tfs.fused_stream_collide(f, f.clone(), 1, 1, TParams(kBT=1e-5),
                                     noise_dist=dist)
        return
    fo, go = tfs.fused_stream_collide(f, f.clone(), 1, 1, TParams(kBT=1e-5),
                                      noise_dist=dist)
    assert bool(torch.isfinite(fo).all() and torch.isfinite(go).all())
