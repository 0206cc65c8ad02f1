"""The port's bulk noise source and its engine choice against the JAX
package.

``ops.noise.thermal_noise`` with explicit normals against JAX's
``thermal_noise`` (its threefry draw fed to the port), USE_REF_STATE
amplitudes included; three plain steps of a coupled interface with
``noise_source="threefry"``, fed JAX's own normals from its key splits,
against ``model.step(noise_source="threefry")`` (atol 2e-5, the coupled
tolerance of tests/test_torch_coupled.py: 1/x against divides, another
gradient summation order); ``run(engine="jnp")`` on the hash stream
against the kernel session without the restore; a bulk-noise restart;
``--engine`` / ``--noise-source`` against JAX's CLI and its resolution
rule; the bulk normals' moments.  The JAX side runs in float32 (the
conftest turns x64 on), on the CPU, without Pallas.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

import bflbm_tpu.run as jrun
from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.config import preset as jpreset
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.config import preset
from bflbm_tpu_torch.io import checkpoint as ckpt
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.models import plain_session
from bflbm_tpu_torch.ops import noise as tnoise
from bflbm_tpu_torch.state import draw_words, init_state

ATOL = 2e-5
F32 = jnp.float32
KW = dict(alpha0=1.5, kappa=0.1, rho_lo=0.1, rho_hi=3.0, kBT=1e-5)


def _interface(shape, seed=5):
    """Perturbed interface populations (numpy float32): the stripe along
    z, every term of the step live."""
    base = tmodel.init_stripe(shape, TParams(**KW), device="cpu")
    f, g = tmodel.perturbed_populations(shape, seed, base=base)
    return f.numpy(), g.numpy()


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    rho = (0.1 + 2.9 * rng.random(shape)).astype(np.float32)
    phi = (3.1 - rho + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    return rho, phi


@pytest.mark.parametrize("ref", [False, True])
def test_thermal_noise_explicit_normals_match_jax(ref):
    shape = (6, 5, 4)
    rho, phi = _fields(shape, 11)
    params = dict(KW, tau_f=0.7, tau_g=0.6)
    key = jax.random.PRNGKey(3)
    ref_j = ref_t = None
    if ref:
        rho_eq, phi_eq = _fields(shape, 12)
        shift = np.array([1.4, -0.6, 2.2])
        ref_j = (jnp.asarray(rho_eq), jnp.asarray(phi_eq), jnp.asarray(shift))
        ref_t = (torch.as_tensor(rho_eq), torch.as_tensor(phi_eq), shift)
    jf, jg = jnoise.thermal_noise(key, jnp.asarray(rho), jnp.asarray(phi),
                                  JParams(**params), ref_j)
    n = np.array(jax.random.normal(key, (33,) + shape, F32))
    tf, tg = tnoise.thermal_noise(0, 0, torch.as_tensor(rho),
                                  torch.as_tensor(phi), TParams(**params),
                                  ref_t, normals=torch.as_tensor(n))
    assert tf.dtype == torch.float32 and tf.shape == (19,) + shape
    for got, want in ((tf, jf), (tg, jg)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-12)
    # kBT = 0: zeros, no draw
    zf, zg = tnoise.thermal_noise(0, 0, torch.as_tensor(rho),
                                  torch.as_tensor(phi),
                                  TParams(**dict(params, kBT=0.0)))
    assert not zf.any() and not zg.any()


def test_bulk_steps_match_jax_threefry():
    shape = (16, 12, 8)
    f, g = _interface(shape)
    jstate = jinit(jnp.asarray(f), jnp.asarray(g), 9)
    tstate = init_state(torch.as_tensor(f), torch.as_tensor(g), 9)
    jp, tp = JParams(**KW), TParams(**KW)
    key = jstate.key
    for _ in range(3):
        key, sub = jax.random.split(key)
        n = np.array(jax.random.normal(sub, (33,) + shape, F32))
        jstate, jh = jmodel.step(jstate, jp, noise_source="threefry")
        tstate, th = tmodel.step(tstate, tp, 0, noise_source="threefry",
                                 normals=torch.as_tensor(n))
        np.testing.assert_allclose(to_np(th.uf), np.asarray(jh.uf), rtol=0,
                                   atol=ATOL)
    assert tstate.step == 3
    for got, want in ((tstate.f, jstate.f), (tstate.g, jstate.g)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                                   atol=ATOL)
    # the port's own draw: a function of the word, unit normals scaled by
    # the amplitudes (finite, and not the zero of the noise-off step)
    s1, _ = tmodel.step(init_state(torch.as_tensor(f), torch.as_tensor(g), 9),
                        tp, 1234, noise_source="threefry")
    s2, _ = tmodel.step(init_state(torch.as_tensor(f), torch.as_tensor(g), 9),
                        tp, 1234, noise_source="threefry")
    s0, _ = tmodel.step(init_state(torch.as_tensor(f), torch.as_tensor(g), 9),
                        TParams(**dict(KW, kBT=0.0)), 1234,
                        noise_source="threefry")
    assert torch.equal(s1.f, s2.f) and torch.isfinite(s1.f).all()
    assert not torch.equal(s1.f, s0.f)


def _iface_cfg(tmp, name, **kw):
    opts = dict(shape=(4, 16, 8), init="stripe", nsteps=20, step_continue=0,
                plot_int=5, print_int=10, out_dir=os.path.join(tmp, name))
    return preset("interface-fluct").replace(**dict(opts, **kw))


def _frames(cfg, **kw):
    frames = {}
    state = trun.run(cfg, device="cpu",
                     on_frame=lambda s, p: frames.__setitem__(s, p.clone()),
                     **kw)
    return state, frames


def test_run_jnp_hash_matches_kernel_session(tmp_path):
    cfg = _iface_cfg(str(tmp_path), "kernel")
    ks, kf = _frames(cfg, mass_restore_int=0)
    ps, pf = _frames(_iface_cfg(str(tmp_path), "plain", noise_source="hash"),
                     engine="jnp")
    assert sorted(kf) == sorted(pf) == [0, 5, 10, 15, 20]
    for s in kf:
        np.testing.assert_allclose(to_np(pf[s]), to_np(kf[s]), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(to_np(ps.f), to_np(ks.f), rtol=0, atol=ATOL)
    assert ps.step == ks.step == 20
    # the non-default source resolves auto to the plain engine
    _, af = _frames(_iface_cfg(str(tmp_path), "auto", noise_source="hash"))
    assert all(torch.equal(af[s], pf[s]) for s in pf)


def test_bulk_run_restarts_bitwise(tmp_path):
    tmp = str(tmp_path)
    whole = trun.run(_iface_cfg(tmp, "whole", plot_int=0, print_int=0),
                     device="cpu", engine="jnp")
    trun.run(_iface_cfg(tmp, "first", nsteps=10, plot_int=0, print_int=0),
             device="cpu", engine="jnp")
    rest = trun.run(_iface_cfg(
        tmp, "rest", nsteps=10, step_continue=10, init="checkpoint",
        checkpoint_path=os.path.join(tmp, "first", "checkpoint0000010"),
        plot_int=0, print_int=0), device="cpu", engine="jnp")
    assert rest.step == whole.step == 20
    assert torch.equal(rest.f, whole.f) and torch.equal(rest.g, whole.g)
    # the checkpoint holds the final state; the noise was on: the
    # trajectory differs from the hash stream's
    stored = ckpt.load_state(os.path.join(tmp, "whole", "checkpoint0000020"),
                             device="cpu")
    assert torch.equal(stored.f, whole.f)
    other = trun.run(_iface_cfg(tmp, "hash", plot_int=0, print_int=0,
                                noise_source="hash"), device="cpu")
    assert not torch.equal(other.f, whole.f)


@pytest.mark.parametrize("source,dist", [
    ("threefry", "clt4"), ("hash", "clt4"), ("hash", "u8")])
def test_chunk_replay_is_the_eager_chunk(source, dist):
    """The graph path's bookkeeping on the CPU: the chunk's bulk normals
    drawn into the static buffer or the hash stream's keys written into
    theirs, the chunk stepped from them (a replay stands in for the
    captured graph), then the eager remainder: 23 steps (2 chunks of
    GRAPH_STEPS and 3 eager) bitwise the eager steps."""
    shape = (4, 6, 8)
    f, g = _interface(shape, 3)
    tp = TParams(**KW)
    eager = plain_session.PlainSession(tp, shape, noise_source=source,
                                       noise_dist=dist, device="cpu")
    chunked = plain_session.PlainSession(tp, shape, noise_source=source,
                                         noise_dist=dist, device="cpu",
                                         graph=True)

    def capture(pc, s=chunked):
        s._allocate(pc)
        s._graph = type("Replay", (), {"replay": lambda _: s._chunk()})()

    chunked._capture = capture
    a = init_state(torch.as_tensor(f), torch.as_tensor(g), 21)
    b = init_state(torch.as_tensor(f), torch.as_tensor(g), 21)
    a = eager.advance(eager.enter(a), 22)
    b = chunked.advance(chunked.enter(b), 22)
    assert plain_session.GRAPH_STEPS == 10
    assert chunked.graph_replays == 2 and chunked.eager_steps == 3
    assert a.step == b.step == 23
    out = chunked.exit(b)
    assert out.f is not chunked._f
    assert torch.equal(out.f, a.f) and torch.equal(out.g, a.g)
    assert draw_words(a.gen, 1) == draw_words(b.gen, 1)
    # the hash stream drawn inside the chunk, from its keys
    assert (chunked._keys is not None) == (source == "hash")


@pytest.mark.parametrize("dist", ["u8", "clt4", "clt2", "bm"])
def test_hash_stream_from_tensor_keys_is_bitwise(dist):
    """hash_normal_stack keyed by 0-dim int64 tensors (what a captured
    chunk reads from device memory) is the stream keyed by ints."""
    shape = (4, 6, 8)
    for word, step in ((-123456789, 7), (2 ** 31 - 1, 1_000_003)):
        got = tnoise.hash_normal_stack(torch.tensor(word), torch.tensor(step),
                                       shape, torch.float32, dist)
        want = tnoise.hash_normal_stack(word, step, shape, torch.float32,
                                        dist)
        assert torch.equal(got, want)


def _parsed(module, argv, monkeypatch):
    got = {}

    def fake(cfg, **kw):
        got.update(kw, noise_source=cfg.noise_source)
        return type("S", (), {"step": 0})()

    monkeypatch.setattr(module, "run", fake)
    module.main(argv + ["--shape", "4", "4", "8", "--nsteps", "1"])
    return got["engine"], got["noise_source"]


@pytest.mark.parametrize("argv", [
    [], ["--engine", "jnp"], ["--noise-source", "hash"],
    ["--engine", "jnp", "--noise-source", "hash"],
    ["--engine", "jnp", "--noise-source", "threefry"],
    ["--noise-source", "threefry"],
])
def test_cli_parses_and_resolves_as_jax(argv, monkeypatch, capsys):
    engine, source = _parsed(trun, argv, monkeypatch)
    assert (engine, source) == _parsed(jrun, argv, monkeypatch)
    # JAX's rule: a non-default source is the jnp engine
    want = "jnp" if (engine == "jnp" or source != "threefry") else "kernel"
    assert trun.resolve_engine(engine, source) == want
    capsys.readouterr()


def test_kernel_engine_with_hash_raises_as_jax(tmp_path):
    jcfg = jpreset("interface-fluct").replace(
        shape=(4, 8, 8), init="stripe", nsteps=1, step_continue=0,
        noise_source="hash", out_dir=str(tmp_path / "jax"), dtype=F32)
    for engine in ("pallas", "halo"):
        with pytest.raises(ValueError, match="noise_source"):
            jrun.run(jcfg, engine=engine)
    tcfg = _iface_cfg(str(tmp_path), "port", noise_source="hash")
    with pytest.raises(ValueError, match="noise_source"):
        trun.run(tcfg, device="cpu", engine="kernel")
    for engine in ("pallas", "halo"):
        with pytest.raises(ValueError, match="not ported"):
            trun.resolve_engine(engine, "threefry")
    with pytest.raises(ValueError, match="no mesh"):
        trun.run(_iface_cfg(str(tmp_path), "m"), device="cpu", engine="jnp",
                 block=2)
    with pytest.raises(SystemExit):
        trun.main(["--engine", "pallas"])


def test_bulk_normals_moments():
    shape = (16, 16, 16)
    n = tnoise.bulk_normal_stack(-123456789, 5, shape)
    assert n.shape == (33,) + shape and n.dtype == torch.float32
    assert torch.equal(n, tnoise.bulk_normal_stack(-123456789, 5, shape))
    x = n.reshape(33, -1).double()
    cells = x.shape[1]
    sig = 1.0 / np.sqrt(cells)
    mean = x.mean(dim=1)
    assert mean.abs().max() <= 5 * sig
    var = x.var(dim=1)
    assert (var - 1).abs().max() <= 5 * np.sqrt(2.0 / cells)
    cov = torch.cov(x)
    off = cov[~torch.eye(33, dtype=torch.bool)]
    assert off.abs().max() <= 5 * sig
    # two words: uncorrelated draws
    m = tnoise.bulk_normal_stack(987654, 5, shape).reshape(33, -1).double()
    assert ((x * m).mean(dim=1)).abs().max() <= 5 * sig


def test_bulk_normals_keyed_by_word_and_step():
    """Two steps that draw the same word draw different, uncorrelated
    normals (the key is (step, word), as the hash stream's); the same
    (word, step) draws the same bits, into `out` too."""
    shape = (8, 8, 8)
    word = -123456789
    a = tnoise.bulk_normal_stack(word, 7, shape)
    b = tnoise.bulk_normal_stack(word, 8, shape)
    c = tnoise.bulk_normal_stack(word, 7 + 2 ** 20, shape)
    out = torch.empty_like(a)
    assert torch.equal(a, tnoise.bulk_normal_stack(word, 7, shape, out=out))
    assert torch.equal(out, a)
    sig = 1.0 / np.sqrt(a.numel())
    for other in (b, c):
        assert not torch.equal(a, other)
        assert abs(float((a.double() * other.double()).mean())) <= 5 * sig
    # distinct keys, distinct seeds (a bijection of (step, word))
    keys = [(w, st) for w in (0, 1, -1, word) for st in (0, 1, 2 ** 31)]
    assert len({tnoise.bulk_seed(w, st) for w, st in keys}) == len(keys)
    # through the step: the same word at another step, another trajectory
    f, g = _interface((4, 6, 8), 3)
    tp = TParams(**KW)
    s0 = init_state(torch.as_tensor(f), torch.as_tensor(g), 9)
    s1 = s0.replace(step=1)
    n0 = tmodel.prelude(s0, tp, word, noise_source="threefry")[1]
    n1 = tmodel.prelude(s1, tp, word, noise_source="threefry")[1]
    assert not torch.equal(n0, n1)
