"""K4, T K steps per sweep (temporal blocking), on the CPU.

The port's plain blocked sweep (``ops.blocked.blocked_sweep_reference``,
the plain version of ``csrc/blocked_step.cu``, tile for tile) against
JAX's blocked Pallas kernel in interpret mode and against composed
one-step K calls, uncoupled (stencil depth 1), with the Shan-Chen force
(depth 2) and with alpha1 (depth 3); ``FusedSession(block=T)`` against
the block-1 composition with JAX's restore rule; the refusals and the
sessions' default block.
Tolerances: against JAX, those of ``tests/test_fused_kernel.py::
test_blocked_equals_composed_with_noise`` (rtol 5e-4, atol 5e-7, the sums
to 1e-6: another transform order); against the port's own composition
atol 2e-6 (the same arithmetic; bitwise equality is printed).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import jax_words, perturbed_pops, to_np, to_torch

import jax
from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels.fused_step import _fused_step_call
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.kernels.session import (FusedSession, ShardedSession,
                                             make_session)
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.ops import blocked
from bflbm_tpu_torch.parallel import mesh as tmesh_lib
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-6
SHAPE = (8, 10, 12)   # no kernel tile divides it (y by 8, z by 32/16/8)
WORDS = [1234567, -987654, 55555, -3, 2 ** 30]
MODES = {   # name -> (LBMParams kwargs, generator, with the ref operand)
    "off": (dict(kBT=0.0), "u8", False),
    "u8": (dict(kBT=1e-5), "u8", False),
    "clt4": (dict(kBT=1e-5), "clt4", False),
    "clt2": (dict(kBT=1e-5), "clt2", False),
    "bm": (dict(kBT=1e-5), "bm", False),
    "ref": (dict(kBT=1e-5), "clt4", True),
    "general": (dict(kBT=1e-5, tau_f=0.7, tau_g=0.6), "clt4", False),
}


def _state(shape, seed):
    return tuple(to_torch(a) for a in perturbed_pops(shape, seed))


def _ref_operand(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (1.0 + 0.1 * rng.standard_normal((2,) + shape)).astype(np.float32))


def _composed(f, g, words, step0, params, dist, ref=None):
    for s, w in enumerate(words):
        f, g = tfs.k_step_reference(f, g, w, step0 + s, params, dist, ref)
    return f, g


def test_plain_sweep_matches_jax_blocked_kernel():
    """One T = 2 sweep of the port's plain blocked version against JAX's
    blocked kernel (``block=2, noise_impl="hash"``, interpret mode) on
    the same words and step, uncoupled, clt4."""
    shape = (8, 8, 8)
    f, g = perturbed_pops(shape, 91)
    w0, w1, s0 = 1234567, -987654, 42
    with pltpu.force_tpu_interpret_mode():
        jf, jg = _fused_step_call(
            JParams(alpha0=0.0, kBT=1e-5), shape, (8, 8), True,
            jnp.asarray([w0, w1, s0], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=2, noise_impl="hash", transform="mxu")
    tp = TParams(alpha0=0.0, kBT=1e-5)
    tf, tg = blocked.blocked_sweep_reference(
        to_torch(f), to_torch(g), [w0, w1], s0, tp, 2,
        tfs.blocked_tile(2, shape), "clt4")
    np.testing.assert_allclose(to_np(tf), np.asarray(jf), rtol=5e-4,
                               atol=5e-7)
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=5e-4,
                               atol=5e-7)
    np.testing.assert_allclose(float(tf.double().sum()),
                               float(np.asarray(jf, np.float64).sum()),
                               rtol=1e-6)


_DROPLET = dict(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=1e-5)
_ALPHA1 = dict(_DROPLET, alpha0=1.2, alpha1=0.5, rho_lo=0.1)
# with a force: (stencil depth tag, T) -> LBMParams keywords of the force
FORCE_CASES = {("coupled", 2): _DROPLET, ("coupled", 3): _DROPLET,
               ("alpha1", 2): _ALPHA1}


def _droplet_state(shape, params, seed):
    base = tmodel.init_droplet(shape, params, device="cpu", radius=0.3)
    return tmodel.perturbed_populations(shape, seed, base=base,
                                        device="cpu")


@pytest.mark.parametrize("kw", [_DROPLET, _ALPHA1],
                         ids=["coupled", "alpha1"])
def test_plain_sweep_with_force_matches_jax_blocked_kernel(kw):
    """One T = 2 sweep with the Shan-Chen force (the alpha0 = 1.5 droplet,
    stencil depth 2) and with alpha1 (depth 3) against JAX's blocked
    kernel in interpret mode, which recomputes psi and its laplacian
    inside each phase, on the same perturbed droplet, words and step."""
    shape = (8, 8, 8)
    tp = TParams(**kw)
    f, g = (to_np(a) for a in _droplet_state(shape, tp, 99))
    w0, w1, s0 = 1234567, -987654, 42
    with pltpu.force_tpu_interpret_mode():
        jf, jg = _fused_step_call(
            JParams(**kw), shape, (8, 8), True,
            jnp.asarray([w0, w1, s0], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=2, noise_impl="hash", transform="mxu")
    tf, tg = blocked.blocked_sweep_reference(
        to_torch(f), to_torch(g), [w0, w1], s0, tp, 2,
        tfs.blocked_tile(2, shape, tfs.sd_depth(tp)), "clt4")
    for a, b in ((tf, jf), (tg, jg)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=5e-4,
                                   atol=5e-7)
        np.testing.assert_allclose(float(a.double().sum()),
                                   float(np.asarray(b, np.float64).sum()),
                                   rtol=1e-6)


@pytest.mark.parametrize("case", sorted(FORCE_CASES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_sweep_with_force_equals_composition(case, mode):
    """With a force, tiling with recomputed seams still equals
    composition: the plain sweep on the kernel's tiles at stencil depth 2
    (T = 2, 3) and 3 (T = 2) against T one-step plain K calls."""
    _, T = case
    kw, dist, with_ref = MODES[mode]
    params = TParams(**dict(FORCE_CASES[case], **kw))
    f, g = _droplet_state(SHAPE, params, 100)
    ref = _ref_operand(SHAPE, 93) if with_ref else None
    got = blocked.blocked_sweep_reference(
        f, g, WORDS[:T], 40, params, T,
        tfs.blocked_tile(T, SHAPE, tfs.sd_depth(params)), dist, ref)
    want = _composed(f, g, WORDS[:T], 40, params, dist, ref)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"{case} {mode}: max |sweep - composed| = {err:.3e}, bitwise "
          f"{all(torch.equal(a, b) for a, b in zip(got, want))}")
    assert err <= ATOL


K4_ODD = (20, 12, 40)   # a shape no cluster tile divides


@pytest.mark.parametrize("shape", [(16, 16, 16), K4_ODD],
                         ids=["16^3", "20x12x40"])
@pytest.mark.parametrize("sd,T", [(2, 2), (2, 3), (3, 2)])
def test_plain_sweep_on_cluster_tiles_is_composition(sd, T, shape):
    """The plain sweep on the tiles that the kernel's clusters march (each
    block's sub-tile times the cluster, ``fused_step.blocked_cluster``) is
    bitwise T composed plain one-step K calls: a cluster computes every
    cell of its tile from the same inputs as one block of that tile."""
    kw = {2: _DROPLET, 3: _ALPHA1}[sd]
    params = TParams(**kw)
    assert tfs.sd_depth(params) == sd
    _, by, bz = tfs.blocked_tile(T, shape, sd)
    cy, cz = tfs.blocked_cluster(T, sd)
    f, g = _droplet_state(shape, params, 101)
    got = blocked.blocked_sweep_reference(f, g, WORDS[:T], 40, params, T,
                                          (shape[0], cy * by, cz * bz),
                                          "clt4")
    want = _composed(f, g, WORDS[:T], 40, params, "clt4")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cluster_table_fits_a_block():
    """Every (sd, T) entry: its sub-tile's shared memory fits a block, its
    warp groups (a warp at least a phase) hold at most 384 threads in
    multiples of 32, its cluster at most 8 blocks, and a sub-tile spans
    at least sd cells across an axis that its cluster spans (a pushed
    cell goes to the next block only)."""
    assert set(tfs._BLOCKED_CLUSTERS) == set(tfs._BLOCKED_SECTIONS)
    for (sd, T), (by, bz) in tfs._BLOCKED_SECTIONS.items():
        cy, cz = tfs.blocked_cluster(T, sd)
        tile = (8, by, bz)
        assert tfs.blocked_smem_bytes(T, tile, sd) <= tfs.SMEM_PER_BLOCK
        assert 1 <= cy * cz <= tfs.MAX_CLUSTER
        assert (cy == 1 or by >= sd) and (cz == 1 or bz >= sd)
        for cluster in ((1, 1), (cy, cz)):
            threads = tfs.blocked_threads(T, tile, sd, cluster)
            assert len(threads) == T and sum(threads) <= 384
            assert all(t >= 32 and t % 32 == 0 for t in threads)
            # the phases' threads shrink with their regions
            assert list(threads) == sorted(threads, reverse=True)
    assert tfs.blocked_cluster(7, 1) == (1, 1)


@pytest.mark.parametrize("sd,T,tile", [(1, 2, (8, 32)), (1, 4, (4, 8)),
                                       (2, 2, (8, 16)), (2, 3, (2, 6)),
                                       (3, 2, (4, 16)), (3, 2, (5, 3))])
def test_blocked_smem_bytes_is_the_source_formula(sd, T, tile):
    """blocked_smem_bytes per block is the formula of
    ``csrc/blocked_step.cu`` bflbm_blocked_smem, written out: 8 bytes for
    each of 2 (T - 1) (sd + 3) mbarriers rounded up to 16, then 4 bytes a
    float of every phase's rings on its region (by + 2 p) x (bz + 2 p),
    p = sd (T - 1 - s): sd + 3 planes of 38 populations but in the last
    phase, with a force 3 (4 under alpha1) psi planes of 2 fields grown by
    sd - 1, under alpha1 3 laplacian planes of 2 grown by 1."""
    by, bz = tile
    floats = 0
    for s in range(T):
        p = sd * (T - 1 - s)
        ny, nz = by + 2 * p, bz + 2 * p
        if s < T - 1:
            floats += (sd + 3) * 38 * ny * nz
        if sd > 1:
            floats += (4 if sd == 3 else 3) * 2 * (ny + 2 * sd - 2) * (
                nz + 2 * sd - 2)
        if sd == 3:
            floats += 3 * 2 * (ny + 2) * (nz + 2)
    bars = 2 * (T - 1) * (sd + 3) * 8
    assert tfs.blocked_smem_bytes(T, (4,) + tile, sd) \
        == (bars + 15) // 16 * 16 + 4 * floats


@pytest.mark.parametrize("T", [2, 3, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_sweep_equals_composition(T, mode):
    """Tiling with recomputed seams equals composition: the plain sweep on
    the kernel's tiles (which do not divide SHAPE) against T one-step
    plain K calls with the same words."""
    kw, dist, with_ref = MODES[mode]
    params = TParams(**kw)
    f, g = _state(SHAPE, 92)
    ref = _ref_operand(SHAPE, 93) if with_ref else None
    got = blocked.blocked_sweep_reference(
        f, g, WORDS[:T], 40, params, T, tfs.blocked_tile(T, SHAPE), dist, ref)
    want = _composed(f, g, WORDS[:T], 40, params, dist, ref)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"T={T} {mode}: max |sweep - composed| = {err:.3e}, bitwise "
          f"{all(torch.equal(a, b) for a, b in zip(got, want))}")
    assert err <= ATOL


@pytest.mark.parametrize("T,tile,kw", [
    (2, (3, 4, 5), {}), (3, (5, 3, 7), {}), (4, (2, 2, 16), {}),
    (2, (3, 4, 5), _DROPLET), (3, (5, 3, 7), _DROPLET),
    (2, (2, 4, 6), _ALPHA1)])
def test_plain_sweep_small_tiles(T, tile, kw):
    """Many tiles a domain, seams on every axis: still the composition,
    at every stencil depth."""
    params = TParams(**dict(kw, kBT=1e-5))
    f, g = (_droplet_state(SHAPE, params, 94) if kw else _state(SHAPE, 94))
    got = blocked.blocked_sweep_reference(f, g, WORDS[:T], 7, params, T,
                                          tile, "clt4")
    want = _composed(f, g, WORDS[:T], 7, params, "clt4")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"T={T} tile {tile}: max |sweep - composed| = {err:.3e}")
    assert err <= ATOL


def test_tile_boxes_cover_the_domain():
    seen = torch.zeros(SHAPE, dtype=torch.int64)
    for box in blocked.tile_boxes(SHAPE, (3, 4, 5)):
        keep = tuple((a, min(b, n)) for (a, b), n in zip(box, SHAPE))
        blocked.box_view(seen, keep).add_(1)
    assert bool((seen == 1).all())
    xs = torch.arange(-3, 9)
    got = blocked.periodic_box(xs.view(1, 1, -1), ((0, 1), (0, 1), (-2, 14)))
    assert torch.equal(got[0, 0], torch.cat([xs[-2:], xs, xs[:2]]))


def _session(params, words, chunks, block, restore, dist="u8"):
    f, g = (_droplet_state(SHAPE, params, 95) if tfs.is_coupled(params)
            else _state(SHAPE, 95))
    sess = FusedSession(params, SHAPE, noise_dist=dist,
                        mass_restore_int=restore, block=block)
    pc = sess.enter(tinit(f, g, 5), words[0])
    used = 1
    for c in chunks:
        pc = sess.advance(pc, c, words[used:used + c])
        used += c
    return pc


def _restores(monkeypatch):
    steps = []
    real = tfs.mass_restore_step

    def record(st, m0f, m0g):
        steps.append(st.step)
        return real(st, m0f, m0g)

    monkeypatch.setattr(tfs, "mass_restore_step", record)
    return steps


@pytest.mark.parametrize("kw", [dict(kBT=1e-5), _DROPLET, _ALPHA1],
                         ids=["uncoupled", "coupled", "alpha1"])
def test_session_chunks_of_whole_sweeps_are_bitwise(monkeypatch, kw):
    """FusedSession(block=2, mass_restore_int=3): chunks [2, 2, 2] equal
    [6] bitwise (the same sweeps), and the restores land on the sweep
    ends that crossed a multiple of 3: steps 3 and 7, not 6, as in JAX;
    uncoupled, on the droplet and with alpha1."""
    steps = _restores(monkeypatch)
    p = TParams(**kw)
    words = [9 * k - 4 for k in range(7)]
    a = _session(p, words, (6,), 2, 3)
    assert steps == [3, 7]
    b = _session(p, words, (2, 2, 2), 2, 3)
    assert a.step == b.step == 7
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)


def test_session_other_split_within_restore_rounding(monkeypatch):
    """[2, 3, 1] (sweeps, then a sweep and a single step, then a single
    step) against [6]: the restore lands after step 6 instead of 7, so
    the two agree to the restore's rounding only."""
    steps = _restores(monkeypatch)
    p = TParams(kBT=1e-5)
    words = [9 * k - 4 for k in range(7)]
    a = _session(p, words, (6,), 2, 3)
    b = _session(p, words, (2, 3, 1), 2, 3)
    assert steps == [3, 7, 3, 6]
    err = max(float((a.f - b.f).abs().max()), float((a.g - b.g).abs().max()))
    assert 0 < err <= 1e-5


@pytest.mark.parametrize("mode", ["u8", "ref", "general", "coupled clt4",
                                  "coupled ref", "alpha1 general"])
def test_session_equals_block1_composition(mode):
    """A block-2 session against one-step plain K calls with the mass
    restore applied where JAX's rule puts it (after each sweep or single
    step that crossed a multiple of the interval), uncoupled and with
    the force of the droplet and of alpha1."""
    force = {"coupled": _DROPLET, "alpha1": _ALPHA1}.get(mode.split()[0], {})
    kw, dist, with_ref = MODES[mode.split()[-1]]
    p = TParams(**dict(force, **kw))
    words = [5 * k + 1 for k in range(8)]
    f, g = _droplet_state(SHAPE, p, 95) if force else _state(SHAPE, 95)
    ref_fields = None
    if with_ref:
        rho = f.sum(0) + 0.01
        ref_fields = (rho, g.sum(0) + 0.01, torch.tensor([3.5, 4.5, 5.5],
                                                         dtype=torch.float64))
    sess = FusedSession(p, SHAPE, noise_dist=dist, mass_restore_int=3,
                        block=2, ref_fields=ref_fields)
    pc = sess.enter(tinit(f, g, 5), words[0])
    want = pc.replace(f=pc.f.clone(), g=pc.g.clone())
    m0 = sess._m0
    ref = sess._ref_operand(sess._ref_shift(pc.f)) if with_ref else None
    got = sess.advance(pc, 7, words[1:])
    steps = [2, 2, 2, 1]
    used = 1
    for n in steps:
        prev = want.step
        fa, ga = _composed(want.f, want.g, words[used:used + n], want.step,
                           p, dist, ref)
        want = tfs._maybe_restore(prev, want.replace(f=fa, g=ga,
                                                     step=prev + n),
                                  (3,) + tuple(m0))
        used += n
    if with_ref:   # no COM crossing here: one roll for the whole advance
        assert sess.ref_violations() == 0 and sess.ref_retry_steps == 0
    err = max(float((got.f - want.f).abs().max()),
              float((got.g - want.g).abs().max()))
    print(f"{mode}: max |session - composition| = {err:.3e}, bitwise "
          f"{torch.equal(got.f, want.f) and torch.equal(got.g, want.g)}")
    assert got.step == want.step == 8 and err <= ATOL


def test_make_ksteps_runs_sweeps_then_singles(monkeypatch):
    """An advance of n at block T is n // T sweeps of T words each, then
    n % T single steps; T is cut to n."""
    calls = []
    real_b, real_k = tfs.blocked_stream_collide, tfs.fused_stream_collide

    def blocked_(f, g, words, step0, params, T, *a, **kw):
        calls.append(("sweep", step0, T, list(words)))
        return real_b(f, g, words, step0, params, T, *a, **kw)

    def single(f, g, word, step, *a, **kw):
        calls.append(("single", step, 1, [word]))
        return real_k(f, g, word, step, *a, **kw)

    monkeypatch.setattr(tfs, "blocked_stream_collide", blocked_)
    monkeypatch.setattr(tfs, "fused_stream_collide", single)
    p = TParams(kBT=1e-5)
    f, g = _state(SHAPE, 96)
    out = tfs.make_ksteps(p, 7, block=3, noise_dist="u8")(
        tinit(f, g, 0, step=10), list(range(7)))
    assert out.step == 17
    assert calls == [("sweep", 10, 3, [0, 1, 2]), ("sweep", 13, 3, [3, 4, 5]),
                     ("single", 16, 1, [6])]
    calls.clear()
    tfs.make_ksteps(p, 2, block=4, noise_dist="u8")(tinit(f, g, 0), [8, 9])
    assert calls == [("sweep", 0, 2, [8, 9])]


def test_blocked_session_matches_jax_hash_chain():
    """The slice as a whole: FusedSession(block=2) over 9 K steps (four
    sweeps and a single step) against JAX's all-hash jnp chain fed the
    same words (atol 2e-5, as tests/test_torch_session.py)."""
    shape = (16, 16, 16)
    f, g = perturbed_pops(shape, 41)
    _, words = jax_words(jax.random.PRNGKey(4), 10)
    one = jax.jit(lambda s: jmodel.step(s, JParams(kBT=1e-5),
                                        noise_source="hash",
                                        noise_dist="u8")[0])
    st = jinit(jnp.asarray(f), jnp.asarray(g), 4)
    for _ in range(10):
        st = one(st)
    sess = FusedSession(TParams(kBT=1e-5), shape, mass_restore_int=0,
                        noise_dist="u8", block=2)
    pc = sess.enter(tinit(to_torch(f), to_torch(g), 4), words[0])
    got = sess.exit(sess.advance(pc, 9, words[1:]))
    assert got.step == int(st.step) == 10
    np.testing.assert_allclose(to_np(got.f), np.asarray(st.f), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(to_np(got.g), np.asarray(st.g), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("kw", [_DROPLET, _ALPHA1])
def test_coupled_and_alpha1_take_block(kw, monkeypatch):
    """The coupled and alpha1 configurations run at block 2:
    FusedSession, make_session, make_ksteps (one sweep, no pre-pass
    scratch) and blocked_stream_collide (the plain sweep on the CPU)."""
    p = TParams(**kw)
    f, g = _droplet_state(SHAPE, p, 97)
    assert FusedSession(p, SHAPE, block=2).block_for(100) == 2
    assert make_session(p, SHAPE, block=2).block_for(5) == 2
    calls = []
    real = tfs.blocked_stream_collide

    def record(f_, g_, words, step0, params, T, *a, **kwargs):
        calls.append((step0, T))
        return real(f_, g_, words, step0, params, T, *a, **kwargs)

    monkeypatch.setattr(tfs, "blocked_stream_collide", record)
    out = tfs.make_ksteps(p, 2, block=2)(tinit(f, g, 0, step=4), [1, 2])
    assert out.step == 6 and calls == [(4, 2)]
    fo, go = real(f, g, [1, 2], 4, p, 2)
    assert torch.equal(fo, out.f) and torch.equal(go, out.g)
    fo, go = real(f, g, [1], 4, p, 1)
    want = tfs.k_step_reference(f, g, 1, 4, p, "clt4")
    assert torch.equal(fo, want[0]) and torch.equal(go, want[1])


def test_mesh_takes_block():
    """The decomposed session takes the block: its pads are sd T deep on
    the sharded axis (tests/test_torch_blocked_mesh.py runs it)."""
    mesh = tmesh_lib.make_mesh((2, 1, 1), "cpu")
    p = TParams(kBT=1e-5)
    for sess, T in ((make_session(p, (16, 16, 16), mesh=mesh, block=2), 2),
                    (ShardedSession(mesh, p, (16, 16, 16), block=4), 4),
                    (make_session(p, (16, 16, 16), mesh=mesh, block=1), 1)):
        assert isinstance(sess, ShardedSession)
        assert sess.block == T and sess.pad == (T, 0, 0)


@pytest.mark.parametrize("T", [0, -1, 2.0, 9])
def test_bad_block_values_refused(T):
    with pytest.raises(ValueError, match="block"):
        FusedSession(TParams(kBT=1e-5), SHAPE, block=T)


def test_block_past_shared_memory_refused():
    """T = 5 on the 8 x 8 cross-section needs 423,424 bytes of shared
    memory a block, past the 232,448 a block holds: refused on the CPU
    too, since the plain version runs the kernel's tiles.  The sub-tiles'
    shared memory at every stencil depth (``csrc/blocked_step.cu``
    bflbm_blocked_smem: the mbarriers, sd + 3 population planes a phase but
    the last, the psi and laplacian rings), and every entry of the tile
    table fits a block."""
    p = TParams(kBT=1e-5)
    with pytest.raises(ValueError, match="423424 bytes"):
        FusedSession(p, SHAPE, block=5)
    f, g = _state(SHAPE, 98)
    with pytest.raises(ValueError, match="423424 bytes"):
        tfs.blocked_stream_collide(f, g, [1] * 5, 0, p, 5)
    assert tfs.blocked_smem_bytes(4, (8, 4, 8)) == 180160
    assert tfs.blocked_smem_bytes(2, (8, 8, 32)) == 206784
    assert tfs.blocked_smem_bytes(3, (8, 8, 8)) == 148480
    with pytest.raises(ValueError, match="words"):
        tfs.blocked_stream_collide(f, g, [1, 2, 3], 0, p, 2)
    for sd, T, tile, need in ((2, 2, (8, 16), 194192),
                              (2, 3, (4, 8), 229888),
                              (3, 2, (4, 16), 227008)):
        assert tfs.blocked_smem_bytes(T, (8,) + tile, sd) == need
    for (sd, T), tile in tfs._BLOCKED_SECTIONS.items():
        assert tfs.blocked_tile(T, SHAPE, sd)[1:] == tile
        assert tfs.blocked_smem_bytes(T, (8,) + tile, sd) \
            <= tfs.SMEM_PER_BLOCK
        tfs.check_block(TParams(**{1: {}, 2: _DROPLET, 3: _ALPHA1}[sd]), T)


@pytest.mark.parametrize("kw,T,need", [(_DROPLET, 4, 368624),
                                       (_ALPHA1, 3, 358080)],
                         ids=["coupled T=4", "alpha1 T=3"])
def test_force_block_past_shared_memory_refused(kw, T, need):
    """Coupled T = 4 and alpha1 T = 3 fit no tile (4 x 4 the smallest):
    refused with the byte figure, before any launch or plain sweep."""
    p = TParams(**kw)
    f, g = _droplet_state(SHAPE, p, 98)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        FusedSession(p, SHAPE, block=T)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        tfs.blocked_stream_collide(f, g, [1] * T, 0, p, T)


@pytest.mark.parametrize("depth", ["", "coupled ", "alpha1 "])
def test_auto_block_table(depth):
    """A session given no block runs one step a launch in every mode at
    each stencil depth (plain, "coupled ", "alpha1 "), whatever the
    advance's length; a given block is kept."""
    force = {"": {}, "coupled ": _DROPLET, "alpha1 ": _ALPHA1}[depth]
    for kw, dist, use_ref in (
            (dict(kBT=0.0), "u8", False),
            (dict(kBT=1e-5), "u8", False),
            (dict(kBT=1e-5), "clt4", False),
            (dict(kBT=1e-5), "clt2", False),
            (dict(kBT=1e-5), "bm", False),
            (dict(kBT=1e-5), "clt4", True),
            (dict(kBT=1e-5, tau_f=0.7), "u8", False)):
        p = TParams(**dict(force, **kw))
        ref = ((torch.ones(SHAPE), torch.ones(SHAPE), (0.0, 0.0, 0.0))
               if use_ref else None)
        sess = FusedSession(p, SHAPE, noise_dist=dist, ref_fields=ref)
        assert sess.block == 1
        assert [sess.block_for(n) for n in (1, 2, 100)] == [1, 1, 1]
        assert FusedSession(p, SHAPE, noise_dist=dist,
                            block=2).block_for(1) == 2
        tfs.check_block(p, 1)


def test_run_block_option(tmp_path, monkeypatch):
    """run(cfg, block=) and --block reach make_session."""
    seen = []
    real = trun.make_session

    def record(*a, **kw):
        seen.append(kw.get("block"))
        return real(*a, **kw)

    monkeypatch.setattr(trun, "make_session", record)
    cfg = trun.preset("mixture-eq").replace(
        shape=(8, 8, 8), nsteps=5, plot_int=0, print_int=0, sf_window=0,
        t_window=0, out_dir=str(tmp_path / "a")).with_params(kBT=1e-5)
    a = trun.run(cfg, device="cpu", block=2)
    b = trun.run(dataclasses.replace(cfg, out_dir=str(tmp_path / "b")),
                 device="cpu", block=1)
    assert seen == [2, 1] and a.step == b.step == 5
    assert float((a.f - b.f).abs().max()) <= ATOL


def test_run_droplet_block(tmp_path, monkeypatch):
    """run(cfg, block=2) on the droplet-eq preset at 16^3 (depth 2): one
    sweep a 2 steps through make_session, the trajectory of block 1."""
    seen = []
    real = tfs.blocked_stream_collide

    def record(*a, **kw):
        seen.append(a[5])
        return real(*a, **kw)

    monkeypatch.setattr(tfs, "blocked_stream_collide", record)
    cfg = trun.preset("droplet-eq").replace(
        shape=(16, 16, 16), nsteps=5, plot_int=0, print_int=0, sf_window=0,
        t_window=0, out_dir=str(tmp_path / "a"))
    a = trun.run(cfg, device="cpu", block=2)
    assert seen == [2, 2]
    b = trun.run(dataclasses.replace(cfg, out_dir=str(tmp_path / "b")),
                 device="cpu", block=1)
    assert seen == [2, 2] and a.step == b.step == 5
    assert float((a.f - b.f).abs().max()) <= ATOL
