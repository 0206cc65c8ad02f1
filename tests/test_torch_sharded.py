"""The decomposed path of the PyTorch port (K7 ext mode, the sharded
session and ``run --mesh``) on the CPU, against the port's whole-domain
path and the JAX package.

Meshes are of CPU devices, a device repeated for every block (the
counterpart of the JAX tests' virtual devices), so every block runs the
plain ext versions of the kernels (:mod:`bflbm_tpu_torch.ops.blocked`).
The blocked step repeats the periodic step's arithmetic op for op on the
same values, so the decomposed trajectories are compared bitwise; the
mass restore sums in float64 in another order, so after a restore the
comparison is within TOL = 2e-5 (chip_smoke.py's kernel tolerance).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.parallel import kernel as jkernel_par
from bflbm_tpu.parallel import mesh as jmesh_lib
from bflbm_tpu_torch import config
from bflbm_tpu_torch import run as run_mod
from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.kernels.session import (FusedSession, ShardedSession,
                                             make_session)
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.observables import stats
from bflbm_tpu_torch.ops import blocked
from bflbm_tpu_torch.parallel import halo
from bflbm_tpu_torch.parallel import kernel as kernel_par
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.state import init_state

TOL = 2e-5
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)
# (params, generator, with a ref operand): the modes of the kernels
MODES = {
    "u8 uncoupled": (dict(kBT=1e-5), "u8", False),
    "clt4 alpha0": (dict(_DROP, alpha0=1.5, kBT=1e-5), "clt4", False),
    "alpha1": (dict(_DROP, alpha0=1.2, alpha1=0.5, kBT=1e-5), "clt4", False),
    "alpha1 without alpha0": (dict(_DROP, alpha1=0.5, kBT=1e-5), "clt4",
                              False),
    "general tau": (dict(_DROP, alpha0=1.5, kBT=1e-5, tau_f=0.7, tau_g=0.6),
                    "clt4", False),
    "ref": (dict(_DROP, alpha0=1.5, kBT=1e-5), "clt4", True),
    "pseudopotential clt2": (dict(_DROP, alpha0=1.5, kBT=1e-5,
                                  use_sc_pseudo=True), "clt2", False),
    "bm kBT 0": (dict(_DROP, alpha0=1.5), "bm", False),
}


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


def _droplet(shape, params, seed):
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    return model.perturbed_populations(shape, seed, base=base, device="cpu")


# -- mesh ---------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,shape,depth,ok", [
    ((2, 4, 1), (8, 32, 128), 2, True),
    ((2, 4, 1), (9, 32, 128), 1, False),     # not divisible
    ((2, 4, 1), (8, 32, 64), 2, True),       # no lane rule in the port
    ((1, 1, 8), (8, 32, 128), 3, True),      # z-sharded runs as it is
    ((8, 1, 1), (32, 8, 128), 3, True),      # local X 4
    ((8, 1, 1), (16, 8, 128), 2, True),      # local X 2 holds sd 2
    ((8, 1, 1), (16, 8, 128), 3, False),     # ... not alpha1's 3
    ((1, 1, 1), (5, 7, 9), 3, True),         # nothing sharded
])
def test_mesh_supports(mesh_shape, shape, depth, ok):
    """JAX's supports cases (tests/test_kernel_shard.py:284-310): the
    port keeps divisibility and the halo depth (sd of the configuration)
    and drops the TPU's lane rules and z restriction."""
    mesh = _cpu_mesh(mesh_shape)
    assert mesh.supports(shape, depth) is ok
    params = LBMParams(**{1: {}, 2: dict(alpha0=1.5),
                          3: dict(alpha0=1.5, alpha1=0.5)}[depth])
    assert kernel_par.supports(mesh, shape, params) is ok
    if ok:
        assert mesh.local_shape(shape) == tuple(
            s // m for s, m in zip(shape, mesh_shape))
    else:
        with pytest.raises(ValueError):
            ShardedSession(mesh, params, shape)


def test_make_mesh_devices():
    mesh = _cpu_mesh((2, 2, 1))
    assert mesh.size == 4 and mesh.sharded == (True, True, False)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert [mesh.coords(b) for b in range(4)] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert mesh.index((-1, 2, 5)) == mesh.index((1, 0, 0)) == 2
    assert mesh_lib.make_mesh((1, 2, 1), ["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        mesh_lib.make_mesh((2, 2, 1), ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_lib.make_mesh((2, 1, 1))


@pytest.mark.parametrize("mesh_shape", [(2, 4, 1), (1, 2, 2), (2, 1, 2),
                                        (1, 1, 8)])
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_shard_gather_round_trip(mesh_shape, depth):
    shape = (8, 16, 24)
    f, g = model.perturbed_populations(shape, 3, device="cpu")
    st = init_state(f, g, 0, step=17)
    mesh = _cpu_mesh(mesh_shape)
    pad = mesh.pads(depth)
    ss = mesh_lib.shard_state(st, mesh, pad)
    assert ss.shape == shape and ss.step == 17 and ss.gen is st.gen
    loc = mesh.local_shape(shape)
    for b, blk in enumerate(ss.blocks):
        assert tuple(blk.shape) == (2, 19) + tuple(
            n + 2 * p for n, p in zip(loc, pad))
        o = mesh.origin(b, shape)
        want = torch.stack([f, g])[:, :, o[0]:o[0] + loc[0],
                                   o[1]:o[1] + loc[1], o[2]:o[2] + loc[2]]
        assert torch.equal(mesh_lib.interior(blk, pad), want)
    back = mesh_lib.gather_state(ss)
    assert torch.equal(back.f, f) and torch.equal(back.g, g)
    assert back.step == 17


# -- hash words with an origin ------------------------------------------------

@pytest.mark.parametrize("origin,region,domain", [
    ((0, 0), (16, 12, 8), (16, 12, 8)),
    ((4, 6), (4, 6, 8), (16, 12, 8)),
    ((-3, 10), (5, 7, 16), (8, 12, 16)),     # wraps on x and y
])
def test_hash_words_origin_matches_jax(origin, region, domain):
    """The port's hash_words at a block origin equals JAX's
    hash_words(word, step, origin, region, domain) to the bit."""
    word, step, n = -1234567, 4321, 5
    want = jfs.hash_words(jnp.int32(word), jnp.int32(step), origin, region,
                          domain, n)
    got = fused_step.hash_words(word, step, region, n, None,
                                origin + (0,), domain)
    for w, t in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64), to_np(t))


def test_hash_words_block_is_slice_of_domain():
    """A block's words are the domain's at its cells, z origin included
    (the port shards z too)."""
    domain = (8, 12, 16)
    whole = fused_step.hash_words(77, 5, domain, 3)
    block = fused_step.hash_words(77, 5, (4, 6, 8), 3, None, (4, 6, 8),
                                  domain)
    for w, b in zip(whole, block):
        assert torch.equal(w[4:8, 6:12, 8:16], b)


# -- halo exchange ------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,depth", [((2, 4, 1), 1), ((1, 2, 2), 2),
                                              ((2, 1, 2), 3), ((2, 2, 2), 2),
                                              ((3, 1, 1), 2)])
def test_exchange_halo_matches_periodic_pad(mesh_shape, depth):
    """After one exchange every padded block equals its window of the
    numpy periodic pad of the global field, edges and corners included."""
    shape = (12, 16, 12)
    rng = np.random.default_rng(5)
    field = rng.standard_normal((2, 3) + shape).astype(np.float32)
    mesh = _cpu_mesh(mesh_shape)
    pad = mesh.pads(depth)
    blocks = mesh_lib.shard_field(torch.from_numpy(field), mesh, pad)
    halo.exchange_halo(blocks, mesh, pad)
    wrapped = np.pad(field, [(0, 0), (0, 0)] + [(p, p) for p in pad],
                     mode="wrap")
    loc = mesh.local_shape(shape)
    for b, blk in enumerate(blocks):
        o = mesh.origin(b, shape)
        want = wrapped[(slice(None), slice(None)) + tuple(
            slice(a, a + n + 2 * p) for a, n, p in zip(o, loc, pad))]
        np.testing.assert_array_equal(to_np(blk), want)


def test_halo_engine_matches_model_nsteps():
    """The plain halo engine (exchange + step_on_block) reproduces the
    whole-domain plain step chain bitwise."""
    params = LBMParams(**_DROP, alpha0=1.5, kBT=1e-5)
    shape = (8, 12, 16)
    f, g = _droplet(shape, params, 6)
    words = [3 * k + 1 for k in range(5)]
    want = model.nsteps(init_state(f.clone(), g.clone(), 0), params, 5,
                        words)
    got = halo.make_halo_nsteps(_cpu_mesh((2, 2, 1)), params, 5)(
        init_state(f, g, 0), words)
    assert got.step == want.step == 5
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)


# -- the plain ext kernels ----------------------------------------------------

def _blocks(f, g, mesh, params):
    pad = mesh.pads(blocked.sd_depth(params))
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    return ss, halo.block_exts(mesh, tuple(f.shape[1:]), pad)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (1, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ext_step_equals_periodic_step(mesh_shape, mode):
    """The plain ext K (``k_step_reference(..., ext=)``) on every block
    equals the plain periodic K's cells to the bit; so do the plain ext
    pre-passes A and L on their regions (interior + sd - 1, + sd - 2)."""
    kw, dist, with_ref = MODES[mode]
    params = LBMParams(**kw)
    shape = (8, 12, 16)
    f, g = _droplet(shape, params, 7)
    ref = (torch.stack([f.sum(0), g.sum(0)]).roll((1, -2, 3), (1, 2, 3))
           .contiguous() if with_ref else None)
    want = fused_step.k_step_reference(f, g, 2024, 37, params, dist, ref)
    psi = fused_step.density_psi_reference(f, g, params)
    lap = fused_step.laplacian_psi_reference(psi)
    mesh = _cpu_mesh(mesh_shape)
    ss, exts = _blocks(f, g, mesh, params)
    refs = (mesh_lib.shard_field(ref, mesh, ss.pad) if with_ref
            else [None] * mesh.size)
    sd = blocked.sd_depth(params)
    for blk, ext, r in zip(ss.blocks, exts, refs):
        cells = tuple(slice(o, o + n) for o, n in
                      zip(ext.origin, ext.interior(blk.shape)))
        fo, go = fused_step.k_step_reference(blk[0], blk[1], 2024, 37,
                                             params, dist, r, ext)
        assert torch.equal(fo, want[0][(slice(None),) + cells])
        assert torch.equal(go, want[1][(slice(None),) + cells])
        for got, whole, ring in (
                (fused_step.density_psi_reference(blk[0], blk[1], params,
                                                  ext), psi, sd - 1),
                (fused_step.laplacian_psi_reference(
                    fused_step.density_psi(blk[0], blk[1], params,
                                           ext=ext), ext)
                 if sd == 3 else None, lap, sd - 2)):
            if got is None:
                continue
            wrapped = np.pad(to_np(whole), [(0, 0)] + [
                (ring, ring) if p else (0, 0) for p in ext.pad], mode="wrap")
            win = tuple(slice(o, o + n + 2 * (ring if p else 0)) for o, n, p
                        in zip(ext.origin, ext.interior(blk.shape), ext.pad))
            np.testing.assert_array_equal(to_np(got),
                                          wrapped[(slice(None),) + win])


def test_ext_step_refuses_shallow_pads():
    params = LBMParams(alpha0=1.5, alpha1=0.5)
    f, g = model.perturbed_populations((8, 8, 8), 1, device="cpu")
    fp = torch.cat([f[:, -2:], f, f[:, :2]], dim=1)
    gp = torch.cat([g[:, -2:], g, g[:, :2]], dim=1)
    ext = blocked.Ext((2, 0, 0), (0, 0, 0), (8, 8, 8))
    with pytest.raises(ValueError, match="shallower"):
        fused_step.fused_stream_collide(fp, gp, 1, 1, params, ext=ext)
    with pytest.raises(ValueError, match="pads"):
        blocked.Ext((2, 1, 0), (0, 0, 0), (8, 8, 8))
    # the same block steps with alpha0 alone (sd 2): the interior sits at
    # the pad offset of the padded output
    p2 = LBMParams(alpha0=1.5)
    fo, go = fused_step.fused_stream_collide(fp, gp, 1, 1, p2, ext=ext)
    want = fused_step.k_step_reference(f, g, 1, 1, p2)
    assert fo.shape == fp.shape
    assert torch.equal(fo[:, 2:10], want[0]) and torch.equal(go[:, 2:10],
                                                             want[1])


# -- the sharded session ------------------------------------------------------

def _session(mesh, params, shape, f, g, words, chunks, restore, dist="clt4",
             ref_fields=None):
    sess = (ShardedSession(mesh, params, shape, noise_dist=dist,
                           mass_restore_int=restore, ref_fields=ref_fields)
            if mesh is not None else
            FusedSession(params, shape, noise_dist=dist,
                         mass_restore_int=restore, ref_fields=ref_fields))
    pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
    used = 1
    for c in chunks:
        pc = sess.advance(pc, c, words[used:used + c])
        used += c
    assert used == len(words)
    return sess, sess.exit(pc)


@pytest.mark.parametrize("mesh_shape", [(2, 4, 1), (1, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("mode", ["clt4 alpha0", "alpha1", "u8 uncoupled"])
def test_sharded_session_matches_fused_session(mesh_shape, mode):
    """1 + 3 + 4 steps: bitwise to FusedSession before the first mass
    restore (step 4 of a restore every 5 steps), within TOL after it (step
    8); the chunking of the two sessions differs."""
    kw, dist, _ = MODES[mode]
    params = LBMParams(**kw)
    shape = (16, 16, 16)
    f, g = _droplet(shape, params, 8)
    words = [101 * k - 7 for k in range(8)]
    mesh = _cpu_mesh(mesh_shape)
    for n, check in ((4, "bitwise"), (8, "tol")):
        _, want = _session(None, params, shape, f, g, words[:n], (n - 1,),
                           5, dist)
        _, got = _session(mesh, params, shape, f, g, words[:n],
                          (1, n - 2), 5, dist)
        assert got.step == want.step == n
        if check == "bitwise":
            assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)
        else:
            assert max(float((got.f - want.f).abs().max()),
                       float((got.g - want.g).abs().max())) <= TOL


def test_sharded_session_matches_jax_block1_kernel():
    """The port's sharded session against JAX's sharded kernel path at
    block 1 (make_kernel_nsteps, hash noise, interpret mode) on the
    conftest's virtual devices: tests/test_kernel_shard.py:42-58's
    configuration (coupled droplet, kBT = 0, 8 x 32 x 128, mesh
    (2, 4, 1), 5 steps), at its tolerance atol 2e-5."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    kw = dict(alpha0=1.5, kBT=0.0, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
    shape = (8, 32, 128)
    state = jmodel.init_droplet(shape, JParams(**kw), dtype=jnp.float32,
                                radius=0.3)
    jmesh = jmesh_lib.make_mesh((2, 4, 1), jax.devices()[:8])
    want = jkernel_par.make_kernel_nsteps(
        jmesh, JParams(**kw), 5, block=1, noise_impl="hash",
        transform="mxu", interpret=True, donate=False)(
        jmesh_lib.shard_state(state, jmesh))
    _, got = _session(_cpu_mesh((2, 4, 1)), LBMParams(**kw), shape,
                      to_torch(state.f), to_torch(state.g), [0] * 5, (4,),
                      0)
    assert got.step == int(want.step) == 5
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=TOL)


def test_sharded_ref_session_crossing_matches_single_block():
    """USE_REF_STATE across COM cell-boundary crossings: the sharded
    session (global COM, each block its slice of the rolled reference,
    the same transactional sub-chunks) equals the single-block ref
    session bitwise, rollbacks included."""
    params = LBMParams(alpha0=0.0, kBT=1e-8)
    shape = (8, 8, 128)
    state, rho, phi = model.boosted_state(shape, (0.0, 0.0, 0.35),
                                         device="cpu")
    ref = (rho, phi, stats.center_of_mass(rho))
    words = [11 * k + 5 for k in range(8)]
    a, want = _session(None, params, shape, state.f, state.g, words, (7,),
                       0, ref_fields=ref)
    b, got = _session(_cpu_mesh((2, 1, 2)), params, shape, state.f,
                      state.g, words, (7,), 0, ref_fields=ref)
    assert a.ref_violations() == b.ref_violations() > 0
    assert a.ref_retry_steps == b.ref_retry_steps > 0
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)


def test_make_session_picks_the_session():
    params = LBMParams(alpha0=1.5)
    shape = (8, 8, 8)
    assert type(make_session(params, shape)) is FusedSession
    assert type(make_session(params, shape, mesh=_cpu_mesh((1, 1, 1)))) \
        is FusedSession
    sess = make_session(params, shape, mesh=_cpu_mesh((2, 1, 1)))
    assert isinstance(sess, ShardedSession) and sess.pad == (2, 0, 0)
    with pytest.raises(ValueError, match="cannot hold"):
        make_session(params, shape, mesh=_cpu_mesh((8, 1, 1)))


def test_ksteps_refuse_other_pads():
    params = LBMParams(alpha0=1.5)
    mesh = _cpu_mesh((2, 1, 1))
    f, g = model.perturbed_populations((8, 8, 8), 1, device="cpu")
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, (1, 0, 0))
    with pytest.raises(ValueError, match="pads"):
        kernel_par.make_kernel_ksteps(mesh, params, 1)(ss, [0])


# -- the driver ---------------------------------------------------------------

def test_run_with_mesh_writes_what_run_writes(tmp_path):
    """run(cfg, mesh=...) against run(cfg): the same frames, checkpoint
    and metrics records (but the wall clock's), on a CPU mesh."""
    cfg = config.preset("droplet-fluct").replace(
        shape=(16, 16, 16), nsteps=20, step_continue=0, init="droplet",
        plot_int=10, print_int=10, droplet_int=10, sf_window=10, sf_every=5)
    run_mod.run(cfg.replace(out_dir=str(tmp_path / "a")), device="cpu")
    run_mod.run(cfg.replace(out_dir=str(tmp_path / "b")), device="cpu",
                mesh=(2, 2, 1))
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert {"checkpoint0000020.npz", "plt0000020.npz",
            "structfact0000020.npz"} <= set(names)
    for name in names:
        if name.endswith(".npz"):
            with np.load(tmp_path / "a" / name) as a, \
                    np.load(tmp_path / "b" / name) as b:
                assert a.files == b.files
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
    def records(d):
        with open(tmp_path / d / "metrics.jsonl") as fh:
            return [{k: v for k, v in json.loads(ln).items()
                     if k not in ("t_wall", "mlups")} for ln in fh]

    assert records("a") == records("b")


def test_sharded_session_continues_after_exit_view():
    """exit_view leaves the resident decomposed state live: advancing
    after a view matches advancing without one."""
    params = LBMParams(**_DROP, alpha0=1.5, kBT=1e-5)
    shape = (8, 8, 16)
    f, g = _droplet(shape, params, 9)
    mesh = _cpu_mesh((2, 2, 1))
    sess = ShardedSession(mesh, params, shape, mass_restore_int=0)
    pc = sess.enter(init_state(f.clone(), g.clone(), 0), 1)
    pc = sess.advance(pc, 2, [2, 3])
    view = sess.exit_view(pc)
    assert view.step == 3 and isinstance(view.f, torch.Tensor)
    end = sess.exit(sess.advance(pc, 2, [4, 5]))
    _, want = _session(mesh, params, shape, f, g, [1, 2, 3, 4, 5], (4,), 0)
    assert torch.equal(end.f, want.f) and torch.equal(end.g, want.g)
