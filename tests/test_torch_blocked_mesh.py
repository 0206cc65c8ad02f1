"""K4 on the decomposed path of the PyTorch port (T steps a launch on
halo-extended blocks, one exchange a sweep: ``ShardedSession(block=T)``,
``make_session(mesh=, block=)`` and ``run(cfg, mesh=, block=)``) on the
CPU, against the port's whole-domain K4 and the JAX package.

Meshes are of CPU devices, a device repeated for every block, so every
block runs the plain ext sweep (``ops.blocked.blocked_sweep_reference(...,
ext=)``), the plain version of the kernel's EXT launch.  A cell's
arithmetic is the whole-domain sweep's, so the comparisons are bitwise;
the mass restore sums in float64 in another order, so after a restore
they are within TOL = 2e-5 (chip_smoke.py's kernel tolerance).
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
# (stencil depth, T) -> the force's keywords: every depth at T = 2, and
# T = 3 where its shared memory fits
CASES = {(1, 2): {}, (1, 3): {}, (2, 2): dict(_DROP, alpha0=1.5),
         (2, 3): dict(_DROP, alpha0=1.5),
         (3, 2): dict(_DROP, alpha0=1.2, alpha1=0.5)}
# mode -> (keywords, generator, with the ref operand)
MODES = {"off": (dict(kBT=0.0), "clt4", False),
         "clt4": (dict(kBT=1e-5), "clt4", False),
         "ref": (dict(kBT=1e-5), "clt4", True),
         "general tau": (dict(kBT=1e-5, tau_f=0.7, tau_g=0.6), "clt4",
                         False)}
MESHES = [(2, 1, 1), (2, 2, 1), (1, 2, 2)]


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


def _droplet(shape, params, seed):
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    return model.perturbed_populations(shape, seed, base=base, device="cpu")


# -- the plain ext sweep --------------------------------------------------

@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_ext_sweep_equals_whole_sweep(case, mode, mesh_shape):
    """The plain ext sweep on every block of a 12^3 droplet (pads sd T
    deep, one exchange; the ref operand's pads filled the same way)
    equals the whole-domain plain sweep on the block's cells, bitwise;
    the wrapper writes it at the pad offset of a padded output."""
    sd, T = case
    kw, dist, with_ref = MODES[mode]
    params = LBMParams(**dict(CASES[case], **kw))
    shape = (12, 12, 12)
    f, g = _droplet(shape, params, 3)
    ref = (torch.stack([f.sum(0), g.sum(0)]).roll((1, -2, 3), (1, 2, 3))
           .contiguous() if with_ref else None)
    words = [7919 * k - 3 for k in range(T)]
    wf, wg = blocked.blocked_sweep_reference(
        f, g, words, 40, params, T, fused_step.blocked_tile(T, shape, sd),
        dist, ref)
    mesh = _cpu_mesh(mesh_shape)
    pad = mesh.pads(sd * T)
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    refs = [None] * mesh.size
    if with_ref:
        refs = mesh_lib.shard_field(ref, mesh, pad)
        halo.exchange_halo(refs, mesh, pad)
    for blk, ext, r in zip(ss.blocks, halo.block_exts(mesh, shape, pad),
                           refs):
        cells = (slice(None),) + tuple(
            slice(o, o + n) for o, n in zip(ext.origin,
                                            ext.interior(blk.shape)))
        fo, go = fused_step.blocked_stream_collide(
            blk[0], blk[1], words, 40, params, T, noise_dist=dist, ref=r,
            ext=ext)
        assert fo.shape == blk[0].shape
        assert torch.equal(ext.region(fo), wf[cells])
        assert torch.equal(ext.region(go), wg[cells])


@pytest.mark.parametrize("mesh_shape,depth", [((2, 2, 1), 4), ((1, 2, 2), 6),
                                              ((2, 2, 2), 6)])
def test_deep_exchange_fills_the_corners(mesh_shape, depth):
    """The axis-by-axis exchange at depth sd T fills every pad, the
    diagonal corners that phase 0 reads included: each padded block is
    its window of the periodic pad of the global field."""
    shape = (12, 12, 12)
    field = np.random.default_rng(4).standard_normal(
        (2,) + shape).astype(np.float32)
    mesh = _cpu_mesh(mesh_shape)
    pad = mesh.pads(depth)
    blocks = mesh_lib.shard_field(torch.from_numpy(field), mesh, pad)
    halo.exchange_halo(blocks, mesh, pad)
    wrapped = np.pad(field, [(0, 0)] + [(p, p) for p in pad], mode="wrap")
    loc = mesh.local_shape(shape)
    for b, blk in enumerate(blocks):
        o = mesh.origin(b, shape)
        want = wrapped[(slice(None),) + tuple(
            slice(a, a + n + 2 * p) for a, n, p in zip(o, loc, pad))]
        np.testing.assert_array_equal(to_np(blk), want)


# -- the sessions ---------------------------------------------------------

def _session(mesh, params, shape, f, g, words, chunks, restore, block,
             ref_fields=None):
    kw = dict(mass_restore_int=restore, ref_fields=ref_fields, block=block)
    sess = (ShardedSession(mesh, params, shape, **kw) if mesh is not None
            else FusedSession(params, shape, **kw))
    pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
    used = 1
    for c in chunks:
        pc = sess.advance(pc, c, words[used:used + c])
        used += c
    assert used == len(words)
    return sess, sess.exit(pc)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("mode", ["clt4 alpha0", "alpha1"])
def test_blocked_sharded_session_matches_fused_session(mesh_shape, mode):
    """ShardedSession(block=2) against FusedSession(block=2) with the same
    chunks (1 + 3 + 4 steps: a sweep and a single step, then two sweeps):
    bitwise before the first restore (step 4 of a restore every 5), within
    TOL after it (step 8, restored after the sweep to step 6)."""
    params = LBMParams(**dict(CASES[(2, 2)] if mode == "clt4 alpha0"
                              else CASES[(3, 2)], kBT=1e-5))
    shape = (12, 12, 12)
    f, g = _droplet(shape, params, 5)
    words = [101 * k - 7 for k in range(8)]
    mesh = _cpu_mesh(mesh_shape)
    for n, chunks, check in ((4, (3,), "bitwise"), (8, (3, 4), "tol")):
        _, want = _session(None, params, shape, f, g, words[:n], chunks, 5,
                           2)
        sess, got = _session(mesh, params, shape, f, g, words[:n], chunks,
                             5, 2)
        assert sess.pad == mesh.pads(2 * fused_step.sd_depth(params))
        assert got.step == want.step == n
        if check == "bitwise":
            assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)
        else:
            assert max(float((got.f - want.f).abs().max()),
                       float((got.g - want.g).abs().max())) <= TOL


def test_remainder_runs_one_step_launches(monkeypatch):
    """An advance of 5 at block 2 runs two sweeps (one blocked call a
    block) and one single step (one-step ext calls) in the same layout,
    bitwise the FusedSession's; the ref operand rides both."""
    params = LBMParams(**dict(CASES[(2, 2)], kBT=1e-5))
    shape = (12, 12, 12)
    f, g = _droplet(shape, params, 6)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    rho, phi = base.f.sum(0), base.g.sum(0)
    ref = (rho, phi, stats.center_of_mass(rho))
    words = [11 * k + 5 for k in range(6)]
    calls = {"blocked": 0, "single": 0}
    real = (fused_step.blocked_stream_collide, fused_step.fused_stream_collide)

    def blocked_call(*a, **kw):
        calls["blocked"] += 1
        return real[0](*a, **kw)

    def single_call(*a, **kw):
        calls["single"] += 1
        return real[1](*a, **kw)

    monkeypatch.setattr(fused_step, "blocked_stream_collide", blocked_call)
    monkeypatch.setattr(fused_step, "fused_stream_collide", single_call)
    mesh = _cpu_mesh((2, 1, 1))
    sess, got = _session(mesh, params, shape, f, g, words, (5,), 0, 2, ref)
    monkeypatch.undo()
    assert calls == {"blocked": 2 * mesh.size, "single": mesh.size}
    _, want = _session(None, params, shape, f, g, words, (5,), 0, 2, ref)
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)


def test_blocked_sharded_session_matches_jax_block2_kernel():
    """The port's ShardedSession(block=2) against JAX's sharded kernel
    path at block 2 (make_kernel_nsteps, hash noise, interpret mode) on
    the conftest's virtual devices: tests/test_kernel_shard.py::
    test_kernel_shard_matches_jnp_deterministic's configuration (coupled
    droplet, kBT = 0, 8 x 32 x 128, mesh (2, 4, 1), 5 steps), atol 2e-5."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    kw = dict(alpha0=1.5, kBT=0.0, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
    shape = (8, 32, 128)
    state = jmodel.init_droplet(shape, JParams(**kw), dtype=jnp.float32,
                                radius=0.3)
    jmesh = jmesh_lib.make_mesh((2, 4, 1), jax.devices()[:8])
    want = jkernel_par.make_kernel_nsteps(
        jmesh, JParams(**kw), 5, block=2, noise_impl="hash",
        transform="mxu", interpret=True, donate=False)(
        jmesh_lib.shard_state(state, jmesh))
    sess, got = _session(_cpu_mesh((2, 4, 1)), LBMParams(**kw), shape,
                         to_torch(state.f), to_torch(state.g), [0] * 5,
                         (4,), 0, 2)
    assert sess.pad == (4, 4, 0)
    assert got.step == int(want.step) == 5
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=TOL)


def test_make_session_passes_the_block():
    params = LBMParams(**CASES[(3, 2)])
    sess = make_session(params, (12, 12, 12), mesh=_cpu_mesh((1, 2, 2)),
                        block=2)
    assert isinstance(sess, ShardedSession)
    assert (sess.block, sess.pad) == (2, (0, 6, 6))
    # block None: one step a launch in every mode (the noise off, general
    # tau, the droplet's clt4), with the split and the strips too; a
    # block of 2 reaches the session's block and pads in each sweep
    off = LBMParams(kBT=0.0)
    assert make_session(off, (12, 12, 12),
                        mesh=_cpu_mesh((2, 1, 1))).block == 1
    general = LBMParams(kBT=0.0, tau_f=0.7, tau_g=0.6)
    for opts in (dict(), dict(overlap=True), dict(y_exchange="strips")):
        assert make_session(general, (12, 12, 12),
                            mesh=_cpu_mesh((2, 1, 1)), **opts).block == 1
        sess = make_session(general, (12, 12, 12),
                            mesh=_cpu_mesh((2, 1, 1)), block=2, **opts)
        assert sess.block == 2 and sess.pad[0] == 2
    assert make_session(params, (12, 12, 12),
                        mesh=_cpu_mesh((2, 1, 1))).block == 1


# -- the driver -----------------------------------------------------------

def test_run_with_mesh_and_block_writes_what_run_writes(tmp_path):
    """run(cfg, mesh=(2, 1, 1), block=2) against run(cfg, block=2): the
    same frames, checkpoint and metrics records (but the wall clock's)."""
    cfg = config.preset("droplet-fluct").replace(
        shape=(12, 12, 12), nsteps=10, step_continue=0, init="droplet",
        plot_int=10, print_int=10, droplet_int=10)
    run_mod.run(cfg.replace(out_dir=str(tmp_path / "a")), device="cpu",
                block=2)
    run_mod.run(cfg.replace(out_dir=str(tmp_path / "b")), device="cpu",
                mesh=(2, 1, 1), block=2)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert {"checkpoint0000010.npz", "plt0000010.npz"} <= set(names)
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


# -- the refusals ---------------------------------------------------------

def test_refusals():
    coupled = LBMParams(**CASES[(2, 2)])
    mesh = _cpu_mesh((2, 1, 1))
    # a sharded local extent shallower than sd T: 4 cells against 2 x 3
    with pytest.raises(ValueError, match="at least sd \\* T = 6"):
        ShardedSession(mesh, coupled, (8, 8, 8), block=3)
    assert not kernel_par.supports(mesh, (8, 8, 8), coupled, 3)
    assert kernel_par.supports(mesh, (8, 8, 8), coupled, 2)
    # the split and the strips at block > 1 build (local 6 < 2 sd T + 1:
    # no axis splits; the strips take y pads sd T deep)
    for opts, strips in ((dict(overlap=True), False),
                         (dict(overlap="force"), False),
                         (dict(y_exchange="strips"), True)):
        sess = ShardedSession(_cpu_mesh((2, 2, 1)), coupled, (12, 12, 12),
                              block=2, **opts)
        assert (sess.block, sess.pad) == (2, (4, 4, 0))
        assert sess.layout.strips == strips and not any(sess.layout.split)
    # T past shared memory
    with pytest.raises(ValueError, match="368624 bytes"):
        ShardedSession(mesh, coupled, (16, 16, 16), block=4)
    # pads shallower than sd T on the launch
    f, g = model.perturbed_populations((12, 12, 12), 1, device="cpu")
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, (2, 0, 0))
    ext = halo.block_exts(mesh, (12, 12, 12), (2, 0, 0))[0]
    with pytest.raises(ValueError, match="shallower"):
        fused_step.blocked_stream_collide(ss.blocks[0][0], ss.blocks[0][1],
                                          [1, 2], 0, coupled, 2, ext=ext)
