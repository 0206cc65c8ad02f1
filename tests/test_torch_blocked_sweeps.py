"""K4 in the overlap split and the y strips of the PyTorch port on the CPU
(windowed and strip-fed T-step launches: ``ShardedSession(block=T,
overlap=True | "force")`` and ``ShardedSession(block=T,
y_exchange="strips")``), against the serial decomposed sweep at block T;
against the JAX package in tests/test_torch_blocked_split_jax.py and
tests/test_torch_ystrips_jax.py.

Meshes are of CPU devices, a device repeated for every block, so every
launch runs its plain version (``ops.blocked.blocked_sweep_reference(...,
window=, strips=)``): a window's tiles cover the window, a strip-fed sweep
reads the strips mounted into a copy of the block's y pads.  Every cell
repeats the serial sweep's arithmetic on the same values, so sweeps and
sessions are compared bitwise, mass restores included.
"""

import functools

import numpy as np
import pytest
import torch

from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.kernels.session import ShardedSession
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.ops import blocked
from bflbm_tpu_torch.parallel import halo
from bflbm_tpu_torch.parallel import kernel as kernel_par
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.state import init_state

TOL = 2e-5
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)
# stencil depth -> (LBMParams keywords at kBT = 1e-5, generator), and a
# small domain whose (2, 2, 1) blocks split at block 2 (local extent
# 2 sd T + 2; z, never split, periodic and 4 planes)
DEPTHS = {1: (dict(kBT=1e-5), "u8", (12, 12, 4)),
          2: (dict(_DROP, alpha0=1.5, kBT=1e-5), "clt4", (20, 20, 4)),
          3: (dict(_DROP, alpha0=1.2, alpha1=0.5, kBT=1e-5), "clt4",
              (28, 28, 4))}


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


def _droplet(shape, params, seed):
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    return model.perturbed_populations(shape, seed, base=base, device="cpu")


def _nan_pads(blk, pad, axes=(0, 1, 2)):
    """A copy of a padded block with NaN in the pads of `axes`."""
    out = blk.clone()
    for d in axes:
        p = int(pad[d])
        if p:
            ax = out.dim() - 3 + d
            out.narrow(ax, 0, p).fill_(float("nan"))
            out.narrow(ax, out.shape[ax] - p, p).fill_(float("nan"))
    return out


def _padded(f, g, mesh, lay, shape):
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, lay.pad)
    halo.exchange_halo(ss.blocks, mesh, lay.pad)
    return ss.blocks, halo.block_exts(mesh, shape, lay.pad)


# -- the windows ----------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,overlap,T,sd", [
    ((2, 2, 1), True, 2, 2), ((2, 2, 2), True, 2, 3),
    ((2, 1, 1), "force", 3, 1)])
def test_windows_at_block_cover_the_interior(mesh_shape, overlap, T, sd):
    """At block T the split's interior window is the interior shrunk by
    sd T on every split axis; with the seam bands it covers every
    interior cell exactly once, and its reach (sd T) stays inside the
    interior."""
    kw = DEPTHS[sd][0]
    shape = (32, 32, 32)
    lay = kernel_par.layout(_cpu_mesh(mesh_shape), shape, LBMParams(**kw),
                            overlap, block=T)
    depth = sd * T
    loc = _cpu_mesh(mesh_shape).local_shape(shape)
    assert lay.split == ((True,) * 3 if overlap == "force"
                         else _cpu_mesh(mesh_shape).sharded)
    assert lay.pad == tuple(depth if s else 0 for s in lay.split)
    arrays = (19,) + tuple(n + 2 * p for n, p in zip(loc, lay.pad))
    inner, bands = kernel_par.split_windows(lay, arrays, depth)
    assert len(bands) == 2 * sum(lay.split)
    hits = torch.zeros(arrays[1:], dtype=torch.int32)
    for box in [inner] + bands:
        blocked.box_view(hits, box).add_(1)
    assert torch.equal(blocked.interior(hits, lay.pad),
                       torch.ones(loc, dtype=torch.int32))
    assert int(hits.sum()) == int(np.prod(loc))
    interior = tuple((p, n - p) for p, n in zip(lay.pad, arrays[1:]))
    reach = tuple((a - depth, b + depth) if s else (a, b)
                  for (a, b), s in zip(inner, lay.split))
    assert reach == interior


@pytest.mark.parametrize("sd", [1, 2, 3])
def test_plain_window_sweeps_with_nan_pads(sd):
    """The plain sweep (T = 2) on the interior window of a block whose
    every pad is NaN writes only its window, finite and bitwise the plain
    ext sweep there; the seam bands, on the exchanged block, complete
    the interior bitwise the ext sweep."""
    kw, dist, shape = DEPTHS[sd]
    params = LBMParams(**kw)
    f, g = _droplet(shape, params, 3 + sd)
    mesh = _cpu_mesh((2, 2, 1))
    lay = kernel_par.layout(mesh, shape, params, True, block=2)
    assert lay.split == (True, True, False)
    blocks, exts = _padded(f, g, mesh, lay, shape)
    blk, ext = blocks[3], exts[3]
    words = [7919, -3]
    whole = fused_step.blocked_stream_collide(blk[0], blk[1], words, 40,
                                              params, 2, noise_dist=dist,
                                              ext=ext)
    inner, bands = kernel_par.split_windows(lay, blk.shape, 2 * sd)
    nan = _nan_pads(blk, lay.pad)
    out = (torch.full_like(blk[0], float("nan")),
           torch.full_like(blk[1], float("nan")))
    fused_step.blocked_stream_collide(nan[0], nan[1], words, 40, params, 2,
                                      out=out, noise_dist=dist, ext=ext,
                                      window=inner)
    for o, w in zip(out, whole):
        got = blocked.box_view(o, inner)
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, blocked.box_view(w, inner))
        assert int(torch.isnan(o).sum()) == o.numel() - got.numel()
    for band in bands:
        fused_step.blocked_stream_collide(blk[0], blk[1], words, 40, params,
                                          2, out=out, noise_dist=dist,
                                          ext=ext, window=band)
    for o, w in zip(out, whole):
        assert torch.equal(ext.region(o), ext.region(w))


def test_band_tiles_and_the_plain_sweep_on_them():
    """A seam band's launch tile: an x band (sd T planes) marches its own
    planes on the interior's section; a y band (sd T rows) is one tile
    across and marches x in chunks of 16 planes (JAX's pick_band).  The
    plain sweep on those tiles gives the one-tile sweep's cells bitwise."""
    assert fused_step.launch_tile(2, (120, 120, 256), 2) == (120, 8, 16)
    assert fused_step.launch_tile(2, (4, 120, 256), 2) == (4, 8, 16)
    assert fused_step.launch_tile(2, (128, 4, 256), 2) == (16, 4, 16)
    assert fused_step.launch_tile(2, (128, 128, 4), 1) == (
        16, fused_step.blocked_tile(2, (1, 1, 1), 1)[1], 4)
    # seam bands thinner than a sub-tile across y or z, and regions
    # thinner than a cluster tile across a clustered axis, run 1 x 1
    # clusters; an x band and the interior take the table's
    for sd in (1, 2, 3):
        cl = fused_step.blocked_cluster(2, sd)
        _, by, bz = fused_step.blocked_tile(2, (1, 1, 1), sd)
        assert fused_step.launch_cluster(2, (128, by - 1, 256), sd) == (1, 1)
        assert fused_step.launch_cluster(2, (128, 256, bz - 1), sd) == (1, 1)
        # a region one cell short of a cluster tile across a clustered axis
        if cl[0] > 1:
            assert fused_step.launch_cluster(
                2, (128, cl[0] * by - 1, 256), sd) == (1, 1)
        if cl[1] > 1:
            assert fused_step.launch_cluster(
                2, (128, 256, cl[1] * bz - 1), sd) == (1, 1)
        assert fused_step.launch_cluster(2, (2 * sd, 256, 256), sd) == cl
        assert fused_step.launch_cluster(2, (120, 120, 256), sd) == cl
    kw, dist, _ = DEPTHS[2]
    params = LBMParams(**kw)
    shape = (40, 20, 8)
    f, g = _droplet(shape, params, 10)
    mesh = _cpu_mesh((1, 2, 1))
    lay = kernel_par.layout(mesh, shape, params, True, block=2)
    blocks, exts = _padded(f, g, mesh, lay, shape)
    _, bands = kernel_par.split_windows(lay, blocks[0].shape, 4)
    assert len(bands) == 2
    for band in bands:
        extent = [b - a for a, b in band]
        tile = fused_step.launch_tile(2, extent, 2)
        assert tile == (16, 4, 8)
        got = blocked.blocked_sweep_reference(
            blocks[0][0], blocks[0][1], [5, 6], 3, params, 2, tile, dist,
            ext=exts[0], window=band)
        want = blocked.blocked_sweep_reference(
            blocks[0][0], blocks[0][1], [5, 6], 3, params, 2, extent, dist,
            ext=exts[0], window=band)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 1, 1)])
def test_plain_strip_sweep_with_nan_y_pads(mesh_shape):
    """The strip-fed plain sweep (coupled, T = 2, the ref operand read
    from its exchanged pads) on blocks whose y pads are NaN equals the
    serial sweep bitwise, and the strips it writes hold its first and
    last sd T interior rows."""
    kw, dist, shape = DEPTHS[2]
    params = LBMParams(**kw)
    f, g = _droplet(shape, params, 8)
    ref = torch.stack([f.sum(0), g.sum(0)]).roll((1, -2, 3), (1, 2, 3))
    mesh = _cpu_mesh(mesh_shape)
    lay = kernel_par.layout(mesh, shape, params, "auto", "strips", block=2)
    assert lay.strips and lay.pad[1] == 4
    blocks, exts = _padded(f, g, mesh, lay, shape)
    refs = mesh_lib.shard_field(ref.contiguous(), mesh, lay.pad)
    halo.exchange_halo(refs, mesh, lay.pad)
    sent = kernel_par.strip_buffers(blocks, lay.pad)
    received = [torch.full_like(t, float("nan")) for t in sent]
    halo.run_plan(halo.strip_plan(sent, received, mesh, lay.pad))
    words = [11, 12]
    px, py = lay.pad[0], lay.pad[1]
    for blk, ext, r, st in zip(blocks, exts, refs, received):
        want = fused_step.blocked_stream_collide(
            blk[0], blk[1], words, 9, params, 2, noise_dist=dist, ref=r,
            ext=ext)
        nan = _nan_pads(blk, lay.pad, axes=(1,))
        out_strips = torch.full_like(st, float("nan"))
        got = fused_step.blocked_stream_collide(
            nan[0], nan[1], words, 9, params, 2, noise_dist=dist, ref=r,
            ext=ext, strips=st, strips_out=out_strips)
        for s, (o, w) in enumerate(zip(got, want)):
            assert torch.equal(ext.region(o), ext.region(w))
            x1, y1 = o.shape[1] - px, o.shape[2] - py
            assert torch.equal(out_strips[0, s][:, px:x1],
                               o[:, px:x1, py:2 * py])
            assert torch.equal(out_strips[1, s][:, px:x1],
                               o[:, px:x1, y1 - py:y1])


def test_window_and_strip_refusals():
    params = LBMParams(**DEPTHS[2][0])
    shape = (20, 20, 16)
    f, g = _droplet(shape, params, 9)
    mesh = _cpu_mesh((2, 2, 1))
    lay = kernel_par.layout(mesh, shape, params, "auto", "strips", block=2)
    blocks, exts = _padded(f, g, mesh, lay, shape)
    blk, ext = blocks[0], exts[0]
    strips = kernel_par.strip_buffers(blocks, lay.pad)[0]
    inner = ((5, 9), (5, 9), (0, 16))
    with pytest.raises(ValueError, match="no y strips"):
        fused_step.blocked_stream_collide(blk[0], blk[1], [1, 2], 0, params,
                                          2, ext=ext, window=inner,
                                          strips=strips)
    with pytest.raises(ValueError, match="inside"):     # reaches a pad
        fused_step.blocked_stream_collide(blk[0], blk[1], [1, 2], 0, params,
                                          2, ext=ext,
                                          window=((3, 9), (5, 9), (0, 16)))
    with pytest.raises(ValueError, match="ext"):
        fused_step.blocked_stream_collide(f, g, [1, 2], 0, params, 2,
                                          window=inner)
    with pytest.raises(ValueError, match="strips must be"):
        fused_step.blocked_stream_collide(blk[0], blk[1], [1, 2], 0, params,
                                          2, ext=ext, strips=strips[:, :, :,
                                                                    :, :2])
    with pytest.raises(ValueError, match="extents of at least 4"):
        ShardedSession(_cpu_mesh((2, 1, 1)), params, (20, 3, 16), block=2,
                       y_exchange="strips")


# -- the sessions ---------------------------------------------------------

def _session(mesh, params, shape, f, g, words, dist, nan_y_pads=False,
             **opts):
    """1 + 5 steps (two sweeps of 2 and one single step) through a
    ShardedSession(block=2) with the restore every 3 steps (after the
    sweep to step 3 and the single step to step 6); nan_y_pads: NaN into
    every block's y pads after enter (the strips never read them)."""
    sess = ShardedSession(mesh, params, shape, noise_dist=dist,
                          mass_restore_int=3, block=2, **opts)
    pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
    if nan_y_pads:
        for blk in pc.blocks:
            blk.copy_(_nan_pads(blk, pc.pad, axes=(1,)))
    return sess, sess.exit(sess.advance(pc, len(words) - 1, words[1:]))


@pytest.fixture
def launches(monkeypatch):
    """The windows the decomposed loop passes to the blocked and one-step
    launches (on the CPU no kernel launches, so the counters stay 0)."""
    seen = {"blocked": [], "single": []}
    real = (fused_step.blocked_stream_collide, fused_step.fused_stream_collide)

    def blocked_call(*a, **kw):
        seen["blocked"].append(kw.get("window"))
        return real[0](*a, **kw)

    def single_call(*a, **kw):
        seen["single"].append(kw.get("window"))
        return real[1](*a, **kw)

    monkeypatch.setattr(fused_step, "blocked_stream_collide", blocked_call)
    monkeypatch.setattr(fused_step, "fused_stream_collide", single_call)
    return seen


@functools.lru_cache(maxsize=None)
def _serial_session(sd):
    """The serial ShardedSession(block=2) run of :func:`_session` at
    stencil depth sd, once for both sweeps."""
    kw, dist, shape = DEPTHS[sd]
    params = LBMParams(**kw)
    f, g = _droplet(shape, params, 20 + sd)
    return _session(_cpu_mesh((2, 2, 1)), params, shape, f, g,
                    [37 * k + 3 for k in range(6)], dist,
                    y_exchange="serial")[1]


@pytest.mark.parametrize("sweep", ["split", "strips"])
@pytest.mark.parametrize("sd", [1, 2, 3])
def test_block2_sweep_session_matches_serial(sd, sweep, launches):
    """ShardedSession(block=2) on (2, 2, 1) with the split (overlap=True)
    and with the strips (NaN y pads) against the serial
    ShardedSession(block=2): bitwise through the remainder step and both
    restores; the split's launches counted: per sweep and block the
    interior window and four bands, the single step's windows too."""
    kw, dist, shape = DEPTHS[sd]
    params = LBMParams(**kw)
    f, g = _droplet(shape, params, 20 + sd)
    words = [37 * k + 3 for k in range(6)]
    mesh = _cpu_mesh((2, 2, 1))
    opts = (dict(overlap=True) if sweep == "split"
            else dict(y_exchange="strips", nan_y_pads=True))
    sess, got = _session(mesh, params, shape, f, g, words, dist, **opts)
    seen = {k: list(v) for k, v in launches.items()}
    for v in launches.values():
        v.clear()
    want = _serial_session(sd)
    assert not any(w is not None for v in launches.values() for w in v)
    assert sess.block == 2 and sess.pad == (2 * sd, 2 * sd, 0)
    assert sess.layout.strips == (sweep == "strips")
    assert got.step == want.step == 6
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)
    per = 5 if sweep == "split" else 1
    assert len(seen["blocked"]) == 2 * mesh.size * per
    assert len(seen["single"]) == mesh.size * per
    if sweep == "split":   # the sweeps' windows at depth sd T, the step's sd
        arrays = (19,) + tuple(n // m + 2 * p for n, m, p in
                               zip(shape, mesh.shape, sess.pad))
        for key, depth in (("blocked", 2 * sd), ("single", sd)):
            inner, bands = kernel_par.split_windows(sess.layout, arrays,
                                                    depth)
            assert seen[key][:mesh.size * per] == ([inner] * mesh.size
                                                   + bands * mesh.size)


def test_forced_split_at_block3_matches_serial(launches):
    """overlap="force" at block 3 (uncoupled: pads 3 deep on every axis of
    a (2, 1, 1) mesh), 1 + 7 steps (two sweeps and a single step),
    bitwise the serial session at block 3; six bands a window."""
    kw, dist, _ = DEPTHS[1]
    params = LBMParams(**kw)
    shape = (16, 8, 8)
    f, g = _droplet(shape, params, 30)
    words = [5 * k - 2 for k in range(8)]
    mesh = _cpu_mesh((2, 1, 1))

    def go(**opts):
        sess = ShardedSession(mesh, params, shape, noise_dist=dist,
                              mass_restore_int=4, block=3, **opts)
        pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
        return sess, sess.exit(sess.advance(pc, 7, words[1:]))

    sess, got = go(overlap="force")
    assert sess.layout.split == (True, True, True)
    assert sess.pad == (3, 3, 3)
    assert len(launches["blocked"]) == 2 * 2 * 7
    assert len(launches["single"]) == 2 * 7
    _, want = go()
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)


def test_strips_at_block3_through_two_single_steps(launches):
    """The strips at block 3 (uncoupled: strips 3 rows deep on (2, 2, 1)),
    1 + 5 steps: one sweep, then two single steps, the second fed by the
    strips the first wrote (which must put its edge rows where the
    strips' layout at depth sd T has them); bitwise the serial session at
    block 3, the y pads NaN."""
    kw, dist, _ = DEPTHS[1]
    params = LBMParams(**kw)
    shape = (12, 12, 4)
    f, g = _droplet(shape, params, 31)
    words = [11 * k + 5 for k in range(6)]
    mesh = _cpu_mesh((2, 2, 1))

    def go(**opts):
        sess = ShardedSession(mesh, params, shape, noise_dist=dist,
                              mass_restore_int=2, block=3, **opts)
        pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
        if sess.layout.strips:
            for blk in pc.blocks:
                blk.copy_(_nan_pads(blk, pc.pad, axes=(1,)))
        return sess, sess.exit(sess.advance(pc, 5, words[1:]))

    sess, got = go(y_exchange="strips")
    assert sess.layout.strips and sess.pad == (3, 3, 0)
    assert len(launches["blocked"]) == mesh.size
    assert len(launches["single"]) == 2 * mesh.size
    _, want = go(y_exchange="serial")
    assert got.step == want.step == 6
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)
