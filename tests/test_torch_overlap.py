"""The rest of K7 in the PyTorch port on the CPU: windowed launches and the
overlap split, and the y-strip exchange (``ShardedSession(overlap=,
y_exchange=)``), against the serial decomposed session; against the JAX
package in tests/test_torch_overlap_jax.py and tests/test_torch_ystrips_jax.py.

Meshes are of CPU devices, a device repeated for every block, so every
launch runs its plain version: a window is cut from the plain ext step of
the whole block, and a strip-fed step reads the strips mounted into a copy
of the block's y pads.  Every sweep then repeats the serial sweep's
arithmetic on the same values, so sessions are compared bitwise, mass
restores included (the restore sums in the same order in every sweep).
"""

import numpy as np
import pytest
import torch

from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.kernels.session import ShardedSession, make_session
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.ops import blocked
from bflbm_tpu_torch.parallel import halo
from bflbm_tpu_torch.parallel import kernel as kernel_par
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.state import init_state

TOL = 2e-5
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)
MODES = {
    "u8 uncoupled": (dict(kBT=1e-5), "u8"),
    "clt4 alpha0": (dict(_DROP, alpha0=1.5, kBT=1e-5), "clt4"),
    "alpha1": (dict(_DROP, alpha0=1.2, alpha1=0.5, kBT=1e-5), "clt4"),
}


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


def _droplet(shape, params, seed):
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    return model.perturbed_populations(shape, seed, base=base, device="cpu")


@pytest.fixture
def windows(monkeypatch):
    """The windows the decomposed loop passes to fused_stream_collide (on
    the CPU no kernel launches, so the launch counters stay 0)."""
    seen = []
    inner = fused_step.fused_stream_collide

    def spy(*args, **kw):
        seen.append(kw.get("window"))
        return inner(*args, **kw)

    monkeypatch.setattr(fused_step, "fused_stream_collide", spy)
    return seen


# -- the sweep's layout -------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,shape,overlap,y_exchange,want", [
    ((2, 2, 1), (16, 16, 16), "auto", "auto",       # serial: measured
     ((False,) * 3, False, (2, 2, 0))),
    ((2, 2, 1), (16, 16, 16), "auto", "serial",
     ((False,) * 3, False, (2, 2, 0))),
    ((2, 1, 1), (16, 16, 16), "auto", "strips",
     ((False,) * 3, True, (2, 2, 0))),          # the 1-block y self-wrap
    ((2, 1, 1), (16, 16, 16), "auto", "auto",
     ((False,) * 3, False, (2, 0, 0))),
    ((2, 2, 1), (16, 16, 16), True, "auto",
     ((True, True, False), False, (2, 2, 0))),  # the split takes copies
    ((1, 2, 2), (16, 16, 16), True, "auto",
     ((False, True, True), False, (0, 2, 2))),
    ((2, 1, 1), (16, 16, 16), "force", "auto",
     ((True,) * 3, False, (2, 2, 2))),          # pads on every axis
    ((2, 4, 1), (8, 32, 128), True, "strips",   # local x 4 < 2 sd + 1
     ((False,) * 3, True, (2, 2, 0))),
    ((1, 2, 2), (16, 16, 16), False, "auto",
     ((False,) * 3, False, (0, 2, 2))),         # z sharded: no strips
])
def test_layout(mesh_shape, shape, overlap, y_exchange, want):
    lay = kernel_par.layout(_cpu_mesh(mesh_shape), shape,
                            LBMParams(alpha0=1.5), overlap, y_exchange)
    assert (lay.split, lay.strips, lay.pad) == want


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_shape=(1, 2, 2), y_exchange="strips"), "z unsharded"),
    (dict(mesh_shape=(2, 1, 2), y_exchange="strips"), "z unsharded"),
    (dict(mesh_shape=(2, 2, 1), y_exchange="dus"), "y_exchange"),
    (dict(mesh_shape=(2, 2, 1), overlap="yes"), "overlap"),
])
def test_sweep_options_refused(kw, match):
    ms = kw.pop("mesh_shape")
    with pytest.raises(ValueError, match=match):
        ShardedSession(_cpu_mesh(ms), LBMParams(alpha0=1.5), (16, 16, 16),
                       **kw)


def test_split_windows_tile_the_interior():
    """The interior window and the seam bands cover every interior cell
    exactly once, and the interior window's reach (sd) stays inside the
    interior."""
    lay = kernel_par.layout(_cpu_mesh((2, 2, 2)), (16, 16, 24),
                            LBMParams(alpha0=1.5, alpha1=0.5), True)
    arrays = (19, 14, 14, 18)
    inner, bands = kernel_par.split_windows(lay, arrays, 3)
    assert len(bands) == 6
    hits = torch.zeros(arrays[1:], dtype=torch.int32)
    for box in [inner] + bands:
        blocked.box_view(hits, box).add_(1)
    assert torch.equal(blocked.interior(hits, lay.pad),
                       torch.ones(8, 8, 12, dtype=torch.int32))
    assert int(hits.sum()) == 8 * 8 * 12
    assert blocked.inside(blocked.grow(inner, 3, ((0, 99),) * 3),
                          ((3, 11), (3, 11), (3, 15)))


# -- windowed launches --------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_plain_window_launches_write_their_window(mode):
    """A, L and K with a window write exactly their window of a NaN-filled
    output, bitwise the window of the whole-region ext launch."""
    kw, dist = MODES[mode]
    params = LBMParams(**kw)
    shape = (16, 16, 16)
    f, g = _droplet(shape, params, 4)
    mesh = _cpu_mesh((2, 2, 1))
    pad = mesh.pads(fused_step.sd_depth(params))
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    ext = halo.block_exts(mesh, shape, pad)[3]
    fb, gb = ss.blocks[3][0], ss.blocks[3][1]
    win = ((pad[0] + 1, pad[0] + 6), (pad[1], pad[1] + 3), (0, 16))

    def nan_like(t, lead):
        return torch.full((lead,) + tuple(t.shape[1:]), float("nan"))

    whole = fused_step.fused_stream_collide(fb, gb, 77, 5, params,
                                            noise_dist=dist, ext=ext)
    got = fused_step.fused_stream_collide(
        fb, gb, 77, 5, params, out=(nan_like(fb, 19), nan_like(gb, 19)),
        noise_dist=dist, ext=ext, window=win)
    for w, o in zip(whole, got):
        assert torch.equal(blocked.box_view(o, win),
                           blocked.box_view(w, win))
        assert int(torch.isnan(o).sum()) == o.numel() - blocked.box_view(
            o, win).numel()
    if not fused_step.is_coupled(params):
        return
    a_win, l_win = fused_step.prepass_windows(params, ext, fb.shape, win)
    psi = fused_step.density_psi(fb, gb, params, ext=ext)
    psi_w = fused_step.density_psi(fb, gb, params, out=nan_like(fb, 2),
                                   ext=ext, window=a_win)
    assert torch.equal(blocked.box_view(psi_w, a_win),
                       blocked.box_view(psi, a_win))
    assert int(torch.isnan(psi_w).sum()) == psi_w.numel() \
        - blocked.box_view(psi_w, a_win).numel()
    if fused_step.has_alpha1(params):
        lap = fused_step.laplacian_psi(psi, ext=ext)
        lap_w = fused_step.laplacian_psi(psi, out=nan_like(fb, 2), ext=ext,
                                         window=l_win)
        assert torch.equal(blocked.box_view(lap_w, l_win),
                           blocked.box_view(lap, l_win))
        assert int(torch.isnan(lap_w).sum()) == lap_w.numel() \
            - blocked.box_view(lap_w, l_win).numel()


def test_window_refusals():
    params = LBMParams(alpha0=1.5)
    f, g = model.perturbed_populations((8, 8, 8), 1, device="cpu")
    fp = torch.cat([f[:, -2:], f, f[:, :2]], dim=1)
    gp = torch.cat([g[:, -2:], g, g[:, :2]], dim=1)
    ext = blocked.Ext((2, 0, 0), (0, 0, 0), (8, 8, 8))
    with pytest.raises(ValueError, match="inside"):      # reaches a pad
        fused_step.fused_stream_collide(fp, gp, 1, 1, params, ext=ext,
                                        window=((1, 6), (0, 8), (0, 8)))
    with pytest.raises(ValueError, match="span"):        # cuts an axis
        fused_step.fused_stream_collide(fp, gp, 1, 1, params, ext=ext,
                                        window=((2, 6), (0, 4), (0, 8)))
    with pytest.raises(ValueError, match="ext"):
        fused_step.fused_stream_collide(f, g, 1, 1, params,
                                        window=((0, 4), (0, 8), (0, 8)))


# -- the strips exchange ------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (1, 4, 1), (2, 1, 1)])
def test_strip_exchange_matches_periodic_pad(mesh_shape):
    """The received strips hold the rows below and above each block's
    interior across its padded x extent, corners included: the periodic
    pad of the whole domain."""
    depth = 2
    shape = (8, 8, 4)
    field = torch.arange(2 * 19 * 8 * 8 * 4, dtype=torch.float32).reshape(
        (2, 19) + shape)
    mesh = _cpu_mesh(mesh_shape)
    lay = kernel_par.layout(mesh, shape, LBMParams(alpha0=1.5), "auto",
                            "strips")
    blocks = mesh_lib.shard_field(field, mesh, lay.pad)
    halo.run_plan(halo.halo_plan(blocks, mesh, lay.pad, axes=(0,)))
    sent = kernel_par.strip_buffers(blocks, lay.pad)
    received = [torch.full_like(t, float("nan")) for t in sent]
    halo.run_plan(halo.strip_plan(sent, received, mesh, lay.pad))
    loc = mesh.local_shape(shape)
    padded = np.pad(field.numpy(), [(0, 0)] * 2 + [(p, p) for p in lay.pad],
                    mode="wrap")
    for b in range(mesh.size):
        o = mesh.origin(b, shape)
        x0, x1 = o[0], o[0] + loc[0] + 2 * lay.pad[0]
        for side, y0 in ((0, o[1]), (1, o[1] + depth + loc[1])):
            want = padded[:, :, x0:x1, y0:y0 + depth, o[2]:o[2] + loc[2]]
            np.testing.assert_array_equal(received[b][side].numpy(), want)


def _sweep_session(mesh, params, shape, f, g, words, dist, restore,
                   nan_y_pads=False, **opts):
    """1 + 2 + (n - 3) steps through a ShardedSession; nan_y_pads: NaN
    into every block's y pads after enter (the strips never read them)."""
    sess = ShardedSession(mesh, params, shape, noise_dist=dist,
                          mass_restore_int=restore, **opts)
    pc = sess.enter(init_state(f.clone(), g.clone(), 0), words[0])
    if nan_y_pads:
        py = pc.pad[1]
        for blk in pc.blocks:
            blk[..., :py, :] = float("nan")
            blk[..., blk.shape[-2] - py:, :] = float("nan")
    pc = sess.advance(pc, 2, words[1:3])
    pc = sess.advance(pc, len(words) - 3, words[3:])
    return sess, sess.exit(pc)


SWEEPS = [("split", ms) for ms in ((2, 1, 1), (2, 2, 1), (1, 2, 2))] + [
    ("strips", ms) for ms in ((2, 2, 1), (2, 1, 1))]


@pytest.mark.parametrize("sweep,mesh_shape", SWEEPS)
@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_session_matches_serial(sweep, mesh_shape, mode, windows):
    """The split session and the strips session against the serial
    ShardedSession, bitwise, through a mass restore at step 3 of 6; the
    strips session with NaN y pads; the split's windows counted: per step
    and block the interior window and two bands per split axis."""
    kw, dist = MODES[mode]
    params = LBMParams(**kw)
    shape = (16, 16, 16)
    f, g = _droplet(shape, params, 12)
    words = [37 * k + 3 for k in range(6)]
    mesh = _cpu_mesh(mesh_shape)
    opts = (dict(overlap=True) if sweep == "split"
            else dict(y_exchange="strips"))
    sess, got = _sweep_session(mesh, params, shape, f, g, words, dist, 3,
                               nan_y_pads=sweep == "strips", **opts)
    assert sess.layout.strips == (sweep == "strips")
    n_win = sum(w is not None for w in windows)
    windows.clear()
    _, want = _sweep_session(mesh, params, shape, f, g, words, dist, 3,
                             y_exchange="serial")
    assert not any(w is not None for w in windows)
    assert got.step == want.step == 6
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)
    n_axes = sum(sess.layout.split)
    assert n_axes == (sweep == "split") * sum(mesh.sharded)
    assert n_win == (5 * mesh.size * (1 + 2 * n_axes) if n_axes else 0)


def test_forced_split_on_one_block_axes_matches_serial(windows):
    """overlap="force" splits every axis, the unsharded ones too (they
    then carry pads that the exchange wraps): the call structure of a
    larger mesh on a (2, 1, 1) mesh, bitwise the serial run."""
    kw, dist = MODES["alpha1"]
    params = LBMParams(**kw)
    shape = (16, 8, 8)
    f, g = _droplet(shape, params, 13)
    words = [5 * k - 2 for k in range(5)]
    mesh = _cpu_mesh((2, 1, 1))
    sess, got = _sweep_session(mesh, params, shape, f, g, words, dist, 2,
                               overlap="force")
    assert sess.layout.split == (True, True, True)
    assert sess.pad == (3, 3, 3)
    assert sum(w is not None for w in windows) == 4 * 2 * 7
    _, want = _sweep_session(mesh, params, shape, f, g, words, dist, 2)
    assert torch.equal(got.f, want.f) and torch.equal(got.g, want.g)


def test_run_with_split_and_strips_writes_what_run_writes(tmp_path):
    """run(cfg, mesh=, overlap=True) and run(cfg, mesh=, y_exchange=
    "strips") write the frames the serial mesh run writes."""
    from bflbm_tpu_torch import config
    from bflbm_tpu_torch import run as run_mod

    cfg = config.preset("droplet-fluct").replace(
        shape=(16, 16, 16), nsteps=6, step_continue=0, init="droplet",
        plot_int=6, print_int=6, droplet_int=0, sf_window=0)
    frames = {}
    for tag, opts in (("serial", dict(y_exchange="serial")),
                      ("split", dict(overlap=True)),
                      ("strips", dict(y_exchange="strips"))):
        out = tmp_path / tag
        run_mod.run(cfg.replace(out_dir=str(out)), device="cpu",
                    mesh=(2, 2, 1), **opts)
        with np.load(out / "plt0000006.npz") as z:
            frames[tag] = {k: z[k] for k in z.files}
    for tag in ("split", "strips"):
        assert frames[tag].keys() == frames["serial"].keys()
        for k, v in frames["serial"].items():
            np.testing.assert_array_equal(frames[tag][k], v)


def test_make_session_passes_the_sweep():
    params = LBMParams(alpha0=1.5)
    sess = make_session(params, (16, 16, 16), mesh=_cpu_mesh((2, 2, 1)),
                        overlap=True)
    assert sess.layout.split == (True, True, False)
    sess = make_session(params, (16, 16, 16), mesh=_cpu_mesh((2, 1, 1)),
                        y_exchange="strips")
    assert sess.layout.strips and sess.pad == (2, 2, 0)
    with pytest.raises(ValueError, match="y_exchange"):
        make_session(params, (16, 16, 16), y_exchange="dus")
