"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Marked ``gpu``: each test skips without a CUDA device.  The module
imports no JAX, so on a machine without JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py configures JAX).  Tolerance atol 2e-5: 1/x
multiplies against divides, and FMA contraction differs.
"""

import dataclasses

import pytest
import torch

from bflbm_tpu_torch import run as run_mod
from bflbm_tpu_torch.config import LBMParams, preset
from bflbm_tpu_torch.io import fields as fields_io
from bflbm_tpu_torch.io import native
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.kernels.session import FusedSession, ShardedSession
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.observables import stats
from bflbm_tpu_torch.ops import collide as collide_ops
from bflbm_tpu_torch.parallel import halo
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.probes import launch as probe_launch
from bflbm_tpu_torch.probes import noise_micro, platform
from bflbm_tpu_torch.state import init_state

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 16, 32), (5, 7, 130)])
@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_kernel_matches_plain(cuda, shape, kBT):
    f, g = model.perturbed_populations(shape, 1, device=cuda)
    params = LBMParams(kBT=kBT)
    before = fused_step.launches
    fo, go = fused_step.fused_stream_collide(f, g, -5, 77, params)
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    fr, gr = fused_step.k_step_reference(f, g, -5, 77, params)
    assert max(_maxdiff(fo, fr), _maxdiff(go, gr)) <= ATOL


@pytest.mark.gpu
def test_kernel_noise_bits(cuda):
    """The noise the kernel adds is the hash stream's: kernel(kBT) -
    kernel(0) matches plain(kBT) - plain(0) far below the noise size."""
    f, g = model.perturbed_populations((8, 8, 128), 2, device=cuda)
    on, off = LBMParams(kBT=1e-5), LBMParams(kBT=0.0)
    dk = fused_step.fused_stream_collide(f, g, 9, 3, on)[0] \
        - fused_step.fused_stream_collide(f, g, 9, 3, off)[0]
    dp = fused_step.k_step_reference(f, g, 9, 3, on)[0] \
        - fused_step.k_step_reference(f, g, 9, 3, off)[0]
    assert float(dp.abs().max()) > 100 * ATOL
    assert _maxdiff(dk, dp) <= ATOL


@pytest.mark.gpu
def test_session_matches_plain_chain(cuda):
    shape = (16, 16, 32)
    f, g = model.perturbed_populations(shape, 3, device=cuda)
    params = LBMParams(kBT=1e-5)
    words = [3 * k - 11 for k in range(10)]
    ref = model.nsteps(init_state(f.clone(), g.clone(), 0), params, 10, words)
    sess = FusedSession(params, shape, mass_restore_int=4)
    before = fused_step.launches
    pc = sess.enter(init_state(f, g, 0), words[0])
    pc = sess.advance(pc, 9, words[1:])
    got = sess.exit(pc)
    assert fused_step.launches == before + 9
    assert max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g)) <= ATOL


@pytest.mark.gpu
def test_kernel_refuses_unsupported(cuda):
    """Every mode runs — alpha1 (K1c), general tau (K1d), clt2 — and
    what the kernels do not take is refused: aliased outputs, float64,
    an unknown generator, a misshapen operand."""
    f, g = model.perturbed_populations((4, 4, 32), 4, device=cuda)
    for params in (LBMParams(alpha0=1.0, alpha1=0.2),
                   LBMParams(alpha1=0.2, tau_f=0.8), LBMParams(tau_f=0.8)):
        fused_step.fused_stream_collide(f, g, 1, 1, params)
    psi = torch.empty((2, 4, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="lap must be given"):
        fused_step.launch_k(f, g, 1, 1, LBMParams(alpha1=0.2),
                            (torch.empty_like(f), torch.empty_like(g)), psi)
    with pytest.raises(ValueError, match="alias"):
        fused_step.laplacian_psi(psi, out=psi)
    with pytest.raises(ValueError, match="alias"):
        fused_step.fused_stream_collide(f, g, 1, 1, LBMParams(),
                                        out=(f, torch.empty_like(g)))
    with pytest.raises(TypeError, match="float32"):
        fused_step.fused_stream_collide(f.double(), g.double(), 1, 1,
                                        LBMParams())
    with pytest.raises(ValueError, match="unknown noise_dist"):
        fused_step.fused_stream_collide(f, g, 1, 1, LBMParams(kBT=1e-5),
                                        noise_dist="normal")
    fused_step.fused_stream_collide(f, g, 1, 1, LBMParams(kBT=1e-5),
                                    noise_dist="clt2")
    with pytest.raises(ValueError, match="ref must have shape"):
        fused_step.fused_stream_collide(f, g, 1, 1, LBMParams(kBT=1e-5),
                                        ref=f[:3].contiguous())
    with pytest.raises(ValueError, match="alias"):
        fused_step.fused_stream_collide(f, g, 1, 1, LBMParams(alpha0=1.5),
                                        psi=f[:2])


def _droplet(shape, device, rho_lo, seed, **kw):
    """Perturbed droplet populations on the card, radius 0.3 of X."""
    params = LBMParams(alpha0=1.5, kappa=0.1, rho_lo=rho_lo, rho_hi=3.0,
                       **kw)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, seed, base=base, device=device)
    return params, f, g


@pytest.mark.gpu
@pytest.mark.parametrize("rho_lo,kw,dist", [
    (0.0, dict(), "u8"),
    (0.0, dict(kBT=1e-5), "u8"),
    (0.0, dict(kBT=1e-5), "clt4"),
    (0.1, dict(kBT=1e-5, use_sc_pseudo=True), "clt4"),
])
def test_coupled_kernel_matches_plain(cuda, rho_lo, kw, dist):
    params, f, g = _droplet((32, 32, 32), cuda, rho_lo, 5, **kw)
    before = (fused_step.launches, fused_step.density_launches)
    fo, go = fused_step.fused_stream_collide(f, g, 12345, 678, params,
                                             noise_dist=dist)
    torch.cuda.synchronize()
    assert (fused_step.launches, fused_step.density_launches) == (
        before[0] + 1, before[1] + 1)
    fr, gr = fused_step.k_step_reference(f, g, 12345, 678, params, dist)
    assert max(_maxdiff(fo, fr), _maxdiff(go, gr)) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("sc", [False, True])
def test_density_psi_matches_plain(cuda, sc):
    params, f, g = _droplet((8, 24, 40), cuda, 0.0, 6, use_sc_pseudo=sc,
                            sc_ref_density=1.5)
    got = fused_step.density_psi(f, g, params)
    torch.cuda.synchronize()
    assert _maxdiff(got, fused_step.density_psi_reference(f, g, params)) \
        <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("dist", ["u8", "clt4", "clt2", "bm"])
def test_kernel_noise_bits_per_generator(cuda, dist):
    """The kernel draws the words of hash_normal_stack(dist): at kBT =
    1e-2 the noise kick is ~1e-2 per population, so kernel(kBT) -
    kernel(0) matching plain(kBT) - plain(0) to 2e-5 leaves no room for a
    wrong word or byte order (Box-Muller: its log, cos and sin differ by
    ulps between the kernel and torch); the next word's kick does not
    match."""
    f, g = model.perturbed_populations((8, 8, 128), 7, device=cuda)
    on, off = LBMParams(kBT=1e-2), LBMParams(kBT=0.0)

    def kick(fn, word):
        return fn(f, g, word, 3, on, noise_dist=dist)[0] \
            - fn(f, g, word, 3, off, noise_dist=dist)[0]

    def plain(f_, g_, w, s, p, noise_dist):
        return fused_step.k_step_reference(f_, g_, w, s, p, noise_dist)

    dk = kick(fused_step.fused_stream_collide, 9)
    dp = kick(plain, 9)
    assert float(dp.abs().max()) > 100 * ATOL
    assert _maxdiff(dk, dp) <= ATOL
    assert _maxdiff(kick(plain, 10), dk) > 100 * ATOL


@pytest.mark.gpu
def test_coupled_session_matches_plain_chain(cuda):
    shape = (16, 16, 32)
    params, f, g = _droplet(shape, cuda, 0.0, 8, kBT=1e-5)
    words = [5 * k - 17 for k in range(10)]
    ref = model.nsteps(init_state(f.clone(), g.clone(), 0), params, 10,
                       words, noise_dist="clt4")
    # no restore: its uniform ~1e-9 shift of f_0 moves cells with rho near
    # 0 across the |rho| > eps guard, and the plain chain has none
    sess = FusedSession(params, shape, noise_dist="clt4", mass_restore_int=0)
    before = (fused_step.launches, fused_step.density_launches)
    pc = sess.enter(init_state(f, g, 0), words[0])
    pc = sess.advance(pc, 9, words[1:])
    got = sess.exit(pc)
    assert (fused_step.launches, fused_step.density_launches) == (
        before[0] + 9, before[1] + 9)
    assert max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g)) <= ATOL


def _k_vs_plain(f, g, params, dist, ref=None):
    """One K through the kernels and through the plain K; returns the
    max |delta| after checking one K launch."""
    before = fused_step.launches
    fo, go = fused_step.fused_stream_collide(f, g, 2468, 97, params,
                                             noise_dist=dist, ref=ref)
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    fr, gr = fused_step.k_step_reference(f, g, 2468, 97, params, dist, ref)
    return max(_maxdiff(fo, fr), _maxdiff(go, gr))


@pytest.mark.gpu
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("dist", ["clt2", "bm"])
def test_new_generators_match_plain(cuda, coupled, dist):
    params, f, g = _droplet((32, 32, 32), cuda, 0.0, 9, kBT=1e-5)
    if not coupled:
        params = dataclasses.replace(params, alpha0=0.0)
    assert _k_vs_plain(f, g, params, dist) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("kBT,dist", [(0.0, "clt4"), (1e-5, "clt4"),
                                      (1e-5, "bm")])
def test_general_tau_matches_plain(cuda, coupled, kBT, dist):
    """K1d: tau_f = 0.7, tau_g = 0.6, all 19 moments relaxed."""
    params, f, g = _droplet((32, 32, 32), cuda, 0.1, 10, kBT=kBT,
                            tau_f=0.7, tau_g=0.6)
    if not coupled:
        params = dataclasses.replace(params, alpha0=0.0)
    assert fused_step.general_relax(params)
    assert _k_vs_plain(f, g, params, dist) <= ATOL


@pytest.mark.gpu
def test_force_general_relax_matches_plain(cuda, monkeypatch):
    """The test hook routes tau 1/2 through the general kernel and the
    general plain collide; both agree with each other and, to rounding,
    with the exact relaxation."""
    params, f, g = _droplet((32, 32, 32), cuda, 0.0, 11, kBT=1e-5)
    exact = fused_step.fused_stream_collide(f, g, 5, 6, params)
    monkeypatch.setattr(collide_ops, "FORCE_GENERAL_RELAX", True)
    assert fused_step.general_relax(params)
    assert _k_vs_plain(f, g, params, "clt4") <= ATOL
    general = fused_step.fused_stream_collide(f, g, 5, 6, params)
    assert _maxdiff(general[0], exact[0]) <= ATOL


def _ref_fields(shape, device, shift):
    """A (2, X, Y, Z) USE_REF_STATE operand: the densities of a droplet
    rolled by `shift`."""
    p = LBMParams(alpha0=1.5, kappa=0.1, rho_lo=0.05, rho_hi=2.5)
    st = model.init_droplet(shape, p, radius=0.25, device=device)
    return torch.stack([st.f.sum(0), st.g.sum(0)]).roll(shift, (1, 2, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("dist", ["clt4", "u8"])
def test_ref_kernel_matches_plain(cuda, coupled, dist):
    """K1e: the noise amplitudes read the ref operand; at kBT = 1e-2 its
    kick differs from the live-density kick far above the tolerance."""
    params, f, g = _droplet((32, 32, 32), cuda, 0.0, 12, kBT=1e-5)
    if not coupled:
        params = dataclasses.replace(params, alpha0=0.0)
    ref = _ref_fields((32, 32, 32), cuda, (3, -2, 5)).contiguous()
    assert _k_vs_plain(f, g, params, dist, ref) <= ATOL
    loud = dataclasses.replace(params, kBT=1e-2)
    with_ref = fused_step.fused_stream_collide(f, g, 1, 2, loud,
                                               noise_dist=dist, ref=ref)
    live = fused_step.fused_stream_collide(f, g, 1, 2, loud, noise_dist=dist)
    assert _maxdiff(with_ref[0], live[0]) > 100 * ATOL
    plain = fused_step.k_step_reference(f, g, 1, 2, loud, dist, ref)
    assert _maxdiff(with_ref[0], plain[0]) <= 10 * ATOL


@pytest.mark.gpu
def test_ref_session_crossing_matches_plain_chain(cuda):
    """The transactional USE_REF_STATE advance on the card lands on the
    per-step plain chain (which re-rolls every step) through a COM
    cell-boundary crossing."""
    params = LBMParams(alpha0=0.0, kBT=1e-8)
    shape = (8, 8, 128)
    state, rho, phi = model.boosted_state(shape, (0.0, 0.0, 0.35),
                                         device=cuda)
    com = stats.center_of_mass(rho)
    words = [11 * k + 5 for k in range(8)]
    ref = model.nsteps(state.replace(f=state.f.clone(), g=state.g.clone()),
                       params, 8, words, ref_state=(rho, phi, com))
    sess = FusedSession(params, shape, mass_restore_int=0,
                        ref_fields=(rho, phi, com))
    before = fused_step.launches
    pc = sess.enter(state, words[0])
    pc = sess.advance(pc, 7, words[1:])
    got = sess.exit(pc)
    assert got.step == 8 and sess.ref_violations() > 0
    assert fused_step.launches > before + 7   # rolled-back sub-chunks
    assert max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g)) <= ATOL


@pytest.mark.gpu
def test_run_on_the_card_matches_cpu(cuda, tmp_path):
    """The driver at 32^3, kBT = 0: the card's run ends where the CPU's
    (plain K) does."""
    cfg = preset("droplet-eq").replace(
        shape=(32, 32, 32), nsteps=20, plot_int=10, print_int=10,
        droplet_int=10, t_window=10)
    gpu = run_mod.run(cfg.replace(out_dir=str(tmp_path / "gpu")))
    cpu = run_mod.run(cfg.replace(out_dir=str(tmp_path / "cpu")),
                      device="cpu")
    assert gpu.step == cpu.step == 20 and gpu.f.is_cuda
    assert max(_maxdiff(gpu.f.cpu(), cpu.f), _maxdiff(gpu.g.cpu(), cpu.g)) \
        <= ATOL
    assert (tmp_path / "gpu" / "equilibrium.npz").exists()


def _alpha1_droplet(shape, device, seed, alpha0=1.2, **kw):
    """Perturbed droplet populations of the alpha1 configuration on the
    card (radius 0.3 of X)."""
    params = LBMParams(alpha0=alpha0, alpha1=0.5, kappa=0.1, rho_lo=0.1,
                       rho_hi=3.0, **kw)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, seed, base=base, device=device)
    return params, f, g


@pytest.mark.gpu
@pytest.mark.parametrize("sc", [False, True])
def test_laplacian_psi_matches_plain(cuda, sc):
    """Kernel L on the density pre-pass's output."""
    params, f, g = _alpha1_droplet((32, 32, 32), cuda, 13,
                                   use_sc_pseudo=sc)
    psi = fused_step.density_psi(f, g, params)
    before = fused_step.laplacian_launches
    got = fused_step.laplacian_psi(psi)
    torch.cuda.synchronize()
    assert fused_step.laplacian_launches == before + 1
    assert _maxdiff(got, fused_step.laplacian_psi_reference(psi)) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("alpha0,kw,dist", [
    (1.2, dict(), "u8"),
    (0.0, dict(), "u8"),
    (1.2, dict(kBT=1e-5), "clt4"),
    (0.0, dict(kBT=1e-5), "clt4"),
    (1.2, dict(kBT=1e-5, tau_f=0.7, tau_g=0.6), "clt4"),
])
def test_alpha1_kernel_matches_plain(cuda, alpha0, kw, dist):
    """Kernel B-A1 (through A, L and K) against the plain K with the
    square-gradient force; one launch of each of A, L and K, all in the
    "alpha1" mode."""
    params, f, g = _alpha1_droplet((32, 32, 32), cuda, 14, alpha0, **kw)
    fused_step.reset_launch_counts()
    fo, go = fused_step.fused_stream_collide(f, g, 2468, 97, params,
                                             noise_dist=dist)
    torch.cuda.synchronize()
    assert (fused_step.density_launches, fused_step.laplacian_launches,
            fused_step.launches, fused_step.mode_launches["alpha1"]) \
        == (1, 1, 1, 1)
    fr, gr = fused_step.k_step_reference(f, g, 2468, 97, params, dist)
    assert max(_maxdiff(fo, fr), _maxdiff(go, gr)) <= ATOL
    # the square-gradient force is far above the tolerance
    free = fused_step.k_step_reference(
        f, g, 2468, 97, dataclasses.replace(params, alpha1=0.0), dist)
    assert _maxdiff(free[0], fo) > 50 * ATOL


@pytest.mark.gpu
def test_alpha1_session_matches_cpu(cuda):
    """The alpha1 session (clt4, 1 + 4 + 5 steps) on the card against the
    same session on the CPU (plain K)."""
    shape = (16, 16, 32)
    params, f, g = _alpha1_droplet(shape, "cpu", 15, kBT=1e-5)
    words = [7 * k - 20 for k in range(10)]

    def go(dev):
        sess = FusedSession(params, shape, noise_dist="clt4",
                            mass_restore_int=0)
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        pc = sess.advance(pc, 4, words[1:5])
        pc = sess.advance(pc, 5, words[5:])
        return sess.exit(pc)

    fused_step.reset_launch_counts()
    got = go(cuda)
    assert (fused_step.launches, fused_step.laplacian_launches) == (9, 9)
    ref = go("cpu")
    assert max(_maxdiff(got.f.cpu(), ref.f), _maxdiff(got.g.cpu(), ref.g)) \
        <= ATOL


@pytest.mark.gpu
def test_native_frames_of_card_tensors(cuda, tmp_path):
    """write_frame(fmt="native") and the async writer take the card's
    tensors; both files read back bitwise."""
    packed = torch.randn((22, 8, 8, 16), device=cuda)
    want = packed.cpu().numpy()
    path = fields_io.write_frame(str(tmp_path / "a"), 3, packed,
                                 fmt="native")
    with native.AsyncFieldWriter() as writer:
        apath = fields_io.write_frame(str(tmp_path / "b"), 3, packed,
                                      fmt="native", writer=writer)
    for p in (path, apath):
        assert p.endswith("plt0000003.bflbm")
        got = fields_io.read_frame(p)
        assert int(got["step"]) == 3
        for i, name in enumerate(fields_io.HYDRO_NAMES):
            assert (got[name] == want[i]).all()


# K7 ext mode: the modes of chip_smoke.py phase 9a, each (params, generator,
# with a ref operand)
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)
_EXT_MODES = {
    "u8 uncoupled": (dict(kBT=1e-5), "u8", False),
    "clt4 alpha0": (dict(_DROP, alpha0=1.5, kBT=1e-5), "clt4", False),
    "alpha1": (dict(_DROP, alpha0=1.2, alpha1=0.5, kBT=1e-5), "clt4", False),
    "general tau": (dict(_DROP, alpha0=1.5, kBT=1e-5, tau_f=0.7, tau_g=0.6),
                    "clt4", False),
    "ref": (dict(_DROP, alpha0=1.5, kBT=1e-5), "clt4", True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 2, 2), (2, 2, 1)])
@pytest.mark.parametrize("mode", sorted(_EXT_MODES))
def test_ext_kernels_match_plain(cuda, mesh_shape, mode):
    """A, L and K in ext mode on every block of a 32^3 droplet decomposed
    over the mesh (blocks on one card), against the plain ext versions;
    K's interior also equals the whole-domain kernel's cells to the bit
    (one instantiation, one arithmetic)."""
    kw, dist, with_ref = _EXT_MODES[mode]
    params = LBMParams(**kw)
    shape = (32, 32, 32)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, 21, base=base, device=cuda)
    ref = (torch.stack([f.sum(0), g.sum(0)]).roll((2, -3, 1), (1, 2, 3))
           .contiguous() if with_ref else None)
    whole = fused_step.fused_stream_collide(f, g, 97531, 864, params,
                                            noise_dist=dist, ref=ref)
    mesh = mesh_lib.make_mesh(mesh_shape, cuda)
    pad = mesh.pads(fused_step.sd_depth(params))
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    refs = (mesh_lib.shard_field(ref, mesh, pad) if with_ref
            else [None] * mesh.size)
    exts = halo.block_exts(mesh, shape, pad)
    fused_step.reset_launch_counts()
    for b, (blk, ext) in enumerate(zip(ss.blocks, exts)):
        fb, gb = blk[0], blk[1]
        psi = torch.zeros((2,) + tuple(fb.shape[1:]), device=cuda)
        lap = torch.zeros_like(psi)
        fo, go = fused_step.fused_stream_collide(
            fb, gb, 97531, 864, params, noise_dist=dist, psi=psi, lap=lap,
            ref=refs[b], ext=ext)
        torch.cuda.synchronize()
        fr, gr = fused_step.k_step_reference(fb, gb, 97531, 864, params,
                                             dist, refs[b], ext)
        assert max(_maxdiff(ext.region(fo), fr),
                   _maxdiff(ext.region(go), gr)) <= ATOL
        o, n = ext.origin, ext.interior(fb.shape)
        cells = (slice(None),) + tuple(slice(a, a + k) for a, k in zip(o, n))
        assert torch.equal(ext.region(fo), whole[0][cells])
        assert torch.equal(ext.region(go), whole[1][cells])
        if fused_step.is_coupled(params):
            want = fused_step.density_psi_reference(fb, gb, params, ext)
            assert _maxdiff(ext.region(psi, 1), want) <= ATOL
        if fused_step.has_alpha1(params):
            want = fused_step.laplacian_psi_reference(psi, ext)
            assert _maxdiff(ext.region(lap, 2), want) <= ATOL
    coupled = int(fused_step.is_coupled(params))
    assert fused_step.launches == fused_step.mode_launches["ext"] \
        == mesh.size
    assert fused_step.density_launches == coupled * mesh.size
    assert fused_step.laplacian_launches == \
        int(fused_step.has_alpha1(params)) * mesh.size


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (1, 2, 2)])
def test_sharded_session_matches_cpu_and_fused(cuda, mesh_shape):
    """The sharded session (clt4 droplet, 1 + 4 + 5 steps, restore every 4)
    on the card against the same session on the CPU (plain ext K), and
    against FusedSession on the card: bitwise up to the first restore."""
    params = LBMParams(**_DROP, alpha0=1.5, kBT=1e-5)
    shape = (16, 16, 32)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, 22, base=base, device="cpu")
    words = [13 * k - 40 for k in range(10)]

    def go(dev, mesh, restore, n=(4, 5)):
        sess = (ShardedSession(mesh, params, shape, mass_restore_int=restore)
                if mesh else FusedSession(params, shape,
                                          mass_restore_int=restore))
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        used = 1
        for k in n:
            pc = sess.advance(pc, k, words[used:used + k])
            used += k
        return sess.exit(pc)

    card = mesh_lib.make_mesh(mesh_shape, cuda)
    fused_step.reset_launch_counts()
    got = go(cuda, card, 4)
    assert fused_step.launches == fused_step.mode_launches["ext"] == 9 * 4
    cpu = go("cpu", mesh_lib.make_mesh(mesh_shape, "cpu"), 4)
    assert max(_maxdiff(got.f.cpu(), cpu.f), _maxdiff(got.g.cpu(), cpu.g)) \
        <= ATOL
    early = go(cuda, card, 0, (2,))
    fused = go(cuda, None, 0, (2,))
    assert torch.equal(early.f, fused.f) and torch.equal(early.g, fused.g)


# K7 window launches (the overlap split) and strip-fed launches (ystrips)

def _padded_droplet(cuda, params, mesh_shape, seed=23):
    shape = (32, 32, 32)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, seed, base=base, device=cuda)
    mesh = mesh_lib.make_mesh(mesh_shape, cuda)
    pad = mesh.pads(fused_step.sd_depth(params))
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    return shape, mesh, ss, halo.block_exts(mesh, shape, pad)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("mode", ["u8 uncoupled", "clt4 alpha0", "alpha1",
                                  "ref"])
def test_window_launches_write_their_window(cuda, mesh_shape, mode):
    """A, L and K launched on the overlap split's windows (the interior
    window and the seam bands) into NaN-filled outputs: each writes
    exactly its window, bitwise the whole-block ext launch there, within
    ATOL of the plain versions."""
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import kernel as kernel_par

    kw, dist, with_ref = _EXT_MODES[mode]
    params = LBMParams(**kw)
    shape, mesh, ss, exts = _padded_droplet(cuda, params, mesh_shape)
    lay = kernel_par.layout(mesh, shape, params, True)
    assert any(lay.split) and lay.pad == ss.pad
    inner, bands = kernel_par.split_windows(lay, ss.blocks[0].shape,
                                            fused_step.sd_depth(params))
    fb, gb = ss.blocks[-1][0], ss.blocks[-1][1]
    ext = exts[-1]
    ref = (torch.stack([fb.sum(0), gb.sum(0)]).contiguous() if with_ref
           else None)
    psi = lap = None
    if fused_step.is_coupled(params):
        psi = fused_step.density_psi(fb, gb, params, ext=ext)
        if fused_step.has_alpha1(params):
            lap = fused_step.laplacian_psi(psi, ext=ext)
    whole = fused_step.fused_stream_collide(fb, gb, 11, 7, params,
                                            noise_dist=dist, ref=ref,
                                            ext=ext)
    fr, gr = fused_step.k_step_reference(fb, gb, 11, 7, params, dist, ref,
                                         ext)

    def nan(lead):
        return torch.full((lead,) + tuple(fb.shape[1:]), float("nan"),
                          device=cuda)

    def check(got, want, win, plain_region, bounds):
        assert torch.equal(blocked.box_view(got, win),
                           blocked.box_view(want, win))
        assert int(torch.isnan(got).sum()) == got.numel() \
            - blocked.box_view(got, win).numel()
        rel = tuple((a - s, b - s) for (a, b), (s, _) in zip(win, bounds))
        assert _maxdiff(blocked.box_view(got, win),
                        blocked.box_view(plain_region, rel)) <= ATOL

    fused_step.reset_launch_counts()
    for win in [inner] + bands:
        out = (nan(19), nan(19))
        fused_step.launch_k(fb, gb, 11, 7, params, out, psi, dist, ref,
                            lap=lap, ext=ext, window=win)
        torch.cuda.synchronize()
        for got, want, pl in zip(out, whole, (fr, gr)):
            check(got, want, win, pl, ext.bounds(fb.shape))
        if psi is not None:
            a_win, l_win = fused_step.prepass_windows(params, ext, fb.shape,
                                                      win)
            got = fused_step.density_psi(fb, gb, params, out=nan(2),
                                         ext=ext, window=a_win)
            check(got, psi, a_win,
                  fused_step.density_psi_reference(fb, gb, params, ext),
                  ext.bounds(fb.shape, 1))
            if lap is not None:
                got = fused_step.laplacian_psi(psi, out=nan(2), ext=ext,
                                               window=l_win)
                check(got, lap, l_win,
                      fused_step.laplacian_psi_reference(psi, ext),
                      ext.bounds(fb.shape, 2))
    assert fused_step.mode_launches["window"] == 1 + len(bands)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("mode", ["u8 uncoupled", "clt4 alpha0", "alpha1",
                                  "ref"])
def test_interior_window_reads_no_pad(cuda, mesh_shape, mode):
    """The split launches the interior window's A, L and K while the side
    stream fills the pads: on a copy of the block whose pads are all NaN,
    from NaN psi and lap, they give the window bitwise what the
    whole-block launches give on exchanged pads."""
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import kernel as kernel_par

    kw, dist, with_ref = _EXT_MODES[mode]
    params = LBMParams(**kw)
    shape, mesh, ss, exts = _padded_droplet(cuda, params, mesh_shape, 25)
    lay = kernel_par.layout(mesh, shape, params, True)
    inner, _ = kernel_par.split_windows(lay, ss.blocks[0].shape,
                                        fused_step.sd_depth(params))

    def nan_pads(t, box):
        out = torch.full_like(t, float("nan"))
        blocked.box_view(out, box).copy_(blocked.box_view(t, box))
        return out

    for blk, ext in zip(ss.blocks, exts):
        fb, gb = blk[0], blk[1]
        box = ext.bounds(fb.shape)
        ref = (torch.stack([fb.sum(0), gb.sum(0)]).contiguous() if with_ref
               else None)
        whole = fused_step.fused_stream_collide(fb, gb, 5, 3, params,
                                                noise_dist=dist, ref=ref,
                                                ext=ext)
        bf, bg = nan_pads(fb, box), nan_pads(gb, box)
        nan2 = torch.full((2,) + tuple(fb.shape[1:]), float("nan"),
                          device=cuda)
        psi = lap = None
        if fused_step.is_coupled(params):
            a_win, l_win = fused_step.prepass_windows(params, ext, fb.shape,
                                                      inner)
            psi = fused_step.density_psi(bf, bg, params, out=nan2.clone(),
                                         ext=ext, window=a_win)
            want = fused_step.density_psi(fb, gb, params, ext=ext)
            assert torch.equal(blocked.box_view(psi, a_win),
                               blocked.box_view(want, a_win))
            if fused_step.has_alpha1(params):
                lap = fused_step.laplacian_psi(psi, out=nan2.clone(),
                                               ext=ext, window=l_win)
                want = fused_step.laplacian_psi(want, ext=ext)
                assert torch.equal(blocked.box_view(lap, l_win),
                                   blocked.box_view(want, l_win))
        out = (torch.full_like(fb, float("nan")),
               torch.full_like(gb, float("nan")))
        fused_step.launch_k(bf, bg, 5, 3, params, out, psi, dist,
                            None if ref is None else nan_pads(ref, box),
                            lap=lap, ext=ext, window=inner)
        torch.cuda.synchronize()
        for got, w in zip(out, whole):
            assert torch.equal(blocked.box_view(got, inner),
                               blocked.box_view(w, inner))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["u8 uncoupled", "clt4 alpha0", "alpha1"])
def test_strip_fed_kernels_match_plain(cuda, mode):
    """On mesh (2, 2, 1), A and K reading the y halo from the exchanged
    strips (the blocks' y pads NaN) against their plain versions, and
    bitwise the pad-fed ext launch; the strips K writes equal its edge
    rows bitwise."""
    from bflbm_tpu_torch.parallel import kernel as kernel_par

    kw, dist, _ = _EXT_MODES[mode]
    params = LBMParams(**kw)
    shape, mesh, ss, exts = _padded_droplet(cuda, params, (2, 2, 1))
    pad = ss.pad
    padfed = [fused_step.fused_stream_collide(b[0], b[1], 3, 9, params,
                                              noise_dist=dist, ext=e)
              for b, e in zip(ss.blocks, exts)]
    sent = kernel_par.strip_buffers(ss.blocks, pad)
    received = [torch.empty_like(t) for t in sent]
    halo.run_plan(halo.strip_plan(sent, received, mesh, pad))
    py = pad[1]
    fused_step.reset_launch_counts()
    for b, (blk, ext) in enumerate(zip(ss.blocks, exts)):
        blk[..., :py, :] = float("nan")
        blk[..., blk.shape[-2] - py:, :] = float("nan")
        out_strips = torch.full_like(sent[b], float("nan"))
        fo, go = fused_step.fused_stream_collide(
            blk[0], blk[1], 3, 9, params, noise_dist=dist, ext=ext,
            strips=received[b], strips_out=out_strips)
        torch.cuda.synchronize()
        fr, gr = fused_step.k_step_reference(blk[0], blk[1], 3, 9, params,
                                             dist, None, ext, received[b])
        assert max(_maxdiff(ext.region(fo), fr),
                   _maxdiff(ext.region(go), gr)) <= ATOL
        assert torch.equal(ext.region(fo), ext.region(padfed[b][0]))
        assert torch.equal(ext.region(go), ext.region(padfed[b][1]))
        px = pad[0]
        for s, o in enumerate((fo, go)):
            inner = o[:, px:o.shape[1] - px]
            ny = inner.shape[2] - 2 * py
            assert torch.equal(out_strips[0, s][:, px:o.shape[1] - px],
                               inner[:, :, py:2 * py])
            assert torch.equal(out_strips[1, s][:, px:o.shape[1] - px],
                               inner[:, :, ny:ny + py])
        if fused_step.is_coupled(params):
            psi = fused_step.density_psi(blk[0], blk[1], params, ext=ext,
                                         strips=received[b])
            want = fused_step.density_psi_reference(blk[0], blk[1], params,
                                                    ext, received[b])
            assert _maxdiff(ext.region(psi, 1), want) <= ATOL
    assert fused_step.mode_launches["ystrips"] == mesh.size


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(overlap=True),
                                  dict(y_exchange="strips")])
def test_split_and_strips_sessions_match_cpu_and_serial(cuda, opts):
    """A split session and a strips session on the card (alpha1 droplet,
    1 + 2 + 4 steps, restore every 4) against the same session on the CPU
    within ATOL and the serial session on the card bitwise."""
    params = LBMParams(**_DROP, alpha0=1.2, alpha1=0.5, kBT=1e-5)
    shape = (16, 16, 32)
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, 24, base=base, device="cpu")
    words = [29 * k - 11 for k in range(7)]

    def go(dev, kw):
        sess = ShardedSession(mesh_lib.make_mesh((2, 2, 1), dev), params,
                              shape, mass_restore_int=4, **kw)
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        pc = sess.advance(pc, 2, words[1:3])
        pc = sess.advance(pc, 4, words[3:])
        return sess.exit(pc)

    fused_step.reset_launch_counts()
    got = go(cuda, opts)
    modes = dict(fused_step.mode_launches)
    if opts.get("overlap"):
        assert modes["window"] == 6 * 4 * 5
    else:
        assert modes["ystrips"] == 6 * 4
    serial = go(cuda, dict(y_exchange="serial"))
    assert torch.equal(got.f, serial.f) and torch.equal(got.g, serial.g)
    cpu = go("cpu", opts)
    assert max(_maxdiff(got.f.cpu(), cpu.f), _maxdiff(got.g.cpu(), cpu.g)) \
        <= ATOL


_K4_MODES = {   # name -> (LBMParams kwargs, generator, with the ref operand)
    "off": (dict(kBT=0.0), "u8", False),
    "u8": (dict(kBT=1e-5), "u8", False),
    "clt4": (dict(kBT=1e-5), "clt4", False),
    "clt2": (dict(kBT=1e-5), "clt2", False),
    "bm": (dict(kBT=1e-5), "bm", False),
    "ref": (dict(kBT=1e-5), "clt4", True),
    "general": (dict(kBT=1e-5, tau_f=0.7, tau_g=0.6), "clt4", False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("T", [2, 3, 4])
@pytest.mark.parametrize("mode", sorted(_K4_MODES))
@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 40)])
def test_blocked_kernel_matches_plain(cuda, T, mode, shape):
    """One K4 launch of T steps against its plain version (the plain sweep
    on the kernel's tiles; (12, 20, 40) is divided by none) and against T
    one-step K launches with the same words."""
    from bflbm_tpu_torch.ops import blocked

    kw, dist, with_ref = _K4_MODES[mode]
    params = LBMParams(**kw)
    f, g = model.perturbed_populations(shape, 31, device=cuda)
    ref = (1.0 + 0.1 * torch.rand((2,) + shape, generator=torch.Generator()
                                  .manual_seed(32))).to(cuda) \
        if with_ref else None
    words = [7919 * k - 3 for k in range(T)]
    before = fused_step.blocked_launches
    fo, go = fused_step.blocked_stream_collide(f, g, words, 40, params, T,
                                               noise_dist=dist, ref=ref)
    torch.cuda.synchronize()
    assert fused_step.blocked_launches == before + 1
    fr, gr = blocked.blocked_sweep_reference(
        f, g, words, 40, params, T, fused_step.blocked_tile(T, f.shape),
        dist, ref)
    assert max(_maxdiff(fo, fr), _maxdiff(go, gr)) <= ATOL
    fa, ga = f, g
    for s, w in enumerate(words):
        fa, ga = fused_step.fused_stream_collide(fa, ga, w, 40 + s, params,
                                                 noise_dist=dist, ref=ref)
    assert max(_maxdiff(fo, fa), _maxdiff(go, ga)) <= ATOL


@pytest.mark.gpu
def test_blocked_session_matches_cpu(cuda):
    """FusedSession(block=3) on the card (1 + 7 steps, restore every 4)
    against the same session on the CPU: two sweeps and a single step."""
    params = LBMParams(kBT=1e-5)
    shape = (16, 16, 32)
    f, g = model.perturbed_populations(shape, 33, device="cpu")
    words = [13 * k + 2 for k in range(8)]

    def go(dev):
        sess = FusedSession(params, shape, noise_dist="u8",
                            mass_restore_int=4, block=3)
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        return sess.exit(sess.advance(pc, 7, words[1:]))

    fused_step.reset_launch_counts()
    got = go(cuda)
    assert fused_step.blocked_launches == 2 and fused_step.launches == 1
    cpu = go("cpu")
    assert max(_maxdiff(got.f.cpu(), cpu.f), _maxdiff(got.g.cpu(), cpu.g)) \
        <= ATOL


@pytest.mark.gpu
def test_blocked_kernel_refusals(cuda):
    f, g = model.perturbed_populations((8, 8, 8), 34, device=cuda)
    p = LBMParams(kBT=1e-5)
    with pytest.raises(ValueError, match="shared memory"):
        fused_step.blocked_stream_collide(f, g, [1] * 5, 0, p, 5)
    with pytest.raises(ValueError, match="alias"):
        fused_step.blocked_stream_collide(f, g, [1, 2], 0, p, 2, out=(f, g))
    coupled = LBMParams(**_DROP, alpha0=1.5, kBT=1e-5)
    with pytest.raises(ValueError, match="297856 bytes"):
        fused_step.blocked_stream_collide(f, g, [1] * 4, 0, coupled, 4)
    with pytest.raises(ValueError, match="303776 bytes"):
        fused_step.blocked_stream_collide(
            f, g, [1] * 3, 0, dataclasses.replace(coupled, alpha1=0.5), 3)
    # the decomposed path runs block 2 (pads sd T = 4 deep), the overlap
    # split too (local x 10: the interior window 2 planes, the bands 4)
    mesh = mesh_lib.make_mesh((2, 1, 1), cuda)
    sess = ShardedSession(mesh, coupled, (16, 16, 16), block=2)
    assert sess.pad == (4, 0, 0)
    pc = sess.enter(init_state(*_droplet_pops((16, 16, 16), coupled, 38,
                                              cuda), 0))
    assert sess.advance(pc, 2).step == 3
    sess = ShardedSession(mesh, coupled, (20, 16, 16), block=2, overlap=True)
    assert sess.layout.split == (True, False, False)
    pc = sess.enter(init_state(*_droplet_pops((20, 16, 16), coupled, 38,
                                              cuda), 0))
    assert sess.advance(pc, 2).step == 3
    # a window with y strips, a window outside the interior
    f4, g4 = pc.blocks[0][0], pc.blocks[0][1]
    with pytest.raises(ValueError, match="no y strips"):
        fused_step.blocked_stream_collide(
            f4, g4, [1, 2], 0, coupled, 2, ext=halo.block_exts(
                mesh, (20, 16, 16), sess.pad)[0],
            window=((4, 6), (0, 16), (0, 16)),
            strips=torch.zeros((2, 2, 19, 18, 0, 16), device=cuda))
    with pytest.raises(ValueError, match="inside"):
        fused_step.blocked_stream_collide(
            f4, g4, [1, 2], 0, coupled, 2, ext=halo.block_exts(
                mesh, (20, 16, 16), sess.pad)[0],
            window=((2, 6), (0, 16), (0, 16)))


# K4 with a force: (stencil depth tag, T) -> the force's LBMParams keywords
_K4_FORCE = {
    ("coupled", 2): dict(_DROP, alpha0=1.5),
    ("coupled", 3): dict(_DROP, alpha0=1.5),
    ("alpha1", 2): dict(_DROP, alpha0=1.2, alpha1=0.5),
}


def _droplet_pops(shape, params, seed, dev):
    base = model.init_droplet(shape, params, device="cpu", radius=0.3)
    return model.perturbed_populations(shape, seed, base=base, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_K4_FORCE))
@pytest.mark.parametrize("mode", sorted(_K4_MODES))
@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 20, 40)])
def test_blocked_force_kernel_matches_plain(cuda, case, mode, shape):
    """One K4 launch of T steps with the Shan-Chen (and alpha1) force on a
    perturbed droplet against its plain version (the plain sweep on the
    kernel's tiles) and against T one-step launches (A, L, K) with the
    same words; the sweep launches no pre-pass."""
    from bflbm_tpu_torch.ops import blocked

    _, T = case
    kw, dist, with_ref = _K4_MODES[mode]
    params = LBMParams(**dict(_K4_FORCE[case], **kw))
    f, g = _droplet_pops(shape, params, 35, cuda)
    ref = (1.0 + 0.1 * torch.rand((2,) + shape, generator=torch.Generator()
                                  .manual_seed(36))).to(cuda) \
        if with_ref else None
    words = [7919 * k - 3 for k in range(T)]
    fused_step.reset_launch_counts()
    fo, go = fused_step.blocked_stream_collide(f, g, words, 40, params, T,
                                               noise_dist=dist, ref=ref)
    torch.cuda.synchronize()
    assert (fused_step.blocked_launches, fused_step.density_launches,
            fused_step.laplacian_launches) == (1, 0, 0)
    fr, gr = blocked.blocked_sweep_reference(
        f, g, words, 40, params, T,
        fused_step.blocked_tile(T, f.shape, fused_step.sd_depth(params)),
        dist, ref)
    assert max(_maxdiff(fo, fr), _maxdiff(go, gr)) <= ATOL
    fa, ga = f, g
    for s, w in enumerate(words):
        fa, ga = fused_step.fused_stream_collide(fa, ga, w, 40 + s, params,
                                                 noise_dist=dist, ref=ref)
    assert max(_maxdiff(fo, fa), _maxdiff(go, ga)) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("alpha1", [0.0, 0.5])
def test_blocked_coupled_session_matches_cpu(cuda, alpha1):
    """A block-2 droplet session on the card (1 + 7 steps, restore every
    4: three sweeps and a single step) against the same session on the
    CPU; only the single step launches the pre-passes."""
    params = LBMParams(**dict(_DROP, alpha0=1.5 if not alpha1 else 1.2,
                              alpha1=alpha1, kBT=1e-5))
    shape = (16, 16, 32)
    f, g = _droplet_pops(shape, params, 37, "cpu")
    words = [13 * k + 2 for k in range(8)]

    def go(dev):
        sess = FusedSession(params, shape, noise_dist="clt4",
                            mass_restore_int=4, block=2)
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        return sess.exit(sess.advance(pc, 7, words[1:]))

    fused_step.reset_launch_counts()
    got = go(cuda)
    assert (fused_step.blocked_launches, fused_step.launches,
            fused_step.density_launches,
            fused_step.laplacian_launches) == (3, 1, 1, 1 if alpha1 else 0)
    cpu = go("cpu")
    assert max(_maxdiff(got.f.cpu(), cpu.f), _maxdiff(got.g.cpu(), cpu.g)) \
        <= ATOL


# K4 on halo-extended blocks: (stencil depth, T) -> the force's keywords
_K4_EXT_CASES = {
    (1, 2): {}, (1, 3): {},
    (2, 2): dict(_DROP, alpha0=1.5), (2, 3): dict(_DROP, alpha0=1.5),
    (3, 2): dict(_DROP, alpha0=1.2, alpha1=0.5),
}


def _one_step_mesh(blocks, mesh, pad, exts, words, step0, params, dist,
                   refs):
    """T steps of one-step ext launches with an exchange before each, on
    copies of the padded blocks (each (2, Q, ...))."""
    cur = [b.clone() for b in blocks]
    for s, w in enumerate(words):
        halo.exchange_halo(cur, mesh, pad)
        nxt = []
        for b, ext, r in zip(cur, exts, refs):
            out = torch.empty_like(b)
            fused_step.fused_stream_collide(b[0], b[1], w, step0 + s, params,
                                            out=(out[0], out[1]),
                                            noise_dist=dist, ref=r, ext=ext)
            nxt.append(out)
        cur = nxt
    return cur


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_K4_EXT_CASES))
@pytest.mark.parametrize("mode", sorted(_K4_MODES))
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 1), (1, 2, 2)])
def test_blocked_ext_kernel_matches_plain(cuda, case, mode, mesh_shape):
    """One K4 launch of T steps on every block of a 16 x 12 x 20 droplet
    (pads sd T deep, exchanged once; the ref operand's pads filled too)
    against the plain ext sweep on the block, against T one-step ext
    launches with an exchange before each, and against the whole-domain
    K4 launch on the block's cells."""
    from bflbm_tpu_torch.ops import blocked

    sd, T = case
    kw, dist, with_ref = _K4_MODES[mode]
    params = LBMParams(**dict(_K4_EXT_CASES[case], **kw))
    shape = (16, 12, 20)
    f, g = _droplet_pops(shape, params, 39, cuda)
    ref = (1.0 + 0.1 * torch.rand((2,) + shape, generator=torch.Generator()
                                  .manual_seed(40))).to(cuda) \
        if with_ref else None
    words = [7919 * k - 3 for k in range(T)]
    mesh = mesh_lib.make_mesh(mesh_shape, cuda)
    pad = mesh.pads(sd * T)
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    exts = halo.block_exts(mesh, shape, pad)
    refs = [None] * mesh.size
    if with_ref:
        refs = mesh_lib.shard_field(ref, mesh, pad)
        halo.exchange_halo(refs, mesh, pad)
    whole = fused_step.blocked_stream_collide(f, g, words, 40, params, T,
                                              noise_dist=dist, ref=ref)
    k1 = _one_step_mesh(ss.blocks, mesh, pad, exts, words, 40, params, dist,
                        refs)
    for b, (blk, ext, r) in enumerate(zip(ss.blocks, exts, refs)):
        fused_step.reset_launch_counts()
        fo, go = fused_step.blocked_stream_collide(
            blk[0], blk[1], words, 40, params, T, noise_dist=dist, ref=r,
            ext=ext)
        torch.cuda.synchronize()
        assert (fused_step.blocked_launches, fused_step.launches,
                fused_step.mode_launches.get("blocked ext")) == (1, 0, 1)
        fr, gr = blocked.blocked_sweep_reference(
            blk[0], blk[1], words, 40, params, T,
            fused_step.blocked_tile(T, ext.interior(blk.shape), sd), dist,
            r, ext)
        got = (ext.region(fo), ext.region(go))
        assert max(_maxdiff(got[0], fr), _maxdiff(got[1], gr)) <= ATOL
        assert max(_maxdiff(got[0], ext.region(k1[b][0])),
                   _maxdiff(got[1], ext.region(k1[b][1]))) <= ATOL
        cells = (slice(None),) + tuple(
            slice(o, o + n) for o, n in zip(ext.origin,
                                            ext.interior(blk.shape)))
        assert max(_maxdiff(got[0], whole[0][cells]),
                   _maxdiff(got[1], whole[1][cells])) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 1)])
def test_blocked_sharded_session_matches_cpu_and_fused(cuda, mesh_shape):
    """ShardedSession(block=2) of the droplet on the card (1 + 7 steps,
    restore every 4: three sweeps and a single step) against the same
    session on the CPU and against FusedSession(block=2) on the card."""
    params = LBMParams(**dict(_DROP, alpha0=1.5, kBT=1e-5))
    shape = (16, 16, 32)
    f, g = _droplet_pops(shape, params, 41, "cpu")
    words = [13 * k + 2 for k in range(8)]

    def go(dev, mesh):
        sess = (ShardedSession(mesh, params, shape, mass_restore_int=4,
                               block=2) if mesh is not None else
                FusedSession(params, shape, mass_restore_int=4, block=2))
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        return sess.exit(sess.advance(pc, 7, words[1:]))

    fused_step.reset_launch_counts()
    got = go(cuda, mesh_lib.make_mesh(mesh_shape, cuda))
    n = int(torch.tensor(mesh_shape).prod())
    assert (fused_step.blocked_launches, fused_step.launches,
            fused_step.mode_launches.get("blocked ext")) == (3 * n, n, 3 * n)
    cpu = go("cpu", mesh_lib.make_mesh(mesh_shape, "cpu"))
    fused = go(cuda, None)
    for other in (cpu, fused):
        assert max(_maxdiff(got.f.cpu(), other.f.cpu()),
                   _maxdiff(got.g.cpu(), other.g.cpu())) <= ATOL


@pytest.mark.gpu
def test_ref_kernel_on_zero_density_droplet(cuda):
    """The one-step kernel with random ref amplitudes 1 + 0.1 U on the
    rho_lo = 0 droplet one step in, at 32^3, against the plain step (the
    case of the ref fault at 256^3 in ROADMAP Queue 3), two steps."""
    params = LBMParams(alpha0=1.5, kappa=0.1, rho_lo=0.0, rho_hi=3.0,
                       kBT=1e-5)
    shape = (32, 32, 32)
    base = model.init_droplet(shape, params, radius=0.3, device=cuda)
    pc = FusedSession(params, shape, block=1).enter(base, 12345)
    ref = (1.0 + 0.1 * torch.rand((2,) + shape, generator=torch.Generator()
                                  .manual_seed(42))).to(cuda)
    a = b = (pc.f, pc.g)
    for s in range(2):
        a = fused_step.fused_stream_collide(*a, 1000 + s, 77 + s, params,
                                            ref=ref)
        b = fused_step.k_step_reference(*b, 1000 + s, 77 + s, params,
                                        "clt4", ref)
        assert max(_maxdiff(a[0], b[0]), _maxdiff(a[1], b[1])) <= ATOL


# K4 in the overlap split (windowed launches) and the y strips (strip-fed
# launches): sweep -> (mesh, ShardedSession options)
_K4_SWEEPS = {"split (2, 2, 1)": ((2, 2, 1), dict(overlap=True)),
              "split (2, 1, 1)": ((2, 1, 1), dict(overlap=True)),
              "force (1, 1, 1)": ((1, 1, 1), dict(overlap="force")),
              "strips (2, 2, 1)": ((2, 2, 1), dict(y_exchange="strips")),
              "strips (2, 1, 1)": ((2, 1, 1), dict(y_exchange="strips"))}


def _nan_pads(t, pad, axes=(0, 1, 2)):
    """A copy of a padded block tensor with NaN in the pads of `axes`."""
    out = t.clone()
    for d in axes:
        if pad[d]:
            ax = out.dim() - 3 + d
            out.narrow(ax, 0, pad[d]).fill_(float("nan"))
            out.narrow(ax, out.shape[ax] - pad[d], pad[d]).fill_(float("nan"))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_K4_EXT_CASES))
@pytest.mark.parametrize("mode", ["off", "ref", "general"])
@pytest.mark.parametrize("sweep", sorted(_K4_SWEEPS))
def test_blocked_window_and_strip_launches(cuda, case, mode, sweep):
    """K4 launches of the split and of the strips at block T on every block
    of a 32^3 droplet: the interior window launched with every pad (the
    ref operand's too) NaN writes exactly its window, finite, and with the
    seam bands the interior bitwise the serial ext K4 launch; the
    strip-fed launch with NaN y pads equals the serial launch bitwise and
    writes its edge rows into its strips bitwise; the last block's
    launches within ATOL of their plain versions."""
    from bflbm_tpu_torch.ops import blocked
    from bflbm_tpu_torch.parallel import kernel as kernel_par

    sd, T = case
    kw, dist, with_ref = _K4_MODES[mode]
    params = LBMParams(**dict(_K4_EXT_CASES[case], **kw))
    shape = (32, 32, 32)
    f, g = _droplet_pops(shape, params, 43, cuda)
    mesh_shape, opts = _K4_SWEEPS[sweep]
    mesh = mesh_lib.make_mesh(mesh_shape, cuda)
    lay = kernel_par.layout(mesh, shape, params, block=T, **opts)
    assert any(lay.split) != lay.strips
    pad = lay.pad
    ss = mesh_lib.shard_state(init_state(f, g, 0), mesh, pad)
    halo.exchange_halo(ss.blocks, mesh, pad)
    exts = halo.block_exts(mesh, shape, pad)
    refs = [None] * mesh.size
    if with_ref:
        ref = (1.0 + 0.1 * torch.rand((2,) + shape, generator=torch
                                      .Generator().manual_seed(44))).to(cuda)
        refs = mesh_lib.shard_field(ref, mesh, pad)
        halo.exchange_halo(refs, mesh, pad)
    words = [7919 * k - 3 for k in range(T)]
    received = [None] * mesh.size
    if lay.strips:
        sent = kernel_par.strip_buffers(ss.blocks, pad)
        received = [torch.full_like(t, float("nan")) for t in sent]
        halo.run_plan(halo.strip_plan(sent, received, mesh, pad))
    else:
        inner, bands = kernel_par.split_windows(lay, ss.blocks[0].shape,
                                                sd * T)
    for b, (blk, ext, r) in enumerate(zip(ss.blocks, exts, refs)):
        want = fused_step.blocked_stream_collide(
            blk[0], blk[1], words, 40, params, T, noise_dist=dist, ref=r,
            ext=ext)
        out = (torch.full_like(blk[0], float("nan")),
               torch.full_like(blk[1], float("nan")))
        fused_step.reset_launch_counts()
        if lay.strips:
            src = _nan_pads(blk, pad, (1,))
            out_strips = torch.full_like(received[b], float("nan"))
            fused_step.blocked_stream_collide(
                src[0], src[1], words, 40, params, T, out=out,
                noise_dist=dist, ref=r, ext=ext, strips=received[b],
                strips_out=out_strips)
            torch.cuda.synchronize()
            assert fused_step.mode_launches.get("blocked ystrips") == 1
            px, py = pad[0], pad[1]
            for s, o in enumerate(out):
                x1, y1 = o.shape[1] - px, o.shape[2] - py
                assert torch.equal(out_strips[0, s][:, px:x1],
                                   o[:, px:x1, py:2 * py])
                assert torch.equal(out_strips[1, s][:, px:x1],
                                   o[:, px:x1, y1 - py:y1])
            plain_box, plain_kw = ext.bounds(blk.shape), dict(
                strips=received[b])
        else:
            src = _nan_pads(blk, pad)
            r_nan = None if r is None else _nan_pads(r, pad)
            fused_step.blocked_stream_collide(
                src[0], src[1], words, 40, params, T, out=out,
                noise_dist=dist, ref=r_nan, ext=ext, window=inner)
            torch.cuda.synchronize()
            for o, w in zip(out, want):
                got = blocked.box_view(o, inner)
                assert bool(torch.isfinite(got).all())
                assert torch.equal(got, blocked.box_view(w, inner))
                assert int(torch.isnan(o).sum()) == o.numel() - got.numel()
            for band in bands:
                fused_step.blocked_stream_collide(
                    blk[0], blk[1], words, 40, params, T, out=out,
                    noise_dist=dist, ref=r, ext=ext, window=band)
            assert fused_step.mode_launches.get("blocked window") \
                == 1 + len(bands)
            plain_box, plain_kw = inner, dict(window=inner)
        assert fused_step.blocked_launches == fused_step.mode_launches[
            "blocked ext"]
        for o, w in zip(out, want):
            assert torch.equal(ext.region(o), ext.region(w))
        if b == mesh.size - 1:
            ref_in = r if lay.strips else r_nan
            fr, gr = blocked.blocked_sweep_reference(
                src[0], src[1], words, 40, params, T,
                fused_step.launch_tile(T, [hi - lo for lo, hi in plain_box],
                                       sd), dist, ref_in, ext, **plain_kw)
            assert max(_maxdiff(blocked.box_view(out[0], plain_box), fr),
                       _maxdiff(blocked.box_view(out[1], plain_box), gr)) \
                <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(overlap=True),
                                  dict(y_exchange="strips"),
                                  dict(y_exchange="strips", block=3)])
def test_blocked_sweep_sessions_match_cpu_and_serial(cuda, opts):
    """ShardedSession(block=2) of the droplet on (2, 2, 1) on the card with
    the split and with the strips (1 + 7 steps, restore every 4: three
    sweeps and a single step), and with the strips at block 3 (1 + 5
    steps: one sweep, then two single steps, the second fed by the
    strips 6 rows deep that the first wrote), bitwise the serial
    session at the same block on the card and within ATOL of the same
    session on the CPU."""
    params = LBMParams(**dict(_DROP, alpha0=1.5, kBT=1e-5))
    shape = (20, 20, 32)
    f, g = _droplet_pops(shape, params, 45, "cpu")
    opts = dict(opts)
    block = opts.pop("block", 2)
    n = 7 if block == 2 else 5
    words = [13 * k + 2 for k in range(n + 1)]

    def go(dev, **kw):
        sess = ShardedSession(mesh_lib.make_mesh((2, 2, 1), dev), params,
                              shape, mass_restore_int=4, block=block, **kw)
        pc = sess.enter(init_state(f.to(dev), g.to(dev), 0), words[0])
        return sess, sess.exit(sess.advance(pc, n, words[1:]))

    fused_step.reset_launch_counts()
    sess, got = go(cuda, **opts)
    tag = "blocked ystrips" if sess.layout.strips else "blocked window"
    per = 1 if sess.layout.strips else 5
    assert sess.layout.strips or sess.layout.split == (True, True, False)
    assert sess.pad[1] == 2 * block
    assert fused_step.mode_launches.get(tag) == (n // block) * 4 * per
    assert fused_step.launches == (n % block) * 4 * per
    _, serial = go(cuda)
    cpu = go("cpu", **opts)[1]
    assert torch.equal(got.f, serial.f) and torch.equal(got.g, serial.g)
    assert max(_maxdiff(got.f.cpu(), cpu.f), _maxdiff(got.g.cpu(), cpu.g)) \
        <= ATOL


# -- the platform probes ------------------------------------------------------

def _pops(shape, cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.empty((19,) + shape, device=cuda).uniform_(0.5, 1.5,
                                                             generator=gen)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 10, 36), (16, 16, 64)])
@pytest.mark.parametrize("variant", platform.COPY_VARIANTS)
def test_probe_copy_matches_plain(cuda, variant, shape):
    """Both copies bitwise f.clone() at every chunk size, the last chunk
    ragged at 2160 cells."""
    f = _pops(shape, cuda, 1)
    for n in platform.CHUNKS:
        out = torch.full_like(f, float("nan"))
        before = platform.launches.get(f"copy {variant}", 0)
        platform.chunk_copy(f, n, variant, out=out)
        torch.cuda.synchronize()
        assert platform.launches[f"copy {variant}"] == before + 1
        assert torch.equal(out, platform.copy_reference(f))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5, 7, 13), (16, 16, 32)])
@pytest.mark.parametrize("variant", platform.TRANSFORM_VARIANTS)
def test_probe_transform_matches_plain(cuda, variant, shape):
    """Unrolled and 3xTF32 tensor-core transforms within 2e-5 of the plain
    einsum on f in [0.5, 1.5); 455 cells leave a ragged group of 16."""
    f = _pops(shape, cuda, 2)
    out = torch.full_like(f, float("nan"))
    platform.moment_transform(f, variant, out=out)
    torch.cuda.synchronize()
    assert _maxdiff(out, platform.transform_reference(f)) <= ATOL


# the cases whose arithmetic the kernel repeats op for op: bitwise
_EXACT_CASES = ("hash_uniform_only", "clt4_hash", "clt4_hash_1mul",
                "clt4_hash_nomul", "philox_bits_only", "clt4_philox")


@pytest.mark.gpu
@pytest.mark.parametrize("case", noise_micro.CASES)
def test_probe_noise_matches_plain(cuda, case):
    """Every generator case within 2e-5 of its plain version on a 16 x 64 x
    40 domain for two seeds (one a negative word); bitwise where no
    transcendental or contracted FMA enters, so the Philox words are the
    plain ones."""
    shape = (16, 64, 40)
    for seed in ((12345, 7), (-5, 2**31 - 1)):
        out = torch.full(shape, float("nan"), device=cuda)
        noise_micro.run_case(case, seed, out)
        torch.cuda.synchronize()
        want = noise_micro.run_case_reference(case, seed, shape,
                                              device=cuda)
        assert _maxdiff(out, want) <= ATOL
        if case in _EXACT_CASES:
            assert torch.equal(out, want)


@pytest.mark.gpu
def test_probe_launch_chain_matches_plain(cuda):
    """400 chained launches from zero, eager and replayed from a CUDA
    graph, end at exactly 400, as the plain chain."""
    (rec,) = probe_launch.probe_launch(cuda)
    assert rec["bitwise_eager"] and rec["bitwise_graph"] and rec["ok"]
    assert rec["ms"] > 0 and rec["eager_ms"] > 0


@pytest.mark.gpu
def test_probes_run_on_the_card(cuda):
    """Every probe through probes.run at 32 x 64 x 64: checks pass, times
    measured, each probe kernel launched."""
    from bflbm_tpu_torch import probes

    probes.reset_launch_counts()
    recs = probes.run(probes.PROBES, device=cuda, shape=(32, 64, 64),
                      out=None)
    assert all(r["ok"] and r["ms"] > 0 for r in recs)
    counts = probes.launch_counts()
    want = {"copy bulk", "copy staged", "transform unrolled",
            "transform mma", "launch"} | {f"noise {c}"
                                          for c in noise_micro.CASES}
    assert set(counts) == want and min(counts.values()) > 0

