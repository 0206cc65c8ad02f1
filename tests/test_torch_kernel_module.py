"""The PyTorch port's K step (``bflbm_tpu_torch.kernels.fused_step``)
against the JAX package.

On the CPU the wrapper runs the kernel's plain version, which is held
here against the Pallas kernel itself (interpret mode, one 8^3 tile,
block 1) and against the JAX model step composed in post-collide space.
Tolerance atol 2e-5, as test_fused_matches_jnp_deterministic: 1/x
multiplies against divides, and FMA contraction differs.  The CUDA
kernel is held against the plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import jax_words, perturbed_pops, to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.ops import stream as jstream
from bflbm_tpu.state import SimState as JState
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import _build
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.ops import noise as tnoise
from bflbm_tpu_torch.ops import stream as tstream
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_k_step_matches_pallas_interpret(kBT):
    shape = (8, 8, 8)
    f, g = perturbed_pops(shape, 31)
    jp, tp = JParams(kBT=kBT), TParams(kBT=kBT)
    word, step = -123456789, 17
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            jp, shape, (8, 8), jp.noise_on,
            jnp.array([word, step], jnp.int32), jnp.asarray(f),
            jnp.asarray(g), block=1, noise_impl="hash", noise_dist="u8")
    before = tfs.launches
    got_f, got_g = tfs.fused_stream_collide(to_torch(f), to_torch(g), word,
                                            step, tp, noise_dist="u8")
    assert tfs.launches == before   # CPU tensors: plain version, no launch
    _close(got_f, fo)
    _close(got_g, go)
    if kBT:
        # the noise kick is far above the tolerance: the bits are tested
        quiet = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                     TParams(kBT=0.0))
        assert float((quiet[0] - got_f).abs().max()) > 50 * ATOL


@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_k_step_matches_model_step_composed(kBT):
    """stream(K(pc)) == model.step(stream(pc)): K = collide∘stream."""
    shape = (6, 8, 10)
    f, g = perturbed_pops(shape, 32)
    jp, tp = JParams(kBT=kBT), TParams(kBT=kBT)
    step = 9
    key = jax.random.PRNGKey(5)
    _, (word,) = jax_words(key, 1)
    js = JState(f=jstream.stream(jnp.asarray(f)),
                g=jstream.stream(jnp.asarray(g)), key=key,
                step=jnp.asarray(step, jnp.int32))
    want, _ = jmodel.step(js, jp, noise_source="hash", noise_dist="u8")
    kf, kg = tfs.k_step_reference(to_torch(f), to_torch(g), word, step, tp,
                                  "u8")
    _close(tstream.stream(kf), want.f)
    _close(tstream.stream(kg), want.g)


def test_wrapper_writes_into_out():
    f, g = (to_torch(a) for a in perturbed_pops((4, 6, 8), 33))
    out = (torch.empty_like(f), torch.empty_like(g))
    got = tfs.fused_stream_collide(f, g, 3, 4, TParams(kBT=1e-5), out=out)
    assert got[0] is out[0] and got[1] is out[1]
    ref = tfs.k_step_reference(f, g, 3, 4, TParams(kBT=1e-5))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_wrapper_refuses_other_devices():
    f = torch.empty((19, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no K-step path"):
        tfs.fused_stream_collide(f, f, 1, 1, TParams())
    with pytest.raises(ValueError, match="g is on"):
        tfs.fused_stream_collide(torch.zeros(19, 2, 2, 2), f, 1, 1,
                                 TParams())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kBT=1e-5),
    dict(alpha0=1.1),
    dict(alpha1=0.3),
    dict(tau_f=0.8),
    dict(tau_g=0.7),
    dict(use_sc_pseudo=True),
    dict(alpha0=1.5, alpha1=0.3),
    dict(alpha0=1.5, use_sc_pseudo=True, tau_g=0.7),
    dict(alpha1=0.3, tau_g=0.7),
    dict(alpha1=0.3, kBT=1e-5, use_sc_pseudo=True),
])
def test_unsupported_reason(kw):
    """The kernels take every configuration the JAX kernel takes: alpha0,
    alpha1, general tau, the pseudopotential, noise."""
    assert tfs.unsupported_reason(TParams(**kw)) is None


@pytest.mark.parametrize("dist", ["normal", "clt8"])
def test_unported_noise_dist(dist):
    """The generators are u8, clt4, clt2 and bm; another name is an
    error, in the noise stack and in the kernel wrapper."""
    with pytest.raises(ValueError, match="unknown noise_dist"):
        tnoise.hash_normal_stack(1, 2, (2, 2, 2), torch.float32, dist)
    f = torch.ones((19, 2, 2, 2))
    with pytest.raises(ValueError, match="unknown noise_dist"):
        tfs.fused_stream_collide(f, f.clone(), 1, 1, TParams(kBT=1e-5),
                                 noise_dist=dist)


def test_make_ksteps_is_the_reference_chain():
    """Bitwise on the CPU: the launch loop is a chain of plain K steps
    with consecutive step labels and one word per step."""
    f, g = (to_torch(a) for a in perturbed_pops((4, 6, 8), 34))
    tp = TParams(kBT=1e-5)
    words = [11, -22, 33]
    rf, rg = f.clone(), g.clone()
    for k, w in enumerate(words):
        rf, rg = tfs.k_step_reference(rf, rg, w, 5 + k, tp)
    got = tfs.make_ksteps(tp, 3)(tinit(f, g, 0, step=5), words)
    assert got.step == 8
    assert torch.equal(got.f, rf) and torch.equal(got.g, rg)


def test_make_ksteps_draws_words_from_generator():
    f, g = (to_torch(a) for a in perturbed_pops((4, 4, 4), 35))
    tp = TParams(kBT=1e-5)
    a = tfs.make_ksteps(tp, 2)(tinit(f.clone(), g.clone(), 7))
    b = tfs.make_ksteps(tp, 2)(tinit(f.clone(), g.clone(), 7))
    c = tfs.make_ksteps(tp, 2)(tinit(f.clone(), g.clone(), 8))
    assert torch.equal(a.f, b.f)
    assert not torch.equal(a.f, c.f)


def test_mass_restore_step_matches_jax():
    f, g = perturbed_pops((6, 8, 10), 36)
    m0f, m0g = float(f.sum()) + 0.3, float(g.sum()) - 0.2
    want = jfs.mass_restore_step(
        JState(f=jnp.asarray(f), g=jnp.asarray(g),
               key=jax.random.PRNGKey(0), step=jnp.int32(0)),
        jnp.float32(m0f), jnp.float32(m0g))
    got = tfs.mass_restore_step(tinit(to_torch(f), to_torch(g), 0),
                                torch.tensor(m0f, dtype=torch.float64),
                                torch.tensor(m0g, dtype=torch.float64))
    # the JAX restore sums in float32 (~5e-6 per cell off here); the port
    # sums in float64 and matches the float64 formula to f32 rounding
    _close(got.f, want.f)
    _close(got.g, want.g)
    for arr, m0, out in ((f, m0f, got.f), (g, m0g, got.g)):
        ref = arr.astype(np.float64)
        ref[0] += (m0 - ref.sum()) / ref[0].size
        _close(out, ref, atol=1e-7)


@pytest.mark.parametrize("prev,new,applied", [
    (998, 999, False), (999, 1000, True), (1000, 1001, False),
    (1999, 2000, True), (0, 1, False),
])
def test_maybe_restore_cadence(prev, new, applied):
    f = torch.ones((19, 2, 2, 2))
    st = tinit(f, f.clone(), 0, step=new)
    out = tfs._maybe_restore(prev, st, (1000, torch.tensor(0.0),
                                        torch.tensor(0.0)))
    assert bool((out.f[0] != 1.0).any()) == applied


def test_build_is_keyed_by_sources():
    assert _build.SOURCES == ("fused_step", "fused_step_force",
                              "fused_step_general",
                              "fused_step_general_force",
                              "fused_step_force_a1",
                              "fused_step_general_force_a1", "density_psi",
                              "laplacian_psi", "blocked_step",
                              "blocked_step_general", "blocked_step_force",
                              "blocked_step_general_force",
                              "blocked_step_force_a1",
                              "blocked_step_general_force_a1")
    for name in _build.SOURCES:
        so = _build.library_path(name)
        assert so.parent == _build.build_dir()
        assert so.parent.parts[-2:] == ("build", "bflbm_tpu_torch")
        assert so.name.startswith(f"lib{name}.")
        assert _build.source_hash(name) in so.name
    assert len({_build.source_hash(n) for n in _build.SOURCES}) == 14
    assert _build.LIBRARIES["fused_step_general_force"] == (
        "fused_step.cu", ("-DBFLBM_GENERAL_RELAX=1", "-DBFLBM_FORCE=1"))
    assert _build.LIBRARIES["fused_step_general_force_a1"] == (
        "fused_step.cu", ("-DBFLBM_GENERAL_RELAX=1", "-DBFLBM_FORCE=1",
                          "-DBFLBM_A1=1"))
    assert _build.LIBRARIES["blocked_step_general"] == (
        "blocked_step.cu", ("-DBFLBM_GENERAL_RELAX=1",))
    assert _build.LIBRARIES["blocked_step_general_force_a1"] == (
        "blocked_step.cu", ("-DBFLBM_GENERAL_RELAX=1", "-DBFLBM_FORCE=1",
                            "-DBFLBM_A1=1"))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS



def test_lattice_tables_header_is_current():
    """csrc/lattice_tables.cuh holds lattice.py's C, M and M_INV as the
    float32 values the __constant__ tables get (tools/gen_lattice_tables.py
    writes it)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "gen_lattice_tables.py"
    spec = importlib.util.spec_from_file_location("gen_lattice_tables", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.HEADER.read_text() == gen.render()
    text = gen.HEADER.read_text()
    from bflbm_tpu_torch import lattice as tlattice

    for name, table in (("kLatM", tlattice.M), ("kLatMinv", tlattice.M_INV)):
        body = text.split(f"float {name}[19][19] = {{")[1].split("};")[0]
        got = np.array([[float.fromhex(v.strip().rstrip("f"))
                         for v in row.split(",") if v.strip()]
                        for row in body.replace("{", "").split("}")
                        if row.strip(" ,\n")], np.float32)
        np.testing.assert_array_equal(got, np.asarray(table, np.float32))
