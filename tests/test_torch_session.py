"""The PyTorch port's slice as a whole: FusedSession (enter -> advance
in chunks -> exit) against the JAX package's all-hash step chain
``model.step(..., noise_source="hash", noise_dist="u8")`` fed the same
per-step words, at 16^3.

JAX's own FusedSession enters through a threefry prelude, so the port
is held against the all-hash chain instead.  Tolerance atol 2e-5 over
10 steps (f32 on both sides, different summation order).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_words, perturbed_pops, to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels.session import FusedSession
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.state import init_state as tinit

ATOL = 2e-5
SHAPE = (16, 16, 16)
N = 10
SEED = 4


def _jax_chain(params, f, g, n, per_step=None):
    """n all-hash JAX steps; per_step(k, state) -> state runs after the
    step that produced label k."""
    one = jax.jit(lambda s: jmodel.step(s, params, noise_source="hash",
                                        noise_dist="u8")[0])
    st = jinit(jnp.asarray(f), jnp.asarray(g), SEED)
    for k in range(1, n + 1):
        st = one(st)
        if per_step is not None:
            st = per_step(k, st)
    return st


def _port_run(params, f, g, words, chunks, mass_restore_int=0, kick=None):
    sess = FusedSession(params, SHAPE, mass_restore_int=mass_restore_int,
                        noise_dist="u8")
    pc = sess.enter(tinit(to_torch(f), to_torch(g), SEED), words[0])
    if kick is not None:
        kick(pc)
    used = 1
    for c in chunks:
        pc = sess.advance(pc, c, words[used:used + c])
        used += c
    assert used == len(words)
    return sess.exit(pc)


@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_session_matches_jax_hash_chain(kBT):
    f, g = perturbed_pops(SHAPE, 41)
    _, words = jax_words(jax.random.PRNGKey(SEED), N)
    want = _jax_chain(JParams(kBT=kBT), f, g, N)
    got = _port_run(TParams(kBT=kBT), f, g, words, (4, 5))
    assert got.step == N == int(want.step)
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=ATOL)


def test_session_chunk_split_invariance():
    """1+9 == 1+4+5 bitwise: one word per physical step, so the chunk
    boundary is invisible."""
    f, g = perturbed_pops(SHAPE, 42)
    words = list(range(-5, 5))
    p = TParams(kBT=1e-5)
    a = _port_run(p, f, g, words, (9,))
    b = _port_run(p, f, g, words, (4, 5))
    assert a.step == b.step == N
    assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)


def test_session_matches_plain_model_chain():
    """enter + advance + exit is the port's own plain step chain."""
    f, g = perturbed_pops(SHAPE, 43)
    words = [7 * k - 3 for k in range(N)]
    p = TParams(kBT=1e-5)
    got = _port_run(p, f, g, words, (2, 7))
    ref = tmodel.nsteps(tinit(to_torch(f), to_torch(g), SEED), p, N, words,
                        noise_dist="u8")
    np.testing.assert_allclose(to_np(got.f), to_np(ref.f), rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_np(got.g), to_np(ref.g), rtol=0, atol=ATOL)


def test_session_mass_restore_matches_jax():
    """mass_restore_int=3: restores after the K steps reaching labels 3,
    6 and 9.  A deliberate mass defect put in after the first step (the
    rest population does not stream, so the kick is the same in
    post-collide and post-stream space) is removed by the restore."""
    f, g = perturbed_pops(SHAPE, 44)
    _, words = jax_words(jax.random.PRNGKey(SEED), N)
    jp, tp = JParams(kBT=1e-5), TParams(kBT=1e-5)
    df, dg = 1e-3, -5e-4
    m0f, m0g = jnp.sum(jnp.asarray(f)), jnp.sum(jnp.asarray(g))

    def jax_hook(restore):
        def hook(k, st):
            if k == 1:
                st = st._replace(f=st.f.at[0].add(df), g=st.g.at[0].add(dg))
            if restore and k in (3, 6, 9):
                st = jfs.mass_restore_step(st, m0f, m0g)
            return st
        return hook

    def kick(pc):
        pc.f[0] += df
        pc.g[0] += dg

    want = _jax_chain(jp, f, g, N, jax_hook(True))
    got = _port_run(tp, f, g, words, (4, 5), mass_restore_int=3, kick=kick)
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=ATOL)
    rel = abs(float(got.f.sum(dtype=torch.float64)) - float(f.sum())) \
        / float(f.sum())
    assert rel < 1e-6
    # without the restore the kicked chain ends far away: the test bites
    unrestored = _jax_chain(jp, f, g, N, jax_hook(False))
    assert np.abs(to_np(got.f) - np.asarray(unrestored.f)).max() > 10 * ATOL


def test_session_checks_shape():
    f, g = perturbed_pops((4, 4, 4), 45)
    sess = FusedSession(TParams(), SHAPE)
    with pytest.raises(ValueError, match="shape"):
        sess.enter(tinit(to_torch(f), to_torch(g), 0))


def test_port_imports_no_jax():
    """Every module of bflbm_tpu_torch — the run driver, io (the native,
    HDF5 and AMReX frame formats too), observables, the kernel wrappers
    and the decomposed path (ops.blocked, parallel) among them — imports
    without JAX or the JAX package, and
    without h5py, which io.hdf5 imports lazily (checked in a fresh
    interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bflbm_tpu_torch\n"
        "for m in pkgutil.walk_packages(bflbm_tpu_torch.__path__,\n"
        "                               'bflbm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = {'bflbm_tpu_torch.run', 'bflbm_tpu_torch.io.checkpoint',\n"
        "        'bflbm_tpu_torch.io.fields', 'bflbm_tpu_torch.io.metrics',\n"
        "        'bflbm_tpu_torch.observables.structfact',\n"
        "        'bflbm_tpu_torch.observables.droplet',\n"
        "        'bflbm_tpu_torch.utils.debug',\n"
        "        'bflbm_tpu_torch.io.native', 'bflbm_tpu_torch.io.amrex',\n"
        "        'bflbm_tpu_torch.io.hdf5',\n"
        "        'bflbm_tpu_torch.kernels.fused_step',\n"
        "        'bflbm_tpu_torch.ops.blocked',\n"
        "        'bflbm_tpu_torch.parallel.mesh',\n"
        "        'bflbm_tpu_torch.parallel.halo',\n"
        "        'bflbm_tpu_torch.parallel.kernel'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'bflbm_tpu' or k.startswith('bflbm_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'h5py' not in sys.modules\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
