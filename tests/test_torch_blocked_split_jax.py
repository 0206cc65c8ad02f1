"""The PyTorch port's overlap split at block 2 (``ShardedSession(block=2,
overlap=True)``, windowed K4 sweeps) against the JAX package's split sweep
at block 2 in interpret mode, on a CPU mesh, in a file of its own: the
JAX side's lowering dominates its time, and ``--dist loadfile`` then gives
it a worker of its own.  Tolerance TOL = 2e-5, chip_smoke.py's kernel
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.parallel import kernel as jkernel_par
from bflbm_tpu.parallel import mesh as jmesh_lib
from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.kernels.session import ShardedSession
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.state import init_state

TOL = 2e-5
_DROP = dict(kappa=0.1, rho_lo=0.1, rho_hi=3.0)


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


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


def test_block2_split_matches_jax_overlap(launches):
    """The port's split session at block 2 against JAX's split sweep
    (make_kernel_nsteps(..., block=2, overlap=True), hash noise,
    interpret mode): coupled droplet, kBT = 0, 20 x 8 x 128 on (2, 1, 1)
    (local x 10, px 4: both sides split x), 1 + 5 steps (two sweeps and
    a single step), atol TOL; the port's windows counted."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    kw = dict(_DROP, alpha0=1.5, kBT=0.0)
    shape = (20, 8, 128)
    n = 6
    state = jmodel.init_droplet(shape, JParams(**kw), dtype=jnp.float32,
                                radius=0.3)
    jmesh = jmesh_lib.make_mesh((2, 1, 1), jax.devices()[:2])
    want = jkernel_par.make_kernel_nsteps(
        jmesh, JParams(**kw), n, block=2, noise_impl="hash",
        transform="mxu", interpret=True, donate=False, overlap=True)(
        jmesh_lib.shard_state(state, jmesh))
    sess = ShardedSession(_cpu_mesh((2, 1, 1)), LBMParams(**kw), shape,
                          mass_restore_int=0, overlap=True, block=2)
    pc = sess.enter(init_state(to_torch(state.f), to_torch(state.g), 0), 0)
    got = sess.exit(sess.advance(pc, n - 1, [0] * (n - 1)))
    assert sess.layout.split == (True, False, False)
    assert sess.pad == (4, 0, 0)
    assert sum(w is not None for w in launches["blocked"]) == 2 * 2 * 3
    assert sum(w is not None for w in launches["single"]) == 2 * 3
    assert got.step == int(want.step) == n
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=TOL)
