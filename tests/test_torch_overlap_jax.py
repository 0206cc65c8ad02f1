"""The PyTorch port's overlap split at block 1 (``ShardedSession(overlap=
True)``) against the JAX package's split sweep in interpret mode, on a
CPU mesh, in a file of its own: the JAX side's lowering dominates its
time, and ``--dist loadfile`` then gives it a worker of its own.
Tolerance TOL = 2e-5, chip_smoke.py's kernel tolerance.
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


def _cpu_mesh(shape):
    return mesh_lib.make_mesh(shape, "cpu")


def test_split_session_matches_jax_overlap():
    """The port's split session against JAX's split sweep at block 1
    (make_kernel_nsteps(..., overlap=True), hash noise, interpret mode):
    tests/test_kernel_shard.py's overlap configuration (coupled droplet,
    kBT = 0, 16 x 96 x 128 on (2, 4, 1), local 8 x 24), 2 steps, atol
    TOL; the port's split ran (its windows counted)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    kw = dict(alpha0=1.5, kBT=0.0, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
    shape = (16, 96, 128)
    n = 2
    state = jmodel.init_droplet(shape, JParams(**kw), dtype=jnp.float32,
                                radius=0.3)
    jmesh = jmesh_lib.make_mesh((2, 4, 1), jax.devices()[:8])
    want = jkernel_par.make_kernel_nsteps(
        jmesh, JParams(**kw), n, block=1, noise_impl="hash",
        transform="mxu", interpret=True, donate=False, overlap=True)(
        jmesh_lib.shard_state(state, jmesh))
    seen = []
    inner = fused_step.fused_stream_collide

    def spy(*args, **kws):
        seen.append(kws.get("window"))
        return inner(*args, **kws)

    sess = ShardedSession(_cpu_mesh((2, 4, 1)), LBMParams(**kw), shape,
                          mass_restore_int=0, overlap=True)
    pc = sess.enter(init_state(to_torch(state.f), to_torch(state.g), 0), 0)
    fused_step.fused_stream_collide = spy
    try:
        got = sess.exit(sess.advance(pc, n - 1, [0] * (n - 1)))
    finally:
        fused_step.fused_stream_collide = inner
    assert sess.layout.split == (True, True, False)
    assert sum(w is not None for w in seen) == 8 * 5
    assert got.step == int(want.step) == n
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_np(got.g), np.asarray(want.g), rtol=0,
                               atol=TOL)
