"""The clt2 and Box-Muller hash-stream generators of the port against
the JAX package's (``bflbm_tpu/kernels/fused_step.py``: ``_clt2_pair``
:633, ``hash_uniforms`` :535, ``_bm_normals`` :668).

- The (33, X, Y, Z) normal stacks: clt2 bitwise (integer byte sums,
  then one exact scale and offset); Box-Muller within 2e-6 absolute
  (float32 log, cos and sin differ by ulps between XLA:CPU and torch).
- The plain K with each generator against the Pallas kernel in interpret
  mode (one 8^3 tile, block 1, hash noise), one coupled and one
  uncoupled case each, atol 2e-5 as the coupled tests
  (tests/test_torch_coupled.py).
- The generators' moments, as ``test_clt2_pair_moments``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.ops import noise as tnoise

ATOL = 2e-5
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
CASES = [
    (0, 0, (4, 4, 4)),
    (1234567, 42, (8, 6, 16)),
    (I32_MIN, 2 ** 31 // 64 - 1, (5, 3, 16)),
    (I32_MAX, 2 ** 31 // 64, (3, 5, 7)),
]


@pytest.mark.parametrize("word,step,shape", CASES)
def test_clt2_stack_bitwise(word, step, shape):
    got = tnoise.hash_normal_stack(word, step, shape, torch.float32, "clt2")
    want = jnoise.hash_normal_stack(word, step, shape, jnp.float32, "clt2")
    assert tuple(got.shape) == (33,) + tuple(shape)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("word,step,shape", CASES)
def test_bm_stack_within_ulps(word, step, shape):
    got = tnoise.hash_normal_stack(word, step, shape, torch.float32, "bm")
    want = jnoise.hash_normal_stack(word, step, shape, jnp.float32, "bm")
    assert tuple(got.shape) == (33,) + tuple(shape)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_clt2_channel_layout():
    """Channel a of the clt2 stack is half a % 2 of hash word a // 2 —
    the layout the CUDA kernel's Draws<DIST_CLT2> reads."""
    shape = (4, 4, 8)
    stack = to_np(tnoise.hash_normal_stack(99, 3, shape, torch.float32,
                                           "clt2"))
    words = [to_np(w) for w in tfs.hash_words(99, 3, shape, 17)]
    for a in range(33):
        w = words[a // 2] >> (16 * (a % 2))
        pair = (w & 0xFF) + ((w >> 8) & 0xFF)
        np.testing.assert_array_equal(
            stack[a], (pair.astype(np.float32) * np.float32(tfs._CLT2_SCALE)
                       + np.float32(tfs._CLT2_OFF)))


def test_bm_channel_layout():
    """Pair p takes its radius from the uniform of word 2p and its angle
    from word 2p + 1; even channels are the cosines, odd the sines."""
    shape = (2, 3, 4)
    stack = to_np(tnoise.hash_normal_stack(-7, 11, shape, torch.float64,
                                           "bm"))
    words = [to_np(w) for w in tfs.hash_words(-7, 11, shape, 34)]
    u = [((w >> 8) + 0.5) / 2 ** 24 for w in words]
    for a in range(33):
        p = a // 2
        r = np.sqrt(-2.0 * np.log(u[2 * p]))
        trig = np.sin if a % 2 else np.cos
        want = r * trig(2 * np.pi * u[2 * p + 1])
        np.testing.assert_allclose(stack[a], want, rtol=1e-12, atol=1e-12)


def test_hash_uniform_never_zero():
    """(w >> 8) 2^-24 + 2^-25 is never 0, so log(u) is finite; in float32
    the top word's 1 - 2^-25 is a tie that rounds to exactly 1 (radius
    0), as in the JAX package and the kernel."""
    w = torch.tensor([0, 255, 256, 2 ** 32 - 1], dtype=torch.int64)
    u = to_np(tfs.hash_uniform(w, torch.float32))
    assert u[0] == u[1] == np.float32(2.0 ** -25)
    assert u[2] == np.float32(3 * 2.0 ** -25)
    assert u[3] == np.float32(1.0)
    assert np.isfinite(np.log(u)).all()
    u64 = to_np(tfs.hash_uniform(w, torch.float64))
    assert 0.0 < u64.min() and u64.max() == 1.0 - 2.0 ** -25


def test_clt2_pair_moments():
    """Exhaustive over a 16-bit half: exact mean 0 and variance 1, excess
    kurtosis -0.6, support +-255 / sqrt(65535 / 6); the high half reads
    bytes 2 and 3."""
    w = torch.arange(1 << 16, dtype=torch.int64)
    lo, hi = (to_np(t) for t in tfs.clt2_pair(w, torch.float64))
    np.testing.assert_allclose(lo.mean(), 0.0, atol=1e-12)
    np.testing.assert_allclose(lo.var(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((lo ** 4).mean() - 3.0, -0.6, atol=2e-3)
    assert np.isclose(np.abs(lo).max(), 255.0 / np.sqrt(65535.0 / 6.0),
                      rtol=1e-9)
    np.testing.assert_allclose(hi, hi[0])
    _, hi2 = (to_np(t) for t in tfs.clt2_pair(w << 16, torch.float64))
    np.testing.assert_allclose(np.sort(hi2), np.sort(lo), atol=1e-12)


def test_bm_moments():
    """Box-Muller over 33 x 16^3 hash draws: mean 0, variance 1, kurtosis
    3 within sampling error (n = 135168)."""
    n = to_np(tnoise.hash_normal_stack(31337, 5, (16, 16, 16), torch.float64,
                                       "bm")).ravel()
    assert np.isfinite(n).all()
    assert abs(n.mean()) < 0.01
    assert abs(n.var() - 1.0) < 0.02
    assert abs((n ** 4).mean() / n.var() ** 2 - 3.0) < 0.1


def _kw(alpha0, kBT=1e-5):
    return dict(alpha0=alpha0, kappa=0.1, rho_lo=0.0, rho_hi=3.0, kBT=kBT)


@pytest.mark.parametrize("dist,alpha0", [("clt2", 0.0), ("clt2", 1.5),
                                         ("bm", 0.0), ("bm", 1.5)])
def test_k_with_generator_matches_pallas_interpret(dist, alpha0):
    shape = (8, 8, 8)
    kw = _kw(alpha0)
    base = tmodel.init_droplet(shape, TParams(**kw), radius=0.3,
                               device="cpu")
    f, g = (t.numpy() for t in tmodel.perturbed_populations(shape, 91,
                                                            base=base))
    word, step = -246813579, 31
    jp = JParams(**kw)
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            jp, shape, (8, 8), True, jnp.array([word, step], jnp.int32),
            jnp.asarray(f), jnp.asarray(g), block=1, noise_impl="hash",
            noise_dist=dist)
    got_f, got_g = tfs.fused_stream_collide(to_torch(f), to_torch(g), word,
                                            step, TParams(**kw),
                                            noise_dist=dist)
    np.testing.assert_allclose(to_np(got_f), np.asarray(fo), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got_g), np.asarray(go), rtol=0,
                               atol=ATOL)
    # the generator is tested: clt4 on the same word gives another kick
    other = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                 TParams(**dict(kw, kBT=1e-2)), "clt4")
    mine = tfs.k_step_reference(to_torch(f), to_torch(g), word, step,
                                TParams(**dict(kw, kBT=1e-2)), dist)
    assert float((other[0] - mine[0]).abs().max()) > 100 * ATOL
