"""The PyTorch port's coordinate-keyed hash noise against the JAX
package's: the hash words bitwise, the deviates within 1 ulp (a compiler
may fuse the scale and offset into one FMA), the noise moments at
atol 1e-9 (amplitudes ~3e-3, f32 ulp ~2e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturbed_pops, to_np, to_torch

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.ops import noise as tnoise

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
CASES = [
    (0, 0, (4, 4, 4)),
    (1234567, 42, (16, 16, 16)),
    (-987654, 7, (16, 16, 16)),
    (I32_MIN, 2 ** 31 // 64 - 1, (16, 16, 16)),   # step*64 at int32 max
    (I32_MAX, 2 ** 31 // 64, (3, 5, 7)),          # step*64 wraps int32
    (-1, 1000, (5, 3, 16)),
]


def _jax_words(word, step, shape, n):
    z = jnp.int32(0)
    ws = jfs.hash_words(jnp.int32(word), jnp.int32(step), (z, z),
                        tuple(shape), tuple(shape), n)
    return [np.asarray(w).astype(np.int64) for w in ws]


@pytest.mark.parametrize("word,step,shape", CASES)
def test_hash_words_bitwise(word, step, shape):
    got = tfs.hash_words(word, step, shape, 9)
    want = _jax_words(word, step, shape, 9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), b)


@pytest.mark.parametrize("word,step,shape", CASES[1:4])
def test_u8_and_clt4_within_one_ulp(word, step, shape):
    (w,) = _jax_words(word, step, shape, 1)
    wj = jnp.asarray(w.astype(np.uint32))
    wt = to_torch(w)
    for a, b in zip(tfs.u8_quad(wt, torch.float32),
                    jfs._u8_quad(wj, jnp.float32)):
        np.testing.assert_array_max_ulp(to_np(a), np.asarray(b), maxulp=1)
    np.testing.assert_array_max_ulp(
        to_np(tfs.clt4_normal(wt, torch.float32)),
        np.asarray(jfs._clt4_normal(wj, jnp.float32)), maxulp=1)


@pytest.mark.parametrize("dist", ["u8", "clt4"])
def test_hash_normal_stack(dist):
    shape = (8, 6, 16)
    got = tnoise.hash_normal_stack(-55555, 321, shape, torch.float32,
                                   dist)
    want = jnoise.hash_normal_stack(-55555, 321, shape, jnp.float32, dist)
    assert tuple(got.shape) == (33,) + shape
    np.testing.assert_array_max_ulp(to_np(got), np.asarray(want), maxulp=1)


def test_u8_channel_layout():
    """Channel a of the u8 stack is byte a % 4 of hash word a // 4 — the
    layout the CUDA kernel's u8_draw reads."""
    shape = (4, 4, 8)
    stack = to_np(tnoise.hash_normal_stack(99, 3, shape, torch.float32,
                                            "u8"))
    words = [to_np(w) for w in tfs.hash_words(99, 3, shape, 9)]
    for a in range(33):
        byte = (words[a // 4] >> (8 * (a % 4))) & 0xFF
        np.testing.assert_array_max_ulp(
            stack[a], (byte.astype(np.float32) * np.float32(tfs._U8_SCALE)
                       + np.float32(tfs._U8_OFF)), maxulp=1)


@pytest.mark.parametrize("dist", ["u8", "clt4"])
@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_thermal_noise_hash(dist, kBT):
    shape = (8, 8, 8)
    f, g = perturbed_pops(shape, 21)
    rho, phi = f.sum(0), g.sum(0)
    got = tnoise.thermal_noise_hash(77, 5, to_torch(rho), to_torch(phi),
                                    TParams(kBT=kBT), dist=dist)
    want = jnoise.thermal_noise_hash(77, 5, jnp.asarray(rho),
                                     jnp.asarray(phi), JParams(kBT=kBT),
                                     dist=dist)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=0,
                                   atol=1e-9)


def test_unported_dist_raises():
    """A generator name the port does not know is an error."""
    with pytest.raises(ValueError, match="unknown noise_dist"):
        tnoise.hash_normal_stack(1, 1, (2, 2, 2), torch.float32, "normal")
