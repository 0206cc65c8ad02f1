"""Whiteness of the coordinate-keyed hash stream in space and time.

The port's ``hash_normal_stack`` (bitwise JAX's, tests/test_torch_noise.py)
drawn for consecutive steps, a fresh word each step as the run driver
draws them, with clt4 and u8 deviates: the lag-1-step correlation of a
channel along each of the 18 lattice vectors and in the same cell, and
the power of the four lowest |k| shells against the mean power, each
within 5 sigma of its sampling bound.  The coupled path's long-wavelength
excess on the card (ROADMAP) would show here if the stream carried it.
The same statistic runs once on JAX's own ``hash_normal_stack`` at a
smaller size.  JAX's ``test_hash_normals_statistics`` checks one word and
spatial lag 1.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu_torch.lattice import C
from bflbm_tpu_torch.ops import noise as tnoise
from bflbm_tpu_torch.state import draw_words, make_generator

NSIG = 5.0


def _stacks(draw, shape, steps, seed):
    words = draw_words(make_generator(seed), steps)
    return [draw(w, t, shape) for t, w in enumerate(words)]


def whiteness(stacks):
    """{name: (value, expected, sigma)}: lag-1-step correlations along
    c_i (i = 0: the same cell) and the four lowest |k|^2 shells' mean
    power over the mean power of every k != 0."""
    x = torch.stack([torch.as_tensor(np.array(s)).double()
                     for s in stacks])                    # (T, 33, X, Y, Z)
    steps, chans = x.shape[:2]
    shape = tuple(x.shape[2:])
    cells = int(np.prod(shape))
    out = {}
    a, b = x[:-1], x[1:]
    sig = 1.0 / np.sqrt((steps - 1) * chans * cells)
    for i, c in enumerate(C):
        nb = torch.roll(b, tuple(-int(v) for v in c), (2, 3, 4))
        out[f"lag1_c{i}"] = (float((a * nb).mean()), 0.0, sig)
    power = torch.fft.fftn(x, dim=(2, 3, 4)).abs() ** 2 / cells
    ks = [np.fft.fftfreq(n, 1.0 / n) for n in shape]
    k2 = (ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
          + ks[2][None, None, :] ** 2)
    mean = float(power[..., torch.as_tensor(k2 > 0)].mean())
    for shell in sorted(set(k2[k2 > 0].ravel()))[:4]:
        sel = torch.as_tensor(k2 == shell)
        # P(k) = P(-k): half the vectors are independent, each Exp(1)
        n_ind = steps * chans * int(sel.sum()) / 2
        out[f"shell_k2_{int(shell)}"] = (float(power[..., sel].mean()) / mean,
                                         1.0, 1.0 / np.sqrt(n_ind))
    return out


def _check(stats):
    bad = {k: v for k, v in stats.items()
           if abs(v[0] - v[1]) > NSIG * v[2]}
    assert not bad, bad
    assert sum(k.startswith("lag1") for k in stats) == 19
    assert sum(k.startswith("shell") for k in stats) == 4


@functools.lru_cache(maxsize=None)
def _port_stacks(dist):
    def draw(word, step, shape):
        return tnoise.hash_normal_stack(word, step, shape, torch.float32,
                                        dist)

    return tuple(_stacks(draw, (32, 32, 32), 16, 2024))


@pytest.mark.parametrize("dist", ["clt4", "u8"])
def test_port_hash_stream_is_white(dist):
    _check(whiteness(_port_stacks(dist)))


def test_jax_hash_stream_is_white():
    def draw(word, step, shape):
        return jnoise.hash_normal_stack(word, step, shape, jnp.float32,
                                        "clt4")

    _check(whiteness(_stacks(draw, (16, 16, 16), 8, 7)))


def test_whiteness_sees_a_long_wavelength_excess():
    """The statistic catches a stream 20% stronger in its lowest shell
    and one correlated along a lattice vector between steps."""
    stacks = _port_stacks("clt4")
    boosted = []
    for s in stacks:
        k = torch.fft.fftn(s.double(), dim=(1, 2, 3))
        for v in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
            for sign in (1, -1):
                k[(slice(None),) + tuple(sign * c for c in v)] *= np.sqrt(1.2)
        boosted.append(torch.fft.ifftn(k, dim=(1, 2, 3)).real)
    stats = whiteness(boosted)
    v, want, sig = stats["shell_k2_1"]
    assert v - want > NSIG * sig
    carried = [stacks[0]]
    for s in stacks[1:]:
        carried.append((s + 0.05 * torch.roll(carried[-1], (1, 0, 0),
                                              (1, 2, 3))) / np.sqrt(1.0025))
    v, want, sig = whiteness(carried)["lag1_c1"]
    assert abs(v - want) > NSIG * sig
