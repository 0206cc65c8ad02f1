"""Shared inputs of the parity tests between the JAX package
(``bflbm_tpu``) and its PyTorch port (``bflbm_tpu_torch``).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; JAX stays on the CPU (tests/conftest.py) in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bflbm_tpu_torch.models.binary_fluid import perturbed_populations


def perturbed_pops(shape, seed, rho0=1.0):
    """(f, g) float32 numpy arrays f_i = w_i rho0 (1 + 0.05 N(0,1)): a
    non-uniform state, so that streaming matters."""
    return [t.numpy() for t in perturbed_populations(shape, seed, rho0=rho0)]


def jax_words(key, n):
    """n per-step noise words derived from a JAX key exactly as the JAX
    package derives them (fused_step.fused_stream_collide and the hash
    prelude of models/binary_fluid.py); returns (key', words)."""
    words = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        words.append(int(jax.random.randint(
            sub, (1,), minval=jnp.iinfo(jnp.int32).min,
            maxval=jnp.iinfo(jnp.int32).max, dtype=jnp.int32)[0]))
    return key, words


def to_torch(a):
    return torch.from_numpy(np.array(a))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
