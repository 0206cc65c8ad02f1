"""General relaxation (the JAX kernel's K1d mode,
``bflbm_tpu/kernels/fused_step.py:843-851, 1051-1064``) in population
space, as the CUDA kernels compute it (``csrc/k_cell.cuh``
``post_collide`` and ``store_relaxed``): every moment k >= 1 relaxes at
the one rate lam = 1 / (tau + 1/2), so with q = lam m_eq + Guo + xi (q_0 =
lam rho) the post-collide populations are

    f'_i = (1 - lam) f_i + [M_INV q]_i   (i >= 1),
    f'_0 = rho - sum_{i >= 1} f'_i       (telescoping),

with no forward transform of the streamed populations.  A float32 torch
transcription of that order, on the plain step's intermediates, against
the port's plain general K (moment space, ``k_step_reference``) and
against JAX's jnp general collide (``bflbm_tpu/ops/collide.py``, float32
inputs) on the same streamed populations, hydro fields and noise:
uncoupled and coupled (alpha0 = 1.5, the droplet), noise off and clt4,
tau_f = 0.7, tau_g = 0.6, at 8^3 and 16 x 12 x 8.

Tolerance atol 2e-5, the kernels' against their plain versions: the two
forms round differently (one product of (1 - lam) against the forward
and back transforms), populations are O(1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.ops import collide as jcollide
from bflbm_tpu.ops.hydro import Hydro as JHydro
from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.lattice import M_INV, Q
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.ops import collide as collide_ops
from bflbm_tpu_torch.ops import hydro as hydro_ops
from bflbm_tpu_torch.ops import noise as noise_ops
from bflbm_tpu_torch.ops import stream as stream_ops

ATOL = 2e-5
_KW = dict(tau_f=0.7, tau_g=0.6, kappa=0.1, rho_lo=0.1, rho_hi=3.0)
_CASES = {"uncoupled": dict(_KW), "coupled": dict(_KW, alpha0=1.5)}


def relax_population_form(fs, gs, h, xi_f, xi_g, params):
    """(f', g') of the population-space general relaxation, float32, from
    the streamed populations (19, ...), the hydro fields h and the noise
    moments: q = lam m_eq(v_b) + Guo + xi with q_0 = lam n, f'_i = (1 -
    lam) f_i + sum_k M_INV[i, k] q_k for i >= 1, then f'_0 by
    telescoping."""
    minv = torch.as_tensor(M_INV, dtype=torch.float32)
    v_b = ((h.rho[None] * h.uf + h.phi[None] * h.ug)
           / (h.rho + h.phi)[None])
    out = []
    for pops, n, u, a, tau, xi in ((fs, h.rho, h.uf, h.af, params.tau_f,
                                    xi_f),
                                   (gs, h.phi, h.ug, h.ag, params.tau_g,
                                    xi_g)):
        lam = torch.tensor(1.0 / (tau + 0.5), dtype=torch.float32)
        q = (lam * collide_ops.equilibrium_moments(n, v_b)
             + collide_ops.force_moments(n, u, a, tau) + xi)
        q[0] = lam * n
        new = torch.empty_like(pops)
        new[1:] = (torch.addcmul(torch.einsum("ik,k...->i...", minv[1:], q),
                                 1.0 - lam, pops[1:]))
        new[0] = n - new[1:].sum(dim=0)
        out.append(new)
    return out[0], out[1]


def _intermediates(params, shape, dist, seed):
    """The plain step's streamed populations, hydro fields and noise
    moments (``kernels.fused_step.k_step_reference``'s order) on a
    perturbed droplet."""
    base = model.init_droplet(shape, params, radius=0.3, device="cpu")
    f, g = model.perturbed_populations(shape, seed, base=base)
    word, step = 918273645 - seed, 7
    fs, gs = stream_ops.stream(f), stream_ops.stream(g)
    hbar = hydro_ops.hydrovars_bar(fs, gs, params)
    xi_f, xi_g = noise_ops.thermal_noise_hash(word, step, hbar.rho,
                                              hbar.phi, params, None, dist)
    h = hydro_ops.hydrovars(fs, gs, xi_f, xi_g, params, hbar)
    return (f, g, word, step), fs, gs, h, xi_f, xi_g


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 12, 8)])
@pytest.mark.parametrize("noise", ["off", "clt4"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_population_form_matches_plain_and_jax(case, noise, shape):
    kBT = 0.0 if noise == "off" else 1e-5
    kw = dict(_CASES[case], kBT=kBT)
    params = LBMParams(**kw)
    assert fused_step.general_relax(params)
    dist = "clt4"
    (f, g, word, step), fs, gs, h, xi_f, xi_g = _intermediates(
        params, shape, dist, seed=len(shape) + shape[0] + (kBT > 0))
    if noise == "clt4":
        assert float(xi_f[4:].abs().max()) > 100 * ATOL
    got_f, got_g = relax_population_form(fs, gs, h, xi_f, xi_g, params)
    assert bool(torch.isfinite(got_f).all() and torch.isfinite(got_g).all())

    # the port's plain general K: moment space, the same intermediates
    want_f, want_g = fused_step.k_step_reference(f, g, word, step, params,
                                                 dist)
    np.testing.assert_allclose(to_np(got_f), to_np(want_f), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got_g), to_np(want_g), rtol=0,
                               atol=ATOL)

    # JAX's jnp general collide on the same float32 inputs
    def j(t):
        return jnp.asarray(to_np(t), dtype=jnp.float32)

    jh = JHydro(*[j(t) for t in h])
    jf, jg = jcollide.collide(j(fs), j(gs), jh, j(xi_f), j(xi_g),
                              JParams(**kw))
    assert np.asarray(jf).dtype == np.float32
    np.testing.assert_allclose(to_np(got_f), np.asarray(jf), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(got_g), np.asarray(jg), rtol=0,
                               atol=ATOL)
    # the mass of every cell is the streamed one, to rounding
    np.testing.assert_allclose(to_np(got_f.sum(dim=0)), to_np(h.rho),
                               rtol=0, atol=4e-6)
    assert got_f.shape == (Q,) + tuple(shape)


def test_population_form_at_tau_half_is_exact_relaxation():
    """lam = 1 (tau = 1/2): (1 - lam) f drops out and the form is the exact
    relaxation's back transform, M_INV (m_eq + Guo + xi) with m'_0 = rho."""
    params = LBMParams(**dict(_KW, tau_f=0.5, tau_g=0.5, alpha0=1.5,
                              kBT=1e-5))
    assert not fused_step.general_relax(params)
    (f, g, word, step), fs, gs, h, xi_f, xi_g = _intermediates(
        params, (8, 8, 8), "clt4", seed=3)
    got = relax_population_form(fs, gs, h, xi_f, xi_g, params)
    want = fused_step.k_step_reference(f, g, word, step, params, "clt4")
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=ATOL)
