"""Parameters and state carried across from the JAX package, the port's
noise-word generator, and its device timing and profiling helpers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturbed_pops, to_np

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.io import checkpoint as jckpt
from bflbm_tpu.models import binary_fluid as jmodel
from bflbm_tpu.state import init_state as jinit
from bflbm_tpu_torch import interop
from bflbm_tpu_torch.config import LBMParams as TParams
from bflbm_tpu_torch.models import binary_fluid as tmodel
from bflbm_tpu_torch.state import draw_words, make_generator
from bflbm_tpu_torch.utils import timing


@pytest.mark.parametrize("kw", [
    dict(),
    dict(tau_f=0.8, tau_g=0.6, alpha0=1.1, kBT=1e-5, kappa=0.1,
         use_sc_pseudo=True, sc_ref_density=1.5, rho_lo=0.1, rho_hi=3.0),
])
def test_params_from_dict(kw):
    jp = JParams(**kw)
    tp = interop.params_from_dict(dataclasses.asdict(jp))
    assert tp == TParams(**kw)
    for prop in ("noise_on", "lam_f", "lam_g", "tau_f_bar", "tau_g_bar",
                 "viscosity"):
        assert getattr(tp, prop) == getattr(jp, prop)


def test_params_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        interop.params_from_dict({"kBT": 0.0, "tau": 1.0})


def test_state_from_arrays():
    f, g = perturbed_pops((4, 6, 8), 51)
    st = interop.state_from_arrays(f, g, np.int32(12), seed=3,
                                  device="cpu")
    assert st.step == 12 and st.shape == (4, 6, 8)
    assert st.f.dtype == torch.float32 and st.f.is_contiguous()
    np.testing.assert_array_equal(to_np(st.f), f)
    np.testing.assert_array_equal(to_np(st.g), g)


def test_load_jax_checkpoint(tmp_path):
    f, g = perturbed_pops((4, 4, 8), 52)
    js = jinit(jnp.asarray(f), jnp.asarray(g), 9, step=33)
    jckpt.save_state(str(tmp_path / "ck"), js)
    st = interop.load_jax_checkpoint(str(tmp_path / "ck"), seed=5,
                                    device="cpu")
    assert st.step == 33
    np.testing.assert_array_equal(to_np(st.f), f)
    np.testing.assert_array_equal(to_np(st.g), g)
    # the generator is seeded from `seed`, not from the threefry key
    assert draw_words(st.gen, 4) == draw_words(make_generator(5), 4)


def test_init_mixture_matches_jax():
    jst = jmodel.init_mixture((4, 6, 8), JParams(), dtype=jnp.float32)
    tst = tmodel.init_mixture((4, 6, 8), TParams(), device="cpu")
    assert tst.step == 0 and tst.f.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tst.f), np.asarray(jst.f))
    np.testing.assert_array_equal(to_np(tst.g), np.asarray(jst.g))


def test_draw_words_range_and_determinism():
    a = draw_words(make_generator(1), 1000)
    assert a == draw_words(make_generator(1), 1000)
    assert a != draw_words(make_generator(2), 1000)
    assert min(a) >= -2 ** 31 and max(a) < 2 ** 31 - 1
    assert min(a) < 0 < max(a)


def test_time_steps_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("checks the no-device refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.time_steps(lambda: None, 1, 1)


def test_profile_session_needs_a_device(capsys):
    from bflbm_tpu_torch.utils import profile_session

    if torch.cuda.is_available():
        pytest.skip("checks the no-device refusal")
    assert profile_session.main(["--n", "8"]) == 1
    assert capsys.readouterr().out == ""


def test_profile_session_busy_time_is_the_union():
    from bflbm_tpu_torch.utils.profile_session import _union_us

    spans = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 21.0),
             ("d", 20.5, 20.7)]
    assert _union_us(spans) == 13.0
    assert _union_us([]) == 0.0


def test_jax_key_words_reach_the_port():
    """One word per physical step: the port's prelude with a word derived
    from the JAX key reproduces JAX's hash-noise step."""
    from torch_parity import jax_words

    f, g = perturbed_pops((4, 6, 8), 53)
    key = jax.random.PRNGKey(7)
    _, (w,) = jax_words(key, 1)
    want, _ = jmodel.step(jinit(jnp.asarray(f), jnp.asarray(g), 7),
                          JParams(kBT=1e-5), noise_source="hash",
                          noise_dist="u8")
    got, _ = tmodel.step(interop.state_from_arrays(f, g, 0, seed=7,
                                                   device="cpu"),
                         TParams(kBT=1e-5), w, noise_dist="u8")
    np.testing.assert_allclose(to_np(got.f), np.asarray(want.f), rtol=0,
                               atol=2e-5)
