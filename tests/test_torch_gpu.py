"""The port's CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: each test skips without a CUDA device.  The module
imports no JAX, so on a machine without JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py configures JAX).  Tolerance atol 2e-5: 1/x
multiplies against divides, and FMA contraction differs.
"""

import pytest
import torch

from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.kernels.session import FusedSession
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.state import init_state

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 16, 32), (5, 7, 130)])
@pytest.mark.parametrize("kBT", [0.0, 1e-5])
def test_kernel_matches_plain(cuda, shape, kBT):
    f, g = model.perturbed_populations(shape, 1, device=cuda)
    params = LBMParams(kBT=kBT)
    before = fused_step.launches
    fo, go = fused_step.fused_stream_collide(f, g, -5, 77, params)
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    fr, gr = fused_step.k_step_reference(f, g, -5, 77, params)
    assert max(_maxdiff(fo, fr), _maxdiff(go, gr)) <= ATOL


@pytest.mark.gpu
def test_kernel_noise_bits(cuda):
    """The noise the kernel adds is the hash stream's: kernel(kBT) -
    kernel(0) matches plain(kBT) - plain(0) far below the noise size."""
    f, g = model.perturbed_populations((8, 8, 128), 2, device=cuda)
    on, off = LBMParams(kBT=1e-5), LBMParams(kBT=0.0)
    dk = fused_step.fused_stream_collide(f, g, 9, 3, on)[0] \
        - fused_step.fused_stream_collide(f, g, 9, 3, off)[0]
    dp = fused_step.k_step_reference(f, g, 9, 3, on)[0] \
        - fused_step.k_step_reference(f, g, 9, 3, off)[0]
    assert float(dp.abs().max()) > 100 * ATOL
    assert _maxdiff(dk, dp) <= ATOL


@pytest.mark.gpu
def test_session_matches_plain_chain(cuda):
    shape = (16, 16, 32)
    f, g = model.perturbed_populations(shape, 3, device=cuda)
    params = LBMParams(kBT=1e-5)
    words = [3 * k - 11 for k in range(10)]
    ref = model.nsteps(init_state(f.clone(), g.clone(), 0), params, 10, words)
    sess = FusedSession(params, shape, mass_restore_int=4)
    before = fused_step.launches
    pc = sess.enter(init_state(f, g, 0), words[0])
    pc = sess.advance(pc, 9, words[1:])
    got = sess.exit(pc)
    assert fused_step.launches == before + 9
    assert max(_maxdiff(got.f, ref.f), _maxdiff(got.g, ref.g)) <= ATOL


@pytest.mark.gpu
def test_kernel_refuses_unsupported(cuda):
    f, g = model.perturbed_populations((4, 4, 32), 4, device=cuda)
    for params, item in ((LBMParams(alpha0=1.0), "K1b"),
                         (LBMParams(tau_f=0.8), "K1d")):
        with pytest.raises(NotImplementedError, match=item):
            fused_step.fused_stream_collide(f, g, 1, 1, params)
    with pytest.raises(ValueError, match="alias"):
        fused_step.fused_stream_collide(f, g, 1, 1, LBMParams(),
                                        out=(f, torch.empty_like(g)))
    with pytest.raises(TypeError, match="float32"):
        fused_step.fused_stream_collide(f.double(), g.double(), 1, 1,
                                        LBMParams())
