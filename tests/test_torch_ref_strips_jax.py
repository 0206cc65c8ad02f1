"""The ref / strips K4 disagreement on the card, held against the JAX
package on the CPU (interpret mode), in a file of its own so that
``--dist loadfile`` gives it a worker.

The card's cases (``tests/test_torch_gpu.py::
test_blocked_window_and_strip_launches[shape1-strips ...-ref-...]``): the
32 x 80 x 72 droplet with rho_lo = 0 (kBT = 1e-5, perturbed with seed 43)
and USE_REF_STATE amplitudes 1 + 0.1 U (seed 44), words 7919 k - 3 from
step 40, clt4.  ``tools/ref_strips_fault.py`` located the disagreement on
the card: one cell, (30, 47, 51), after two steps, and the 18 around it
after three; the strip-fed K4 launch is bitwise the serial one, the plain
strip-fed sweep bitwise the plain serial sweep, and the whole-domain
one-step launches differ from the plain steps at the same cells.  At that
cell the streamed density after one step is within a few ulps of the
``|rho| > eps`` guard of the divisions (eps = FLT_EPSILON): the kernel's
is -eps exactly (guard closed), the plain step's -1.1944212e-07 (open),
so the velocity of species f and with it g's equilibrium differ by
1.027e-3.  ``data/ref_strips_fault_card.json`` holds the kernel's
step-one populations on the 27 cells that step two pulls there and its
step-two output at the cell (written on the card by that tool).

What JAX says:
- after one step its Pallas kernel and its jnp step agree with the plain
  step and with the kernel within 2e-5 everywhere, and land on the
  kernel's side of the guard (-1.1827797e-07 and -eps exactly);
- from the same input every implementation gives the same step two:
  JAX's kernel on the plain step's output matches the plain step two
  everywhere, and on the kernel's step-one cells the kernel's step two;
- JAX's block-2 sweep (K4) matches the kernel's two steps at the cell.
So each side computes its step right; the two trajectories part at a
guard that a rounding of 3e-10 in a density flips.  Tolerance 2e-5, the
card tests'.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bflbm_tpu.config import LBMParams as JParams
from bflbm_tpu.kernels import fused_step as jfs
from bflbm_tpu.ops import collide as jcollide
from bflbm_tpu.ops import hydro as jhydro
from bflbm_tpu.ops import noise as jnoise
from bflbm_tpu.ops import stream as jstream
from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step
from bflbm_tpu_torch.models import binary_fluid as model
from bflbm_tpu_torch.ops import blocked, stream
from bflbm_tpu_torch.ops.moments import density
from bflbm_tpu_torch.parallel import halo
from bflbm_tpu_torch.parallel import kernel as kernel_par
from bflbm_tpu_torch.parallel import mesh as mesh_lib
from bflbm_tpu_torch.state import init_state

TOL = 2e-5
SHAPE = (32, 80, 72)
WORDS = [7919 * k - 3 for k in range(2)]
STEP0 = 40
EPS = float(np.finfo(np.float32).eps)
CARD = Path(__file__).with_name("data") / "ref_strips_fault_card.json"


@pytest.fixture(scope="module")
def case():
    """The inputs, the card's cells, the plain steps one and two, JAX's
    kernel step one, and the kernel's step-one cells set into the plain
    step one (everything step two pulls at the cell is then the
    kernel's)."""
    params = LBMParams(kBT=1e-5)
    base = model.init_droplet(SHAPE, params, device="cpu", radius=0.3)
    f, g = model.perturbed_populations(SHAPE, 43, base=base)
    ref = 1.0 + 0.1 * torch.rand((2,) + SHAPE,
                                 generator=torch.Generator().manual_seed(44))
    card = json.loads(CARD.read_text())
    x, y, z = card["cell"]
    p1 = fused_step.k_step_reference(f, g, WORDS[0], STEP0, params, "clt4",
                                     ref)
    p2 = fused_step.k_step_reference(*p1, WORDS[1], STEP0 + 1, params,
                                     "clt4", ref)
    cube = (slice(None), slice(x - 1, x + 2), slice(y - 1, y + 2),
            slice(z - 1, z + 2))
    k1 = [t.clone() for t in p1]
    for t, key in zip(k1, ("input_f", "input_g")):
        t[cube] = torch.tensor(card[key], dtype=torch.float32)
    return dict(params=params, f=f, g=g, ref=ref, card=card, cell=(x, y, z),
                cube=cube, p1=p1, p2=p2, k1=k1,
                j1=_jax_kernel((f, g), ref, [WORDS[0]], STEP0))


def _jax_kernel(fg, ref, words, step0):
    """JAX's Pallas K (block = len(words)) in interpret mode on one
    whole-domain tile, numpy (f, g)."""
    with pltpu.force_tpu_interpret_mode():
        fo, go = jfs._fused_step_call(
            JParams(kBT=1e-5), SHAPE, SHAPE[:2], True,
            jnp.array(list(words) + [step0], jnp.int32),
            jnp.asarray(np.asarray(fg[0])), jnp.asarray(np.asarray(fg[1])),
            block=len(words), noise_impl="hash", noise_dist="clt4",
            ref=jnp.asarray(ref.numpy()))
    return np.asarray(fo), np.asarray(go)


def _jax_jnp_k(fg, ref, word, step):
    """JAX's jnp K (stream, hydro, hash noise with the ref amplitudes,
    collide) in float32, numpy (f, g)."""
    jp = JParams(kBT=1e-5)
    fs = jstream.stream(jnp.asarray(np.asarray(fg[0])))
    gs = jstream.stream(jnp.asarray(np.asarray(fg[1])))
    hbar = jhydro.hydrovars_bar(fs, gs, jp)
    r = jnp.asarray(ref.numpy())
    xi_f, xi_g = jnoise.thermal_noise_hash(
        jnp.int32(word), jnp.int32(step), hbar.rho, hbar.phi, jp,
        (r[0], r[1], jnp.zeros(3, jnp.float32)), "clt4")
    h = jhydro.hydrovars(fs, gs, xi_f, xi_g, jp, hbar)
    fo, go = jcollide.collide(fs, gs, h, xi_f, xi_g, jp)
    assert fo.dtype == jnp.float32
    return np.asarray(fo), np.asarray(go)


def _maxdiff(a, b):
    return max(float(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max()),
               float(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max()))


def _at(pair, cell):
    return [np.asarray(t)[(slice(None),) + tuple(cell)] for t in pair]


def _streamed_rho(f, cell):
    return float(density(stream.stream(torch.from_numpy(np.array(f))))[
        tuple(cell)])


def test_step_one_agrees_everywhere(case):
    """Step one: the plain step, JAX's kernel and JAX's jnp step within
    2e-5 of each other, and the kernel's cells within 2e-5 of the plain
    step's."""
    p1, j1 = case["p1"], case["j1"]
    assert _maxdiff(p1, j1) <= TOL
    n1 = _jax_jnp_k((case["f"], case["g"]), case["ref"], WORDS[0], STEP0)
    assert _maxdiff(p1, n1) <= TOL
    cube = case["cube"]
    assert _maxdiff([t[cube] for t in case["k1"]],
                    [t[cube] for t in p1]) <= TOL


def test_streamed_density_sits_on_the_guard(case):
    """The streamed density at the cell after step one lies within 1e-9
    of -eps everywhere; the kernel's (-eps exactly), JAX's kernel's and
    JAX's jnp step's close the |rho| > eps guard, the plain step's opens
    it."""
    cell = case["cell"]
    n1 = _jax_jnp_k((case["f"], case["g"]), case["ref"], WORDS[0], STEP0)
    rho = {"kernel": _streamed_rho(case["k1"][0], cell),
           "jax kernel": _streamed_rho(case["j1"][0], cell),
           "jax jnp": _streamed_rho(n1[0], cell),
           "plain": _streamed_rho(case["p1"][0], cell)}
    assert all(abs(r + EPS) < 1e-9 for r in rho.values()), rho
    assert rho["kernel"] == -EPS
    assert [abs(r) > EPS for r in rho.values()] == [False, False, False,
                                                    True], rho


def test_each_side_right_from_its_own_input(case):
    """Step two from the same input: JAX's kernel on the plain step one
    matches the plain step two everywhere; on the kernel's step-one cells
    JAX's kernel and the plain step both match the kernel's step two at
    the cell; the two trajectories differ there by more than 2e-5 (the
    card tests' failure)."""
    cell, card = case["cell"], case["card"]
    kern2 = [np.asarray(card["output_f"], np.float32),
             np.asarray(card["output_g"], np.float32)]
    j_on_plain = _jax_kernel(case["p1"], case["ref"], [WORDS[1]], STEP0 + 1)
    assert _maxdiff(j_on_plain, case["p2"]) <= TOL
    j_on_kern = _jax_kernel(case["k1"], case["ref"], [WORDS[1]], STEP0 + 1)
    assert _maxdiff(_at(j_on_kern, cell), kern2) <= TOL
    p_on_kern = fused_step.k_step_reference(
        *case["k1"], WORDS[1], STEP0 + 1, case["params"], "clt4",
        case["ref"])
    assert _maxdiff(_at(p_on_kern, cell), kern2) <= TOL
    assert _maxdiff(_at(case["p2"], cell), kern2) > 50 * TOL


def test_jax_sweep_sides_with_the_kernel(case):
    """JAX's block-2 sweep (K4, interpret mode) from the same input as the
    card's launch: at the cell within 2e-5 of the kernel's two steps and
    1e-3 from the plain two steps; and the plain strip-fed sweep on the
    last block of (2, 1, 1) bitwise the plain serial sweep (the strips
    are not where the two part)."""
    cell, card = case["cell"], case["card"]
    kern2 = [np.asarray(card["output_f"], np.float32),
             np.asarray(card["output_g"], np.float32)]
    jb = _jax_kernel((case["f"], case["g"]), case["ref"], WORDS, STEP0)
    assert _maxdiff(_at(jb, cell), kern2) <= TOL
    assert _maxdiff(_at(jb, cell), _at(case["p2"], cell)) > 50 * TOL

    params, T = case["params"], 2
    mesh = mesh_lib.make_mesh((2, 1, 1), "cpu")
    lay = kernel_par.layout(mesh, SHAPE, params, block=T,
                            y_exchange="strips")
    ss = mesh_lib.shard_state(init_state(case["f"], case["g"], 0), mesh,
                              lay.pad)
    halo.exchange_halo(ss.blocks, mesh, lay.pad)
    refs = mesh_lib.shard_field(case["ref"], mesh, lay.pad)
    halo.exchange_halo(refs, mesh, lay.pad)
    sent = kernel_par.strip_buffers(ss.blocks, lay.pad)
    received = [torch.full_like(t, float("nan")) for t in sent]
    halo.run_plan(halo.strip_plan(sent, received, mesh, lay.pad))
    blk, r = ss.blocks[-1], refs[-1]
    ext = halo.block_exts(mesh, SHAPE, lay.pad)[-1]
    tile = fused_step.launch_tile(T, ext.interior(blk.shape))
    src = blk.clone()
    ax = src.dim() - 2
    src.narrow(ax, 0, lay.pad[1]).fill_(float("nan"))
    src.narrow(ax, src.shape[ax] - lay.pad[1], lay.pad[1]).fill_(
        float("nan"))
    fed = blocked.blocked_sweep_reference(src[0], src[1], WORDS, STEP0,
                                          params, T, tile, "clt4", r, ext,
                                          strips=received[-1])
    serial = blocked.blocked_sweep_reference(blk[0], blk[1], WORDS, STEP0,
                                             params, T, tile, "clt4", r, ext)
    assert all(torch.equal(a, b) for a, b in zip(fed, serial))
    # the block's cells are the whole-domain plain steps'
    cells = tuple(slice(o, o + n) for o, n in
                  zip(ext.origin, ext.interior(blk.shape)))
    assert _maxdiff([t[(slice(None),) + cells] for t in case["p2"]],
                    serial) <= TOL
