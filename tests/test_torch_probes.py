"""The platform probes of the PyTorch port (``bflbm_tpu_torch.probes``) on
the CPU: their plain versions against the JAX package's TPU probes
(``benchmarks/tpu_noise_micro.py``, imported by path; the lattice tables
and a HIGHEST ``dot_general`` pair for the transform), the Philox stream
against its known answers and its statistics, and the CLI.

The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 15).  Tolerance 2e-5 on sums of 34 draws and on the
transform: transcendentals and summation order differ between XLA and
PyTorch; the words are compared bitwise.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflbm_tpu import lattice as jlattice
from bflbm_tpu_torch import lattice as tlattice
from bflbm_tpu_torch import probes
from bflbm_tpu_torch.probes import launch, noise_micro, platform
from bflbm_tpu_torch.probes.__main__ import main as probes_main

TOL = 2e-5
HASH_CASES = [c for c in noise_micro.CASES
              if c not in noise_micro.PHILOX_CASES]
# (word, step) pairs: the TPU probe's seed, and a negative word with a
# large step (int32 wrap in the counter words).
WORD_STEPS = ((12345, 7), (-987654321, 123456))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain noise arithmetic is thousands of small int64 ops: on a
    machine loaded by the suite's parallel workers, torch's intra-op
    thread pool makes each one wait for its threads (~10x slower), so this
    module runs with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jnoise():
    """benchmarks/tpu_noise_micro.py, imported by path.  Its generator
    cases run on the CPU on the first 64 z planes of their (12, 36, 256)
    region of 256^3 (a quarter of the cost; the cells keep their keys,
    which the global (Y, Z) = (256, 256) define)."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "tpu_noise_micro.py"
    spec = importlib.util.spec_from_file_location("tpu_noise_micro", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.REGION = mod.REGION[:2] + (64,)
    return mod


def _region_cells(jnoise):
    """The cell keys of the TPU probe's region, as its _cellwords keys
    them (int64-held uint32)."""
    (rx, ry, rz), (_, Y, Z) = jnoise.REGION, jnoise.SHAPE
    ix = torch.arange(rx)[:, None, None]
    iy = torch.arange(ry)[None, :, None]
    iz = torch.arange(rz)[None, None, :]
    return ((ix * Y + iy) * Z + iz) & 0xFFFFFFFF


def _jax_words(jnoise, case, word, step):
    """The words the TPU probe's case draws, from its own mixers."""
    h1 = jnoise._mix32(jnoise._cellwords(jnp.int32(word)))
    sbase = jnp.int32(step) * jnp.int32(64)
    pair = case in ("hash_u16", "hash_1mul16", "hash_nomul")
    words = []
    for a in range(noise_micro.NPAIR if pair else noise_micro.NDRAWS):
        cnt = jnp.full((1, 1, 1), (sbase + a) * jnp.int32(jnoise._GOLD_I32),
                       jnp.int32)
        x = h1 + jnoise._u32(cnt)
        if case in ("hash_cur", "hash_uniform_only", "hash_u16",
                    "clt4_hash"):
            x = jnoise._mix32(x)
        elif case in ("hash_1mul24", "hash_1mul16", "clt4_hash_1mul"):
            x = jnoise._mix32_1mul(x)
        else:
            rounds = (13, 17, 5, 11) if case == "hash_nomul" else (13, 17, 7)
            shift = 7 if case == "hash_nomul" else 9
            for k in rounds:
                x = x + jnoise._rotl(x, k)
                x = x ^ (x >> shift)
        words.append(np.asarray(x).astype(np.int64))
    return words


@pytest.mark.parametrize("case", HASH_CASES)
def test_noise_case_matches_jax(jnoise, case):
    """Each hash case's plain words bitwise the TPU probe's, and its sum of
    34 draws within TOL of the probe's gen_* (eager JAX on the CPU), for
    two (word, step) pairs."""
    cell = _region_cells(jnoise)
    for word, step in WORD_STEPS:
        got = noise_micro.case_words(case, cell, word, step)
        want = _jax_words(jnoise, case, word, step)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        total = noise_micro.case_sum(case, cell, word, step)
        ref = np.asarray(jnoise.CASES[case](jnp.int32(word),
                                            jnp.int32(step)))
        assert total.dtype == torch.float32 and total.shape == ref.shape
        np.testing.assert_allclose(total.numpy(), ref, rtol=0, atol=TOL)


def test_run_case_tiles_match_jax(jnoise, monkeypatch):
    """run_case on a CPU (16, 64, 64) domain (the plain version): tile
    (i, j) is the TPU probe's gen(seed0 + 7919 i + 104729 j,
    seed1)[2:10, 2:34, :], on three tiles, with the probe's region keyed
    by the same (Y, Z) = (64, 64)."""
    seed = (12345 + 5, 7 + 5)
    shape = (16, 64, 64)
    monkeypatch.setattr(jnoise, "Y", 64)
    monkeypatch.setattr(jnoise, "Z", 64)
    monkeypatch.setattr(jnoise, "SHAPE", (256, 64, 64))
    monkeypatch.setattr(jnoise, "REGION", (12, 36, 64))
    got = noise_micro.run_case("hash_cur", seed,
                               torch.full(shape, float("nan")))
    for i, j in ((0, 0), (1, 1), (0, 1)):
        word = int(np.int32(np.int64(seed[0]) + 7919 * i + 104729 * j))
        ref = np.asarray(jnoise.gen_hash_cur(jnp.int32(word),
                                             jnp.int32(seed[1])))
        np.testing.assert_allclose(
            got[8 * i:8 * i + 8, 32 * j:32 * j + 32].numpy(),
            ref[2:10, 2:34, :], rtol=0, atol=TOL)


def test_run_case_wraps_int32_seeds():
    """Seeds past int32 wrap as the TPU probe's int32 seed + k does."""
    shape = (8, 32, 16)
    a = noise_micro.run_case("clt4_hash", (2**31 - 1 + 3, -2**31 - 2),
                             torch.empty(shape))
    b = noise_micro.run_case("clt4_hash", (-2**31 + 2, 2**31 - 2),
                             torch.empty(shape))
    assert torch.equal(a, b)


def test_lattice_tables_equal_jax():
    np.testing.assert_array_equal(tlattice.M, jlattice.M)
    np.testing.assert_array_equal(tlattice.M_INV, jlattice.M_INV)
    assert platform.TRANSFORM_OPS == 183 + 2 * 24 + 2 * 207


@pytest.mark.parametrize("variant", platform.TRANSFORM_VARIANTS)
def test_transform_plain_matches_float64_and_jax(variant):
    """M_INV (M f) on f in [0.5, 1.5): the plain einsum (the CPU path of
    either variant) against numpy float64 of the JAX package's tables and
    against two HIGHEST dot_generals, within TOL."""
    rng = np.random.default_rng(13)
    f = rng.uniform(0.5, 1.5, (19, 6, 10, 12)).astype(np.float32)
    got = platform.moment_transform(torch.from_numpy(f), variant).numpy()
    flat = f.reshape(19, -1)
    want64 = (jlattice.M_INV @ (jlattice.M @ flat.astype(np.float64)))
    np.testing.assert_allclose(got.reshape(19, -1), want64, rtol=0, atol=TOL)
    hi = jax.lax.Precision.HIGHEST
    dims = (((1,), (0,)), ((), ()))
    mom = jax.lax.dot_general(jnp.asarray(jlattice.M, jnp.float32),
                              jnp.asarray(flat), dims, precision=hi,
                              preferred_element_type=jnp.float32)
    want = jax.lax.dot_general(jnp.asarray(jlattice.M_INV, jnp.float32), mom,
                               dims, precision=hi,
                               preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.reshape(19, -1), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("variant", platform.COPY_VARIANTS)
def test_copy_plain_is_exact(variant):
    f = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (19, 4, 6, 10)).astype(np.float32))
    for n in platform.CHUNKS:
        out = platform.chunk_copy(f, n, variant)
        assert torch.equal(out, f) and out.data_ptr() != f.data_ptr()
    with pytest.raises(ValueError, match="multiples of 4"):
        platform.chunk_copy(f, 510, variant)
    with pytest.raises(ValueError, match="shared memory"):
        platform.chunk_copy(f, 4096, variant)
    with pytest.raises(ValueError, match="alias"):
        platform.chunk_copy(f, 512, variant, out=f)


def test_wrappers_refuse_bad_input():
    f = torch.zeros((19, 2, 2, 2))
    with pytest.raises(ValueError, match="variant"):
        platform.chunk_copy(f, 512, "dma")
    with pytest.raises(ValueError, match="variant"):
        platform.moment_transform(f, "mxu")
    with pytest.raises(TypeError):
        platform.moment_transform(f.double())
    with pytest.raises(ValueError, match=r"\(19, X, Y, Z\)"):
        platform.chunk_copy(torch.zeros((18, 2, 2, 2)))
    with pytest.raises(ValueError, match="unknown noise case"):
        noise_micro.run_case("hw", (1, 2), torch.empty((8, 32, 4)))
    with pytest.raises(ValueError, match="tile"):
        noise_micro.run_case("hash_cur", (1, 2), torch.empty((12, 32, 4)))
    with pytest.raises(ValueError, match="1024"):
        launch.add_one(torch.zeros(2048))
    with pytest.raises(ValueError, match="alias"):
        x = torch.zeros(8)
        launch.add_one(x, out=x)


def test_launch_plain_chain_is_exact():
    """400 chained adds from zero end at exactly 400 through the CPU path
    of the wrapper and in the plain chain."""
    a = torch.zeros(launch.SHAPE)
    res = launch.chain(lambda x, y: launch.add_one(x, out=y), a,
                       torch.empty_like(a))
    assert res.data_ptr() == a.data_ptr()
    assert torch.equal(res, torch.full(launch.SHAPE, 400.0))
    (rec,) = launch.probe_launch(torch.device("cpu"))
    assert rec["ok"] and rec["bitwise"] and rec["ms"] is None


def test_philox_known_answers():
    """Philox4x32-10 against the known answers of Salmon et al.'s
    Random123 (counter, key) -> output."""
    def run(ctr, key):
        return [int(w) for w in noise_micro.philox4x32(
            [torch.tensor(c) for c in ctr], [torch.tensor(k) for k in key])]

    assert run([0] * 4, [0] * 2) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    assert run([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
               [0xA4093822, 0x299F31D0]) == [0xD16CFE09, 0x94FDCCEB,
                                             0x5001E420, 0x24126EA1]


def test_philox_stream_statistics():
    """10^6 Philox draws of the probe's keying: the byte histogram's
    chi-square (255 degrees of freedom) and the Box-Muller normals' mean
    and variance (the philox case's pairs (p, 17 + p)) within 4 sigma."""
    n = 10**6 // noise_micro.NDRAWS + 1
    cell = torch.arange(n, dtype=torch.int64)
    ws = noise_micro.philox_words(cell, -123456789, 42)
    words = torch.stack(ws).reshape(-1)
    bytes_ = torch.cat([(words >> s) & 0xFF for s in (0, 8, 16, 24)])
    counts = torch.bincount(bytes_, minlength=256).double()
    expect = bytes_.numel() / 256
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert abs(chi2 - 255) < 4 * np.sqrt(2 * 255), chi2
    u1 = torch.stack([(w >> 8).double() / 2**24 + 2.0**-25
                      for w in ws[:noise_micro.NPAIR]])
    u2 = torch.stack([(w >> 8).double() / 2**24
                      for w in ws[noise_micro.NPAIR:]])
    r = torch.sqrt(-2 * torch.log(u1))
    z = torch.cat([r * torch.cos(2 * np.pi * u2),
                   r * torch.sin(2 * np.pi * u2)]).reshape(-1)
    m = z.numel()
    assert m >= 10**6
    assert abs(float(z.mean())) < 4 / np.sqrt(m)
    assert abs(float(z.var()) - 1) < 4 * np.sqrt(2 / m)


def test_cli_runs_on_cpu(capsys):
    """python -m bflbm_tpu_torch.probes --device cpu --shape 16 16 16: every
    probe's plain version and check, every time "not measured"; the CPU
    paths launch nothing."""
    probes.reset_launch_counts()
    assert probes_main(["--device", "cpu", "--shape", "16", "16", "16"]) == 0
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert len(lines) == 1 + 2 + 2 + 2 + len(noise_micro.CASES) + 1
    assert all(ln.endswith("ok") for ln in lines)
    assert "not measured" in text and " ms " not in text
    assert probes.launch_counts() == {}
    with pytest.raises(SystemExit):
        probes_main(["dma", "nonsense", "--device", "cpu"])


def test_cuda_without_a_card_raises():
    """On "cuda" the probes measure the card or raise: no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        probes.run(["copy"], device="cuda", out=None)
