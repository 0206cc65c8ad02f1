"""The port's frame formats (``bflbm_tpu_torch/io/{fields,native,hdf5,
amrex}.py``) against the JAX package's, on the CPU.

Frames written by one package are read by the other's ``read_frame`` and
must equal that package's own reading bitwise, in every format:
``.bflbm`` (the native container), ``.h5`` and AMReX plotfile
directories.  ``fmt="auto"``'s switch at 32 MiB is tested by lowering the
threshold constant, not by writing a 32 MiB frame.  The port's native
library builds under ``build/``, never into ``native/``.
"""

import os

import numpy as np
import pytest
import torch

from bflbm_tpu.io import fields as jfields
from bflbm_tpu_torch import config as tconfig
from bflbm_tpu_torch import run as trun
from bflbm_tpu_torch.io import fields as tfields
from bflbm_tpu_torch.io import native as tnative
from bflbm_tpu_torch.kernels import _build
from bflbm_tpu_torch.ops.moments import density

SHAPE = (4, 5, 6)
NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


def _packed(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((22,) + SHAPE).astype(np.float32)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt,suffix", [("native", ".bflbm"), ("h5", ".h5"),
                                        ("amrex", "")])
def test_frames_cross_packages(tmp_path, writer, fmt, suffix):
    arr = _packed(101)
    if writer == "jax":
        path = jfields.write_frame(str(tmp_path), 7, arr, fmt=fmt)
    else:
        path = tfields.write_frame(str(tmp_path), 7, torch.from_numpy(arr),
                                   fmt=fmt)
    assert path == os.path.join(str(tmp_path), "plt0000007" + suffix)
    got = tfields.read_frame(path)
    _assert_same(got, jfields.read_frame(path))
    assert int(got["step"]) == 7
    for i, name in enumerate(tfields.HYDRO_NAMES):
        np.testing.assert_array_equal(got[name], arr[i])


@pytest.mark.parametrize("threshold,ext", [(1, "bflbm"), (2 ** 40, "npz")])
def test_auto_switches_at_the_threshold(tmp_path, monkeypatch, threshold,
                                        ext):
    """auto writes native at and above the threshold, npz below, in both
    packages, and the port's constant is JAX's."""
    assert tfields._AUTO_NATIVE_BYTES == jfields._AUTO_NATIVE_BYTES
    monkeypatch.setattr(tfields, "_AUTO_NATIVE_BYTES", threshold)
    monkeypatch.setattr(jfields, "_AUTO_NATIVE_BYTES", threshold)
    arr = _packed(102)
    tpath = tfields.write_frame(str(tmp_path / "port"), 3, arr)
    jpath = jfields.write_frame(str(tmp_path / "jax"), 3, arr)
    assert tpath.endswith(f"plt0000003.{ext}")
    assert jpath.endswith(f"plt0000003.{ext}")
    _assert_same(tfields.read_frame(tpath), jfields.read_frame(jpath))


def test_async_writer_frames(tmp_path):
    frames = [_packed(103 + k) for k in range(3)]
    with tnative.AsyncFieldWriter() as writer:
        paths = [tfields.write_frame(str(tmp_path), k, torch.from_numpy(a),
                                     fmt="native", writer=writer)
                 for k, a in enumerate(frames)]
        frames[0][:] = 0.0      # submit copied the fields
    for k, (path, arr) in enumerate(zip(paths, frames)):
        got = jfields.read_frame(path)
        assert int(got["step"]) == k
        for i, name in enumerate(tfields.HYDRO_NAMES):
            want = _packed(103)[i] if k == 0 else arr[i]
            np.testing.assert_array_equal(got[name], want)


def test_native_library_builds_under_build(tmp_path, monkeypatch):
    """A fresh build lands in build/.../native/ keyed by the source, and
    nothing is written into native/."""
    assert tnative.library_path().parent == _build.build_dir() / "native"
    before = sorted(os.listdir(NATIVE_DIR))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "b")
    so = tnative.build()
    assert so == tmp_path / "b" / "native" / so.name
    assert so.name.startswith("libbflbm_native.") and so.exists()
    assert tnative.build() == so                      # cached
    assert sorted(os.listdir(NATIVE_DIR)) == before


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "b")
    monkeypatch.setattr(tnative, "_SOURCE", bad)
    with pytest.raises(RuntimeError, match="bad.cc"):
        tnative.build()
    assert not tnative.library_path().exists()


def test_run_writes_large_frames_through_the_async_writer(tmp_path,
                                                          monkeypatch):
    """With the threshold lowered, run() writes .bflbm frames through an
    AsyncFieldWriter, flushed before it returns, and the convergence
    report reads them back."""
    monkeypatch.setattr(tfields, "_AUTO_NATIVE_BYTES", 1)
    made = []
    real = tnative.AsyncFieldWriter

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tnative, "AsyncFieldWriter", Spy)
    cfg = tconfig.preset("droplet-eq").replace(
        shape=(8, 8, 8), nsteps=4, plot_int=2, print_int=0, droplet_int=0,
        t_window=4, out_dir=str(tmp_path))
    final = trun.run(cfg, device="cpu")
    assert len(made) == 1 and made[0]._h is None     # closed
    names = sorted(p for p in os.listdir(tmp_path) if p.startswith("plt"))
    assert names == [f"plt{s:07d}.bflbm" for s in (0, 2, 4)]
    last = tfields.read_frame(str(tmp_path / "plt0000004.bflbm"))
    np.testing.assert_array_equal(last["rho"], density(final.f).numpy())
    assert (tmp_path / "convergence.json").exists()
