"""The launch geometry of kernels L and B-A1 on the CPU: the x-marching
tiles of ``csrc/stencil_tile.cuh`` (a block a (ty, tz) tile of the
launch's region marching xc planes of x) cover every cell of each region
the wrappers launch on exactly once and nothing outside it, and every
tile the table or the sweep holds fits a thread block."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bflbm_tpu_torch.config import LBMParams
from bflbm_tpu_torch.kernels import fused_step as tfs
from bflbm_tpu_torch.parallel import halo
from bflbm_tpu_torch.parallel import kernel as kernel_par
from bflbm_tpu_torch.parallel import mesh as mesh_lib

ALPHA1 = LBMParams(alpha0=1.2, alpha1=0.5, kappa=0.1, rho_lo=0.1,
                   rho_hi=3.0, kBT=1e-5)


def _sweep_tiles():
    """(ty, tz, xc) of every case of tools/stencil_tiles.py."""
    path = Path(__file__).resolve().parents[1] / "tools" / "stencil_tiles.py"
    spec = importlib.util.spec_from_file_location("stencil_tiles", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(ty, tz, xc) for ty, tz in mod.TILES for xc in mod.CHUNKS]


# the table's tiles, one that marches a chunk of 5 planes, a 64-wide one
TILES = sorted({tfs.stencil_tile(k) for k in ("l", "b_a1")}
               | {(2, 128, 5), (4, 64, 8)})


def _region(shape, ext=None, kind="b_a1", window=None):
    """(first cell, extents) of the region an L (kind "l") or B-A1 launch
    on arrays of `shape` covers, as the wrappers compute it."""
    cut, need = (2, 2) if kind == "l" else (None, 3)
    geom = tfs._geom(torch.empty((2,) + tuple(shape), device="meta"), ext,
                     cut, need, window)
    return tuple(geom[3:6]), tuple(geom[6:9])


def _check_cover(shape, start, region, tile):
    """Each block's box lies inside the region and the boxes cover it once;
    the grid holds one block a box."""
    count = np.zeros(tuple(shape), dtype=np.int64)
    boxes = list(tfs.stencil_blocks(tile, region))
    assert len(boxes) == int(np.prod(tfs.stencil_grid(tile, region)))
    for box in boxes:
        for (a, b), n in zip(box, region):
            assert 0 <= a < b <= n
        count[tuple(slice(s + a, s + b)
                    for s, (a, b) in zip(start, box))] += 1
    inside = tuple(slice(s, s + n) for s, n in zip(start, region))
    assert (count[inside] == 1).all()
    assert int(count.sum()) == int(np.prod(region))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("shape", [(16, 16, 16), (20, 12, 40), (5, 7, 3)])
@pytest.mark.parametrize("kind", ["l", "b_a1"])
def test_tiles_cover_the_whole_domain(kind, shape, tile):
    """The whole periodic domain, including Z smaller than the tile (3
    and 16 under 32, 40 under 64 and 128)."""
    start, region = _region(shape, kind=kind)
    assert start == (0, 0, 0) and region == shape
    _check_cover(shape, start, region, tile)


def _blocks(mesh_shape, shape, overlap=False):
    """The padded block shape, the exts and the layout of the alpha1
    droplet's decomposition (pads 3 deep)."""
    mesh = mesh_lib.make_mesh(mesh_shape, "cpu")
    lay = kernel_par.layout(mesh, shape, ALPHA1, overlap)
    pad = lay.pad if any(lay.split) else mesh.pads(3)
    exts = halo.block_exts(mesh, shape, pad)
    arrays = tuple(n + 2 * p for n, p in zip(mesh.local_shape(shape), pad))
    return arrays, exts, lay


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("kind", ["l", "b_a1"])
def test_tiles_cover_ext_blocks(kind, mesh_shape, tile):
    """Every block of 16^3 and 20 x 12 x 40 with its pads: B-A1 on the
    interior, L on the interior and one cell beyond on the padded axes."""
    for shape in ((16, 16, 16), (20, 12, 40)):
        arrays, exts, _ = _blocks(mesh_shape, shape)
        for ext in exts:
            start, region = _region(arrays, ext, kind)
            grow = 0 if kind == "b_a1" else 1
            assert region == tuple(n + 2 * grow * (p > 0) for n, p in
                                   zip(ext.interior(arrays), ext.pad))
            _check_cover(arrays, start, region, tile)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("overlap", [True, "force"])
def test_tiles_cover_split_windows(overlap, tile):
    """The overlap split's interior window and seam bands on the last block
    of 16^3 on (2, 2, 1), and L's windows in front of them
    (prepass_windows); each window's launch covers exactly the window."""
    arrays, exts, lay = _blocks((2, 2, 1), (16, 16, 16), overlap)
    assert any(lay.split)
    ext = exts[-1]
    inner, bands = kernel_par.split_windows(lay, arrays, 3)
    for win in [inner] + bands:
        _, l_win = tfs.prepass_windows(ALPHA1, ext, arrays, win)
        for kind, box in (("b_a1", win), ("l", l_win)):
            start, region = _region(arrays, ext, kind, box)
            assert start == tuple(a for a, _ in box)
            assert region == tuple(b - a for a, b in box)
            _check_cover(arrays, start, region, tile)


def test_stencil_grid_is_the_ceiling():
    """(z tiles, y tiles, x chunks), the last of each past the region's
    end where the tile does not divide it."""
    assert tfs.stencil_grid((8, 32, 16), (256, 256, 256)) == (8, 32, 16)
    assert tfs.stencil_grid((8, 32, 16), (20, 12, 40)) == (2, 2, 2)
    assert tfs.stencil_grid((4, 64, 8), (12, 16, 32)) == (1, 4, 2)


@pytest.mark.parametrize("tile", [(8, 32), (2, 128), (4, 64), (5, 3)])
@pytest.mark.parametrize("fields", [1, 2])
def test_stencil_smem_bytes_is_the_source_formula(tile, fields):
    """stencil_smem_bytes is ``csrc/stencil_tile.cuh`` tile_smem, which
    bflbm_laplacian_smem (fields 1) and bflbm_a1_smem export, written out:
    6 ring slots (x - 1, x, x + 1 and 3 planes ahead) x fields x 2
    species x (ty + 2)(tz + 2) floats of 4 bytes."""
    ty, tz = tile
    assert tfs.stencil_smem_bytes(tile, fields) \
        == 6 * fields * 2 * (ty + 2) * (tz + 2) * 4


def test_stencil_fields():
    """L's ring holds psi; B-A1's the laplacian, and psi unless alpha0 =
    0."""
    assert tfs.stencil_fields("l") == 1
    assert tfs.stencil_fields("b_a1", ALPHA1) == 2
    no_sc = LBMParams(alpha0=0.0, alpha1=0.5, kappa=0.1)
    assert tfs.stencil_fields("b_a1", no_sc) == 1


@pytest.mark.parametrize("source", ["table", "sweep"])
def test_tiles_fit_a_block(source):
    """Every tile of the table and of the sweep: y and z at least 2 cells,
    at most 256 threads, and its largest ring (both fields) inside the
    232,448 bytes a block holds."""
    tiles = ([tfs.stencil_tile(k) for k in ("l", "b_a1")]
             if source == "table" else _sweep_tiles())
    for ty, tz, xc in tiles:
        assert ty >= 2 and tz >= 2 and xc >= 1
        assert ty * tz <= tfs.STENCIL_MAX_THREADS
        assert tfs.stencil_smem_bytes((ty, tz), 2) <= tfs.SMEM_PER_BLOCK
