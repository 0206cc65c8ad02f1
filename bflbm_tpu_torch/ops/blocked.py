"""Halo-extended blocks: the model step on one block of a decomposed
domain (``bflbm_tpu/ops/blocked.py``), the plain version of the K7 ext
mode of the kernels.

A decomposed domain is cut into blocks (:mod:`bflbm_tpu_torch.parallel.
mesh`).  Each block is held extended by pads of depth p on its sharded
axes, which the halo exchange (:mod:`bflbm_tpu_torch.parallel.halo`)
fills with its neighbours' cells, while an unsharded axis spans the
whole domain and wraps periodically in place.  Every neighbour shift is
then a slice on a padded axis and a roll on the others.  One K step
reaches :func:`sd_depth` cells: 1 for the pull stream, 2 with the
Shan-Chen gradient of the streamed densities, 3 with the alpha1 gradient
of their laplacian, so that is the pad depth a step needs.

The arithmetic is the periodic plain step's, op for op (the stencils take
the block's neighbour function, :meth:`Window.at`), so a block's interior
equals the periodic step's cells; the noise is keyed by global
coordinates (the block's origin and the global domain), as the JAX
kernel's seed operand keys it.

The same pieces give the plain version of K4, T steps per sweep on tiles
whose phases shrink by the stencil depth (:func:`blocked_sweep_reference`),
on the periodic domain or on a block whose pads are sd T deep, there also
on a window of the interior or fed by received y strips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..config import LBMParams
from ..lattice import C, Q
from . import collide as collide_ops
from . import hydro as hydro_ops
from . import noise as noise_ops
from . import stencil as stencil_ops
from .moments import density


def sd_depth(params: LBMParams) -> int:
    """Cells one K step reaches (``bflbm_tpu/kernels/fused_step.py:
    sd_depth``): the pull stream 1, the Shan-Chen gradient (alpha0 != 0)
    a second, the alpha1 gradient of the laplacian a third."""
    if params.alpha1 != 0.0:
        return 3
    return 2 if params.alpha0 != 0.0 else 1


@dataclass(frozen=True)
class Ext:
    """Where a halo-extended block lies: its pads per axis (0 on an axis
    that is not sharded, one depth p on the others), the global
    coordinates of its first interior cell, and the global domain."""

    pad: Tuple[int, int, int]
    origin: Tuple[int, int, int]
    domain: Tuple[int, int, int]

    def __post_init__(self):
        depths = {int(p) for p in self.pad if p}
        if len(depths) > 1 or any(int(p) < 0 for p in self.pad):
            raise ValueError(f"pads must be 0 or one depth, got {self.pad}")

    @property
    def depth(self) -> int:
        return max(int(p) for p in self.pad)

    def interior(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """The interior extents of a block whose arrays end in `shape`."""
        out = tuple(int(n) - 2 * int(p)
                    for n, p in zip(tuple(shape)[-3:], self.pad))
        if min(out) < 1:
            raise ValueError(f"arrays {tuple(shape)} have no interior "
                             f"inside the pads {self.pad}")
        return out

    def region(self, t: torch.Tensor, cut: Optional[int] = None
               ) -> torch.Tensor:
        """View of t's cells that lie `cut` or more cells inside its padded
        edges (cut None: the interior); axes without pads are whole."""
        return interior(t, [p if cut is None else min(p, cut)
                            for p in self.pad])

    def bounds(self, shape: Sequence[int], cut: Optional[int] = None
               ) -> Box:
        """The box of :meth:`region` in the array coordinates of arrays
        ending in `shape`."""
        return tuple((s, int(n) - s) for s, n in zip(
            (p if cut is None else min(p, cut) for p in self.pad),
            tuple(shape)[-3:]))


# A box of a block's arrays: per spatial axis the cells [start, stop), in
# array coordinates (pads included).
Box = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def box_view(t: torch.Tensor, box: Box) -> torch.Tensor:
    """View of t's cells in `box` (its last three axes)."""
    return t[(slice(None),) * (t.dim() - 3)
             + tuple(slice(int(a), int(b)) for a, b in box)]


def inside(box: Box, outer: Box) -> bool:
    return all(o0 <= a < b <= o1 for (a, b), (o0, o1) in zip(box, outer))


def grow(box: Box, by: int, within: Box) -> Box:
    """`box` grown by `by` cells on every side, clipped to `within`."""
    return tuple((max(a - by, w0), min(b + by, w1))
                 for (a, b), (w0, w1) in zip(box, within))


def mount_strips(a: torch.Tensor, strips: torch.Tensor, species: int
                 ) -> torch.Tensor:
    """A copy of the padded block array `a` (.., X, Y, Z) whose y pads
    hold the received y strips of `species` (the strips exchange,
    :func:`bflbm_tpu_torch.parallel.halo.strip_plan`): `strips` is
    (2 sides, 2 species, .., X, rows, Z), side 0 mounted below the
    interior rows, side 1 above them."""
    rows = int(strips.shape[-2])
    out = a.clone()
    out[..., :rows, :] = strips[0, species]
    out[..., out.shape[-2] - rows:, :] = strips[1, species]
    return out


def interior(t: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """View of t without `pad` cells on each side of its last three
    axes."""
    idx = [slice(None)] * (t.dim() - 3)
    idx += [slice(int(p), int(n) - int(p))
            for n, p in zip(t.shape[-3:], pad)]
    return t[tuple(idx)]


def shift_block(arr: torch.Tensor, cvec, halo_axes: Sequence[bool],
                trim: int, halo: int) -> torch.Tensor:
    """arr evaluated at x + cvec on the window `trim` cells beyond the
    interior, given `halo` cells beyond it on the flagged axes (|c| + trim
    <= halo there); unflagged axes are periodic and roll.  The spatial
    axes are the last three."""
    out = arr
    for d in range(3):
        ax = arr.dim() - 3 + d
        c = int(cvec[d])
        if halo_axes[d]:
            n_int = arr.shape[ax] - 2 * halo
            if abs(c) + trim > halo:
                raise ValueError(f"shift {c} with {trim} ring cells reaches "
                                 f"past a ring of {halo}")
            out = out.narrow(ax, halo + c - trim, n_int + 2 * trim)
        elif c:
            out = torch.roll(out, -c, ax)
    return out


def trim_block(arr: torch.Tensor, halo_axes: Sequence[bool], trim: int,
               halo: int) -> torch.Tensor:
    """Cut a `halo`-extended field down to `trim` ring cells."""
    return shift_block(arr, (0, 0, 0), halo_axes, trim, halo)


class Window:
    """Neighbour shifts of the fields of one block.  A field covers the
    block's interior plus `ring` cells on each padded side; its ring is
    read from its shape."""

    def __init__(self, ext: Ext, shape: Sequence[int]):
        self.interior = ext.interior(shape)
        self.padded = tuple(int(p) > 0 for p in ext.pad)

    def ring(self, a: torch.Tensor) -> int:
        for d, on in enumerate(self.padded):
            if on:
                return (int(a.shape[a.dim() - 3 + d]) - self.interior[d]) // 2
        return 0

    def shift(self, a: torch.Tensor, cvec, trim: int) -> torch.Tensor:
        return shift_block(a, cvec, self.padded, trim, self.ring(a))

    def at(self, a: torch.Tensor, cvec) -> torch.Tensor:
        """The stencils' neighbour function: a at x + cvec, one ring cell
        fewer."""
        return self.shift(a, cvec, self.ring(a) - 1)

    def centre(self, a: torch.Tensor) -> torch.Tensor:
        return trim_block(a, self.padded, 0, self.ring(a))


def _streamed(win: Window, f: torch.Tensor, trim: int) -> torch.Tensor:
    """The pull-streamed populations f_i(x - c_i) with `trim` ring
    cells."""
    return torch.stack([win.shift(f[i], -C[i], trim) for i in range(Q)])


def _check_depth(ext: Ext, need: int, what: str) -> None:
    if any(0 < int(p) < need for p in ext.pad):
        raise ValueError(f"{what} reaches {need} cells; the pads "
                         f"{ext.pad} are shallower")


def density_psi_block(f: torch.Tensor, g: torch.Tensor, params: LBMParams,
                      ext: Ext) -> torch.Tensor:
    """psi of the streamed densities on the block's interior plus p - 1
    ring cells (the region ``csrc/density_psi.cu`` writes), (2, ...)."""
    win = Window(ext, f.shape)
    trim = ext.depth - 1
    return torch.stack([
        stencil_ops.pseudopotential(density(_streamed(win, a, trim)),
                                    params.use_sc_pseudo,
                                    params.sc_ref_density)
        for a in (f, g)])


def laplacian_psi_block(psi: torch.Tensor, ext: Ext) -> torch.Tensor:
    """The 19-point laplacian of both psi fields on the interior plus
    p - 2 ring cells (the region ``csrc/laplacian_psi.cu`` writes), from a
    padded (2, ...) psi valid on p - 1 ring cells."""
    _check_depth(ext, 2, "the laplacian pre-pass")
    win = Window(ext, psi.shape)
    valid = win.shift(psi, (0, 0, 0), ext.depth - 1)
    return torch.stack([stencil_ops.laplacian(p, at=win.at) for p in valid])


def step_on_block(f: torch.Tensor, g: torch.Tensor, word: int, step: int,
                  params: LBMParams, ext: Ext, noise_dist: str = "clt4",
                  ref: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K = collide∘stream of a post-collide block (19, ...) whose pads
    hold its neighbours' cells: stream -> hydrovars_bar -> hash noise
    keyed by global coordinates -> hydrovars (forces from the streamed
    densities on the sd - 1 ring) -> collide.  ref: the padded (2, ...)
    USE_REF_STATE amplitude fields, or None.  Returns the interior
    (f_out, g_out)."""
    _check_depth(ext, sd_depth(params), "this configuration's K step")
    win = Window(ext, f.shape)
    fs = _streamed(win, f, 0)
    gs = _streamed(win, g, 0)
    hbar = hydro_ops.hydrovars_bar(fs, gs, params)
    if params.alpha0 != 0.0 or params.alpha1 != 0.0:
        trim = sd_depth(params) - 1
        af, ag = hydro_ops.accelerations(
            density(_streamed(win, f, trim)),
            density(_streamed(win, g, trim)), params, at=win.at,
            centre=win.centre)
    else:   # the periodic step's accelerations are zeros here
        af = torch.zeros((3,) + tuple(hbar.rho.shape), dtype=f.dtype,
                         device=f.device)
        ag = af
    ref_state = (None if ref is None
                 else (win.centre(ref[0]), win.centre(ref[1]), None))
    xi_f, xi_g = noise_ops.thermal_noise_hash(
        word, step, hbar.rho, hbar.phi, params, ref_state, noise_dist,
        origin=ext.origin, domain=ext.domain)
    h = hydro_ops.hydrovars_with_acc(fs, gs, hbar, af, ag, xi_f, xi_g,
                                     params)
    return collide_ops.collide(fs, gs, h, xi_f, xi_g, params)


def periodic_box(t: torch.Tensor, box: Box) -> torch.Tensor:
    """A copy of t's cells in `box` of its last three axes, which are
    periodic: a box may start below 0 or end past an axis' extent, and its
    cells there wrap."""
    out = t
    for d, (a, b) in enumerate(box):
        ax = t.dim() - 3 + d
        idx = torch.arange(int(a), int(b), device=t.device) % t.shape[ax]
        out = out.index_select(ax, idx)
    return out


def tile_boxes(shape: Sequence[int], tile: Sequence[int]):
    """The output tiles of a blocked sweep over the periodic domain
    `shape`: boxes of `tile` cells from the origin, in order; the last
    tile of an axis that `tile` does not divide reaches past its extent
    (its cells there are the wrapped ones, which the sweep computes and
    does not write)."""
    ranges = [range(0, int(n), int(b)) for n, b in zip(shape, tile)]
    return [tuple((a, a + int(b)) for a, b in zip(start, tile))
            for start in ((x, y, z) for x in ranges[0] for y in ranges[1]
                          for z in ranges[2])]


def blocked_sweep_reference(f: torch.Tensor, g: torch.Tensor,
                            words: Sequence[int], step0: int,
                            params: LBMParams, T: int,
                            tile: Sequence[int], noise_dist: str = "clt4",
                            ref: Optional[torch.Tensor] = None,
                            ext: Optional[Ext] = None,
                            window: Optional[Box] = None,
                            strips: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T K steps of the post-collide pair (f, g) on the periodic domain,
    computed as the K4 kernel (``csrc/blocked_step.cu``) computes them:
    tile by tile (:func:`tile_boxes`), phase s = 0..T-1 on the tile grown
    by sd (T - 1 - s) cells (:func:`step_on_block` on a periodic
    halo-extended copy, the noise of word s at step step0 + s keyed by
    the wrapped global coordinates), each phase reading the region the
    previous one computed, and only the tile's own cells inside the
    domain written.  A cell near a seam is computed by several tiles and
    must come out the same from each.  ref: the (2, X, Y, Z)
    USE_REF_STATE amplitude fields, or None.  Every stencil depth: with a
    force (sd = 2, 3) each phase recomputes its psi (and laplacian) from
    its own streamed input on the sd - 1 ring, as the JAX kernel's
    ``_k_compute`` does inside each of its phases.

    ext: f, g (and ref) are one halo-extended block of a decomposed
    domain whose pads, at least sd T deep on its sharded axes, hold its
    neighbours' cells (the kernel's EXT launch, JAX's sharded sweep at
    block T).  The tiles then cover the block's interior; the grown
    regions read the pads on a padded axis and wrap in place on the
    others; the noise is keyed by the wrapped global coordinates; only
    interior cells are written, and the result is the interior.

    window (the overlap split's windows, with ext): a box of the block's
    arrays inside its interior; the tiles cover the window from its first
    cell and the result is the window's cells (the kernel's windowed
    launch).  strips (the strips exchange, with ext): the block's received
    y strips, (2 sides, 2 species, Q, X, rows, Z) with rows the y pads'
    depth, read in place of the y pads (:func:`mount_strips`); ref is
    still read from its own pads."""
    sd = sd_depth(params)
    if T < 1 or len(words) != T:
        raise ValueError(f"T = {T} steps need T >= 1 and T words, got "
                         f"{len(words)}")
    arrays = tuple(int(n) for n in f.shape[1:])
    if ext is None:
        if window is not None or strips is not None:
            raise ValueError("a window or y strips need ext=, a "
                             "halo-extended block")
        ext = Ext((0, 0, 0), (0, 0, 0), arrays)
    _check_depth(ext, sd * T, f"a sweep of {T} steps")
    region = ext.bounds(arrays)
    if window is not None:
        if not inside(window, region):
            raise ValueError(f"window {tuple(window)} is not a non-empty box "
                             f"inside the interior {region}")
        region = tuple((int(a), int(b)) for a, b in window)
    if strips is not None:
        f, g = mount_strips(f, strips, 0), mount_strips(g, strips, 1)
    shape = tuple(b - a for a, b in region)
    off = tuple(a for a, _ in region)
    # the global coordinates of the region's first cell
    origin = tuple(o + a - p for o, a, p in zip(ext.origin, off, ext.pad))

    def cut(box, by):
        """`box` of the region grown by `by`, in array coordinates."""
        return tuple((a + o - by, b + o + by) for (a, b), o in zip(box, off))

    fo = torch.empty(f.shape[:1] + shape, dtype=f.dtype, device=f.device)
    go = torch.empty_like(fo)
    for box in tile_boxes(shape, tile):
        halo = cut(box, sd * T)
        cf, cg = periodic_box(f, halo), periodic_box(g, halo)
        for s in range(T):
            p = sd * (T - 1 - s)
            grown = tuple((a - p, b + p) for a, b in box)
            e = Ext((sd,) * 3, tuple(o + a for o, (a, _) in
                                     zip(origin, grown)), ext.domain)
            r = None if ref is None else periodic_box(ref, cut(grown, sd))
            cf, cg = step_on_block(cf, cg, int(words[s]), int(step0) + s,
                                   params, e, noise_dist, r)
        keep = tuple((a, min(b, n)) for (a, b), n in zip(box, shape))
        inner = tuple((0, b - a) for a, b in keep)
        box_view(fo, keep).copy_(box_view(cf, inner))
        box_view(go, keep).copy_(box_view(cg, inner))
    return fo, go
