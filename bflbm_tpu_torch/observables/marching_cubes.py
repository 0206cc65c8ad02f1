"""Marching cubes and the reference's vertex-weighted spherical-harmonic
surface projection (``bflbm_tpu/observables/marching_cubes.py``).

The reference's shape-fluctuation pipeline (``Droplet_Fluctuation.ipynb``
cells 32-39) extracts the rho isosurface with
``skimage.measure.marching_cubes`` at level = (min+max)/2, shifts the
vertices by the centre of mass, gives every vertex a solid-angle weight
(each triangle's radially projected solid angle split over its three
corners) and projects the vertex radii onto Y_lm with a weighted-ratio
estimator.

The triangle table is generated on the host at first use, as in the JAX
package: for each of the 256 corner-sign cases the inside corners are
split into edge-connected components, and the convex hull of each
component's corners and crossing-edge midpoints (``scipy.spatial.
ConvexHull``) gives the facets made of crossing points only, oriented
inside -> outside.  The classification of the cubes, the edge crossings
and the emission of the faces run in torch on the field's device (a
numpy field on the CPU), in float64; vertices and faces come out in the
JAX package's order (crossings row-major by axis, faces by case
ascending, then triangle of the case, then cube row-major).  The
harmonic projection (``scipy.special.sph_harm_y``) is numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ._fields import as_field, host

# corner c at ((c>>0)&1, (c>>1)&1, (c>>2)&1); 12 edges (lower corner,
# axis) with the lower corner having bit `axis` clear
_CORNER_XYZ = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], dtype=np.int64)
_EDGES = [(c, a) for c in range(8) for a in range(3)
          if not (c >> a) & 1]                      # 12 (corner, axis)
_EDGE_ENDS = [(c, c | (1 << a)) for c, a in _EDGES]


def _components(inside):
    """Edge-connected components of a set of cube corners."""
    left, comps = set(inside), []
    while left:
        stack, comp = [left.pop()], set()
        while stack:
            c = stack.pop()
            comp.add(c)
            for a in range(3):
                nb = c ^ (1 << a)
                if nb in left:
                    left.discard(nb)
                    stack.append(nb)
        comps.append(sorted(comp))
    return comps


def _gen_tri_table():
    """256-entry triangle table, each entry a list of (e0, e1, e2)
    local-edge-index triples oriented with the normal pointing from
    inside (field > level) to outside."""
    from scipy.spatial import ConvexHull

    mids = {i: (_CORNER_XYZ[c0] + _CORNER_XYZ[c1]) / 2.0
            for i, (c0, c1) in enumerate(_EDGE_ENDS)}
    table = []
    for case in range(256):
        inside = [c for c in range(8) if (case >> c) & 1]
        tris = []
        for comp in _components(inside):
            cset = set(comp)
            cross = [i for i, (c0, c1) in enumerate(_EDGE_ENDS)
                     if (c0 in cset) != (c1 in cset)]
            if not cross:
                continue  # comp fills the whole cube
            pts = np.concatenate(
                [_CORNER_XYZ[comp].astype(float),
                 np.array([mids[i] for i in cross])])
            hull = ConvexHull(pts)
            nc = len(comp)
            for s, eq in zip(hull.simplices, hull.equations):
                if not all(v >= nc for v in s):
                    continue  # facet touches an inside corner
                tri = [cross[v - nc] for v in s]
                # orient with qhull's outward (inside -> outside) normal
                p = pts[s]
                n = np.cross(p[1] - p[0], p[2] - p[0])
                if np.dot(n, eq[:3]) < 0:
                    tri = [tri[0], tri[2], tri[1]]
                tris.append(tuple(tri))
        table.append(tris)
    return table


_TRI_TABLE = None


def _tri_table():
    global _TRI_TABLE
    if _TRI_TABLE is None:
        _TRI_TABLE = _gen_tri_table()
    return _TRI_TABLE


def _padded_table(device):
    """(256, T, 3) local edges of each case's triangles (-1 past its
    count) and (256,) triangle counts, on `device`."""
    table = _tri_table()
    depth = max(len(t) for t in table)
    pad = np.full((256, depth, 3), -1, dtype=np.int64)
    for c, tris in enumerate(table):
        if tris:
            pad[c, :len(tris)] = tris
    counts = np.array([len(t) for t in table], dtype=np.int64)
    return (torch.as_tensor(pad, device=device),
            torch.as_tensor(counts, device=device))


def _marching_cubes(f: torch.Tensor, level: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`marching_cubes` on a float64 tensor, tensors out."""
    dev = f.device
    inside = f > level
    nx, ny, nz = f.shape
    # cube case index from the 8 corner bits
    case = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.int64,
                       device=dev)
    for c in range(8):
        dx, dy, dz = (int(v) for v in _CORNER_XYZ[c])
        case |= inside[dx:nx - 1 + dx, dy:ny - 1 + dy,
                       dz:nz - 1 + dz].to(torch.int64) << c

    # one vertex per crossing grid edge, numbered row-major axis by axis;
    # ids[a] holds the number (or -1) of each edge along axis a
    ids, verts, nvert = [], [], 0
    for a in range(3):
        lo = tuple(slice(0, -1) if ax == a else slice(None) for ax in range(3))
        hi = tuple(slice(1, None) if ax == a else slice(None)
                   for ax in range(3))
        crossing = inside[lo] != inside[hi]
        flat = crossing.reshape(-1)
        num = torch.cumsum(flat.to(torch.int64), 0) - 1 + nvert
        ids.append(torch.where(flat, num, torch.full_like(num, -1)))
        base = torch.nonzero(crossing).to(torch.float64)
        f0, f1 = f[lo][crossing], f[hi][crossing]
        base[:, a] += torch.clamp((level - f0) / (f1 - f0), 0.0, 1.0)
        verts.append(base)
        nvert += base.shape[0]
    verts = torch.cat(verts)

    # the faces: cubes whose case has triangles, grouped by case
    # ascending (row-major within a case), each group emitting its
    # case's first triangle for every cube, then its second, ...
    pad, counts = _padded_table(dev)
    flat_case = case.reshape(-1)
    cube = torch.nonzero(counts[flat_case] > 0)[:, 0]
    cval, order = torch.sort(flat_case[cube], stable=True)
    cube = cube[order]
    ncase = torch.bincount(cval, minlength=256)          # cubes per case
    start = torch.cumsum(ncase, 0) - ncase               # first cube
    nface = ncase * counts
    fstart = torch.cumsum(nface, 0) - nface              # first face
    total = int(nface.sum())
    faces = torch.empty((total, 3), dtype=torch.int64, device=dev)
    if total:
        rank = torch.arange(cube.numel(), device=dev) - start[cval]
        t = torch.arange(pad.shape[1], device=dev)
        live = t[None, :] < counts[cval][:, None]         # (ncube, T)
        row = fstart[cval][:, None] + t[None, :] * ncase[cval][:, None] \
            + rank[:, None]
        cx = cube // ((ny - 1) * (nz - 1))
        cy = cube // (nz - 1) % (ny - 1)
        cz = cube % (nz - 1)
        edge_axis = torch.as_tensor([a for _, a in _EDGES], device=dev)
        edge_off = torch.as_tensor(_CORNER_XYZ[[c for c, _ in _EDGES]],
                                   device=dev)
        col = []
        for k in range(3):
            e = pad[cval][:, :, k].clamp(min=0)           # (ncube, T)
            ax, off = edge_axis[e], edge_off[e]
            x, y, z = cx[:, None] + off[..., 0], cy[:, None] + off[..., 1], \
                cz[:, None] + off[..., 2]
            v = torch.full_like(e, -1)
            for a in range(3):
                # the edge grid along axis a: (n - 1) cells on a
                sy = ny - 1 if a == 1 else ny
                sz = nz - 1 if a == 2 else nz
                sel = ax == a
                lin = (x * sy + y) * sz + z
                v = torch.where(sel, ids[a][torch.where(sel, lin, 0)], v)
            col.append(v)
        face = torch.stack(col, dim=-1)                   # (ncube, T, 3)
        faces[row[live]] = face[live]

    # drop unreferenced crossing vertices (array-boundary edges that
    # belong to no complete cube)
    used = torch.zeros(nvert, dtype=torch.bool, device=dev)
    used[faces.reshape(-1)] = True
    remap = torch.cumsum(used.to(torch.int64), 0) - 1
    return verts[used], remap[faces]


def marching_cubes(field, level: float) -> Tuple[np.ndarray, np.ndarray]:
    """(verts, faces) of the `field == level` isosurface.

    Vertices in array-index coordinates on grid-edge crossings (linear
    interpolation), shared between incident triangles; faces oriented
    with normals pointing toward lower field values (out of the
    droplet).  Non-periodic, like the reference's skimage call — the
    surface must not touch the array boundary."""
    verts, faces = _marching_cubes(as_field(field), level)
    return host(verts), host(faces)


def _boundary_edges(faces: torch.Tensor) -> int:
    e = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    lo, hi = e.min(dim=1).values, e.max(dim=1).values
    key = lo * (int(faces.max()) + 1 if faces.numel() else 1) + hi
    _, counts = torch.unique(key, return_counts=True)
    return int((counts != 2).sum())


def boundary_edge_count(faces) -> int:
    """Number of triangle edges not shared by exactly two faces — 0 for
    a watertight surface; counts the pinholes left by ambiguous-face
    resolution mismatches."""
    return _boundary_edges(torch.as_tensor(np.asarray(faces))
                           if not isinstance(faces, torch.Tensor) else faces)


def _corners(verts: torch.Tensor, faces: torch.Tensor):
    return tuple(verts[faces[:, i]] for i in range(3))


def _surface_area(verts: torch.Tensor, faces: torch.Tensor) -> float:
    v0, v1, v2 = _corners(verts, faces)
    cross = torch.linalg.cross(v1 - v0, v2 - v0, dim=1)
    return float(0.5 * torch.linalg.norm(cross, dim=1).sum())


def surface_area(verts, faces) -> float:
    """Total triangle area (the reference's S_fluctuating,
    Droplet_Fluctuation.ipynb cell 41)."""
    return _surface_area(as_field(verts), _index(faces))


def _index(faces) -> torch.Tensor:
    if isinstance(faces, torch.Tensor):
        return faces.to(torch.int64)
    return torch.as_tensor(np.asarray(faces, dtype=np.int64))


def _solid_angle_weights(verts: torch.Tensor, faces: torch.Tensor
                         ) -> torch.Tensor:
    v0, v1, v2 = _corners(verts, faces)
    cross = torch.linalg.cross(v1 - v0, v2 - v0, dim=1)
    area = 0.5 * torch.linalg.norm(cross, dim=1)
    centroid = (v0 + v1 + v2) / 3.0
    r0 = torch.linalg.norm(centroid, dim=1) + 1e-15
    cos_nr = torch.abs((cross * centroid).sum(dim=1)) \
        / (2.0 * area * r0 + 1e-30)
    omega = area * cos_nr / r0 ** 2
    w = torch.zeros(verts.shape[0], dtype=torch.float64, device=verts.device)
    w.index_add_(0, faces.reshape(-1), (omega / 3.0).repeat_interleave(3))
    return w


def vertex_solid_angle_weights(verts, faces) -> np.ndarray:
    """Per-vertex solid-angle weights of the reference's projection
    (cell 32): each face contributes its radially projected solid angle
    area * |cos(n, r)| / r^2 at the centroid, split equally over its
    three vertices.  `verts` must already be COM-centred.  Sums to
    ~4 pi for a star-shaped surface around the origin."""
    verts = as_field(verts)
    return host(_solid_angle_weights(verts, _index(faces).to(verts.device)))


def harmonic_amplitudes(verts: np.ndarray, w: np.ndarray, lmax: int = 2
                        ) -> Dict[Tuple[int, int], complex]:
    """zeta_lm of the vertex radii by the reference's weighted-ratio
    estimator (cell 32),

        zeta_lm = sum(r * conj(Y_lm) * w) / sum(|Y_lm|^2 * w),

    over COM-centred vertices with solid-angle weights `w` (radius in
    length units; zeta_00 = R sqrt(4 pi)), numpy on the host."""
    from scipy.special import sph_harm_y

    verts, w = np.asarray(verts), np.asarray(w)
    r = np.linalg.norm(verts, axis=1)
    theta = np.arccos(np.clip(verts[:, 2] / (r + 1e-15), -1.0, 1.0))
    phi = np.arctan2(verts[:, 1], verts[:, 0])
    out = {}
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, m, theta, phi)
            num = np.sum(r * np.conj(ylm) * w)
            den = np.sum(np.abs(ylm) ** 2 * w)
            out[(l, m)] = complex(num / (den + 1e-30))
    return out


def mc_surface_amplitudes(rho, com, level: float = None, lmax: int = 2):
    """The reference pipeline on one density frame: marching cubes at
    `level` (default (min+max)/2, cell 32) -> COM shift -> solid-angle
    weights -> zeta_lm.  Returns (amps, diag), diag with n_verts /
    n_faces / area / boundary_edges / sum_w."""
    rho = as_field(rho)
    if level is None:
        level = 0.5 * (float(rho.min()) + float(rho.max()))
    verts, faces = _marching_cubes(rho, level)
    sv = verts - torch.as_tensor(np.asarray(com, dtype=float),
                                 device=verts.device)
    w = _solid_angle_weights(sv, faces)
    amps = harmonic_amplitudes(host(sv), host(w), lmax)
    diag = {"n_verts": int(verts.shape[0]), "n_faces": int(faces.shape[0]),
            "area": _surface_area(verts, faces),
            "boundary_edges": _boundary_edges(faces),
            "sum_w": float(w.sum())}
    return amps, diag
