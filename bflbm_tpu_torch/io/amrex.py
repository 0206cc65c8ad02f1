"""AMReX plotfile / VisMF MultiFab reader + writer (pure numpy): the
port's copy of ``bflbm_tpu/io/amrex.py``, so that both packages read and
write the same plotfile directories.

The reference stores every frame, checkpoint and analysis artifact as
AMReX plotfiles (``WriteSingleLevelPlotfile``) and raw VisMF MultiFabs,
and its offline notebooks re-load them through ``VisMF::Read``
(``AMReX_FileIO.H:18-113``: LoadSingleMultiFab / LoadSlicedMultiFab /
LoadSetOfMultiFabs).  This module gives the port direct access to that
on-disk format, so existing reference output can be read through
``io.fields.read_frame`` without conversion — and the port's frames can
be exported for AMReX-side tooling (amrvis/yt/paraview).

Format (single level, cell-centered, as written by AMReX on x86):

``<plt>/Header`` — ASCII ``HyperCLaw-V1.1``: ncomp, variable names,
ndim, time, finest_level, prob_lo/hi, refinement ratios, per-level
problem domain boxes, level steps, cell sizes, coord-sys, bwidth, then
per level: ``<lev> <ngrids> <time>``, ``<steps>``, per-grid physical
extents, and the MultiFab path ``Level_0/Cell``.

``<plt>/Level_0/Cell_H`` — VisMF header: version, how, ncomp, ngrow,
a BoxArray (``(N 0`` + one ``((lo) (hi) (type))`` box per line + ``)``),
N ``FabOnDisk: Cell_D_xxxxx <offset>`` entries, then N x ncomp per-box
min values and max values.

``Cell_D_xxxxx`` — per FAB: one ASCII line
``FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1))) ((lo) (hi) (0,0,0)) <ncomp>``
followed by the box's doubles, Fortran order, component-major.  The
RealDescriptor is parsed, so 32-bit FABs and either byte order are
accepted on read; we write native little-endian float64.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_FAB_HEAD_RE = re.compile(
    rb"FAB \(\((\d+), \(([\d ]+)\)\),\((\d+), \(([\d ]+)\)\)\)"
    rb"\s*\(\(([-\d,]+)\) \(([-\d,]+)\) \(([-\d,]+)\)\) (\d+)")
_BOX_RE = re.compile(r"\(\(([-\d,]+)\) \(([-\d,]+)\) \(([-\d,]+)\)\)")

_NATIVE64 = "(8, (64 11 52 0 1 12 0 1023))"
_LE_ORDER = "(8, (8 7 6 5 4 3 2 1))"


def _ivec(s) -> Tuple[int, ...]:
    if isinstance(s, bytes):
        s = s.decode()
    return tuple(int(v) for v in s.split(","))


def _dtype_from_descriptor(nbytes: int, fmt: str, order: str):
    """Map a RealDescriptor to a numpy dtype (float32/float64, endian)."""
    bits = [int(v) for v in fmt.split()]
    if bits[:3] == [64, 11, 52]:
        kind = "f8"
    elif bits[:3] == [32, 8, 23]:
        kind = "f4"
    else:
        raise ValueError(f"unsupported FAB real descriptor: {fmt!r}")
    ob = [int(v) for v in order.split()]
    endian = "<" if ob[0] > ob[-1] else ">"
    return np.dtype(endian + kind)


# ---------------------------------------------------------------------------
# VisMF MultiFab
# ---------------------------------------------------------------------------

def read_multifab(prefix: str) -> Tuple[np.ndarray, dict]:
    """Read a VisMF MultiFab ``<prefix>_H`` + ``<prefix>_D_*``.

    Returns (data, meta): data has shape (ncomp, X, Y, Z) assembled over
    all boxes (ghost cells stripped); meta carries ncomp/ngrow/boxes.
    Mirrors ``VisMF::Read`` as used by LoadSingleMultiFab
    (AMReX_FileIO.H:18-34).
    """
    with open(prefix + "_H") as fh:
        txt = fh.read()
    lines = [ln for ln in txt.splitlines()]
    pos = 0
    _version = int(lines[pos]); pos += 1
    _how = int(lines[pos]); pos += 1
    ncomp = int(lines[pos]); pos += 1
    ngrow_s = lines[pos]; pos += 1
    # ngrow may be an IntVect "(1,1,1)" in newer AMReX
    ngrow = (_ivec(ngrow_s.strip("()"))[0]
             if ngrow_s.startswith("(") else int(ngrow_s))
    m = re.match(r"\((\d+) (\d+)", lines[pos]); pos += 1
    nbox = int(m.group(1))
    boxes = []
    while len(boxes) < nbox:
        mb = _BOX_RE.search(lines[pos]); pos += 1
        if mb:
            boxes.append((_ivec(mb.group(1)), _ivec(mb.group(2)),
                          _ivec(mb.group(3))))
    while lines[pos].strip() != ")":
        pos += 1
    pos += 1
    nfab = int(lines[pos]); pos += 1
    fabs = []
    for _ in range(nfab):
        name, off = lines[pos].split()[1:3]; pos += 1
        fabs.append((name, int(off)))

    lo_all = np.min([b[0] for b in boxes], axis=0)
    hi_all = np.max([b[1] for b in boxes], axis=0)
    shape = tuple(int(h - l + 1) for l, h in zip(lo_all, hi_all))
    data = np.empty((ncomp,) + shape, np.float64)
    seen = np.zeros(shape, bool)
    dirname = os.path.dirname(prefix)
    handles: Dict[str, object] = {}
    try:
        for (name, off), (lo, hi, _t) in zip(fabs, boxes):
            fh = handles.get(name)
            if fh is None:
                fh = handles[name] = open(os.path.join(dirname, name), "rb")
            fh.seek(off)
            head = fh.readline()
            mh = _FAB_HEAD_RE.match(head)
            if not mh:
                raise ValueError(f"bad FAB header in {name!r}: {head!r}")
            dt = _dtype_from_descriptor(int(mh.group(1)), mh.group(2).decode(),
                                        mh.group(4).decode())
            flo, fhi = _ivec(mh.group(5)), _ivec(mh.group(6))
            fcomp = int(mh.group(8))
            fshape = tuple(h - l + 1 for l, h in zip(flo, fhi))
            count = fcomp * int(np.prod(fshape))
            raw = np.frombuffer(fh.read(count * dt.itemsize), dt, count)
            # Fortran order, component slowest: (x,y,z,comp) F-ordered
            arr = raw.reshape(fshape + (fcomp,), order="F").astype(np.float64)
            sl = tuple(slice(l - gl, h - gl + 1)
                       for l, h, gl in zip(lo, hi, lo_all))
            # valid region of the FAB (strip ghost cells)
            vs = tuple(slice(l - fl, l - fl + (h - l + 1))
                       for l, h, fl in zip(lo, hi, flo))
            for c in range(min(fcomp, ncomp)):
                data[(c,) + sl] = arr[vs + (c,)]
            seen[sl] = True
    finally:
        for fh in handles.values():
            fh.close()
    if not seen.all():
        raise ValueError(f"BoxArray does not cover the domain ({prefix})")
    return data, {"ncomp": ncomp, "ngrow": ngrow, "boxes": boxes,
                  "lo": tuple(int(v) for v in lo_all),
                  "hi": tuple(int(v) for v in hi_all)}


def _fab_bytes(block: np.ndarray, lo, hi) -> bytes:
    head = (f"FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"
            f"(({','.join(map(str, lo))}) ({','.join(map(str, hi))}) "
            f"(0,0,0)) {block.shape[0]}\n").encode()
    # file layout: flat = x + nx*(y + ny*(z + nz*c)) — i.e. C-order of
    # the (c, z, y, x) transpose
    payload = np.ascontiguousarray(block.transpose(0, 3, 2, 1))
    return head + payload.astype("<f8").tobytes()


def _split_boxes(shape, max_grid: Optional[int]):
    """BoxArray.maxSize-style domain split (main_run_job.cpp:140-143);
    [(lo, hi)] inclusive index boxes, single box when max_grid is None."""
    cuts = [range(0, n, max_grid or n) for n in shape]
    boxes = []
    for x0 in cuts[0]:
        for y0 in cuts[1]:
            for z0 in cuts[2]:
                lo = (x0, y0, z0)
                hi = tuple(min(s0 + (max_grid or n), n) - 1
                           for s0, n in zip(lo, shape))
                boxes.append((lo, hi))
    return boxes


def write_multifab(prefix: str, data: np.ndarray,
                   max_grid: Optional[int] = None) -> None:
    """Write (ncomp, X, Y, Z) as a VisMF MultiFab (``<prefix>_H`` etc).

    max_grid: optional BoxArray.maxSize-style split of the domain
    (main_run_job.cpp:140-143) — exercises multi-FAB layouts.
    """
    data = np.asarray(data, np.float64)
    ncomp = data.shape[0]
    shape = data.shape[1:]
    boxes = _split_boxes(shape, max_grid)
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    fabs = []
    offset = 0
    dname = f"{os.path.basename(prefix)}_D_00000"
    with open(os.path.join(os.path.dirname(prefix), dname), "wb") as fh:
        for lo, hi in boxes:
            sl = tuple(slice(l, h + 1) for l, h in zip(lo, hi))
            blob = _fab_bytes(data[(slice(None),) + sl], lo, hi)
            fabs.append((dname, offset))
            fh.write(blob)
            offset += len(blob)
    mins = [[float(data[(c,) + tuple(slice(l, h + 1) for l, h in
                                     zip(lo, hi))].min())
             for c in range(ncomp)] for lo, hi in boxes]
    maxs = [[float(data[(c,) + tuple(slice(l, h + 1) for l, h in
                                     zip(lo, hi))].max())
             for c in range(ncomp)] for lo, hi in boxes]
    with open(prefix + "_H", "w") as fh:
        fh.write("1\n0\n%d\n0\n" % ncomp)
        fh.write("(%d 0\n" % len(boxes))
        for lo, hi in boxes:
            fh.write("((%s) (%s) (0,0,0))\n"
                     % (",".join(map(str, lo)), ",".join(map(str, hi))))
        fh.write(")\n%d\n" % len(fabs))
        for name, off in fabs:
            fh.write(f"FabOnDisk: {name} {off}\n")
        fh.write("\n%d,%d\n" % (len(boxes), ncomp))
        for row in mins:
            fh.write(",".join("%.17g" % v for v in row) + ",\n")
        fh.write("\n%d,%d\n" % (len(boxes), ncomp))
        for row in maxs:
            fh.write(",".join("%.17g" % v for v in row) + ",\n")


# ---------------------------------------------------------------------------
# Single-level plotfiles
# ---------------------------------------------------------------------------

def write_plotfile(plotdir: str, data: np.ndarray, names: Sequence[str],
                   time: float = 0.0, step: int = 0,
                   max_grid: Optional[int] = None) -> None:
    """``WriteSingleLevelPlotfile`` analog: Header + Level_0/Cell."""
    data = np.asarray(data, np.float64)
    assert data.shape[0] == len(names), (data.shape, len(names))
    shape = data.shape[1:]
    os.makedirs(os.path.join(plotdir, "Level_0"), exist_ok=True)
    write_multifab(os.path.join(plotdir, "Level_0", "Cell"), data, max_grid)
    hi = tuple(n - 1 for n in shape)
    with open(os.path.join(plotdir, "Header"), "w") as fh:
        fh.write("HyperCLaw-V1.1\n%d\n" % len(names))
        for n in names:
            fh.write(n + "\n")
        fh.write("3\n%.17g\n0\n" % time)
        fh.write(" ".join("0" for _ in shape) + "\n")
        fh.write(" ".join("%.17g" % n for n in shape) + "\n")
        fh.write("\n")                                   # ref ratios (none)
        fh.write("((%s) (%s) (0,0,0))\n"
                 % (",".join("0" for _ in shape), ",".join(map(str, hi))))
        fh.write("%d\n" % step)
        fh.write(" ".join("1" for _ in shape) + "\n")    # cell size
        fh.write("0\n0\n")                               # coordsys, bwidth
        # level grid list must match the Level_0/Cell BoxArray (AMReX
        # tooling reads it): one physical-extent triple per FAB box
        boxes = _split_boxes(shape, max_grid)
        fh.write("0 %d %.17g\n%d\n" % (len(boxes), time, step))
        for lo, hi_b in boxes:
            for d in range(len(shape)):
                fh.write("%.17g %.17g\n" % (float(lo[d]),
                                            float(hi_b[d] + 1)))
        fh.write("Level_0/Cell\n")


def read_plotfile(plotdir: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read a single-level plotfile dir -> ({name: (X,Y,Z)}, meta)."""
    with open(os.path.join(plotdir, "Header")) as fh:
        lines = fh.read().splitlines()
    assert lines[0].startswith("HyperCLaw"), lines[0]
    ncomp = int(lines[1])
    names = lines[2:2 + ncomp]
    pos = 2 + ncomp
    ndim = int(lines[pos]); pos += 1
    time = float(lines[pos]); pos += 1
    finest = int(lines[pos]); pos += 1
    pos += 3                                  # prob_lo, prob_hi, ref ratios
    pos += finest + 1                         # prob_domain per level
    step_line = lines[pos]; pos += 1
    # find the per-level MultiFab path (last line ending in /Cell)
    mf_rel = None
    for ln in lines[pos:]:
        if ln.strip().endswith("/Cell"):
            mf_rel = ln.strip()
            break
    if mf_rel is None:
        mf_rel = "Level_0/Cell"
    data, meta = read_multifab(os.path.join(plotdir, mf_rel))
    meta.update(time=time, step=int(step_line.split()[0]), names=names,
                ndim=ndim)
    return {n: data[i] for i, n in enumerate(names)}, meta


def is_plotfile(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "Header"))
            and os.path.exists(os.path.join(path, "Level_0", "Cell_H")))
