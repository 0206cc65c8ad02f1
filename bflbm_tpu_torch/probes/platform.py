"""The platform probes of ``benchmarks/tpu_probe.py``, on the card.

- ``copy``: ``x.add_(1.0)`` on the (19, X, Y, Z) float32 array, the
  library's elementwise rate (the JAX probe's XLA ``x + 1``); no kernel of
  the port.
- ``dma``: :func:`chunk_copy`, the array through shared memory in chunks of
  19 x n cells, a persistent grid whose blocks keep S chunks a ring
  (``csrc/probe_copy.cu``, bulk (TMA) and staged), the counterpart of
  ``_pallas_roundtrip`` (``tpu_probe.py:53-92``), against its plain
  version ``f.clone()`` bitwise, at every (chunk, stages) of
  :func:`copy_configs`.
- ``transform``: :func:`moment_transform`, M_INV (M f) per cell
  (``csrc/probe_transform.cu``, unrolled FMAs and tensor cores in
  3xTF32), the counterpart of ``probe_transform.make`` (:95-176), within
  :data:`TRANSFORM_TOL` of its plain ``torch.einsum``.
- ``kernel``: a 10-step mixture ``FusedSession`` at kBT 0 (block 2) and
  kBT 1e-5 (block 1), the port's physics kernels (``probe_kernel``).

Each probe returns records (dicts) with its times on the card, or None
for every time on the CPU, where only the plain versions and the checks
run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..kernels.fused_step import _raise_on
from ..lattice import M, M_INV
from . import _lib

Q = 19
CHUNKS = (256, 512, 1024, 2048)   # cells a chunk: 19.5-155.6 KB a stage
STAGES = (1, 2, 4, 8)             # chunks a block keeps in its ring
COPY_VARIANTS = ("bulk", "staged")
TRANSFORM_VARIANTS = ("unrolled", "mma")
MAX_SMEM = 232448              # dynamic shared memory a block may hold
BYTES_PER_CELL = 2 * Q * 4     # 19 float32 read, 19 written
# Operations a cell of the unrolled transform, counted from its source: a
# +-1 coefficient of M one add or subtract, any other coefficient an FMA
# (2): 183 + 2 * 24 for M's 207 nonzeros and 2 * 207 for M_INV's.
TRANSFORM_OPS = int(sum(1 if abs(c) == 1 else 2 for c in M.ravel() if c)
                    + 2 * np.count_nonzero(M_INV))
TRANSFORM_TOL = 2e-5           # f in [0.5, 1.5): summation order, FMA
SEED = 20261018

# Kernel launches by wrapper: "copy bulk", "copy staged", "transform
# unrolled", "transform mma".
launches: Dict[str, int] = {}


def reset_launch_counts() -> None:
    launches.clear()


def _count(key: str) -> None:
    launches[key] = launches.get(key, 0) + 1


def _check_pops(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 4 or t.shape[0] != Q:
        raise ValueError(f"{name} must have shape (19, X, Y, Z), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _output(out: Optional[torch.Tensor], f: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty_like(f)
    _check_pops("out", out)
    if out.shape != f.shape or out.device != f.device:
        raise ValueError("out must have f's shape and device")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("out must not alias f")
    return out


def _populations(shape, device: torch.device, seed: int) -> torch.Tensor:
    """(19, X, Y, Z) float32 in [0.5, 1.5), drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.empty((Q,) + tuple(shape), dtype=torch.float32, device=device)
    return f.uniform_(0.5, 1.5, generator=gen)


# -- the copy ------------------------------------------------------------

def copy_reference(f: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`chunk_copy`."""
    return f.clone()


def copy_configs() -> List[Tuple[int, int]]:
    """The (chunk, stages) pairs the dma probe runs: every pair of
    :data:`CHUNKS` and :data:`STAGES` whose ring fits a block's shared
    memory."""
    return [(n, s) for n in CHUNKS for s in STAGES
            if s * Q * n * 4 <= MAX_SMEM]


def chunk_copy(f: torch.Tensor, chunk: int = CHUNKS[1],
               variant: str = "bulk",
               out: Optional[torch.Tensor] = None, *,
               stages: int = 1) -> torch.Tensor:
    """f, a (19, X, Y, Z) float32 tensor, copied into `out` (allocated when
    None) through shared memory in chunks of 19 x `chunk` cells by a
    persistent grid whose blocks each keep a ring of `stages` chunks
    (1-8): variant "bulk" by the Tensor Memory Accelerator, "staged" by
    threads with cp.async (``csrc/probe_copy.cu``).  The cell count and
    `chunk` must be multiples of 4 (16-byte rows), and the ring (stages x
    19 x chunk x 4 bytes) must fit a block's shared memory.

    CPU tensors run :func:`copy_reference`.  CUDA tensors launch the
    kernel or raise."""
    _check_pops("f", f)
    if variant not in COPY_VARIANTS:
        raise ValueError(f"unknown copy variant {variant!r}; "
                         f"one of {COPY_VARIANTS}")
    cells = f[0].numel()
    if chunk <= 0 or chunk % 4 or cells % 4:
        raise ValueError(f"the chunk ({chunk}) and the cell count ({cells}) "
                         "must be positive multiples of 4")
    if (isinstance(stages, bool) or not isinstance(stages, int)
            or not 1 <= stages <= max(STAGES)):
        raise ValueError(f"stages must be an integer in 1..{max(STAGES)}, "
                         f"got {stages!r}")
    if stages * Q * chunk * 4 > MAX_SMEM:
        raise ValueError(f"{stages} stages of {chunk} cells need "
                         f"{stages * Q * chunk * 4} B of shared memory, past "
                         f"{MAX_SMEM}")
    out = _output(out, f)
    if f.device.type == "cpu":
        return out.copy_(copy_reference(f))
    if f.device.type != "cuda":
        raise ValueError(f"no copy probe for device {f.device}")
    lib = _build.load("probe_copy", f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.bflbm_probe_copy(f.device.index, f.data_ptr(), out.data_ptr(),
                              cells, chunk, stages, int(variant == "bulk"),
                              stream)
    _raise_on(rc, lib, f"probe_copy ({variant})")
    _count(f"copy {variant}")
    return out


# -- the 19 x 19 transform -----------------------------------------------

def _tables(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if f.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain transform is float32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return (torch.as_tensor(M, dtype=torch.float32, device=f.device),
            torch.as_tensor(M_INV, dtype=torch.float32, device=f.device))


def transform_reference(f: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`moment_transform`: M_INV (M f) per cell,
    two float32 ``torch.einsum``."""
    m, minv = _tables(f)
    flat = f.reshape(Q, -1)
    mom = torch.einsum("kq,qn->kn", m, flat)
    return torch.einsum("qk,kn->qn", minv, mom).reshape(f.shape)


def transform_library(f: torch.Tensor) -> torch.Tensor:
    """The yardstick: two ``torch.matmul`` calls in float32 (TF32 off)."""
    m, minv = _tables(f)
    return torch.matmul(minv, torch.matmul(m, f.reshape(Q, -1))).reshape(
        f.shape)


def moment_transform(f: torch.Tensor, variant: str = "unrolled",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = M_INV (M f) for each cell of the (19, X, Y, Z) float32 f, into
    `out` (allocated when None): variant "unrolled" on FMAs with the
    tables as immediates, "mma" on the tensor cores in 3xTF32
    (``csrc/probe_transform.cu``).

    CPU tensors run :func:`transform_reference`.  CUDA tensors launch the
    kernel or raise."""
    _check_pops("f", f)
    if variant not in TRANSFORM_VARIANTS:
        raise ValueError(f"unknown transform variant {variant!r}; "
                         f"one of {TRANSFORM_VARIANTS}")
    out = _output(out, f)
    if f.device.type == "cpu":
        return out.copy_(transform_reference(f))
    if f.device.type != "cuda":
        raise ValueError(f"no transform probe for device {f.device}")
    lib = _build.load("probe_transform", f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.bflbm_probe_transform(f.device.index, f.data_ptr(),
                                   out.data_ptr(), f[0].numel(),
                                   int(variant == "mma"), stream)
    _raise_on(rc, lib, f"probe_transform ({variant})")
    _count(f"transform {variant}")
    return out


# -- the probes ----------------------------------------------------------

def probe_copy(device: torch.device, shape) -> List[dict]:
    """``x.add_(1.0)`` on a (19, X, Y, Z) array of ones: GB/s at 2 x its
    bytes."""
    f = torch.ones((Q,) + tuple(shape), dtype=torch.float32, device=device)
    ms = _lib.timed(device, lambda: f.add_(1.0))
    return [dict(probe="copy", name="library copy (x.add_(1.0))", key=None,
                 cells=f[0].numel(), bytes=2 * f.nbytes, ms=ms,
                 plain_ms=None, library_ms=ms, max_abs_err=None, ok=True)]


def probe_dma(device: torch.device, shape) -> List[dict]:
    """Each copy variant at each (chunk, stages) of :func:`copy_configs`
    against ``f.clone()``, bitwise; the record's ms is its fastest
    pair's."""
    f = _populations(shape, device, SEED)
    want = copy_reference(f)
    out = torch.empty_like(f)
    plain_ms = _lib.timed(device, lambda: copy_reference(f))
    library_ms = _lib.timed(device, lambda: out.copy_(f))
    records = []
    for variant in COPY_VARIANTS:
        by_config, ok, err = {}, True, 0.0
        for n, s in copy_configs():
            out.fill_(float("nan"))
            chunk_copy(f, n, variant, out=out, stages=s)
            ok = ok and torch.equal(out, want)
            err = max(err, _lib.max_abs_err(out, want))
            by_config[f"{n}x{s}"] = _lib.timed(
                device, lambda n=n, s=s: chunk_copy(f, n, variant, out=out,
                                                    stages=s))
        best = (None if device.type != "cuda"
                else min(by_config, key=by_config.get))
        records.append(dict(
            probe="dma", name=f"copy {variant}", key=f"copy {variant}",
            cells=f[0].numel(), bytes=BYTES_PER_CELL * f[0].numel(),
            ms=None if best is None else by_config[best], best=best,
            ms_by_config=by_config, plain_ms=plain_ms,
            library_ms=library_ms, max_abs_err=err, bitwise=ok, ok=ok))
    return records


def probe_transform(device: torch.device, shape) -> List[dict]:
    """Each transform variant on f in [0.5, 1.5) against the plain
    einsum, within :data:`TRANSFORM_TOL`."""
    f = _populations(shape, device, SEED + 1)
    want = transform_reference(f)
    out = torch.empty_like(f)
    plain_ms = _lib.timed(device, lambda: transform_reference(f))
    library_ms = _lib.timed(device, lambda: transform_library(f))
    records = []
    for variant in TRANSFORM_VARIANTS:
        out.fill_(float("nan"))
        moment_transform(f, variant, out=out)
        err = _lib.max_abs_err(out, want)
        ms = _lib.timed(device, lambda v=variant: moment_transform(f, v,
                                                                   out=out))
        records.append(dict(
            probe="transform", name=f"transform {variant}",
            key=f"transform {variant}", cells=f[0].numel(),
            bytes=BYTES_PER_CELL * f[0].numel(), ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, max_abs_err=err,
            ok=bool(err <= TRANSFORM_TOL)))
    return records


def probe_kernel(device: torch.device, shape) -> List[dict]:
    """Ten K steps of the uniform mixture through ``FusedSession``: kBT 0
    at block 2, kBT 1e-5 at block 1; ms a step and MLUPS."""
    from ..config import LBMParams
    from ..kernels.session import FusedSession
    from ..models import binary_fluid as model

    cells = int(np.prod(shape))
    records = []
    for kbt, block in ((0.0, 2), (1e-5, 1)):
        params = LBMParams(alpha0=0.0, kBT=kbt)
        sess = FusedSession(params, shape, block=block)
        pcs = [sess.enter(model.init_mixture(shape, params, device=device))]

        def advance():
            pcs[0] = sess.advance(pcs[0], 10)

        advance()
        ms = _lib.timed(device, advance, calls=10)
        view = sess.exit_view(pcs[0])
        ok = bool(torch.isfinite(view.f).all()
                  and torch.isfinite(view.g).all())
        records.append(dict(
            probe="kernel", name=f"FusedSession kBT={kbt:g} block {block}",
            key=None, cells=cells, ms=ms, plain_ms=None, library_ms=None,
            max_abs_err=None, mlups=None if ms is None else
            cells / ms / 1e3, ok=ok))
    return records
