"""Build and load the port's CUDA kernels.

``nvcc`` compiles each library of :data:`LIBRARIES` — a ``csrc/*.cu``
source and its ``-D`` flags — into its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  ``fused_step.cu`` and ``blocked_step.cu`` (K4, T steps a
launch) are built six times each, once per relaxation
(``BFLBM_GENERAL_RELAX``) and force (``BFLBM_FORCE``, and with it
``BFLBM_A1``, the alpha1 square-gradient force), so that their parts
compile in parallel.  The builds happen at first use, all libraries at
once in parallel, into ``build/bflbm_tpu_torch/`` beside the package,
and are cached by a hash of the source, the shared headers and the
flags (:func:`digest`); a file lock (:func:`locked`) keeps processes that
share the directory from building the same library twice, and every
library is written to a temporary file and renamed into place.
``-Xptxas -v`` output (registers, spills) is kept in a ``.log`` beside
each library.

Every library exports ``bflbm_error_string``; those with ``__constant__``
lattice tables (the K, K4 and density libraries) also export
``bflbm_set_tables(device, c, m, minv, gw)``, which fills them.  The
laplacian library and the probes read the tables as immediates
(``csrc/lattice_tables.cuh``).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..lattice import C, CS2, M, M_INV, W

_CSRC = Path(__file__).resolve().parent / "csrc"
# library name -> (source in csrc/, extra nvcc flags)
LIBRARIES = {
    "fused_step": ("fused_step.cu", ("-DBFLBM_GENERAL_RELAX=0",
                                     "-DBFLBM_FORCE=0")),
    "fused_step_force": ("fused_step.cu", ("-DBFLBM_GENERAL_RELAX=0",
                                           "-DBFLBM_FORCE=1")),
    "fused_step_general": ("fused_step.cu", ("-DBFLBM_GENERAL_RELAX=1",
                                             "-DBFLBM_FORCE=0")),
    "fused_step_general_force": ("fused_step.cu", ("-DBFLBM_GENERAL_RELAX=1",
                                                   "-DBFLBM_FORCE=1")),
    "fused_step_force_a1": ("fused_step.cu", ("-DBFLBM_GENERAL_RELAX=0",
                                              "-DBFLBM_FORCE=1",
                                              "-DBFLBM_A1=1")),
    "fused_step_general_force_a1": ("fused_step.cu",
                                    ("-DBFLBM_GENERAL_RELAX=1",
                                     "-DBFLBM_FORCE=1", "-DBFLBM_A1=1")),
    "density_psi": ("density_psi.cu", ()),
    "laplacian_psi": ("laplacian_psi.cu", ()),
    "blocked_step": ("blocked_step.cu", ("-DBFLBM_GENERAL_RELAX=0",)),
    "blocked_step_general": ("blocked_step.cu", ("-DBFLBM_GENERAL_RELAX=1",)),
    "blocked_step_force": ("blocked_step.cu", ("-DBFLBM_GENERAL_RELAX=0",
                                               "-DBFLBM_FORCE=1")),
    "blocked_step_general_force": ("blocked_step.cu",
                                   ("-DBFLBM_GENERAL_RELAX=1",
                                    "-DBFLBM_FORCE=1")),
    "blocked_step_force_a1": ("blocked_step.cu", ("-DBFLBM_GENERAL_RELAX=0",
                                                  "-DBFLBM_FORCE=1",
                                                  "-DBFLBM_A1=1")),
    "blocked_step_general_force_a1": ("blocked_step.cu",
                                      ("-DBFLBM_GENERAL_RELAX=1",
                                       "-DBFLBM_FORCE=1", "-DBFLBM_A1=1")),
    "probe_copy": ("probe_copy.cu", ()),
    "probe_transform": ("probe_transform.cu", ()),
    "probe_noise": ("probe_noise.cu", ()),
    "probe_launch": ("probe_launch.cu", ()),
}
SOURCES = tuple(LIBRARIES)
_HEADERS = ("common.cuh", "k_cell.cuh", "lattice_tables.cuh",
            "stencil_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # wall seconds of the last nvcc runs
_tables_set = set()   # (name, device index) whose tables are filled (or none)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "bflbm_tpu_torch"


def digest(flags, files) -> str:
    """16 hex digits of a hash of the compiler flags and the files' names
    and contents: the key of a build."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def source_hash(name: str) -> str:
    src, defines = LIBRARIES[name]
    return digest(NVCC_FLAGS + defines,
                  [_CSRC / part for part in (src,) + _HEADERS])


@contextlib.contextmanager
def locked(path: Path):
    """Hold an exclusive lock on ``<path>.lock`` for the block, so that
    processes sharing a build directory build `path` once."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_name(path.name + ".lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.{source_hash(name)}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> Dict[str, Path]:
    """Compile every kernel library whose sources changed, one ``nvcc``
    per library, all started together."""
    with locked(build_dir() / "nvcc"):
        return _build_unlocked()


def _build_unlocked() -> Dict[str, Path]:
    todo = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        so = library_path(name)
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            src, defines = LIBRARIES[name]
            cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
                   str(_CSRC / src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            todo[name] = (so, tmp, cmd, proc)
    failed = []
    for name, (so, tmp, cmd, proc) in todo.items():
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {name}:\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in SOURCES}


def _function_name(mangled: str) -> str:
    """The unqualified name of an Itanium-mangled function: the last of
    the length-prefixed names after ``_Z`` / ``_ZN`` (the anonymous
    namespace's own name carries digits, so no pattern can find it)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if m is None:
            return name
        pos += len(m.group(0))
        name = mangled[pos:pos + int(m.group(0))]
        pos += int(m.group(0))


def ptxas_summary() -> List[str]:
    """One line per kernel instantiation of the current builds: its
    template arguments (k_step_kernel<NOISE, DIST, FORCE, GENERAL, REF,
    A1, EXT>, a1_tile_kernel<NOISE, DIST, GENERAL, REF, EXT> of the A1
    builds, blocked_kernel<NOISE, DIST, GENERAL, REF, EXT, STRIPS> of the
    library's force and relaxation) with the
    ``-Xptxas -v`` registers and spills."""
    out = []
    for name in SOURCES:
        log = library_path(name).with_suffix(".log")
        if not log.exists():
            continue
        entry, spill = None, ""
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                mangled = m.group(1)
                args = re.findall(r"L[bi](\d+)E", mangled)
                entry = f"{_function_name(mangled)}<{','.join(args)}>"
            elif "spill" in ln:
                spill = ln.strip()
            elif "registers" in ln and entry is not None:
                regs = re.search(r"Used (\d+) registers", ln)
                out.append(f"{name} {entry}: "
                           f"{regs.group(1) if regs else ln.strip()} "
                           f"registers, {spill}")
                entry = None
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    if hasattr(lib, "bflbm_set_tables"):
        lib.bflbm_set_tables.argtypes = [i, p, p, p, p]
        lib.bflbm_set_tables.restype = i
    lib.bflbm_error_string.argtypes = [i]
    lib.bflbm_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "bflbm_fused_step"):
        lib.bflbm_fused_step.argtypes = [i, p, p, p, p, p, p, p, p, i, i,
                                         f, f, f, f, f, i, i, p, f, f, f,
                                         f, p, p, i, p, p]
        lib.bflbm_fused_step.restype = i
    if hasattr(lib, "bflbm_bm_normals"):
        lib.bflbm_bm_normals.argtypes = [i, p, p, i, i, p]
        lib.bflbm_bm_normals.restype = i
    if hasattr(lib, "bflbm_a1_smem"):
        lib.bflbm_a1_smem.argtypes = [i, i, i]
        lib.bflbm_a1_smem.restype = ll
    if hasattr(lib, "bflbm_density_psi"):
        lib.bflbm_density_psi.argtypes = [i, p, p, p, p, i, f, p, i, p]
        lib.bflbm_density_psi.restype = i
    if hasattr(lib, "bflbm_blocked_step"):
        lib.bflbm_blocked_step.argtypes = [i, p, p, p, p, p, p, p, i, i, p,
                                           p, f, f, f, f, f, i, i, p, f, f,
                                           f, f, i, f, i, p, p, i, p]
        lib.bflbm_blocked_step.restype = i
        lib.bflbm_blocked_smem.argtypes = [i, i, i, i]
        lib.bflbm_blocked_smem.restype = ctypes.c_longlong
    if hasattr(lib, "bflbm_laplacian_psi"):
        lib.bflbm_laplacian_psi.argtypes = [i, p, p, p, p, p]
        lib.bflbm_laplacian_psi.restype = i
        lib.bflbm_laplacian_smem.argtypes = [i, i]
        lib.bflbm_laplacian_smem.restype = ll
    if hasattr(lib, "bflbm_probe_copy"):
        lib.bflbm_probe_copy.argtypes = [i, p, p, ll, i, i, i, p]
        lib.bflbm_probe_copy.restype = i
    if hasattr(lib, "bflbm_probe_transform"):
        lib.bflbm_probe_transform.argtypes = [i, p, p, ll, i, p]
        lib.bflbm_probe_transform.restype = i
    if hasattr(lib, "bflbm_probe_noise"):
        lib.bflbm_probe_noise.argtypes = [i, p, i, i, i, i, i, i, i, i, f,
                                          f, f, f, p]
        lib.bflbm_probe_noise.restype = i
    if hasattr(lib, "bflbm_probe_add_one"):
        lib.bflbm_probe_add_one.argtypes = [i, p, p, i, p]
        lib.bflbm_probe_add_one.restype = i


def load(name: str, device) -> ctypes.CDLL:
    """Kernel library `name`, built if needed (with all the others), with
    the lattice tables (C, M, M_INV, w / cs^2) filled into the device's
    __constant__ memory where the library has them."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel library {name!r}")
    if name not in _libs:
        paths = build()
        for n, so in paths.items():
            if n not in _libs:
                lib = ctypes.CDLL(str(so))
                _declare(lib)
                _libs[n] = lib
    lib = _libs[name]
    idx = device.index if device.index is not None else 0
    if (name, idx) not in _tables_set:
        if hasattr(lib, "bflbm_set_tables"):
            c = np.ascontiguousarray(C, dtype=np.int32)
            m = np.ascontiguousarray(M, dtype=np.float32)
            minv = np.ascontiguousarray(M_INV, dtype=np.float32)
            gw = np.ascontiguousarray(W / CS2, dtype=np.float32)
            rc = lib.bflbm_set_tables(idx, c.ctypes.data, m.ctypes.data,
                                      minv.ctypes.data, gw.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"setting the {name} kernel tables "
                                   "failed: "
                                   + lib.bflbm_error_string(rc).decode())
        _tables_set.add((name, idx))
    return lib
