"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build happens at first use, into
``build/bflbm_tpu_torch/`` beside the package, and is cached by a hash of
the sources and flags.  ``-Xptxas -v`` output (registers, spills) is kept
in a ``.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..lattice import C, M_INV

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("fused_step.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_tables_set = set()   # device indices whose __constant__ tables are filled


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "bflbm_tpu_torch"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libfused_step.{source_hash()}.so"


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


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def ptxas_summary() -> List[str]:
    """The ``-Xptxas -v`` register / spill lines of the current build."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bflbm_set_tables.argtypes = [i, p, p]
    lib.bflbm_set_tables.restype = i
    lib.bflbm_fused_step.argtypes = [i, p, p, p, p, i, i, i, i, i,
                                     f, f, f, i, p, p]
    lib.bflbm_fused_step.restype = i
    lib.bflbm_error_string.argtypes = [i]
    lib.bflbm_error_string.restype = ctypes.c_char_p


def load(device) -> ctypes.CDLL:
    """The kernel library, built if needed, with the lattice tables
    (C, M_INV) filled into the device's __constant__ memory."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    idx = device.index if device.index is not None else 0
    if idx not in _tables_set:
        c = np.ascontiguousarray(C, dtype=np.int32)
        minv = np.ascontiguousarray(M_INV, dtype=np.float32)
        rc = _lib.bflbm_set_tables(idx, c.ctypes.data, minv.ctypes.data)
        if rc != 0:
            raise RuntimeError("setting the kernel tables failed: "
                               + _lib.bflbm_error_string(rc).decode())
        _tables_set.add(idx)
    return _lib
