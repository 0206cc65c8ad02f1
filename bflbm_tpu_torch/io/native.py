"""ctypes bindings to the repository's native runtime library
(``native/bflbm_native.cc``): the ``.bflbm`` multi-field container, its
background-thread snapshot writer (the AMReX VisMF async-I/O analog) and
its reader.  The port's copy of ``bflbm_tpu/io/native.py``; the two write
and read the same files.

The library is compiled at first use with ``g++`` and the flags of
``native/Makefile`` into ``build/bflbm_tpu_torch/native/
libbflbm_native.<hash>.so``, keyed by the source and the flags, under a
file lock, through a temporary file renamed into place
(:mod:`bflbm_tpu_torch.kernels._build`).  It never builds into
``native/``.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..kernels import _build

_SOURCE = (Path(__file__).resolve().parents[2] / "native"
           / "bflbm_native.cc")
# native/Makefile's CXXFLAGS and link flag
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return (_build.build_dir() / "native"
            / f"libbflbm_native.{_build.digest(CXXFLAGS, [_SOURCE])}.so")


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def available() -> bool:
    """The library is built, or a C++ compiler is there to build it."""
    return (_lib is not None or library_path().exists()
            or _compiler() is not None)


def build() -> Path:
    """Compile the library unless this source's build exists; raises
    RuntimeError with the compiler's output when it fails."""
    so = library_path()
    with _build.locked(so):
        if so.exists():
            return so
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++, or $CXX) to build the "
                               "native library")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native library failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The library, built if needed, with its functions declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.bflbm_writer_create.restype = ctypes.c_void_p
    lib.bflbm_writer_create.argtypes = [ctypes.c_int]
    lib.bflbm_writer_submit.restype = ctypes.c_int
    lib.bflbm_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32, ctypes.c_uint32]
    lib.bflbm_writer_flush.restype = None
    lib.bflbm_writer_flush.argtypes = [ctypes.c_void_p]
    lib.bflbm_writer_errors.restype = ctypes.c_int
    lib.bflbm_writer_errors.argtypes = [ctypes.c_void_p]
    lib.bflbm_writer_destroy.restype = None
    lib.bflbm_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.bflbm_write.restype = ctypes.c_int
    lib.bflbm_write.argtypes = lib.bflbm_writer_submit.argtypes[1:]
    lib.bflbm_read_header.restype = ctypes.c_int
    lib.bflbm_read_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
    lib.bflbm_read_field.restype = ctypes.c_int
    lib.bflbm_read_field.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint32]
    _lib = lib
    return lib


def _prep(names: Sequence[str], arrays: Sequence[np.ndarray]):
    """Contiguous host arrays of one shape and item size, their pointers,
    the newline-joined names and the shape."""
    arrs = [np.ascontiguousarray(a) for a in arrays]
    itemsize = arrs[0].dtype.itemsize
    if any(a.dtype.itemsize != itemsize or a.shape != arrs[0].shape
           for a in arrs):
        raise ValueError("fields must share one shape and item size")
    if len(names) != len(arrs):
        raise ValueError(f"{len(names)} names for {len(arrs)} fields")
    shape = np.asarray(arrs[0].shape, dtype=np.uint64)
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
    names_b = "\n".join(names).encode()
    return arrs, ptrs, names_b, shape, itemsize


class AsyncFieldWriter:
    """Background-thread snapshot writer: submit() copies the fields and
    returns; flush() waits for every submitted file."""

    def __init__(self, nthreads: int = 2):
        self._lib = load()
        self._h = self._lib.bflbm_writer_create(nthreads)

    def submit(self, path: str, names: Sequence[str],
               arrays: Sequence[np.ndarray]) -> None:
        arrs, ptrs, names_b, shape, itemsize = _prep(names, arrays)
        rc = self._lib.bflbm_writer_submit(
            self._h, path.encode(), names_b, ptrs, len(arrs),
            shape.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(shape), itemsize)
        if rc != 0:
            raise IOError(f"submit failed rc={rc}")

    def flush(self) -> None:
        self._lib.bflbm_writer_flush(self._h)
        errs = self._lib.bflbm_writer_errors(self._h)
        if errs:
            raise IOError(f"{errs} async writes failed")

    def close(self) -> None:
        if self._h:
            try:
                self.flush()
            finally:
                self._lib.bflbm_writer_destroy(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_fields(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write same-shaped host arrays to one ``.bflbm`` file, by name."""
    lib = load()
    names = list(fields)
    arrs, ptrs, names_b, shape, itemsize = _prep(names,
                                                 [fields[n] for n in names])
    rc = lib.bflbm_write(
        path.encode(), names_b, ptrs, len(arrs),
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(shape), itemsize)
    if rc != 0:
        raise IOError(f"write failed rc={rc}")


def read_fields(path: str, names: Optional[Sequence[str]] = None
                ) -> Dict[str, np.ndarray]:
    """The fields of a ``.bflbm`` file, by name (float32 or float64); with
    `names`, only those, read in file order until all are found."""
    lib = load()
    nf = ctypes.c_uint32()
    ndim = ctypes.c_uint32()
    shape = (ctypes.c_uint64 * 8)()
    rc = lib.bflbm_read_header(path.encode(), ctypes.byref(nf),
                               ctypes.byref(ndim), shape)
    if rc != 0:
        raise IOError(f"bad header rc={rc}")
    dims = tuple(shape[i] for i in range(ndim.value))
    cells = int(np.prod(dims))
    want = None if names is None else set(names)
    out: Dict[str, np.ndarray] = {}
    for i in range(nf.value):
        if want is not None and want <= set(out):
            break
        buf = np.empty(cells, dtype=np.float64)  # max itemsize
        name = ctypes.create_string_buffer(256)
        dt = lib.bflbm_read_field(path.encode(), i,
                                  buf.ctypes.data_as(ctypes.c_void_p),
                                  buf.nbytes, name, 256)
        if dt < 0:
            raise IOError(f"read field {i} failed rc={dt}")
        key = name.value.decode()
        if want is not None and key not in want:
            continue
        dtype = np.float32 if dt == 4 else np.float64
        arr = buf.view(np.uint8)[: cells * dt].view(dtype).reshape(dims)
        out[key] = arr.copy()
    return out
