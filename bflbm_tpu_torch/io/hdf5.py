"""HDF5 frame export (optional; gated on h5py): the port's copy of
``bflbm_tpu/io/hdf5.py``, writing and reading the same files.

The reference carried an HDF5 option that was compiled out
(GNUmakefile:24 `USE_HDF5 = FALSE`; HDF5RW.ipynb is its h5py scratch
pad).  Here frames export as one dataset per hydro field plus `step`
and `names` attributes — readable by any HDF5 tool chain.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def available() -> bool:
    try:
        import h5py  # noqa: F401

        return True
    except Exception:
        return False


def write_frame_h5(path: str, step: int, packed_hydro,
                   names, compression=None) -> str:
    import h5py

    arr = np.asarray(packed_hydro)
    with h5py.File(path, "w") as hf:
        hf.attrs["step"] = int(step)
        hf.attrs["names"] = list(names)
        for i, n in enumerate(names):
            hf.create_dataset(n, data=arr[i], compression=compression)
    return path


def read_frame_h5(path: str) -> Dict[str, np.ndarray]:
    import h5py

    out = {}
    with h5py.File(path, "r") as hf:
        out["step"] = int(hf.attrs["step"])
        for n in hf.attrs["names"]:
            out[str(n)] = np.asarray(hf[str(n)])
    return out
