"""Platform probes of the H100: the port's counterparts of the JAX
package's TPU probes under ``benchmarks/``, each a hand-written CUDA
kernel beside its plain PyTorch version.

======== ======================================== =========================
probe    what it runs                             TPU counterpart
======== ======================================== =========================
copy     ``x.add_(1.0)`` on (19, X, Y, Z)         ``tpu_probe.py`` copy
dma      bulk (TMA) and staged copies through     ``_pallas_roundtrip``
         shared memory (``csrc/probe_copy.cu``)   (``tpu_probe.py:75``)
transform M_INV (M f) on FMAs and tensor cores    ``probe_transform.make``
         (``csrc/probe_transform.cu``)            (``tpu_probe.py:162``)
kernel   a 10-step mixture ``FusedSession``       ``tpu_probe.py`` kernel
noise    twelve generator cases                   ``run_case``
         (``csrc/probe_noise.cu``)                (``tpu_noise_micro.py:294``)
launch   400 chained (8, 128) launches, eager     ``launch_micro.one``
         and from a CUDA graph                    (``tpu_overlap_r5.py:87``)
         (``csrc/probe_launch.cu``)
======== ======================================== =========================

Run them with ``python -m bflbm_tpu_torch.probes`` (the card, 256^3) or
:func:`run`.  On the CPU (``--device cpu``) the plain versions and their
checks run and every time reads "not measured".
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from . import _lib, launch, noise_micro, platform

PROBES = ("copy", "dma", "transform", "kernel", "noise", "launch")
SHAPE = (256, 256, 256)
_MODULES = (platform, noise_micro, launch)


def reset_launch_counts() -> None:
    for mod in _MODULES:
        mod.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """Kernel launches by probe kernel since the last reset."""
    out: Dict[str, int] = {}
    for mod in _MODULES:
        out.update(mod.launches)
    return out


def _fmt(v, unit="ms") -> str:
    return "not measured" if v is None else f"{v:.4f} {unit}"


def describe(rec: dict) -> str:
    """One line of a probe record: its time and rate, the plain version's
    and the library's time, the check."""
    parts = [f"{rec['name']:<34} {_fmt(rec['ms'])}"]
    if rec.get("bytes") and rec["ms"]:
        parts.append(f"{rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s")
    if rec.get("ns_per_cell") is not None:
        parts.append(f"{rec['ns_per_cell']:.4f} ns/cell")
    if rec.get("mlups") is not None:
        parts.append(f"{rec['mlups']:.1f} MLUPS")
    if rec.get("ms_by_config"):
        parts.append("by chunk x stages " + ", ".join(
            f"{n}: {_fmt(ms)}" for n, ms in rec["ms_by_config"].items()))
    if rec["probe"] == "launch":
        parts.append(f"eager {_fmt(rec['eager_ms'])}, library graph "
                     f"{_fmt(rec['library_ms'])} eager "
                     f"{_fmt(rec['library_eager_ms'])}")
    elif rec.get("library_ms") is not None or rec["probe"] != "kernel":
        parts.append(f"library {_fmt(rec.get('library_ms'))}")
    if rec.get("plain_ms") is not None or rec.get("key"):
        parts.append(f"plain {_fmt(rec.get('plain_ms'))}")
    if rec.get("max_abs_err") is not None:
        parts.append(f"max|d| {rec['max_abs_err']:.3e}")
    if rec.get("bitwise") is not None:
        parts.append(f"bitwise {rec['bitwise']}")
    parts.append("ok" if rec["ok"] else "FAILED")
    return "  ".join(parts)


def run(names: Sequence[str] = PROBES, device="cuda", shape=SHAPE,
        cases: Optional[Sequence[str]] = None,
        out: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Run the probes `names` on `device` at `shape` (noise: the `cases`,
    all by default), print a line a record through `out`, and return the
    records.  Raises if any check failed, after every probe ran."""
    device = _lib.device_of(device)
    shape = tuple(int(s) for s in shape)
    unknown = set(names) - set(PROBES)
    if unknown:
        raise ValueError(f"unknown probes {sorted(unknown)}; one of {PROBES}")
    t0 = time.perf_counter()
    records: List[dict] = []
    for name in names:
        if name == "copy":
            recs = platform.probe_copy(device, shape)
        elif name == "dma":
            recs = platform.probe_dma(device, shape)
        elif name == "transform":
            recs = platform.probe_transform(device, shape)
        elif name == "kernel":
            recs = platform.probe_kernel(device, shape)
        elif name == "noise":
            recs = noise_micro.probe_noise(device, shape, cases)
        else:
            recs = launch.probe_launch(device)
        for rec in recs:
            if out is not None:
                out(f"[{time.perf_counter() - t0:7.2f} s] {describe(rec)}")
        records += recs
    failed = [r["name"] for r in records if not r["ok"]]
    if failed:
        raise RuntimeError(f"probe checks failed: {failed}")
    return records
