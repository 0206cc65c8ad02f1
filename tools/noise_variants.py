#!/usr/bin/env python3
"""The noise probe's builds timed in turns on one card: this tree's
``csrc/probe_noise.cu`` and, with ``--parent PATH``, a parent tree's
source of the same file.  Each build's twelve cases are timed with CUDA
events (6 calls a run, best of 3, ms a call, as the probe times them),
parent, this, this, parent, and held against their plain versions
(max |delta|, bitwise).  Prints the card, one JSON line a build and
turn, then one with each build's best time a case, its worst error a
case, and its ptxas registers a case.

    PYTHONPATH=. python tools/noise_variants.py [--parent build/parent]

Only the probe's libraries are built (``_build.SOURCES`` narrowed to
them), into ``build/bflbm_tpu_torch/`` as usual.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from bflbm_tpu_torch.kernels import _build, fused_step
from bflbm_tpu_torch.probes import noise_micro as nm

SHAPE = (256, 256, 256)


def register(parent):
    """Add a library a build; returns {build: library name}."""
    names = {"this": "probe_noise_this"}
    _build.LIBRARIES[names["this"]] = ("probe_noise.cu", ())
    if parent:
        src = (Path(parent) / "bflbm_tpu_torch" / "kernels" / "csrc"
               / "probe_noise.cu").resolve()
        names["parent"] = "probe_noise_parent"
        _build.LIBRARIES[names["parent"]] = (str(src), ())
    _build.SOURCES = tuple(names.values())
    return names


def launch(lib, case, seed, out):
    bx, by = nm.tile_of(out.shape)
    X, Y, Z = out.shape
    rc = lib.bflbm_probe_noise(
        out.device.index, out.data_ptr(), X, Y, Z, bx, by, seed[0], seed[1],
        nm.CASES.index(case), fused_step._CLT4_SCALE, fused_step._CLT4_OFF,
        nm.CLT4_SCALE, nm.CLT4_OFF,
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.bflbm_error_string(rc).decode())


def time_case(lib, case, out):
    """ms a call: 6 calls (seed + k) between CUDA events, best of 3."""
    def calls():
        for k in range(nm.NCALLS):
            launch(lib, case, (nm.SEED[0] + k, nm.SEED[1] + k), out)

    calls()
    best = None
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        calls()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / nm.NCALLS
        best = ms if best is None else min(best, ms)
    return best


def registers(name):
    """{case index: registers} from the library's ptxas log."""
    log = _build.library_path(name).with_suffix(".log").read_text()
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)E", m.group(1))
            cur = int(t.group(1)) if t else None
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            out[nm.CASES[cur]] = int(m.group(1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a parent checkout whose probe_noise.cu to time")
    args = ap.parse_args(argv)
    names = register(args.parent)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    libs = {k: _build.load(n, dev) for k, n in names.items()}
    out = torch.empty(SHAPE, device=dev)
    seed = (-424242, 99)
    errs = {k: {} for k in libs}
    for case in nm.CASES:
        want = nm.run_case_reference(case, seed, SHAPE, device=dev)
        for key, lib in libs.items():
            out.fill_(float("nan"))
            launch(lib, case, seed, out)
            errs[key][case] = (float((out - want).abs().max()),
                               bool(torch.equal(out, want)))
        del want
    order = list(libs)
    if "parent" in order:
        order.remove("parent")
        order = ["parent"] + order
    times = {k: {} for k in libs}
    for turn, seq in enumerate((order, order[::-1])):
        for key in seq:
            t = {case: time_case(libs[key], case, out) for case in nm.CASES}
            for case, ms in t.items():
                times[key].setdefault(case, []).append(ms)
            print(json.dumps({"build": key, "turn": turn, "ms": t}),
                  flush=True)
    summary = {key: {"best_ms": {c: min(v) for c, v in times[key].items()},
                     "ms_by_turn": times[key],
                     "max_abs_err": {c: e[0] for c, e in errs[key].items()},
                     "bitwise": {c: e[1] for c, e in errs[key].items()},
                     "within_tol": all(e[0] <= nm.TOL
                                       for e in errs[key].values()),
                     "registers": registers(names[key])}
               for key in libs}
    print(json.dumps({"shape": SHAPE, "tol": nm.TOL, "builds": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
