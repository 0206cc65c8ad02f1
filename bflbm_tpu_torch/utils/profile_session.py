"""Where the time of the fused session goes on one CUDA device.

    python -m bflbm_tpu_torch.utils.profile_session [--n 256] [--chunk 100]

For the mixture path (a uniform mixture, tau = 1/2, alpha = 0, u8) at
kBT = 1e-5 and at kBT = 0, and for the coupled path (the droplet-fluct
physics: droplet-eq with kBT = 1e-5, alpha0 = 1.5, clt4) it prints:

- ``enter``: the first call of the process (lazy CUDA initialisation
  included) and a warmed call; ``exit_view``;
- ``advance(chunk)``: the best of `repeats` runs between synchronize
  barriers (:func:`time_steps`) and its MLUPS;
- host enqueue per launch: the host time of one ``advance(chunk)``
  without a barrier, divided by its launches (one per step, two when
  coupled), outside the profiler and inside it (the profiler adds host
  work to every launch);
- from ``torch.profiler`` over one ``advance(chunk)``: the device time
  and count of each kernel, and the device's idle share of the traced
  advance's wall time (1 - union of kernel intervals / wall).

The first line names the card and its power limit (``nvidia-smi``); the
last line is one JSON object with every number.  Exits 1, printing no
result, without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _kernel_intervals(prof):
    """[(name, start_us, end_us)] of the device kernels in a trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _union_us(intervals) -> float:
    busy, end = 0.0, None
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


CASES = (("mixture", 1e-5), ("mixture", 0.0), ("droplet", 1e-5))


def profile_config(case: str, kBT: float, n: int, chunk: int, repeats: int,
                   device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import preset
    from ..kernels import fused_step
    from ..kernels.session import make_session
    from ..models import binary_fluid as model
    from .timing import time_steps

    shape = (n, n, n)
    cells = n ** 3
    name, dist = {"mixture": ("bench-256", "u8"),
                  "droplet": ("droplet-eq", "clt4")}[case]
    cfg = preset(name).replace(shape=shape).with_params(kBT=kBT)
    params = cfg.params
    state = model.make_initial_state(cfg, device=device)
    sess = make_session(params, shape, noise_dist=dist)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    pc = sess.enter(state)
    torch.cuda.synchronize(device)
    enter_first_ms = (time.perf_counter() - t0) * 1e3
    enter_ms = time_steps(lambda: sess.enter(state), cells, 1,
                          device=device)["best_s"] * 1e3
    del state

    box = [pc]

    def run():
        box[0] = sess.advance(box[0], chunk)

    adv = time_steps(run, cells, chunk, warmup=1, repeats=repeats,
                     device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run()
    n_launch = chunk * (2 if fused_step.is_coupled(params) else 1)
    enqueue_us = (time.perf_counter() - t0) / n_launch * 1e6
    torch.cuda.synchronize(device)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        enqueue_prof_us = (time.perf_counter() - t0) / n_launch * 1e6
        torch.cuda.synchronize(device)
        traced_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _kernel_intervals(prof)
    by_name = {}
    for name, a, b in kernels:
        cnt, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (cnt + 1, tot + (b - a))
    busy_us = _union_us(kernels)
    exit_ms = time_steps(lambda: sess.exit_view(box[0]), cells, 1,
                         device=device)["best_s"] * 1e3
    del box, pc
    torch.cuda.empty_cache()
    return {
        "case": case, "noise_dist": dist, "kBT": kBT,
        "alpha0": params.alpha0, "shape": list(shape), "chunk": chunk,
        "enter_first_ms": enter_first_ms, "enter_ms": enter_ms,
        "exit_view_ms": exit_ms,
        "advance_ms": adv["best_s"] * 1e3,
        "advance_ms_all": [t * 1e3 for t in adv["times_s"]],
        "mlups": adv["mlups"],
        "enqueue_us_per_launch": enqueue_us,
        "enqueue_us_per_launch_profiled": enqueue_prof_us,
        "traced_wall_ms": traced_wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if kernels else None,
        "idle_share": 1.0 - busy_us / traced_wall_us if kernels else None,
        "kernels": {k: {"count": c, "device_ms": t / 1e3}
                    for k, (c, t) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][1])},
    }


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256, help="edge of the cube")
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_session: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # a card set below its maximum power runs slower under load
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device {card}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    results = []
    for case, kBT in CASES:
        r = profile_config(case, kBT, args.n, args.chunk, args.repeats,
                           device)
        idle = ("not measured (no device events in the trace)"
                if r["idle_share"] is None else f"{r['idle_share']:.4f}")
        print(f"{case} kBT={kBT}: enter first {r['enter_first_ms']:.1f} "
              f"ms, warm {r['enter_ms']:.2f} ms; exit_view "
              f"{r['exit_view_ms']:.2f} ms; advance({args.chunk}) "
              f"{r['advance_ms']:.2f} ms = {r['mlups']:.1f} MLUPS; enqueue "
              f"{r['enqueue_us_per_launch']:.1f} us/launch "
              f"({r['enqueue_us_per_launch_profiled']:.1f} under the "
              f"profiler); idle share {idle}", flush=True)
        for name, k in r["kernels"].items():
            print(f"  {k['count']:5d} x {k['device_ms']:10.3f} ms  "
                  f"{name[:90]}", flush=True)
        results.append(r)
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "card": card, "configs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
