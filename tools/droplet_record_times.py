#!/usr/bin/env python3
"""Wall seconds of the run driver's online droplet record
(``bflbm_tpu_torch.run._droplet_record``: excess-mass COM, equivalent
radius, the tanh fit of the radial profile) on a 256^3 droplet's density,
on the host as the driver calls it.  Run it with ``PYTHONPATH`` set to
each tree to compare (a parent unpacked under ``build/``, then this one)
in one call; it prints the tree's path, the best of three records and
the record itself.

    PYTHONPATH=build/parent python tools/droplet_record_times.py
    PYTHONPATH=. python tools/droplet_record_times.py

The density is the droplet-eq preset's initial droplet at 256^3 with
float32 noise of 1e-3 from seed 7, made on the card and copied to the
host, as the driver copies its frame's rho.
"""

import sys
import time


def main() -> int:
    import torch

    import bflbm_tpu_torch
    from bflbm_tpu_torch import config, run
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.ops.moments import density

    device = "cuda" if torch.cuda.is_available() else "cpu"
    shape = (256, 256, 256) if device == "cuda" else (32, 32, 32)
    cfg = config.preset("droplet-eq")
    state = model.init_droplet(shape, cfg.params, device=device,
                               radius=cfg.init_radius)
    rho = density(state.f)
    gen = torch.Generator(device=device).manual_seed(7)
    rho = (rho + 1e-3 * torch.randn(rho.shape, generator=gen,
                                    device=device)).cpu().numpy()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rec = run._droplet_record(rho)
        times.append(time.perf_counter() - t0)
    print(f"{bflbm_tpu_torch.__file__}: {shape}, best of 3 "
          f"{min(times):.3f} s (all {[round(t, 3) for t in times]}); "
          f"{rec}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
