"""``python -m bflbm_tpu_torch.probes [copy dma transform kernel noise
launch] [--cases ...] [--device cuda|cpu] [--shape X Y Z]``:
the platform probes (:mod:`bflbm_tpu_torch.probes`), on the card by
default at 256^3; ``--device cpu`` runs the plain versions and their
checks, with every time "not measured"."""

from __future__ import annotations

import argparse
import sys

from . import PROBES, SHAPE, noise_micro, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bflbm_tpu_torch.probes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*",
                    help=f"probes to run, of {PROBES} (default: all)")
    ap.add_argument("--cases", nargs="+", choices=noise_micro.CASES,
                    help="noise cases (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions only)")
    ap.add_argument("--shape", nargs=3, type=int, default=list(SHAPE),
                    metavar=("X", "Y", "Z"))
    args = ap.parse_args(argv)
    unknown = sorted(set(args.probes) - set(PROBES))
    if unknown:
        ap.error(f"unknown probes {unknown}; choose from {PROBES}")
    run(args.probes or PROBES, device=args.device, shape=args.shape,
        cases=args.cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
