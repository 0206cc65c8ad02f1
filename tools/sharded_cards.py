#!/usr/bin/env python3
"""The decomposed session across the node's cards: the 256^3 droplet-fluct
configuration of ``chip_smoke.py`` phase 5 (``preset("droplet-eq")`` at
256^3 with kBT = 1e-5, clt4, 1 + 11 x 100 steps, the mass restore at step
1000) through ``FusedSession`` on cuda:0, then through ``ShardedSession``
on meshes (2, 1, 1) and, with four cards or more, (2, 2, 1) whose blocks
sit on distinct cards (peer copies in the halo exchange), each in its
sweeps: the serial exchange, the overlap split (``overlap=True``: the
exchange on a side stream of every card under the interior windows'
kernels) and, on (2, 2, 1), the y strips (``y_exchange="strips"``).
Each sharded run is held against the single-card one at steps 901 and
1101 (max |delta| <= 2e-5, bitwise printed) and its MLUPS are printed
beside it.  ``--block T`` runs every session, the single-card one too,
at T K steps a launch (K4: one exchange and the sweep's blocked launches
every T steps); without it the sessions take block 1.

    python tools/sharded_cards.py            # needs two cards or more
    python tools/sharded_cards.py --block 2

Prints every card's name and power limit first and one JSON line last;
on a node with fewer than two cards it prints "no multi-card machine"
and exits 1.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPE = (256, 256, 256)
CHUNK, NCHUNKS = 100, 11
TOL = 2e-5
SWEEPS = {"serial": dict(y_exchange="serial"),
          "split": dict(overlap=True),
          "strips": dict(y_exchange="strips")}


def _run(sess, state, keep):
    """enter + NCHUNKS x advance(CHUNK); exit views at the steps in `keep`
    (outside the timed advances).  Returns (views, advance seconds)."""
    import torch

    pc = sess.enter(state)
    t_adv = 0.0
    views = {}
    for _ in range(NCHUNKS):
        t0 = time.perf_counter()
        pc = sess.advance(pc, CHUNK)
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        t_adv += time.perf_counter() - t0
        if pc.step in keep:
            views[pc.step] = sess.exit_view(pc)
    return views, t_adv


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", type=int, default=1,
                    help="K steps a launch in every session (default 1)")
    T = ap.parse_args(argv).block
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print("sharded_cards: no multi-card machine", file=sys.stderr)
        return 1
    from bflbm_tpu_torch import config
    from bflbm_tpu_torch.kernels import _build, fused_step
    from bflbm_tpu_torch.kernels.session import ShardedSession, make_session
    from bflbm_tpu_torch.models import binary_fluid as model
    from bflbm_tpu_torch.parallel import mesh as mesh_lib

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    # build the kernels and fill every card's tables before any timing
    for d in range(cards):
        for name in _build.SOURCES:
            _build.load(name, torch.device("cuda", d))
    dev = torch.device("cuda", 0)
    cfg = config.preset("droplet-eq").replace(shape=SHAPE).with_params(
        kBT=1e-5)
    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    n_k = CHUNK * NCHUNKS
    keep = (901, 1 + n_k)
    want, t_one = _run(make_session(cfg.params, SHAPE, noise_dist="clt4",
                                    block=T),
                       model.make_initial_state(cfg, device=dev), keep)
    out = {"cards": cards, "block": T,
           "single_mlups": cells * n_k / t_one / 1e6}
    print(f"FusedSession(block={T}) on cuda:0: {out['single_mlups']:.1f} "
          f"MLUPS", flush=True)
    # launches a block and window: blocked sweeps of T steps, the rest
    # one-step launches
    sweeps = NCHUNKS * (CHUNK // T) if T > 1 else 0
    meshes = [(2, 1, 1)] + ([(2, 2, 1)] if cards >= 4 else [])
    ok = True
    for ms in meshes:
        mesh = mesh_lib.make_mesh(ms)
        for sweep, opts in SWEEPS.items():
            if sweep == "strips" and ms[1] == 1:
                continue
            sess = make_session(cfg.params, SHAPE, noise_dist="clt4",
                                mesh=mesh, block=T, **opts)
            assert isinstance(sess, ShardedSession)
            fused_step.reset_launch_counts()
            got, t_adv = _run(sess, model.make_initial_state(cfg,
                                                             device=dev),
                              keep)
            cmp = {s: (max(float((got[s].f - want[s].f).abs().max()),
                           float((got[s].g - want[s].g).abs().max())),
                       bool(torch.equal(got[s].f, want[s].f)
                            and torch.equal(got[s].g, want[s].g)))
                   for s in keep}
            mlups = cells * n_k / t_adv / 1e6
            modes = dict(fused_step.mode_launches)
            print(f"ShardedSession(block={T}) {sweep} mesh {ms} on "
                  f"{[str(d) for d in mesh.devices]}: {mlups:.1f} MLUPS; "
                  f"launches by mode {modes}; vs cuda:0 "
                  + ", ".join(f"step {s} max|delta| {e:.3e} (bitwise {b})"
                              for s, (e, b) in cmp.items()), flush=True)
            per = mesh.size * (1 + 2 * sum(sess.layout.split))
            ok &= (max(e for e, _ in cmp.values()) <= TOL
                   and modes.get("blocked ext", 0) == per * sweeps
                   and modes.get("ext", 0) == per * (n_k - sweeps * T))
            out[f"{ms} {sweep}"] = {"mlups": mlups, "bitwise": {
                str(s): b for s, (_, b) in cmp.items()}}
            del got, sess
            torch.cuda.empty_cache()
    out["ok"] = bool(ok)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
