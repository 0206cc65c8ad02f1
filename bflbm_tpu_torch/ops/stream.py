"""Streaming step as periodic pull shifts: out_i(x) = f_i(x - c_i).

Reference: push-scheme ``stream_push`` (LBM_binary.H:519-531); the pull
form is the same map written as a gather.
"""

from __future__ import annotations

import torch

from ..lattice import C, Q


def stream(f: torch.Tensor, dims=(-3, -2, -1)) -> torch.Tensor:
    """Pull-stream all 19 directions of a (19, X, Y, Z) tensor."""
    outs = []
    for i in range(Q):
        sh = [int(s) for s in C[i]]
        ax = [a for a, s in zip(dims, sh) if s != 0]
        sh = [s for s in sh if s != 0]
        fi = f[i]
        outs.append(torch.roll(fi, sh, ax) if sh else fi)
    return torch.stack(outs)
