"""The halo exchange of a decomposed domain and the plain engine built on
it (``bflbm_tpu/parallel/halo.py``).

Each block holds its post-collide populations in a padded layout
(:mod:`bflbm_tpu_torch.parallel.mesh`): pads of depth p on the sharded
axes.  :func:`exchange_halo` fills every pad from the neighbouring
blocks' interiors, periodic over the mesh, axis by axis: x first, then y
across the whole padded x extent, then z across the whole padded x and y
extents, so the second and third rounds carry the pads the earlier ones
filled and the D3Q19 edge diagonals arrive through two hops (SURVEY.md
§7 hard part 4).  One exchange a step replaces the reference's
``FillBoundary`` calls (LBM_binary.H:553-592).  Every copy is a
``Tensor.copy_`` between views, a peer copy when the blocks sit on
different cards.  :func:`strip_plan` is the strips exchange of a
y-sharded mesh, in which the y halo travels as compact strips that the
K kernel writes (K7's ystrips).

:func:`make_halo_nsteps` is the plain engine: the halo exchange and the
plain block step (:func:`bflbm_tpu_torch.ops.blocked.step_on_block`),
which the kernel path (:mod:`bflbm_tpu_torch.parallel.kernel`) is held
against.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..config import LBMParams
from ..models import binary_fluid as model
from ..ops import blocked
from ..ops import collide as collide_ops
from ..ops import stream as stream_ops
from ..state import SimState, draw_words
from . import mesh as mesh_lib

Copy = Tuple[torch.Tensor, torch.Tensor]


def halo_plan(blocks: Sequence[torch.Tensor], mesh: mesh_lib.Mesh,
              pad: Sequence[int], axes: Sequence[int] = (0, 1, 2)
              ) -> List[Copy]:
    """The (destination, source) view pairs of one exchange of these
    block tensors, in the order they must run (axis by axis); only the
    rounds of `axes` (the strips exchange takes the x round alone)."""
    plan = []
    for d in axes:
        p = int(pad[d])
        if not p:
            continue
        ax = blocks[0].dim() - 3 + d
        n_int = int(blocks[0].shape[ax]) - 2 * p
        if n_int < p:
            raise ValueError(f"a block's {mesh_lib.SPATIAL_AXES[d]} extent "
                             f"{n_int} is shallower than its pads {p}")

        def cut(t: torch.Tensor, lo: int) -> torch.Tensor:
            """Planes [lo, lo + p) along d; the interior of the axes after
            d (their pads are filled by the later rounds)."""
            v = t.narrow(ax, lo, p)
            for e in range(d + 1, 3):
                if pad[e]:
                    v = v.narrow(t.dim() - 3 + e, int(pad[e]),
                                 int(t.shape[t.dim() - 3 + e])
                                 - 2 * int(pad[e]))
            return v

        for b, blk in enumerate(blocks):
            c = list(mesh.coords(b))
            lo_nb = blocks[mesh.index(c[:d] + [c[d] - 1] + c[d + 1:])]
            hi_nb = blocks[mesh.index(c[:d] + [c[d] + 1] + c[d + 1:])]
            # my low pad is my low neighbour's last p interior planes, my
            # high pad my high neighbour's first p
            plan.append((cut(blk, 0), cut(lo_nb, n_int)))
            plan.append((cut(blk, p + n_int), cut(hi_nb, p)))
    return plan


def strip_plan(sent: Sequence[torch.Tensor],
               received: Sequence[torch.Tensor], mesh: mesh_lib.Mesh,
               pad: Sequence[int]) -> List[Copy]:
    """The y-strip exchange (``bflbm_tpu/parallel/kernel.py:
    _strip_exchange``, K7's ystrips) of per-block strip tensors (2 sides,
    2 species, Q, X, rows, Z): the strips K wrote (`sent`; side 0 the
    first interior rows, side 1 the last) and those the next step reads
    (`received`; side 0 mounted below the interior, side 1 above).  First
    every block's sent strips go whole to its y neighbours, one
    contiguous copy each: its last rows become the high neighbour's
    strip below, its first rows the low neighbour's strip above.  Then,
    with x pads, the x-pad columns of every received strip are copied
    from the x neighbours' received strips, whose interior columns carry
    the diagonal (x, y) corners: y first, then x, the opposite of
    :func:`halo_plan`'s order.  On a 1-block y axis a block's strips go
    to itself, the periodic wrap."""
    plan = []
    for b in range(mesh.size):
        c = list(mesh.coords(b))
        lo_nb = mesh.index((c[0], c[1] - 1, c[2]))
        hi_nb = mesh.index((c[0], c[1] + 1, c[2]))
        plan.append((received[b][0], sent[lo_nb][1]))
        plan.append((received[b][1], sent[hi_nb][0]))
    px = int(pad[0])
    if px:
        n_int = int(received[0].shape[-3]) - 2 * px
        for b in range(mesh.size):
            c = list(mesh.coords(b))
            lo_nb = received[mesh.index((c[0] - 1, c[1], c[2]))]
            hi_nb = received[mesh.index((c[0] + 1, c[1], c[2]))]
            for side in (0, 1):
                r = received[b][side]
                plan.append((r.narrow(-3, 0, px),
                             lo_nb[side].narrow(-3, n_int, px)))
                plan.append((r.narrow(-3, px + n_int, px),
                             hi_nb[side].narrow(-3, px, px)))
    return plan


def run_plan(plan: Sequence[Copy]) -> None:
    for dst, src in plan:
        dst.copy_(src)


def exchange_halo(blocks: Sequence[torch.Tensor], mesh: mesh_lib.Mesh,
                  pad: Sequence[int]) -> None:
    """Fill the pads of every block tensor in place from its neighbours'
    interiors (periodic over the mesh); axes without pads are left."""
    run_plan(halo_plan(blocks, mesh, pad))


def block_exts(mesh: mesh_lib.Mesh, shape: Sequence[int],
               pad: Sequence[int]) -> List[blocked.Ext]:
    """The :class:`~bflbm_tpu_torch.ops.blocked.Ext` of every block of a
    global domain `shape`."""
    shape = tuple(int(s) for s in shape)
    return [blocked.Ext(tuple(int(p) for p in pad), mesh.origin(b, shape),
                        shape) for b in range(mesh.size)]


def make_halo_nsteps(mesh: mesh_lib.Mesh, params: LBMParams, n: int, *,
                     noise_dist: str = "clt4"):
    """fn(state, words=None) -> state: n standard steps of a post-stream
    SimState through the halo engine — the plain prelude and collide on
    the whole state, then n - 1 steps of one exchange and the plain block
    step on every block, then the gather and the pull stream.  Noise is
    keyed by global coordinates, so the trajectory is
    ``models.binary_fluid.nsteps``'s for every mesh.  words: the n
    per-step words (default: drawn from state.gen)."""
    if n < 1:
        raise ValueError("n >= 1")
    pad = mesh.pads(blocked.sd_depth(params))

    def run(state: SimState, words: Optional[Sequence[int]] = None
            ) -> SimState:
        if words is None:
            words = draw_words(state.gen, n)
        if len(words) != n:
            raise ValueError(f"need {n} words, got {len(words)}")
        h, xi_f, xi_g = model.prelude(state, params, words[0],
                                      noise_dist=noise_dist)
        f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g,
                                     params)
        ss = mesh_lib.shard_state(
            state.replace(f=f1, g=g1, step=state.step + 1), mesh, pad)
        exts = block_exts(mesh, state.shape, pad)
        plan = halo_plan(ss.blocks, mesh, pad)
        step = ss.step
        for w in words[1:]:
            run_plan(plan)
            # each block reads only its own pads, so it is updated in place
            for blk, ext in zip(ss.blocks, exts):
                fo, go = blocked.step_on_block(blk[0], blk[1], w, step,
                                               params, ext, noise_dist)
                mesh_lib.interior(blk[0], pad).copy_(fo)
                mesh_lib.interior(blk[1], pad).copy_(go)
            step += 1
        pc = mesh_lib.gather_state(ss.replace(step=step), state.f.device)
        return pc.replace(f=stream_ops.stream(pc.f),
                          g=stream_ops.stream(pc.g))

    return run
