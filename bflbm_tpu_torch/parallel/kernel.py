"""The decomposed K-step loop on the kernels (K7, the sharded modes of
``bflbm_tpu/parallel/kernel.py``).

Each block of a mesh (:mod:`bflbm_tpu_torch.parallel.mesh`) stays in the
padded layout between steps: pads of depth sd (``ops.blocked.sd_depth``:
1 uncoupled, 2 with alpha0, 3 with alpha1) on the sharded axes, none on
the others, which the kernels wrap in place.  That covers what JAX's
``wrap_y`` computes without a y exchange, and lets a z-sharded mesh run
as it is, with no mesh permutation.  A step runs one of three sweeps
(:func:`layout` picks it):

- serial (JAX's ``y_exchange="dus"``): one halo exchange
  (:func:`bflbm_tpu_torch.parallel.halo.halo_plan`) fills every pad from
  the neighbours' interiors; then per block the kernels in ext mode
  (``kernels.fused_step.fused_stream_collide(..., ext=)``): the density
  pre-pass A when a force is on, the laplacian pre-pass L with alpha1,
  then K, which writes the block's interior into the other buffer of the
  pair at the pad offset (JAX's ``owin``), so no step copies a block out
  of its layout;
- strips (JAX's ``ystrips``, its default on a y-sharded mesh with z
  unsharded; here only on ``y_exchange="strips"``, see :func:`layout`):
  the exchange fills the x pads and ships the y halo as
  compact strips (:func:`bflbm_tpu_torch.parallel.halo.strip_plan`) that
  A and K read in place of the y pads and that K writes anew each step;
  the blocks' y pads are never read;
- the overlap split (``overlap=True`` or ``"force"``, JAX's split
  sweep): the exchange runs on a side stream of each card while A, L and
  K run on every block's interior window, the interior shrunk by sd on
  each split axis, whose reads touch no pad; then the compute streams
  wait for the exchange and run the seam bands, each with its A and L
  rings in front of it.  Every launch writes its window in place in the
  one padded output (JAX's ``win`` / ``owin`` / ``out_alias``).

After every block's kernels, the cadenced exact-mass restore, with the
sums over every block's interior in float64; the next exchange refreshes
the pads (and, under strips, the restore shifts the strips too).

At block T > 1 (K4 on the blocks, JAX's sharded sweeps at block T,
``bflbm_tpu/parallel/kernel.py:466-481, 541-569, 646-770``) the pads are
sd T deep and a sweep runs T steps with one exchange, in each of the
three sweeps (``kernels.fused_step.blocked_stream_collide(..., ext=)``):
serial, one blocked launch a block after the exchange; strips, the x
exchange and the strips (sd T rows deep), then one strip-fed blocked
launch a block; split, the exchange on the side stream under one blocked
launch a block on the interior window (the interior shrunk by sd T on
each split axis, whose reads touch no pad), then one a seam band.  The
n % T steps left of an advance run as one-step launches inside the same
layout (JAX's "T=1 remainder phase inside the blocked phase's layout":
the split's windows then at depth sd, the strips read and written sd T
rows deep), and the restore follows the sweep that crossed its step.

The noise is keyed by global coordinates, and every cell runs the
arithmetic of the whole-domain launch, so the trajectory is
``FusedSession``'s for every mesh and every sweep at the same block.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LBMParams
from ..kernels import fused_step
from ..ops import blocked
from ..ops.blocked import Box
from ..state import draw_words
from . import halo
from . import mesh as mesh_lib

OVERLAPS = ("auto", False, True, "force")
Y_EXCHANGES = ("auto", "strips", "serial")


def supports(mesh: mesh_lib.Mesh, shape, params: LBMParams,
             block: int = 1) -> bool:
    """The mesh divides the domain and each sharded local extent holds the
    sd T planes (sd: ``ops.blocked.sd_depth``, T the block) a
    neighbour's pads take from it."""
    return mesh.supports(shape, blocked.sd_depth(params) * int(block))


def pad_state(state, mesh: mesh_lib.Mesh, pad: Sequence[int]):
    """A SimState in the resident padded layout of the mesh with the
    sweep's pads (:attr:`Layout.pad`); back with
    :func:`bflbm_tpu_torch.parallel.mesh.gather_state`."""
    return mesh_lib.shard_state(state, mesh, pad)


@dataclass(frozen=True)
class Layout:
    """How the decomposed steps of one (mesh, domain, configuration)
    run: which axes the overlap split cuts, whether the y halo travels
    as strips, and the resident layout's pad depth per axis."""

    split: Tuple[bool, bool, bool]
    strips: bool
    pad: Tuple[int, int, int]


def check_sweep(overlap, y_exchange: str) -> None:
    """Raise ValueError for a sweep option :func:`layout` does not
    know."""
    if not (overlap is True or overlap is False
            or overlap in ("auto", "force")):
        raise ValueError(f"overlap must be one of {OVERLAPS}, got "
                         f"{overlap!r}")
    if y_exchange not in Y_EXCHANGES:
        raise ValueError(f"y_exchange must be one of {Y_EXCHANGES}, got "
                         f"{y_exchange!r}")


def layout(mesh: mesh_lib.Mesh, shape, params: LBMParams,
           overlap="auto", y_exchange: str = "auto",
           block: int = 1) -> Layout:
    """The sweep for these options (JAX's ``_split_flags`` and
    ``_make_advance``).

    overlap: "auto" and False keep the serial sweep (JAX's default: its
    split cost more than it hid on one host); True splits every sharded
    axis; "force" every axis, giving the unsharded ones pads too, so that
    one card runs the call structure of a larger mesh.  An axis splits
    when its local extent less sd T on each side is not empty (block
    below); if a requested axis cannot, nothing splits.

    y_exchange: "auto" and "serial" are the copy exchange (JAX's "dus");
    "strips" takes the strips on any mesh with z unsharded (on a 1-block
    y axis the periodic self-wrap: the layout then carries y pads).  The
    split always takes the copy exchange.

    block: the T of the sweeps, whose reach sd T (sd: the stencil depth)
    is the depth of every pad and strip and the width of the split's seam
    bands: an axis splits when its local extent less sd T on each side is
    not empty, the strips need local y extents of at least sd T.  Raises
    ValueError for unknown options, for "strips" on a z-sharded mesh (the
    JAX path never shards z) or on a y extent shallower than sd T.  A
    sharded local extent shallower than the pads is refused by
    :func:`supports` and by the exchange (``halo.halo_plan``)."""
    check_sweep(overlap, y_exchange)
    if y_exchange == "strips" and mesh.shape[2] > 1:
        raise ValueError("y_exchange='strips' needs z unsharded: the JAX "
                         "path never shards z")
    depth = blocked.sd_depth(params) * int(block)
    loc = mesh.local_shape(shape)
    if overlap == "force":
        want = (True, True, True)
    elif overlap is True:
        want = mesh.sharded
    else:
        want = (False, False, False)
    split = (want if all(n - 2 * depth >= 1 for w, n in zip(want, loc) if w)
             else (False, False, False))
    # JAX's "auto" takes the strips on a y-sharded mesh with z unsharded;
    # here it keeps the copies: on one H100 (NVIDIA H100 80GB HBM3, 700 W;
    # chip_smoke.py phase 10b) the 256^3 droplet on mesh (2, 2, 1) ran
    # 3987.4 MLUPS with strips against 4148.6 serial, a step 4.0% longer
    # (more, smaller copies, and the rows next to the y halo in a slower
    # loop), past the 2% that would keep JAX's choice.
    strips = not any(split) and y_exchange == "strips"
    if strips and loc[1] < depth:
        raise ValueError(f"the y strips need local y extents of at least "
                         f"{depth}, got {loc[1]}")
    pad = tuple(depth if (on or cut or (d == 1 and strips)) else 0
                for d, (on, cut) in enumerate(zip(mesh.sharded, split)))
    return Layout(tuple(split), bool(strips), pad)


def split_windows(lay: Layout, arrays, depth: int
                  ) -> Tuple[Box, List[Box]]:
    """The overlap split's windows of a block whose arrays end in
    `arrays`: the interior window (the interior shrunk by `depth` on each
    split axis) and the seam bands, which cover the rest of the interior
    (JAX's partition, ``parallel/kernel.py:710-717``: the band of axis d
    spans the interior on the axes before d and the interior window's
    range on the axes after it, so the y bands span the full x width and
    the x bands the middle rows)."""
    whole = tuple((p, int(n) - p) for p, n in zip(lay.pad,
                                                  tuple(arrays)[-3:]))
    inner = tuple((a + depth, b - depth) if cut else (a, b)
                  for (a, b), cut in zip(whole, lay.split))
    bands = []
    for d in range(3):
        if not lay.split[d]:
            continue
        a, b = whole[d]
        for seam in ((a, a + depth), (b - depth, b)):
            bands.append(tuple(whole[e] if e < d else
                               (seam if e == d else inner[e])
                               for e in range(3)))
    return inner, bands


def strip_buffers(blocks: Sequence[torch.Tensor], pad) -> List[torch.Tensor]:
    """Per block a (2 sides, 2 species, Q, X, rows, Z) strip tensor holding
    the first (side 0) and last (side 1) `rows` = y-pad interior rows of f
    and g across the whole padded x extent: what K writes into its strips
    (JAX's ``prime_strips``, once per advance)."""
    out = []
    py = int(pad[1])
    for blk in blocks:
        ny = int(blk.shape[-2]) - 2 * py
        st = torch.empty((2, 2) + tuple(blk.shape[1:3]) + (py,)
                         + tuple(blk.shape[4:]), dtype=blk.dtype,
                         device=blk.device)
        st[0].copy_(blk[..., py:2 * py, :])
        st[1].copy_(blk[..., ny:ny + py, :])
        out.append(st)
    return out


class _Spans:
    """Per-step CUDA events on the first card's streams, for the split of
    a step's time (:func:`span_ms`).  Without a list nothing is
    recorded."""

    def __init__(self, spans: Optional[list], device):
        self.spans = spans
        self.dev = device
        self.cur: Dict[str, torch.cuda.Event] = {}

    def begin(self) -> None:
        if self.spans is not None:
            self.cur = {}
            self.spans.append(self.cur)

    def mark(self, key: str, stream=None) -> None:
        if self.spans is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream if stream is not None
                  else torch.cuda.current_stream(self.dev))
        self.cur[key] = ev


def span_ms(spans: Sequence[Dict[str, torch.cuda.Event]]) -> Dict[str, float]:
    """Mean ms a step of the events :func:`make_kernel_ksteps` recorded
    (synchronize first): "exchange" (the copies, on the stream that ran
    them), "interior" (A, L and K on the interior windows; every kernel
    of a serial step), "exposed" (the compute stream's wait for the
    exchange after its interior kernels; in a serial step the whole
    exchange) and "bands" (the seam bands; 0 in a serial step)."""
    out = {"exchange": 0.0, "interior": 0.0, "exposed": 0.0, "bands": 0.0}
    for sp in spans:
        ex = sp["x0"].elapsed_time(sp["x1"])
        out["exchange"] += ex
        if "b0" in sp:
            out["interior"] += sp["start"].elapsed_time(sp["i1"])
            out["exposed"] += sp["i1"].elapsed_time(sp["b0"])
            out["bands"] += sp["b0"].elapsed_time(sp["end"])
        else:
            out["interior"] += sp["x1"].elapsed_time(sp["end"])
            out["exposed"] += ex
    return {k: v / max(len(spans), 1) for k, v in out.items()}


class _SideExchange:
    """The overlap split's exchange on a side stream of every card: it
    waits for everything enqueued so far on the cards' current (compute)
    streams, which include the previous step's bands and restore, runs
    the plan, and :meth:`join` makes the compute streams wait for it
    before the seam bands.  Every stream of a card that a copy touches
    is a side stream, so peer copies between cards stay off the compute
    streams too."""

    def __init__(self, devices, marks: _Spans):
        self.devs = list(dict.fromkeys(devices))
        self.compute = {d: torch.cuda.current_stream(d) for d in self.devs}
        self.side = {d: torch.cuda.Stream(device=d) for d in self.devs}
        self.ready = {d: torch.cuda.Event() for d in self.devs}
        self.done = {d: torch.cuda.Event() for d in self.devs}
        self.marks = marks

    def keep(self, tensors) -> None:
        """The caching allocator keeps these compute-stream tensors until
        the side streams' work on them is done."""
        for t in tensors:
            t.record_stream(self.side[t.device])

    def exchange(self, plan) -> None:
        for d in self.devs:
            self.ready[d].record(self.compute[d])
        for d in self.devs:
            for e in self.ready.values():
                self.side[d].wait_event(e)
        first = self.side[self.devs[0]]
        self.marks.mark("x0", first)
        with contextlib.ExitStack() as st:
            for d in self.devs:
                st.enter_context(torch.cuda.stream(self.side[d]))
            halo.run_plan(plan)
        self.marks.mark("x1", first)
        for d in self.devs:
            self.done[d].record(self.side[d])

    def join(self) -> None:
        for d in self.devs:
            for e in self.done.values():
                self.compute[d].wait_event(e)


def mass_restore_blocks(ss: mesh_lib.ShardedState, m0f, m0g,
                        ncells: float,
                        strips: Sequence[torch.Tensor] = ()) -> None:
    """The exact-mass restore (``fused_step.mass_restore_step``) of a
    decomposed state, IN PLACE: the float64 sums run over every block's
    interior (per block, then over the blocks in order) and the shift is
    added to the interior of each block's rest population, and to the
    interior x cells of the rest population in the strips K wrote (which
    copy the interior's edge rows, so they stay bitwise equal to them)."""
    px = int(ss.pad[0])
    for s, m0 in ((0, m0f), (1, m0g)):
        views = [mesh_lib.interior(blk[s], ss.pad) for blk in ss.blocks]
        home = torch.as_tensor(m0).device
        total = sum(v.sum(dtype=torch.float64).to(home) for v in views)
        shift = ((m0 - total) / ncells).to(views[0].dtype)
        for v in views:
            v[0] += shift.to(v.device)
        for st in strips:
            st[:, s, 0, px:int(st.shape[-3]) - px] += shift.to(st.device)


def make_kernel_ksteps(mesh: mesh_lib.Mesh, params: LBMParams, n: int,
                       mass_restore=None, *, noise_dist: str = "clt4",
                       overlap="auto", y_exchange: str = "auto",
                       spans: Optional[list] = None, block: int = 1):
    """fn(ss, words=None, ref=None) -> ss: n K steps of a decomposed
    post-collide state in the resident padded layout of the sweep
    (:func:`layout`'s pads: :func:`pad_state` with ``pad=``), one
    exchange and the kernels on every block a step, ping-ponging two
    buffers per block and reusing one psi (and lap) scratch per block
    for the chunk.  overlap, y_exchange: the sweep (:func:`layout`).

    block = T > 1 (:func:`~bflbm_tpu_torch.kernels.fused_step.
    check_block`; the layout's pads are sd T deep): n // T' sweeps, T' =
    min(T, n), each one exchange and the blocked launches
    (``fused_step.blocked_stream_collide(..., ext=)``) of the sweep, one a
    block (strip-fed under the strips; under the split one on the
    interior window, shrunk by sd T', and one a seam band), then n % T'
    single steps as above in the same layout (the split's windows at
    depth sd); the mass restore follows the sweep or step that crossed
    its interval.

    The input's block buffers become the second buffers, so `ss` is
    consumed.  words: the n per-step noise words (default: drawn from
    ss.gen).  ref: per block the padded (2, ...) USE_REF_STATE amplitude
    fields, held fixed for the n steps, or None; before a blocked sweep
    their pads are filled from the neighbours' interiors in place, once
    for the advance (JAX's ``prep_ref_sm``): the sweeps' ring cells read
    them there.  mass_restore: optional (interval, m0f, m0g).  spans: on
    CUDA, a list into which every exchange appends its CUDA events
    (:func:`span_ms`; the events cost a few microseconds of host time a
    step), or None.

    On the CPU every window runs in program order, with no streams."""
    fused_step.check_noise_dist(noise_dist)
    fused_step.check_block(params, block)

    def run_k(ss: mesh_lib.ShardedState,
              words: Optional[Sequence[int]] = None,
              ref: Optional[List[torch.Tensor]] = None
              ) -> mesh_lib.ShardedState:
        if words is None:
            words = draw_words(ss.gen, n)
        if len(words) != n:
            raise ValueError(f"need {n} words, got {len(words)}")
        shape = ss.shape
        lay = layout(mesh, shape, params, overlap, y_exchange, block)
        if tuple(ss.pad) != lay.pad:
            raise ValueError(f"state pads {ss.pad} are not this "
                             f"configuration's {lay.pad}")
        if not n:
            return ss
        T = min(int(block), n)
        n_blocked = n // T if T > 1 else 0
        exts = halo.block_exts(mesh, shape, ss.pad)
        cur = list(ss.blocks)
        spare = [torch.empty_like(b) for b in cur]
        cuda = cur[0].device.type == "cuda"
        scratch = [(None, None)] * mesh.size
        if fused_step.is_coupled(params) and cuda and n > n_blocked * T:
            scratch = [
                (torch.empty((2,) + tuple(b.shape[2:]), dtype=b.dtype,
                             device=b.device),
                 torch.empty((2,) + tuple(b.shape[2:]), dtype=b.dtype,
                             device=b.device)
                 if fused_step.has_alpha1(params) else None) for b in cur]
        refs = [None] * mesh.size if ref is None else ref
        if ref is not None and n_blocked:
            halo.exchange_halo(refs, mesh, ss.pad)
        sent = received = [None] * mesh.size
        if lay.strips:
            sent = strip_buffers(cur, ss.pad)
            received = [torch.empty_like(t) for t in sent]
            plans = [halo.halo_plan(bufs, mesh, ss.pad, axes=(0,))
                     + halo.strip_plan(sent, received, mesh, ss.pad)
                     for bufs in (cur, spare)]
        else:
            plans = [halo.halo_plan(bufs, mesh, ss.pad)
                     for bufs in (cur, spare)]
        split = any(lay.split)
        sd = blocked.sd_depth(params)
        # the split's (interior window, seam bands) by the reach of a launch
        windows = ({r: split_windows(lay, cur[0].shape, r)
                    for r in {sd, sd * T}} if split else {})
        marks = _Spans(spans if cuda else None, cur[0].device)
        side = None
        if split and cuda:
            side = _SideExchange([b.device for b in cur], marks)
            side.keep(cur + spare)
        step = ss.step
        ncells = float(np.prod(shape))

        def kernels(b, w, window=None):
            fused_step.fused_stream_collide(
                cur[b][0], cur[b][1], w, step, params,
                out=(spare[b][0], spare[b][1]), noise_dist=noise_dist,
                psi=scratch[b][0], lap=scratch[b][1], ref=refs[b],
                ext=exts[b], window=window, strips=received[b],
                strips_out=sent[b])

        def sweep(b, ws, window=None):
            fused_step.blocked_stream_collide(
                cur[b][0], cur[b][1], ws, step, params, T,
                out=(spare[b][0], spare[b][1]), noise_dist=noise_dist,
                ref=refs[b], ext=exts[b], window=window,
                strips=received[b], strips_out=sent[b])

        def exchange_and(launch, reach) -> None:
            """One exchange and `launch(block, window)` on every block:
            after the exchange, or under the split on the interior windows
            (at this reach) while it runs, then on the seam bands."""
            marks.begin()
            if split:
                inner, bands = windows[reach]
                marks.mark("start")
                if side is None:
                    halo.run_plan(plans[0])
                else:
                    side.exchange(plans[0])
                for b in range(mesh.size):
                    launch(b, inner)
                marks.mark("i1")
                if side is not None:
                    side.join()
                marks.mark("b0")
                for b in range(mesh.size):
                    for band in bands:
                        launch(b, band)
            else:
                marks.mark("x0")
                halo.run_plan(plans[0])
                marks.mark("x1")
                for b in range(mesh.size):
                    launch(b, None)
            marks.mark("end")

        def restore() -> None:
            if mass_restore is not None:
                interval, m0f, m0g = mass_restore
                if step // interval > prev // interval:
                    mass_restore_blocks(ss.replace(blocks=cur), m0f, m0g,
                                        ncells, [t for t in sent
                                                 if t is not None])

        for k in range(n_blocked):
            ws = words[k * T:(k + 1) * T]
            exchange_and(lambda b, win: sweep(b, ws, win), sd * T)
            cur, spare = spare, cur
            plans.reverse()
            prev, step = step, step + T
            restore()
        for w in words[n_blocked * T:]:
            exchange_and(lambda b, win: kernels(b, w, win), sd)
            cur, spare = spare, cur
            plans.reverse()
            prev, step = step, step + 1
            restore()
        return ss.replace(blocks=cur, step=step)

    return run_k
