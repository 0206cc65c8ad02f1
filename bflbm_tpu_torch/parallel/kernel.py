"""The decomposed K-step loop on the kernels (K7, the sharded modes of
``bflbm_tpu/parallel/kernel.py``).

Each block of a mesh (:mod:`bflbm_tpu_torch.parallel.mesh`) stays in the
padded layout between steps: pads of depth sd (``ops.blocked.sd_depth``:
1 uncoupled, 2 with alpha0, 3 with alpha1) on the sharded axes, none on
the others, which the kernels wrap in place.  That covers what JAX's
``wrap_y`` computes without a y exchange, and lets a z-sharded mesh run
as it is, with no mesh permutation.  A step is

    1. one halo exchange (:func:`bflbm_tpu_torch.parallel.halo.halo_plan`)
       that fills every pad from the neighbours' interiors;
    2. per block, the kernels in ext mode (``kernels.fused_step.
       fused_stream_collide(..., ext=)``): the density pre-pass A when a
       force is on, the laplacian pre-pass L with alpha1, then K, which
       writes the block's interior into the other buffer of the pair, at
       the pad offset (JAX's ``owin``), so no step copies a block out of
       its layout;
    3. the cadenced exact-mass restore, with the sums over every block's
       interior in float64; the next exchange refreshes the pads.

The noise is keyed by global coordinates, and every cell runs the
arithmetic of the whole-domain launch, so the trajectory is
``FusedSession``'s for every mesh.  This is block 1 (one exchange and one
K a physical step); temporal blocking (K4) and the overlap split of the
exchange under the interior's kernels are queued.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import LBMParams
from ..kernels import fused_step
from ..ops import blocked
from ..state import draw_words
from . import halo
from . import mesh as mesh_lib


def supports(mesh: mesh_lib.Mesh, shape, params: LBMParams) -> bool:
    """The mesh divides the domain and each sharded local extent holds the
    sd planes a neighbour's pads take from it."""
    return mesh.supports(shape, blocked.sd_depth(params))


def pads(mesh: mesh_lib.Mesh, params: LBMParams):
    """The resident layout's pad depth per axis for this configuration."""
    return mesh.pads(blocked.sd_depth(params))


def pad_state(state, mesh: mesh_lib.Mesh, params: LBMParams):
    """A SimState in the resident padded layout of the mesh (back with
    :func:`bflbm_tpu_torch.parallel.mesh.gather_state`)."""
    return mesh_lib.shard_state(state, mesh, pads(mesh, params))


def mass_restore_blocks(ss: mesh_lib.ShardedState, m0f, m0g,
                        ncells: float) -> None:
    """The exact-mass restore (``fused_step.mass_restore_step``) of a
    decomposed state, IN PLACE: the float64 sums run over every block's
    interior (per block, then over the blocks in order) and the shift is
    added to the interior of each block's rest population."""
    for s, m0 in ((0, m0f), (1, m0g)):
        views = [mesh_lib.interior(blk[s], ss.pad) for blk in ss.blocks]
        home = torch.as_tensor(m0).device
        total = sum(v.sum(dtype=torch.float64).to(home) for v in views)
        shift = ((m0 - total) / ncells).to(views[0].dtype)
        for v in views:
            v[0] += shift.to(v.device)


def make_kernel_ksteps(mesh: mesh_lib.Mesh, params: LBMParams, n: int,
                       mass_restore=None, *, noise_dist: str = "clt4"):
    """fn(ss, words=None, ref=None) -> ss: n K steps of a decomposed
    post-collide state in the resident padded layout (:func:`pad_state`),
    one exchange and one K launch per block a step (with A and L when the
    configuration needs them), ping-ponging two buffers per block and
    reusing one psi (and lap) scratch per block for the chunk.

    The input's block buffers become the second buffers, so `ss` is
    consumed.  words: the n per-step noise words (default: drawn from
    ss.gen).  ref: per block the padded (2, ...) USE_REF_STATE amplitude
    fields, held fixed for the n steps, or None.  mass_restore: optional
    (interval, m0f, m0g)."""
    fused_step.check_noise_dist(noise_dist)

    def run_k(ss: mesh_lib.ShardedState,
              words: Optional[Sequence[int]] = None,
              ref: Optional[List[torch.Tensor]] = None
              ) -> mesh_lib.ShardedState:
        if words is None:
            words = draw_words(ss.gen, n)
        if len(words) != n:
            raise ValueError(f"need {n} words, got {len(words)}")
        if tuple(ss.pad) != pads(mesh, params):
            raise ValueError(f"state pads {ss.pad} are not this "
                             f"configuration's {pads(mesh, params)}")
        if not n:
            return ss
        shape = ss.shape
        exts = halo.block_exts(mesh, shape, ss.pad)
        cur = list(ss.blocks)
        spare = [torch.empty_like(b) for b in cur]
        plan = halo.halo_plan(cur, mesh, ss.pad)
        spare_plan = halo.halo_plan(spare, mesh, ss.pad)
        scratch = [(None, None)] * mesh.size
        if fused_step.is_coupled(params) and cur[0].device.type == "cuda":
            scratch = [
                (torch.empty((2,) + tuple(b.shape[2:]), dtype=b.dtype,
                             device=b.device),
                 torch.empty((2,) + tuple(b.shape[2:]), dtype=b.dtype,
                             device=b.device)
                 if fused_step.has_alpha1(params) else None) for b in cur]
        refs = [None] * mesh.size if ref is None else ref
        step = ss.step
        ncells = float(np.prod(shape))
        for w in words:
            halo.run_plan(plan)
            for b in range(mesh.size):
                fused_step.fused_stream_collide(
                    cur[b][0], cur[b][1], w, step, params,
                    out=(spare[b][0], spare[b][1]), noise_dist=noise_dist,
                    psi=scratch[b][0], lap=scratch[b][1], ref=refs[b],
                    ext=exts[b])
            cur, spare = spare, cur
            plan, spare_plan = spare_plan, plan
            step += 1
            if mass_restore is not None:
                interval, m0f, m0g = mass_restore
                if step // interval > (step - 1) // interval:
                    mass_restore_blocks(ss.replace(blocks=cur), m0f, m0g,
                                        ncells)
        return ss.replace(blocks=cur, step=step)

    return run_k
