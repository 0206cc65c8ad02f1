"""Persistent post-collide session: the state stays resident in the
K-step's post-collide space across chunks.

    pc = session.enter(state)      # one plain prelude+collide: 1 full step
    pc = session.advance(pc, n)    # n fused K = collide∘stream steps
    view = session.exit_view(pc)   # post-stream view (pc stays live)
    state = session.exit(pc)       # final post-stream state

State convention: a post-collide state labeled ``step == k`` streams to
the standard post-stream state of step k, so ``exit_view`` returns step
k's fields without advancing anything.  ``enter`` counts as ONE step
(prelude+collide is the first half of step t -> t+1, the view's stream
the second half), and a run of N steps is ``enter + advance(N-1) +
exit``.

Every step consumes one noise word: ``enter(state, word)`` and
``advance(pc, n, words)`` take them explicitly, or draw them from the
state's generator.

:func:`make_session` is the entry point for a configuration: it returns
a :class:`FusedSession` or raises for what the kernels cannot run.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import LBMParams
from ..models import binary_fluid as model
from ..ops import collide as collide_ops
from ..ops import stream as stream_ops
from ..state import SimState
from . import fused_step


class FusedSession:
    """Single-device session over the fused K-step kernels.

    noise_dist: the hash-stream generator, "u8" or "clt4" (both the
    entry prelude and the kernel use it).  mass_restore_int: cadence (in
    steps) of the global exact-mass restore
    (:func:`fused_step.mass_restore_step`); 0 disables it.  The
    invariants (m0f, m0g) are captured at the first :meth:`enter`."""

    def __init__(self, params: LBMParams, shape: Tuple[int, int, int], *,
                 noise_dist: str = "u8", mass_restore_int: int = 1000):
        fused_step.check_noise_dist(noise_dist)
        self.params = params
        self.shape = tuple(int(s) for s in shape)
        self.noise_dist = noise_dist
        self.mass_restore_int = int(mass_restore_int or 0)
        self._m0 = None

    def _mass_restore_arg(self):
        if self.mass_restore_int and self._m0 is not None:
            return (self.mass_restore_int,) + tuple(self._m0)
        return None

    def enter(self, state: SimState, word: Optional[int] = None) -> SimState:
        """Post-stream state (step t) -> resident post-collide state
        (step t+1); counts as one step.  The first enter captures the
        run's total masses (in float64) for the mass restore."""
        if state.shape != self.shape:
            raise ValueError(f"state shape {state.shape} != session shape "
                             f"{self.shape}")
        if self.mass_restore_int and self._m0 is None:
            self._m0 = (state.f.sum(dtype=torch.float64),
                        state.g.sum(dtype=torch.float64))
        h, xi_f, xi_g = model.prelude(state, self.params, word,
                                      noise_dist=self.noise_dist)
        f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g,
                                     self.params)
        return state.replace(f=f1, g=g1, step=state.step + 1)

    def advance(self, pc: SimState, n: int,
                words: Optional[Sequence[int]] = None) -> SimState:
        """Advance the resident state n K steps.  Consumes pc: its
        buffers become the ping-pong partner of the kernel loop."""
        if n <= 0:
            return pc
        run = fused_step.make_ksteps(self.params, n, self._mass_restore_arg(),
                                     noise_dist=self.noise_dist)
        return run(pc, words)

    def exit_view(self, pc: SimState) -> SimState:
        """Post-stream view of the resident state at its current step;
        pc is not consumed."""
        return pc.replace(f=stream_ops.stream(pc.f),
                          g=stream_ops.stream(pc.g))

    exit = exit_view


def make_session(params: LBMParams, shape, *, noise_dist: str = "u8",
                 mass_restore_int: int = 1000) -> FusedSession:
    """The single-device session for this configuration (the counterpart
    of ``bflbm_tpu.kernels.session.make_session`` without a mesh).
    Raises NotImplementedError, naming the ROADMAP item, for what the
    kernels cannot run; there is no plain-torch engine to fall back to."""
    reason = fused_step.unsupported_reason(params)
    if reason is not None:
        raise NotImplementedError(reason)
    return FusedSession(params, shape, noise_dist=noise_dist,
                        mass_restore_int=mass_restore_int)
