"""Persistent post-collide session: the state stays resident in the
K-step's post-collide space across chunks.

    pc = session.enter(state)      # one plain prelude+collide: 1 full step
    pc = session.advance(pc, n)    # n fused K = collide∘stream steps
                                   #   (T a launch with block=T)
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

USE_REF_STATE (``ref_fields``, LBM_binary.H:92-106): the noise
amplitudes read the stored equilibrium (rho_eq, phi_eq) rolled into the
instantaneous centre-of-mass frame.  The reference re-rolls every step;
the session rolls once per sub-chunk and runs the sub-chunks
transactionally (:meth:`FusedSession._advance_ref`, as
``bflbm_tpu/kernels/session.py:244-280``), so that a COM cell-boundary
crossing lands on a sub-chunk boundary and the trajectory is the per-step
one.

:class:`ShardedSession` runs the same steps on a decomposed domain: one
block per device of a mesh (:mod:`bflbm_tpu_torch.parallel`), each kept
in the padded layout of the kernels' ext mode between advances, with one
halo exchange a step, or at block T one exchange and the blocked launches
of a sweep for T steps.

:func:`make_session` is the entry point for a configuration: it returns
a :class:`FusedSession`, or a :class:`ShardedSession` on a mesh of more
than one block, or raises for what the kernels cannot run.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..config import LBMParams
from ..models import binary_fluid as model
from ..observables import stats
from ..ops import collide as collide_ops
from ..ops import moments as moments_ops
from ..ops import noise as noise_ops
from ..ops import stream as stream_ops
from ..parallel import kernel as kernel_par
from ..parallel import mesh as mesh_lib
from ..state import SimState, draw_words
from . import fused_step


class FusedSession:
    """Single-device session over the fused K-step kernels: per K step the
    density pre-pass when a force is on, the laplacian pre-pass when
    alpha1 != 0, and K, with the pre-passes' psi and lap scratch held for
    each advance (:func:`fused_step.make_ksteps`).

    noise_dist: the hash-stream generator, "clt4" (default, as in the
    JAX package), "u8", "clt2" or "bm" (both the entry prelude and the
    kernel use it).  block: K steps per launch (K4, temporal blocking, in
    every configuration: with a force the sweeps launch no pre-pass;
    :func:`fused_step.check_block` refuses a T past shared memory); None
    takes 1, the fastest step in every mode on an H100 (JAX's auto block
    picks T per mode and n).  An advance of n runs n // T blocked sweeps, then
    n % T single steps, and the mass restore falls after the sweep that
    crossed its step.  mass_restore_int: cadence (in steps) of the global
    exact-mass restore (:func:`fused_step.mass_restore_step`); 0
    disables it.  The invariants (m0f, m0g) are captured at the first
    :meth:`enter`.  ref_fields: optional (rho_eq, phi_eq, com_ref) of
    USE_REF_STATE — the stored equilibrium densities (X, Y, Z) and the
    centre of mass of rho_eq."""

    _REF_CAP = 64   # longest transactional sub-chunk (ref_fields only)

    def __init__(self, params: LBMParams, shape: Tuple[int, int, int], *,
                 noise_dist: str = "clt4", mass_restore_int: int = 1000,
                 ref_fields=None, block: Optional[int] = None):
        fused_step.check_noise_dist(noise_dist)
        if block is not None:
            fused_step.check_block(params, block)
        self.block = 1 if block is None else block
        self.params = params
        self.shape = tuple(int(s) for s in shape)
        self.noise_dist = noise_dist
        self.mass_restore_int = int(mass_restore_int or 0)
        self._m0 = None
        self.use_ref = ref_fields is not None
        self._viol = 0
        self._ref_cap = self._REF_CAP
        self.ref_backup_s = 0.0    # wall seconds of the rollback copies
        self.ref_retry_steps = 0   # K steps run again after a rollback
        if self.use_ref:
            rho_eq, phi_eq, com_ref = ref_fields
            self._rho_eq = torch.as_tensor(rho_eq)
            self._phi_eq = torch.as_tensor(phi_eq)
            self._com_ref = torch.as_tensor(com_ref, dtype=torch.float64)
            if tuple(self._rho_eq.shape) != self.shape:
                raise ValueError(f"ref field shape {tuple(self._rho_eq.shape)}"
                                 f" != session shape {self.shape}")

    def _mass_restore_arg(self):
        if self.mass_restore_int and self._m0 is not None:
            return (self.mass_restore_int,) + tuple(self._m0)
        return None

    def _ref_on(self, like: torch.Tensor) -> None:
        """Move the ref fields to the state's device and dtype (once)."""
        if self._rho_eq.device != like.device or \
                self._rho_eq.dtype != like.dtype:
            self._rho_eq = self._rho_eq.to(like.device, like.dtype)
            self._phi_eq = self._phi_eq.to(like.device, like.dtype)

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
        ref_state = None
        if self.use_ref:
            self._ref_on(state.f)
            ref_state = (self._rho_eq, self._phi_eq, self._com_ref)
        h, xi_f, xi_g = model.prelude(state, self.params, word,
                                      ref_state=ref_state,
                                      noise_dist=self.noise_dist)
        f1, g1 = collide_ops.collide(state.f, state.g, h, xi_f, xi_g,
                                     self.params)
        return state.replace(f=f1, g=g1, step=state.step + 1)

    def block_for(self, n: int) -> int:
        """The block an advance of n steps runs."""
        return self.block

    def _ksteps(self, n: int):
        return fused_step.make_ksteps(self.params, n, self._mass_restore_arg(),
                                      noise_dist=self.noise_dist,
                                      block=self.block_for(n))

    def advance(self, pc: SimState, n: int,
                words: Optional[Sequence[int]] = None) -> SimState:
        """Advance the resident state n K steps.  Consumes pc: its
        buffers become the ping-pong partner of the kernel loop.
        USE_REF_STATE sessions run transactionally
        (:meth:`_advance_ref`)."""
        if n <= 0:
            return pc
        if not self.use_ref:
            return self._ksteps(n)(pc, words)
        if words is None:
            words = draw_words(pc.gen, n)
        if len(words) != n:
            raise ValueError(f"need {n} words, got {len(words)}")
        return self._advance_ref(pc, list(words))

    # -- USE_REF_STATE ---------------------------------------------------
    # The resident state's pieces the transactional advance touches:
    # its f on one device, a copy, and the devices to synchronize.
    def _whole_f(self, pc) -> torch.Tensor:
        return pc.f

    def _copy(self, pc):
        return pc.replace(f=pc.f.clone(), g=pc.g.clone())

    def _devices(self, pc):
        return {pc.f.device}

    def _ref_operand(self, shift: Sequence[int]):
        return self._rolled_ref(shift)

    def _ref_shift(self, f: torch.Tensor) -> List[int]:
        """Integer COM shift of the state that post-collide f streams to.
        The per-step path rolls from the post-stream density the prelude
        sees; collide keeps each cell's mass, so the COM of pc.f is one
        step stale: the mass field is streamed first (plain torch, not
        the pre-pass kernel, so that the kernels' launch counts stay
        those of the physical steps)."""
        rho = moments_ops.density(stream_ops.stream(f))
        com = stats.center_of_mass(rho)
        return torch.round(com - self._com_ref.to(com.device)).to(
            torch.int64).tolist()

    def _rolled_ref(self, shift: Sequence[int]) -> torch.Tensor:
        """(2, X, Y, Z) (rho_eq, phi_eq) rolled by `shift`: the kernel's
        ref operand."""
        return torch.stack([noise_ops._roll3(self._rho_eq, shift),
                            noise_ops._roll3(self._phi_eq, shift)])

    def _advance_ref(self, pc: SimState, words: List[int]) -> SimState:
        """Transactional USE_REF_STATE advance
        (``bflbm_tpu/kernels/session.py:244-280``): sub-chunks of at most
        ``_REF_CAP`` steps, each run with the ref fields rolled by the
        COM shift at its start and with the block of its own length
        (:meth:`block_for`), as JAX's are; when the shift at its end differs (a
        cell-boundary crossing inside a sub-chunk of more than one step)
        the state is restored from a copy and the sub-chunk halved, until
        the crossing lands on a sub-chunk boundary.  A crossing inside a
        one-step sub-chunk is accepted and counted
        (:meth:`ref_violations`): its roll came from the COM at that
        step's start, as in the reference.  A retried sub-chunk replays
        the same words: they are drawn once for the whole advance.  Cost:
        one device copy of the state and one host sync per sub-chunk."""
        f = self._whole_f(pc)
        self._ref_on(f)
        done = 0
        cap = self._ref_cap
        shift0 = self._ref_shift(f)
        while done < len(words):
            n_i = min(len(words) - done, cap)
            backup = None
            if n_i > 1:
                t0 = time.perf_counter()
                backup = self._copy(pc)
                for dev in self._devices(pc):   # the shift's read synced
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                self.ref_backup_s += time.perf_counter() - t0
            out = self._ksteps(n_i)(pc, words[done:done + n_i],
                                    self._ref_operand(shift0))
            shift1 = self._ref_shift(self._whole_f(out))
            if shift1 != shift0 and n_i > 1:
                pc = backup
                self.ref_retry_steps += n_i
                cap = max(1, n_i // 2)
                continue
            if shift1 != shift0:
                self._viol += 1
            pc, shift0 = out, shift1
            done += n_i
            cap = min(self._REF_CAP, cap * 2)
        self._ref_cap = cap
        return pc

    def ref_violations(self) -> int:
        """COM cell-boundary crossings the transactional advance isolated
        to one-step sub-chunks: how often the droplet crossed a cell
        boundary (each handled at step granularity)."""
        return self._viol

    def exit_view(self, pc: SimState) -> SimState:
        """Post-stream view of the resident state at its current step;
        pc is not consumed."""
        return pc.replace(f=stream_ops.stream(pc.f),
                          g=stream_ops.stream(pc.g))

    exit = exit_view


class ShardedSession(FusedSession):
    """Decomposed session (``bflbm_tpu/kernels/session.py:ShardedSession``):
    each block of `mesh` on its device, resident in the padded layout of
    the kernels' ext mode, with per step one halo exchange and the
    kernels on every block, or at block T one exchange and one blocked
    launch a block for T steps
    (:func:`bflbm_tpu_torch.parallel.kernel.make_kernel_ksteps`).

    enter runs the plain prelude and collide on the whole state, on the
    state's device, and shards the result; exit_view gathers the
    interiors back onto that device, so views, frames and checkpoints are
    those of the undecomposed run.  The mass restore sums every block's
    interior in float64.  ref_fields: the COM and its shift are taken on
    the gathered density, and each block gets its slice of the rolled
    reference, in the transactional sub-chunks of :class:`FusedSession`.
    The noise is keyed by global coordinates, so the trajectory is
    FusedSession's for every mesh: bitwise before the first mass restore,
    and within the float64 summation order's rounding after it.

    overlap, y_exchange (JAX's ``kernel_opts``): the sweep
    (:func:`bflbm_tpu_torch.parallel.kernel.layout`).  overlap "auto"
    keeps the serial exchange, True runs it on a side stream of each card
    under the interior windows' kernels (the overlap split), "force"
    splits every axis; y_exchange "strips" ships the y halo as strips
    that the kernels read and write, "auto" and "serial" keep the copy
    exchange (strips measured slower, ``parallel.kernel.layout``).  Every
    sweep gives the same trajectory bitwise.

    block: K steps a launch on every block (K4 on halo-extended blocks,
    JAX's sharded sweeps at block T), fixed at construction because the
    resident pads are sd T deep (``fused_step.sd_depth``); an advance of
    n runs n // T sweeps of one exchange and the blocked launches of the
    sweep (one a block; under the split one on each block's interior
    window and one a seam band; under the strips strip-fed), then n % T
    single steps, and the trajectory is FusedSession's at the same block
    in every sweep.  None takes 1, as FusedSession does (JAX's sharded
    session defaults to 2).  A sharded
    local extent shallower than sd T raises ValueError."""

    def __init__(self, mesh: mesh_lib.Mesh, params: LBMParams,
                 shape: Tuple[int, int, int], *, noise_dist: str = "clt4",
                 mass_restore_int: int = 1000, ref_fields=None,
                 overlap="auto", y_exchange: str = "auto",
                 block: Optional[int] = None):
        fused_step.check_noise_dist(noise_dist)
        kernel_par.check_sweep(overlap, y_exchange)
        super().__init__(params, shape, noise_dist=noise_dist,
                         mass_restore_int=mass_restore_int,
                         ref_fields=ref_fields, block=block)
        sd = fused_step.sd_depth(params)
        if not kernel_par.supports(mesh, self.shape, params, self.block):
            raise ValueError(
                f"mesh {mesh.shape} cannot hold domain {self.shape} at block "
                f"{self.block}: every axis must divide and each sharded block "
                f"extent must be at least sd * T = {sd * self.block}")
        self.mesh = mesh
        self.overlap = overlap
        self.y_exchange = y_exchange
        self.layout = kernel_par.layout(mesh, self.shape, params, overlap,
                                        y_exchange, self.block)
        self.pad = self.layout.pad
        self._home = None

    def enter(self, state: SimState,
              word: Optional[int] = None) -> mesh_lib.ShardedState:
        """Post-stream state (step t) on any device -> resident decomposed
        post-collide state (step t+1); counts as one step."""
        pc = super().enter(state, word)
        self._home = state.f.device
        return kernel_par.pad_state(pc, self.mesh, self.pad)

    def _ksteps(self, n: int):
        return kernel_par.make_kernel_ksteps(
            self.mesh, self.params, n, self._mass_restore_arg(),
            noise_dist=self.noise_dist, overlap=self.overlap,
            y_exchange=self.y_exchange, block=self.block)

    def _whole_f(self, pc: mesh_lib.ShardedState) -> torch.Tensor:
        return mesh_lib.gather_field([b[0] for b in pc.blocks], self.mesh,
                                     self.pad, self._home)

    def _copy(self, pc: mesh_lib.ShardedState) -> mesh_lib.ShardedState:
        return pc.replace(blocks=[b.clone() for b in pc.blocks])

    def _devices(self, pc: mesh_lib.ShardedState):
        return {b.device for b in pc.blocks}

    def _ref_operand(self, shift: Sequence[int]) -> List[torch.Tensor]:
        return mesh_lib.shard_field(self._rolled_ref(shift), self.mesh,
                                    self.pad)

    def exit_view(self, pc: mesh_lib.ShardedState) -> SimState:
        """Post-stream view of the whole domain, on the device the state
        entered from; pc is not consumed."""
        return super().exit_view(mesh_lib.gather_state(pc, self._home))

    exit = exit_view


def make_session(params: LBMParams, shape, *, noise_dist: str = "clt4",
                 mass_restore_int: int = 1000, ref_fields=None,
                 mesh: Optional[mesh_lib.Mesh] = None, overlap="auto",
                 y_exchange: str = "auto",
                 block: Optional[int] = None) -> FusedSession:
    """The session for this configuration (the counterpart of
    ``bflbm_tpu.kernels.session.make_session``): a :class:`ShardedSession`
    on a mesh of more than one block, with the sweep options overlap and
    y_exchange, else the single-device :class:`FusedSession`, which has
    no exchange to split; either with `block` steps a launch (None:
    1).  The kernels run every configuration, alpha1 included, at
    every block whose tiles fit in shared memory, on one device or on a
    mesh.  Raises ValueError for an unknown generator name or sweep
    option, a mesh that cannot hold the domain at the block, or a block
    past shared memory."""
    if mesh is not None and mesh.size > 1:
        return ShardedSession(mesh, params, shape, noise_dist=noise_dist,
                              mass_restore_int=mass_restore_int,
                              ref_fields=ref_fields, overlap=overlap,
                              y_exchange=y_exchange, block=block)
    kernel_par.check_sweep(overlap, y_exchange)
    return FusedSession(params, shape, noise_dist=noise_dist,
                        mass_restore_int=mass_restore_int,
                        ref_fields=ref_fields, block=block)
