"""The plain engine: :func:`~bflbm_tpu_torch.models.binary_fluid.step` in
chunks, behind the interface of the kernel sessions
(:mod:`bflbm_tpu_torch.kernels.session`), so that the run driver runs it
as it runs a session (``run(cfg, engine="jnp")``, the JAX package's jnp
engine: ``jax.jit`` of the step, ``lax.scan`` over a chunk).

It is plain PyTorch on the state's device, with the noise of
``noise_source`` ("threefry": the bulk source; "hash": the hash stream)
and no mass restore.  On the card, without USE_REF_STATE, a chunk of
:data:`GRAPH_STEPS` steps is captured once in a CUDA graph and replayed
(the step launches ~470 small kernels; eager, their enqueue bounds it).
Before each replay the chunk's bulk normals are drawn into a static
buffer, one draw a step from the step's (word, step), as the eager step
draws them; the hash stream is computed inside the graph
(:func:`~bflbm_tpu_torch.ops.noise.hash_normal_stack`, every generator)
from a static (word, step) pair a step.  A replay computes the eager
chunk's bits.  USE_REF_STATE rolls the reference
fields by the centre of mass a step, a host read, so it runs eagerly, as
does every step on the CPU and a chunk's remainder.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..config import LBMParams
from ..ops import noise as noise_ops
from ..state import SimState, draw_words
from . import binary_fluid as model

GRAPH_STEPS = 10          # steps a captured chunk
_capture_lock = threading.Lock()
# over every session: "graph replays" (captured chunks replayed), "eager
# steps"
counts = {"graph replays": 0, "eager steps": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


class PlainSession:
    """The plain step in chunks: ``enter`` (one step), ``advance(pc, n)``,
    ``exit`` and ``exit_view``, as a kernel session.  Its
    post-collide state ``pc`` is a :class:`SimState` after the stream; on
    the graph path its populations are the graph's static tensors, so a
    view from :meth:`exit_view` holds until the next ``advance``, and
    :meth:`exit` returns copies.

    graph: capture CUDA graphs (default: on a CUDA device without
    ref_state).  Counters: ``graph_replays`` (captured chunks replayed),
    ``eager_steps``."""

    def __init__(self, params: LBMParams, shape, *,
                 noise_source: str = "threefry", noise_dist: str = "clt4",
                 ref_state=None, device="cuda",
                 graph: Optional[bool] = None):
        if noise_source not in noise_ops.NOISE_SOURCES:
            raise ValueError(f"noise_source {noise_source!r} not in "
                             f"{noise_ops.NOISE_SOURCES}")
        self.params = params
        self.shape = tuple(int(s) for s in shape)
        self.noise_source = noise_source
        self.noise_dist = noise_dist
        self.ref_state = ref_state
        self.device = torch.device(device)
        if graph is None:
            graph = self.device.type == "cuda" and ref_state is None
        if graph and ref_state is not None:
            raise ValueError("USE_REF_STATE runs eagerly: its roll reads "
                             "the centre of mass on the host")
        self.graph = bool(graph)
        self.graph_replays = 0
        self.eager_steps = 0
        self.ref_backup_s = 0.0
        self.ref_retry_steps = 0
        self._graph = None
        self._f = self._g = self._n = None
        # the hash stream's key in the graph: (word, step) a step
        self._keys = None

    # -- the session interface ----------------------------------------------

    def enter(self, state: SimState) -> SimState:
        """One step from a standard state."""
        return self.advance(state, 1)

    def advance(self, pc: SimState, n: int) -> SimState:
        """n steps, a word each from ``pc.gen``."""
        words = draw_words(pc.gen, n)
        step0 = pc.step
        if not self.graph or n < GRAPH_STEPS:
            return self._eager(pc, words)
        if self._graph is None:
            self._capture(pc)
        elif pc.f is not self._f:
            self._f.copy_(pc.f)
            self._g.copy_(pc.g)
        k = GRAPH_STEPS
        full = n - n % k
        for c in range(0, full, k):
            if self._keys is not None:
                keys = torch.tensor([[w, step0 + c + j] for j, w in
                                     enumerate(words[c:c + k])],
                                    dtype=torch.int64)
                self._keys.copy_(keys.pin_memory() if self._keys.is_cuda
                                 else keys, non_blocking=True)
            elif self._n is not None:
                for j in range(k):
                    noise_ops.bulk_normal_stack(words[c + j], step0 + c + j,
                                                self.shape, out=self._n[j])
            self._graph.replay()
            self.graph_replays += 1
            counts["graph replays"] += 1
        pc = pc.replace(f=self._f, g=self._g, step=step0 + full)
        if full < n:
            pc = self._eager(pc, words[full:])
            self._f.copy_(pc.f)
            self._g.copy_(pc.g)
            pc = pc.replace(f=self._f, g=self._g)
        return pc

    def exit(self, pc: SimState) -> SimState:
        """The standard state, its populations copies."""
        if pc.f is self._f:
            return pc.replace(f=pc.f.clone(), g=pc.g.clone())
        return pc

    def exit_view(self, pc: SimState) -> SimState:
        """The standard state, valid until the next ``advance``."""
        return pc

    def ref_violations(self) -> int:
        """USE_REF_STATE rolls the reference every step: none."""
        return 0

    # -- the steps ------------------------------------------------------------

    def _step(self, state: SimState, word: int, normals=None) -> SimState:
        return model.step(state, self.params, word, ref_state=self.ref_state,
                          noise_dist=self.noise_dist,
                          noise_source=self.noise_source,
                          normals=normals)[0]

    def _eager(self, pc: SimState, words) -> SimState:
        for w in words:
            pc = self._step(pc, w)
        self.eager_steps += len(words)
        counts["eager steps"] += len(words)
        return pc

    def _chunk(self) -> None:
        """GRAPH_STEPS steps on the static tensors, the normals of step j
        from the hash stream at self._keys[j] or from self._n[j]; the
        result written back into them."""
        st = SimState(f=self._f, g=self._g, step=0, gen=None)
        for j in range(GRAPH_STEPS):
            if self._keys is not None:
                n = noise_ops.hash_normal_stack(
                    self._keys[j, 0], self._keys[j, 1], self.shape,
                    self._f.dtype, self.noise_dist, self._f.device)
            else:
                n = None if self._n is None else self._n[j]
            st = self._step(st, 0, n)
        self._f.copy_(st.f)
        self._g.copy_(st.g)

    def _allocate(self, pc: SimState) -> None:
        """The chunk's static tensors: the populations (a copy of pc's),
        and the bulk normals' buffer or the hash keys."""
        self._f = pc.f.clone()
        self._g = pc.g.clone()
        if self.params.noise_on and self.noise_source == "hash":
            self._keys = torch.zeros((GRAPH_STEPS, 2), dtype=torch.int64,
                                     device=pc.f.device)
        elif self.params.noise_on:
            self._n = torch.zeros(
                (GRAPH_STEPS, noise_ops.N_CHANNELS) + self.shape,
                dtype=pc.f.dtype, device=pc.f.device)

    def _capture(self, pc: SimState) -> None:
        """Capture one chunk on a side stream (after a warm-up there, on
        copies of the state), then load the state into the static
        tensors.  Thread-local capture, one at a time, so that runs in
        other threads keep launching on their own streams (none of them
        may synchronize the whole device meanwhile)."""
        self._allocate(pc)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with _capture_lock:
            with torch.cuda.stream(side):
                self._chunk()          # warm-up: kernels and workspaces
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self._chunk()
        self._graph = graph
        self._f.copy_(pc.f)
        self._g.copy_(pc.g)
