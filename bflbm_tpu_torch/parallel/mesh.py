"""The device mesh of a decomposed domain (``bflbm_tpu/parallel/mesh.py``).

The reference decomposes its box over MPI ranks (``BoxArray.maxSize`` and
``DistributionMapping``, main_run_job.cpp:140-143).  The port holds the
decomposition in one process, as the JAX package's single-controller
sessions do: a :class:`Mesh` is an (mx, my, mz) grid of torch devices,
block (i, j, k) holds the cells [i Xl, (i + 1) Xl) x [j Yl, (j + 1) Yl) x
[k Zl, (k + 1) Zl) of the global (X, Y, Z) domain on its device, and the
halo exchange between blocks is a ``Tensor.copy_``: a peer copy between
cards.  A device may appear more than once: on a node with fewer cards
than blocks several blocks share a card, each as its own tensors (the
counterpart of the JAX tests' virtual CPU devices).

A decomposed state (:class:`ShardedState`) keeps each block in one
(2, 19, Xl + 2 px, Yl + 2 py, Zl + 2 pz) tensor, f then g, with pads of
depth p on the sharded axes (:mod:`bflbm_tpu_torch.parallel.halo` fills
them) and none on the others, which wrap in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..lattice import Q
from ..ops.blocked import interior
from ..state import SimState

SPATIAL_AXES = ("x", "y", "z")


@dataclass(frozen=True)
class Mesh:
    """An (mx, my, mz) grid of devices; block b = (i * my + j) * mz + k
    sits on ``devices[b]``."""

    shape: Tuple[int, int, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def sharded(self) -> Tuple[bool, bool, bool]:
        """Which spatial axes the mesh cuts."""
        return tuple(m > 1 for m in self.shape)

    def coords(self, b: int) -> Tuple[int, int, int]:
        my, mz = self.shape[1], self.shape[2]
        return (b // (my * mz), (b // mz) % my, b % mz)

    def index(self, coords: Sequence[int]) -> int:
        """The block at `coords`, wrapped periodically over the mesh."""
        i, j, k = (int(c) % m for c, m in zip(coords, self.shape))
        return (i * self.shape[1] + j) * self.shape[2] + k

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """Each block's extents of a global (X, Y, Z) domain."""
        if any(int(s) % m for s, m in zip(shape, self.shape)):
            raise ValueError(f"domain {tuple(shape)} not divisible by mesh "
                             f"{self.shape}")
        return tuple(int(s) // m for s, m in zip(shape, self.shape))

    def supports(self, shape: Sequence[int], depth: int = 1) -> bool:
        """Every axis divides, and every sharded local extent holds the
        `depth` planes a neighbour's pads take from it."""
        if any(int(s) % m for s, m in zip(shape, self.shape)):
            return False
        return all(int(s) // m >= depth
                   for s, m in zip(shape, self.shape) if m > 1)

    def origin(self, b: int, shape: Sequence[int]) -> Tuple[int, int, int]:
        """Global coordinates of block b's first cell."""
        loc = self.local_shape(shape)
        return tuple(c * n for c, n in zip(self.coords(b), loc))

    def pads(self, depth: int) -> Tuple[int, int, int]:
        """Pad depth per axis: `depth` on the sharded axes, 0 elsewhere."""
        return tuple(int(depth) if on else 0 for on in self.sharded)


def make_mesh(shape: Sequence[int], devices=None) -> Mesh:
    """A mesh of prod(shape) blocks.  devices: one device for every
    block, a sequence of them in block order (repeats allowed), or None:
    ``cuda:0 .. cuda:n-1``, and on a node with fewer cards the cards
    repeated in order, said in one printed line.  Raises without a card
    when devices is None: a block is never moved to the CPU unasked."""
    shape = tuple(int(m) for m in shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh shape must be three positive ints, got "
                         f"{shape}")
    n = int(np.prod(shape))
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("make_mesh needs a CUDA device, or devices=")
        devs = [torch.device("cuda", b % cards) for b in range(n)]
        if cards < n:
            print(f"make_mesh: {n} blocks on {cards} card(s): cards repeat "
                  "in order, blocks sharing a card are separate tensors",
                  flush=True)
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"mesh {shape} needs {n} devices, got "
                             f"{len(devs)}")
    return Mesh(shape, tuple(devs))


@dataclass
class ShardedState:
    """A decomposed state: per block one (2, 19, ...) tensor, f then g, in
    the padded layout of `pad` on the block's device; step and generator
    as in :class:`~bflbm_tpu_torch.state.SimState`."""

    blocks: List[torch.Tensor]
    step: int
    gen: torch.Generator
    mesh: Mesh
    pad: Tuple[int, int, int]

    @property
    def shape(self) -> Tuple[int, int, int]:
        """The global domain."""
        loc = interior(self.blocks[0], self.pad).shape[-3:]
        return tuple(int(n) * m for n, m in zip(loc, self.mesh.shape))

    def replace(self, **kw) -> "ShardedState":
        return dataclasses.replace(self, **kw)


def shard_field(field: torch.Tensor, mesh: Mesh, pad=(0, 0, 0)
                ) -> List[torch.Tensor]:
    """Split a (..., X, Y, Z) field into the mesh's blocks, each on its
    device in the padded layout of `pad` (pads zeroed)."""
    lead = tuple(field.shape[:-3])
    loc = mesh.local_shape(field.shape[-3:])
    out = []
    for b in range(mesh.size):
        o = mesh.origin(b, field.shape[-3:])
        blk = torch.zeros(lead + tuple(n + 2 * int(p)
                                       for n, p in zip(loc, pad)),
                          dtype=field.dtype, device=mesh.devices[b])
        interior(blk, pad).copy_(field[..., o[0]:o[0] + loc[0],
                                       o[1]:o[1] + loc[1],
                                       o[2]:o[2] + loc[2]])
        out.append(blk)
    return out


def gather_field(blocks: Sequence[torch.Tensor], mesh: Mesh, pad,
                 device=None) -> torch.Tensor:
    """Join the blocks' interiors into one (..., X, Y, Z) field on
    `device` (default: the first block's)."""
    device = blocks[0].device if device is None else torch.device(device)
    first = interior(blocks[0], pad)
    loc = tuple(first.shape[-3:])
    out = torch.empty(tuple(first.shape[:-3])
                      + tuple(n * m for n, m in zip(loc, mesh.shape)),
                      dtype=first.dtype, device=device)
    for b, blk in enumerate(blocks):
        o = tuple(c * n for c, n in zip(mesh.coords(b), loc))
        out[..., o[0]:o[0] + loc[0], o[1]:o[1] + loc[1],
            o[2]:o[2] + loc[2]].copy_(interior(blk, pad))
    return out


def shard_state(state: SimState, mesh: Mesh, pad=(0, 0, 0)
                ) -> ShardedState:
    """Place a SimState onto the mesh, each block in the padded layout of
    `pad`; the pads are zero until an exchange fills them."""
    fg = torch.stack([state.f, state.g])
    return ShardedState(shard_field(fg, mesh, pad), state.step, state.gen,
                        mesh, tuple(int(p) for p in pad))


def gather_state(ss: ShardedState, device=None) -> SimState:
    """Join a decomposed state's interiors into one SimState on `device`
    (default: the first block's)."""
    fg = gather_field(ss.blocks, ss.mesh, ss.pad, device)
    if fg.shape[1] != Q:
        raise ValueError(f"blocks hold {fg.shape[1]} populations, not {Q}")
    return SimState(f=fg[0], g=fg[1], step=ss.step, gen=ss.gen)
