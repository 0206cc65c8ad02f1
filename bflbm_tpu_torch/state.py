"""Simulation state of the PyTorch port."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import torch

_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1


@dataclass
class SimState:
    """Populations plus RNG bookkeeping.

    f, g: (19, X, Y, Z) tensors, z contiguous (the JAX package's layout).
    step: the step label, a Python int.
    gen: a CPU ``torch.Generator`` that yields one int32 noise word per
    physical step (:func:`draw_words`).  Words are drawn on the host, a
    chunk at a time, and reach the kernel as scalar arguments, so a step
    needs no device sync.
    """

    f: torch.Tensor
    g: torch.Tensor
    step: int
    gen: torch.Generator

    @property
    def shape(self):
        return tuple(self.f.shape[1:])

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def make_generator(seed: int) -> torch.Generator:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return gen


def init_state(f: torch.Tensor, g: torch.Tensor, seed: int,
               step: int = 0) -> SimState:
    return SimState(f=f, g=g, step=int(step), gen=make_generator(seed))


def draw_words(gen: torch.Generator, n: int) -> List[int]:
    """n int32 noise words, one per physical step, on the range the JAX
    package draws (``randint(minval=int32 min, maxval=int32 max)``)."""
    return torch.randint(_I32_MIN, _I32_MAX, (int(n),), generator=gen,
                         dtype=torch.int64).tolist()


def peek_words(gen: torch.Generator, n: int) -> List[int]:
    """The next n words of `gen` without consuming them (a copy draws
    them): what an observable view uses, so that the trajectory does not
    depend on the observable cadence."""
    return draw_words(generator_from_state(gen.get_state()), n)


def generator_from_state(state: torch.Tensor) -> torch.Generator:
    """A CPU generator continuing from ``gen.get_state()`` (a uint8
    tensor, as checkpoints store it)."""
    gen = torch.Generator(device="cpu")
    gen.set_state(torch.as_tensor(state, dtype=torch.uint8).cpu())
    return gen
