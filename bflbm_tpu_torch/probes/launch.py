"""The launch-overhead probe of ``benchmarks/tpu_overlap_r5.py:78-111``
(``launch_micro``), on the card.

:func:`add_one` is y = x + 1 on an (8, 128) float32 tile
(``csrc/probe_launch.cu``), the counterpart of ``launch_micro.one`` (the
pl.pallas_call at :87).  :func:`probe_launch` chains :data:`N_LAUNCHES`
launches two ways: eagerly, through the wrapper, the path the port's
Python loops pay; and replayed from a ``torch.cuda.CUDAGraph`` captured
once, the counterpart of the TPU's launches under one compiled ``scan``.
From x = 0 the chain ends at exactly 400 both ways, bitwise the plain
chain of 400 float32 adds.  The yardstick is ``torch.add(x, 1, out=y)``,
eager and in a graph.  The graphs here are measurement only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..kernels import _build
from ..kernels.fused_step import _raise_on
from . import _lib

SHAPE = (8, 128)
N_LAUNCHES = 400

# Kernel launches: "launch".  A launch captured into a graph counts once,
# when it is captured; the graph's replays are not counted.
launches: Dict[str, int] = {}


def reset_launch_counts() -> None:
    launches.clear()


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`add_one`."""
    return x + 1.0


def add_one(x: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """out = x + 1 for a contiguous float32 x of at most 1024 elements,
    into `out` (allocated when None; it must not alias x).

    CPU tensors run :func:`add_one_reference`.  CUDA tensors launch the
    kernel or raise."""
    if x.dtype != torch.float32 or not x.is_contiguous() or \
            not 0 < x.numel() <= 1024:
        raise ValueError("x must be a contiguous float32 tensor of 1 to "
                         "1024 elements")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor like x")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not alias x")
    if x.device.type == "cpu":
        return out.copy_(add_one_reference(x))
    if x.device.type != "cuda":
        raise ValueError(f"no launch probe for device {x.device}")
    lib = _build.load("probe_launch", x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.bflbm_probe_add_one(x.device.index, x.data_ptr(), out.data_ptr(),
                                 x.numel(), stream)
    _raise_on(rc, lib, "probe_launch")
    launches["launch"] = launches.get("launch", 0) + 1
    return out


def chain(step: Callable[[torch.Tensor, torch.Tensor], object],
          a: torch.Tensor, b: torch.Tensor, n: int = N_LAUNCHES
          ) -> torch.Tensor:
    """n steps b = step(a), ping-ponging between a and b; the buffer that
    holds the last result (a for even n)."""
    for _ in range(n):
        step(a, b)
        a, b = b, a
    return a


def _graph(step, a, b) -> torch.cuda.CUDAGraph:
    """The chain of N_LAUNCHES steps captured once."""
    chain(step, a, b, 2)    # warm up (module loading) outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(step, a, b)
    return graph


def probe_launch(device: torch.device) -> List[dict]:
    """The 400-launch chain from zeros, eager and replayed from a graph,
    against the plain chain bitwise; ms a launch each way and the same for
    ``torch.add(x, 1, out=y)``."""
    a = torch.zeros(SHAPE, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    want = a
    for _ in range(N_LAUNCHES):
        want = add_one_reference(want)

    def kernel(x, y):
        add_one(x, out=y)

    def library(x, y):
        torch.add(x, 1, out=y)

    a.zero_()
    eager = chain(kernel, a, b)
    ok = torch.equal(eager, want)
    err = _lib.max_abs_err(eager, want)
    rec = dict(probe="launch", name="launch add_one", key="launch",
               cells=a.numel(), bytes=2 * a.nbytes, bitwise_eager=ok,
               library_ms=None, library_eager_ms=None, eager_ms=None,
               ms=None, plain_ms=None)
    if device.type == "cuda":
        graph = _graph(kernel, a, b)
        a.zero_()
        graph.replay()
        rec["bitwise_graph"] = torch.equal(a, want)
        err = max(err, _lib.max_abs_err(a, want))
        ok = ok and rec["bitwise_graph"]
        rec["eager_ms"] = _lib.timed(device, lambda: chain(kernel, a, b),
                                     calls=N_LAUNCHES)
        rec["ms"] = _lib.timed(device, graph.replay, calls=N_LAUNCHES)
        lib_graph = _graph(library, a, b)
        rec["library_eager_ms"] = _lib.timed(
            device, lambda: chain(library, a, b), calls=N_LAUNCHES)
        rec["library_ms"] = _lib.timed(device, lib_graph.replay,
                                       calls=N_LAUNCHES)

        def plain():
            x = a
            for _ in range(N_LAUNCHES):
                x = add_one_reference(x)

        rec["plain_ms"] = _lib.timed(device, plain, calls=N_LAUNCHES)
    rec.update(max_abs_err=err, bitwise=ok, ok=ok)
    return [rec]
