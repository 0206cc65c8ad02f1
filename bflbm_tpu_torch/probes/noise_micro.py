"""The noise-generator probe of ``benchmarks/tpu_noise_micro.py``, on the
card.

:func:`run_case` writes, for every cell of an (X, Y, Z) float32 output,
the sum of the 34 draws of one generator case (``csrc/probe_noise.cu``),
the counterpart of the TPU probe's ``run_case`` (:276-318) and its
``CASES`` (:260-273).  The domain is cut in (8, 32) tiles; tile (i, j)
keys its cells with word = seed[0] + 7919 i + 104729 j and step = seed[1],
and cell (x, y, z) with the index of its place in the tile's phase-0
region, as the TPU's ``_cellwords`` did: ix = x - 8 i + 2, iy = y - 32 j
+ 2, cell = (ix Y + iy) Z + z, all in uint32 with wrap.  The TPU kernel
computed the whole (12, 36, Z) region and wrote its interior; the port
computes each cell once.

The cases (:data:`CASES`) are the TPU probe's hash cases and, where it
drew the TPU's hardware bits (``hw``, ``hw_bits_only``, ``clt4_hw``), a
counter-based Philox4x32-10 (Salmon et al., SC'11) with key (word, step)
and counter (cell, draw // 4, 0, 0): ``philox``, ``philox_bits_only``,
``clt4_philox``.

The plain versions hold uint32 words in int64 tensors on any device
(:func:`case_sum` on index grids, :func:`run_case_reference` on a
domain).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..kernels.fused_step import (_CLT4_OFF, _CLT4_SCALE, _TWO_PI, _mix32,
                                  _mul32, _raise_on, clt4_normal,
                                  hash_uniform)
from . import _lib

CASES = ("hash_cur", "hash_uniform_only", "hash_u16", "hash_1mul24",
         "hash_1mul16", "hash_nomul", "clt4_hash", "clt4_hash_1mul",
         "clt4_hash_nomul", "philox", "philox_bits_only", "clt4_philox")
PHILOX_CASES = ("philox", "philox_bits_only", "clt4_philox")
TILE = (8, 32)        # the TPU probe's (BX, BY)
PAD = 2               # its phase-0 ring
NPAIR = 17
NDRAWS = 2 * NPAIR
SEED = (12345, 7)     # the TPU probe's seed
NCALLS = 6            # calls a timed run, the k-th with seed + k
TOL = 2e-5            # sums of 34 draws: transcendentals, FMA

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_DRAW_STRIDE = 64
# The TPU probe's CLT-4 byte sum (its _clt4), standardized.
_CLT4_STD = float(np.sqrt(4 * (65536.0 - 1.0) / 12.0) / 256.0)
CLT4_SCALE = 1.0 / (256.0 * _CLT4_STD)
CLT4_OFF = -510.0 / (256.0 * _CLT4_STD)
# Philox4x32-10: round multipliers and key increments.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# Operations a cell, as (integer, float) pairs, counted in the SASS of
# csrc/probe_noise.cu by tools/noise_ops.py (NVIDIA H100 80GB HBM3,
# sm_90a; its output pasted here): integer = the ALU pipe's instructions
# (LOP3, SHF, IADD3, LEA, ...), 64 a clock an SM; float = the FMA pipe's
# (FFMA, FADD, FMUL and the integer multiplies IMAD), two operations each
# against the float32 rate of 256 a clock an SM.  What is counted is the
# fast path of an in-range cell: the straight-line cases whole, the
# Box-Muller ones with the branch-free logf and the fast paths of
# sincosf and sqrtf of every pair (their slow paths never taken).
OPS = {
    "hash_cur": (402, 388),
    "hash_uniform_only": (266, 320),
    "hash_u16": (274, 1710),
    "hash_1mul24": (329, 1712),
    "hash_1mul16": (232, 1676),
    "hash_nomul": (375, 1634),
    "clt4_hash": (436, 388),
    "clt4_hash_1mul": (402, 320),
    "clt4_hash_nomul": (572, 252),
    "philox": (334, 2086),
    "philox_bits_only": (199, 462),
    "clt4_philox": (403, 528),
}

# Kernel launches by case: "noise <case>".
launches: Dict[str, int] = {}


def reset_launch_counts() -> None:
    launches.clear()


# -- the plain arithmetic on int64-held uint32 words ----------------------

def _mix32_1mul(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    return x ^ (x >> 15)


def _arx(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """One add-rotate-xor round: x + rotl(x, k), then x ^ (x >> s)."""
    x = (x + (((x << k) & _MASK) | (x >> (32 - k)))) & _MASK
    return x ^ (x >> s)


def _count(step: int, a: int) -> int:
    """The counter word of draw a at `step`: (step * 64 + a) * GOLDEN."""
    return ((step * _DRAW_STRIDE + a) * _GOLDEN) & _MASK


def _u24(w: torch.Tensor) -> torch.Tensor:
    """Top 24 bits over 2^24, no half step."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _u16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32) * (1.0 / 65536.0) + (0.5 / 65536.0)


def _bm(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """The TPU probe's Box-Muller term r (cos th + sin th)."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = _TWO_PI * u2
    return r * (torch.cos(th) + torch.sin(th))


def _clt4(w: torch.Tensor) -> torch.Tensor:
    """The TPU probe's CLT-4 normal: the four bytes of w summed."""
    s = (w & 0xFF) + ((w >> 8) & 0xFF) + ((w >> 16) & 0xFF) + (w >> 24)
    return s.to(torch.float32) * CLT4_SCALE + CLT4_OFF


def _fold(terms) -> torch.Tensor:
    """terms[0] + terms[1] + ..., left to right."""
    it = iter(terms)
    acc = next(it)
    for t in it:
        acc = acc + t
    return acc


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a * b) mod 2^32 and (a * b) >> 32 for a 32-bit constant a and int64
    b in [0, 2^32): 16-bit halves of a keep every partial product below
    2^49."""
    t = b * (a >> 16)
    mid = ((t & 0xFFFF) << 16) + b * (a & 0xFFFF)
    return mid & _MASK, (t >> 16) + (mid >> 32)


def philox4x32(counter: Sequence, key: Sequence) -> List[torch.Tensor]:
    """Philox4x32-10 of the four counter words under the two key words
    (int64-held uint32 tensors or ints); four words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _MASK
                      for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & _MASK for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK
            k1 = (k1 + _PHILOX_W[1]) & _MASK
        lo0, hi0 = _mulhilo(_PHILOX_M[0], c0)
        lo1, hi1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def philox_words(cell: torch.Tensor, word, step: int) -> List[torch.Tensor]:
    """The Philox words of the 34 draws at each cell: draw a is word a % 4
    of the block with counter (cell, a // 4, 0, 0), key (word, step)."""
    zero = torch.zeros((), dtype=torch.int64, device=cell.device)
    words: List[torch.Tensor] = []
    for b in range((NDRAWS + 3) // 4):
        words += philox4x32((cell, zero + b, zero, zero),
                            (torch.as_tensor(word, device=cell.device),
                             zero + step))
    return words[:NDRAWS]


def _arx3(x: torch.Tensor) -> torch.Tensor:
    return _arx(_arx(_arx(x, 13, 9), 17, 9), 7, 9)


def _arx4(x: torch.Tensor) -> torch.Tensor:
    return _arx(_arx(_arx(_arx(x, 13, 7), 17, 7), 5, 7), 11, 7)


# The second-stage mixer of each hash case, and the cases that draw one
# word a Box-Muller pair (split into two 16-bit uniforms).
_MIXERS = {"hash_cur": _mix32, "hash_uniform_only": _mix32,
           "hash_u16": _mix32, "clt4_hash": _mix32,
           "hash_1mul24": _mix32_1mul, "hash_1mul16": _mix32_1mul,
           "clt4_hash_1mul": _mix32_1mul, "hash_nomul": _arx4,
           "clt4_hash_nomul": _arx3}
_WORD_A_PAIR = ("hash_u16", "hash_1mul16", "hash_nomul")


def case_words(case: str, cell: torch.Tensor, word,
               step: int) -> List[torch.Tensor]:
    """The uint32 words (int64-held) one case consumes at each cell, in
    order: one a draw (34), or one a Box-Muller pair (17) for the cases
    that split a word into two 16-bit uniforms.  cell: int64 tensor of
    uint32 cell keys; word: int or int64 tensor (broadcast against cell)
    of int32 words; step: the int32 step."""
    if case not in CASES:
        raise ValueError(f"unknown noise case {case!r}; one of {CASES}")
    if case in PHILOX_CASES:
        return philox_words(cell, word, step)
    word = torch.as_tensor(word, dtype=torch.int64, device=cell.device)
    h1 = _mix32((cell ^ word) & _MASK)
    n = NPAIR if case in _WORD_A_PAIR else NDRAWS
    mix = _MIXERS[case]
    return [mix((h1 + _count(int(step), a)) & _MASK) for a in range(n)]


def case_sum(case: str, cell: torch.Tensor, word, step: int) -> torch.Tensor:
    """Plain version of one case: the float32 sum of its 34 draws at each
    cell (arguments as :func:`case_words`)."""
    ws = case_words(case, cell, word, step)
    if case == "philox":
        u = [_u24(w) for w in ws]
        return _fold(_bm(u[p] + (0.5 / (1 << 24)), u[NPAIR + p])
                     for p in range(NPAIR))
    if case == "philox_bits_only":
        return _fold(_u24(w) for w in ws)
    if case in ("clt4_philox", "clt4_hash", "clt4_hash_1mul",
                "clt4_hash_nomul"):
        return _fold(_clt4(w) for w in ws)
    if case == "hash_cur":
        n = [clt4_normal(w, torch.float32) for w in ws]
        return _fold(n[0::2]) + _fold(n[1::2])
    if case == "hash_uniform_only":
        return _fold(hash_uniform(w, torch.float32) for w in ws)
    if case == "hash_1mul24":
        u = [_u24(w) + (0.5 / (1 << 24)) for w in ws]
        return _fold(_bm(u[2 * p], u[2 * p + 1]) for p in range(NPAIR))
    return _fold(_bm(_u16(w & 0xFFFF), _u16(w >> 16)) for w in ws)


def tile_of(shape) -> Tuple[int, int]:
    """The (8, 32) tile, each side cut to the domain's where it is
    smaller (small CPU shapes)."""
    bx, by = min(TILE[0], shape[0]), min(TILE[1], shape[1])
    if shape[0] % bx or shape[1] % by:
        raise ValueError(f"the tile ({bx}, {by}) must divide the domain's "
                         f"(X, Y) = {tuple(shape[:2])}")
    return bx, by


def run_case_reference(case: str, seed: Tuple[int, int], shape,
                       device=None) -> torch.Tensor:
    """Plain version of :func:`run_case` on an (X, Y, Z) domain: every
    cell keyed by its tile and its place in the tile's phase-0 region."""
    X, Y, Z = (int(s) for s in shape)
    bx, by = tile_of((X, Y, Z))
    x = torch.arange(X, dtype=torch.int64, device=device)[:, None, None]
    y = torch.arange(Y, dtype=torch.int64, device=device)[None, :, None]
    z = torch.arange(Z, dtype=torch.int64, device=device)[None, None, :]
    i, j = x // bx, y // by
    word = (int(seed[0]) + 7919 * i + 104729 * j) & _MASK
    cell = (((x - bx * i + PAD) * Y + (y - by * j + PAD)) * Z + z) & _MASK
    return case_sum(case, cell, word, int(seed[1]))


def run_case(case: str, seed: Tuple[int, int],
             out: torch.Tensor) -> torch.Tensor:
    """Case `case`'s 34-draw sum at every cell of `out`, an (X, Y, Z)
    float32 tensor, with seed (word, step) as int32s
    (``csrc/probe_noise.cu``).

    A CPU `out` gets :func:`run_case_reference`.  A CUDA one is written by
    the kernel, or the call raises."""
    if case not in CASES:
        raise ValueError(f"unknown noise case {case!r}; one of {CASES}")
    if out.dtype != torch.float32 or out.dim() != 3 or \
            not out.is_contiguous():
        raise ValueError("out must be a contiguous (X, Y, Z) float32 tensor")
    bx, by = tile_of(out.shape)
    s0, s1 = (int(np.int64(s).astype(np.int32)) for s in seed)
    if out.device.type == "cpu":
        return out.copy_(run_case_reference(case, (s0, s1), out.shape))
    if out.device.type != "cuda":
        raise ValueError(f"no noise probe for device {out.device}")
    X, Y, Z = out.shape
    if X > 65535 or Y > 65535:
        raise ValueError("the noise probe's grid takes X, Y <= 65535")
    lib = _build.load("probe_noise", out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.bflbm_probe_noise(out.device.index, out.data_ptr(), X, Y, Z,
                               bx, by, s0, s1, CASES.index(case),
                               _CLT4_SCALE, _CLT4_OFF, CLT4_SCALE, CLT4_OFF,
                               stream)
    _raise_on(rc, lib, f"probe_noise ({case})")
    key = f"noise {case}"
    launches[key] = launches.get(key, 0) + 1
    return out


def probe_noise(device: torch.device, shape,
                cases: Optional[Sequence[str]] = None) -> List[dict]:
    """Each case timed over NCALLS calls (the k-th with seed + k, as the
    TPU probe's loop) and held against its plain version at the last
    seed: ns an output cell."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    cells = out.numel()
    records = []
    for case in cases or CASES:
        def calls(case=case):
            for k in range(NCALLS):
                run_case(case, (SEED[0] + k, SEED[1] + k), out)

        ms = _lib.timed(device, calls, calls=NCALLS)
        last = (SEED[0] + NCALLS - 1, SEED[1] + NCALLS - 1)
        out.fill_(float("nan"))
        run_case(case, last, out)
        want = []

        def plain(case=case):   # once: the plain version is no yardstick
            want[:] = [run_case_reference(case, last, shape, device=device)]

        plain_ms = _lib.timed(device, plain, warmup=0, repeats=1)
        if not want:
            plain()
        err = _lib.max_abs_err(out, want[0])
        records.append(dict(
            probe="noise", name=f"noise {case}", key=f"noise {case}",
            cells=cells, bytes=4 * cells, ms=ms,
            ns_per_cell=None if ms is None else ms / cells * 1e6,
            plain_ms=plain_ms, library_ms=None, max_abs_err=err,
            bitwise=torch.equal(out, want[0]),
            mean=float(out.double().mean()), ok=bool(err <= TOL)))
    return records
