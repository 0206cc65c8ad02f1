"""Fused collide-stream step K = collide∘stream — the hot path of the port.

Between steps the state is kept in POST-COLLIDE space: a post-collide
state labeled ``step == k`` streams to the standard post-stream state of
step k, and one K (pull stream, then the step-k collide with the noise
keyed by (word_k, k)) advances it to label k + 1.

:func:`fused_stream_collide` launches the hand-written CUDA kernel
``csrc/fused_step.cu`` on CUDA tensors and runs its plain PyTorch version
:func:`k_step_reference` on CPU tensors.  The kernel covers the main
path's mode: alpha0 = alpha1 = 0, tau_f = tau_g = 1/2, kBT = 0 or the
hash stream with u8 deviates.

The noise bits are those of the JAX package's coordinate-keyed hash
stream (``bflbm_tpu/kernels/fused_step.py:hash_words``): two rounds of
the lowbias32 mixer keyed as

    h1 = mix(cell ^ word)                      (once per cell)
    h2 = mix(h1 + (step*64 + draw) * GOLDEN)   (per draw)

with cell = (x*Y + y)*Z + z, all in uint32 arithmetic.  CPU torch has no
uint32 shifts, so the plain version emulates it in int64, masking to 32
bits after every operation and splitting each 32x32 product into 16-bit
halves so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LBMParams
from ..lattice import B, CS2, Q
from ..ops import collide as collide_ops
from ..ops import hydro as hydro_ops
from ..ops import noise as noise_ops
from ..ops import stream as stream_ops
from ..state import SimState, draw_words

# ---------------------------------------------------------------------------
# Coordinate-keyed counter RNG (bit-exact to the JAX package's hash_words).
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_DRAW_STRIDE = 64

# u8 deviates: each byte of a hash word, standardized (variance-matched
# uniforms, Ladd's original FLBM noise) — four per word.
_U8_VAR = (65536.0 - 1.0) / 12.0
_U8_SCALE = float(1.0 / np.sqrt(_U8_VAR))
_U8_OFF = float(-127.5 / np.sqrt(_U8_VAR))

# CLT-4 byte-sum normal: the four bytes of a word summed, standardized.
_CLT4_VAR = 4.0 * (65536.0 - 1.0) / 12.0
_CLT4_SCALE = float(1.0 / np.sqrt(_CLT4_VAR))
_CLT4_OFF = float(-510.0 / np.sqrt(_CLT4_VAR))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): 16-bit halves of c keep
    every partial product below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (Wellons) on int64-held uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_words(word: int, step: int, shape, ndraws: int,
               device=None) -> List[torch.Tensor]:
    """ndraws uint32 hash words on the (X, Y, Z) domain, as int64 tensors
    in [0, 2^32).  word: int32 per-step word (negative allowed); step:
    the step label."""
    X, Y, Z = (int(s) for s in shape)
    cell = torch.arange(X * Y * Z, dtype=torch.int64,
                        device=device).reshape(X, Y, Z) & _MASK
    h1 = _mix32(cell ^ (int(word) & _MASK))
    sbase = int(step) * _DRAW_STRIDE
    return [_mix32((h1 + (((sbase + a) * _GOLDEN) & _MASK)) & _MASK)
            for a in range(ndraws)]


def u8_quad(w: torch.Tensor, dtype) -> List[torch.Tensor]:
    """Hash word -> 4 standardized byte-uniform deviates."""
    return [((w >> sh) & 0xFF).to(dtype) * _U8_SCALE + _U8_OFF
            for sh in (0, 8, 16, 24)]


def clt4_normal(w: torch.Tensor, dtype) -> torch.Tensor:
    """Hash word -> standardized byte-sum normal (SWAR pairwise sum)."""
    t = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)
    s = (t & 0xFFFF) + (t >> 16)
    return s.to(dtype) * _CLT4_SCALE + _CLT4_OFF


# ---------------------------------------------------------------------------
# One K step: plain version and kernel wrapper.
# ---------------------------------------------------------------------------

def k_step_reference(f: torch.Tensor, g: torch.Tensor, word: int, step: int,
                     params: LBMParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K = collide∘stream of a post-collide state:
    stream -> hydrovars_bar -> hash-u8 noise (word, step) -> hydrovars ->
    collide."""
    fs = stream_ops.stream(f)
    gs = stream_ops.stream(g)
    hbar = hydro_ops.hydrovars_bar(fs, gs, params)
    xi_f, xi_g = noise_ops.thermal_noise_hash(word, step, hbar.rho, hbar.phi,
                                              params)
    h = hydro_ops.hydrovars(fs, gs, xi_f, xi_g, params, hbar)
    return collide_ops.collide(fs, gs, h, xi_f, xi_g, params)


# Kernel launches made by fused_stream_collide (CUDA tensors only).
launches = 0


def unsupported_reason(params: LBMParams) -> Optional[str]:
    """Why the CUDA kernel cannot run this configuration, or None."""
    if params.alpha0 != 0.0 or params.alpha1 != 0.0:
        return ("alpha0/alpha1 != 0 needs the coupled kernel "
                "(ROADMAP Queue 1 items 8-9, K1b/K1c)")
    if params.tau_f != 0.5 or params.tau_g != 0.5:
        return "tau != 1/2 needs the general-tau kernel (ROADMAP K1d)"
    if params.use_sc_pseudo:
        return "the pseudopotential enters only the coupled kernel (K1b)"
    return None


@functools.lru_cache(maxsize=16)
def _noise_coef(kBT: float, lam_f: float, lam_g: float) -> Tuple[float, ...]:
    """[pref_mom, cf(a=4..18), cg(a=4..18), u8 scale, u8 offset]."""
    pref_f = 2.0 * (lam_f - 0.5 * lam_f * lam_f) * kBT
    pref_g = 2.0 * (lam_g - 0.5 * lam_g * lam_g) * kBT
    cf = [float(np.sqrt(pref_f / CS2 * B[a])) for a in range(4, Q)]
    cg = [float(np.sqrt(pref_g / CS2 * B[a])) for a in range(4, Q)]
    return tuple([pref_f] + cf + cg + [_U8_SCALE, _U8_OFF])


def _as_i32(v: int) -> int:
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _check_pops(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, f on {like.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.shape != like.shape or t.dim() != 4 or t.shape[0] != Q:
        raise ValueError(f"{name} must have shape (19, X, Y, Z) like f, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


Pair = Tuple[torch.Tensor, torch.Tensor]


def fused_stream_collide(f: torch.Tensor, g: torch.Tensor, word: int,
                         step: int, params: LBMParams,
                         out: Optional[Pair] = None) -> Pair:
    """One K step of the post-collide pair (f, g) with noise word `word`
    at step label `step`; returns the new pair (written into `out` when
    given — it must not alias f or g: the pull reads neighbours).

    CPU tensors run :func:`k_step_reference`.  CUDA tensors launch the
    CUDA kernel, or raise: NotImplementedError for a configuration the
    kernel does not cover, RuntimeError for a failed build or launch.
    """
    global launches
    if g.device != f.device:
        raise ValueError(f"g is on {g.device}, f on {f.device}")
    if f.device.type == "cpu":
        fo, go = k_step_reference(f, g, word, step, params)
        if out is None:
            return fo, go
        out[0].copy_(fo)
        out[1].copy_(go)
        return out
    if f.device.type != "cuda":
        raise ValueError(f"no K-step path for device {f.device}")
    reason = unsupported_reason(params)
    if reason is not None:
        raise NotImplementedError(reason)
    _check_pops("f", f, f)
    _check_pops("g", g, f)
    if out is None:
        out = (torch.empty_like(f), torch.empty_like(g))
    for name, t in zip(("out[0]", "out[1]"), out):
        _check_pops(name, t, f)
        if t.data_ptr() in (f.data_ptr(), g.data_ptr()):
            raise ValueError(f"{name} aliases an input: the pull stream "
                             "cannot run in place")
    X, Y, Z = (int(s) for s in f.shape[1:])
    if X > 65535 or Y > 65535:
        raise ValueError(f"X and Y must be <= 65535 (grid limits), got "
                         f"{(X, Y)}")
    from . import _build

    lib = _build.load(f.device)
    coef = (ctypes.c_float * 33)(*_noise_coef(
        float(params.kBT), params.lam_f, params.lam_g))
    rc = lib.bflbm_fused_step(
        f.device.index, f.data_ptr(), g.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), X, Y, Z,
        _as_i32(word), _as_i32(step), params.div_eps,
        0.5 * params.lam_f, 0.5 * params.lam_g, int(params.noise_on), coef,
        torch.cuda.current_stream(f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_step kernel launch failed: "
                           + lib.bflbm_error_string(rc).decode())
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Mass restore and the K-step loop.
# ---------------------------------------------------------------------------

def mass_restore_step(st: SimState, m0f, m0g) -> SimState:
    """Global exact-mass restore, IN PLACE: pin the stored total masses
    back to the invariants (m0f, m0g) captured at session entry by
    spreading the pure-rounding defect uniformly over the rest
    population.  Sums are taken in float64."""
    ncf = float(np.prod(st.shape))
    st.f[0] += ((m0f - st.f.sum(dtype=torch.float64)) / ncf).to(st.f.dtype)
    st.g[0] += ((m0g - st.g.sum(dtype=torch.float64)) / ncf).to(st.g.dtype)
    return st


def _maybe_restore(prev_step: int, st: SimState, mass_restore) -> SimState:
    """Apply mass_restore_step when [prev_step, st.step) crossed a
    multiple of the restore interval."""
    if mass_restore is None:
        return st
    interval, m0f, m0g = mass_restore
    if st.step // interval > prev_step // interval:
        return mass_restore_step(st, m0f, m0g)
    return st


def make_ksteps(params: LBMParams, n: int, mass_restore=None):
    """fn(s, words=None) -> s: n K steps of a post-collide SimState, one
    launch per step (block 1), ping-ponging two buffer pairs.

    The input's buffers are reused as the second pair, so `s` is
    consumed.  words: the n per-step noise words (default: drawn from
    s.gen).  mass_restore: optional (interval, m0f, m0g)."""

    def run_k(s: SimState, words: Optional[Sequence[int]] = None) -> SimState:
        if words is None:
            words = draw_words(s.gen, n)
        if len(words) != n:
            raise ValueError(f"need {n} words, got {len(words)}")
        cur = s
        spare = None
        for w in words:
            if spare is None:
                spare = (torch.empty_like(cur.f), torch.empty_like(cur.g))
            fo, go = fused_stream_collide(cur.f, cur.g, w, cur.step, params,
                                          out=spare)
            spare = (cur.f, cur.g)
            nxt = cur.replace(f=fo, g=go, step=cur.step + 1)
            cur = _maybe_restore(cur.step, nxt, mass_restore)
        return cur

    return run_k

