"""Fused collide-stream step K = collide∘stream — the hot path of the port.

Between steps the state is kept in POST-COLLIDE space: a post-collide
state labeled ``step == k`` streams to the standard post-stream state of
step k, and one K (pull stream, then the step-k collide with the noise
keyed by (word_k, k)) advances it to label k + 1.

:func:`fused_stream_collide` launches the hand-written CUDA kernels on
CUDA tensors and runs their plain PyTorch versions on CPU tensors.  The
kernels cover every configuration the JAX kernel takes at block 1:
exact (tau_f = tau_g = 1/2) or general relaxation, kBT = 0 or the hash
stream with u8, clt4, clt2 or Box-Muller deviates, noise amplitudes from
the live densities or from a stored reference state (USE_REF_STATE, the
``ref`` operand), and the forces of alpha0 and alpha1:

- uncoupled (alpha0 = alpha1 = 0): one launch of ``csrc/fused_step.cu``
  (:func:`launch_k`, plain version :func:`k_step_reference`);
- coupled (alpha0 != 0): the density pre-pass ``csrc/density_psi.cu``
  (:func:`density_psi`, plain version :func:`density_psi_reference`)
  writes psi of the streamed densities, then the K kernel reads its
  neighbours' psi for the Shan-Chen force;
- alpha1 != 0 (K1c, stencil depth 3): the density pre-pass, then the
  laplacian pre-pass ``csrc/laplacian_psi.cu`` (:func:`laplacian_psi`,
  plain version :func:`laplacian_psi_reference`) writes the laplacian of
  psi, then the K kernel takes its neighbours' gradient for the
  square-gradient force.

:func:`blocked_stream_collide` runs T steps in one launch (K4, temporal
blocking) of ``csrc/blocked_step.cu`` in every configuration, the
intermediate steps kept in shared memory and, with a force, psi and its
laplacian recomputed inside every step from its own input, with no
pre-pass (plain version
:func:`bflbm_tpu_torch.ops.blocked.blocked_sweep_reference`, on any
tiling), on the whole domain or, with ``ext=``, on a halo-extended block
whose pads are sd T deep (the kernel's EXT mode, JAX's sharded sweep at
block T), there also on a window of the interior (the overlap split) or
fed by y strips (the strips exchange); :func:`make_ksteps` takes
``block=T``; the sessions take T = 1 unless given another (on an H100
the one-step kernels run the fastest step in every mode, PERF.md section
6).

Each of the one-step wrappers also takes ``ext=``, an
:class:`~bflbm_tpu_torch.ops.blocked.Ext` (K7's ext mode): the arrays are
then one block of a decomposed domain, extended by pads of depth p on its
sharded axes that the halo exchange has filled (:mod:`bflbm_tpu_torch.parallel.halo`).  A writes psi
on the interior and p - 1 cells beyond it, L the laplacian p - 2 cells
beyond, and K the interior, into arrays of the same padded layout; the
plain versions run :mod:`bflbm_tpu_torch.ops.blocked`.  Every launch
passes its geometry (extents and ``csrc/common.cuh`` Region); one whose
region is not the whole domain runs the kernels' EXT instantiation.
Two more of K7's modes ride on it:

- ``window=`` (the JAX kernel's ``win`` / ``odomain`` / ``owin`` /
  ``out_alias``): a box of the block inside the region a launch writes;
  only its cells are written, in place in the one padded output, the
  rest is left as it was.  The overlap split
  (:mod:`bflbm_tpu_torch.parallel.kernel`) launches the interior's
  window under the halo exchange and the seam bands after it;
- ``strips=`` / ``strips_out=`` (``ystrips``): on a y-sharded block A
  and K read the y halo from compact received strips instead of the y
  pads, and K writes its first and last interior rows a second time
  into the strips the exchange ships whole
  (:func:`bflbm_tpu_torch.parallel.halo.strip_plan`).

The noise bits are those of the JAX package's coordinate-keyed hash
stream (``bflbm_tpu/kernels/fused_step.py:hash_words``): two rounds of
the lowbias32 mixer keyed as

    h1 = mix(cell ^ word)                      (once per cell)
    h2 = mix(h1 + (step*64 + draw) * GOLDEN)   (per draw)

with cell = (gx*GY + gy)*GZ + gz over the global coordinates and extents
(a block's cells are keyed where they lie in the whole domain), all in
uint32 arithmetic.  CPU torch has no uint32 shifts, so the plain version
emulates it in int64, masking to 32 bits after every operation and
splitting each 32x32 product into 16-bit halves so that no intermediate
leaves the int64 range.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LBMParams
from ..lattice import B, CS2, Q
from ..ops import blocked
from ..ops import collide as collide_ops
from ..ops import hydro as hydro_ops
from ..ops import moments as moments_ops
from ..ops import noise as noise_ops
from ..ops import stencil as stencil_ops
from ..ops import stream as stream_ops
from ..ops.blocked import Box, Ext, sd_depth
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

# CLT-2 byte-pair normal: each 16-bit half of a word summed as two bytes,
# standardized — two per word.
_CLT2_VAR = 2.0 * (65536.0 - 1.0) / 12.0
_CLT2_SCALE = float(1.0 / np.sqrt(_CLT2_VAR))
_CLT2_OFF = float(-255.0 / np.sqrt(_CLT2_VAR))

# Box-Muller over hash uniforms (h >> 8) 2^-24 + 2^-25, strictly in (0, 1).
_NPAIR = 17       # 34 uniforms -> 34 normals, of which 33 are used
_TWO_PI = 6.283185307179586

# The generators the kernel runs: name -> (kernel code, scale, offset);
# Box-Muller needs no scale.
NOISE_DISTS = {"u8": (0, _U8_SCALE, _U8_OFF),
               "clt4": (1, _CLT4_SCALE, _CLT4_OFF),
               "clt2": (2, _CLT2_SCALE, _CLT2_OFF),
               "bm": (3, 1.0, 0.0)}


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


def hash_word_groups(word: int, step: int, shape, ndraws: int, group: int,
                     device=None, origin=(0, 0, 0), domain=None
                     ) -> Iterator[torch.Tensor]:
    """The uint32 hash words of draws 0 to ndraws - 1 on the (X, Y, Z)
    region at global `origin` of the global `domain` (default: the region
    is the domain), keyed by global coordinates wrapped into the domain,
    as JAX's ``hash_words(word, step, origin, region, domain, ndraws)``:
    (g, X, Y, Z) int64 tensors in [0, 2^32) of `group` consecutive draws
    (the last may hold fewer), the cells keyed once.  word: int32
    per-step word (negative allowed); step: the step label; each an int
    or a 0-dim int64 tensor on `device` (a CUDA graph then reads the key
    from device memory)."""
    domain = tuple(int(s) for s in (shape if domain is None else domain))
    g = [(torch.arange(int(n), dtype=torch.int64, device=device) + int(o))
         % d for n, o, d in zip(shape, origin, domain)]
    cell = ((g[0][:, None, None] * domain[1] + g[1][None, :, None])
            * domain[2] + g[2][None, None, :]) & _MASK
    if not isinstance(word, torch.Tensor):
        word, step = int(word), int(step)
    h1 = _mix32(cell ^ (word & _MASK))
    sbase = step * _DRAW_STRIDE
    for a0 in range(0, ndraws, group):
        a = torch.arange(a0, min(a0 + group, ndraws), dtype=torch.int64,
                         device=device).reshape(-1, 1, 1, 1)
        yield _mix32((h1 + (((sbase + a) * _GOLDEN) & _MASK)) & _MASK)


def hash_words(word: int, step: int, shape, ndraws: int, device=None,
               origin=(0, 0, 0), domain=None) -> List[torch.Tensor]:
    """ndraws uint32 hash words (:func:`hash_word_groups`), one (X, Y, Z)
    int64 tensor each."""
    return [w[0] for w in hash_word_groups(word, step, shape, ndraws, 1,
                                           device, origin, domain)]


def u8_quad(w: torch.Tensor, dtype) -> List[torch.Tensor]:
    """Hash word -> 4 standardized byte-uniform deviates."""
    return [((w >> sh) & 0xFF).to(dtype) * _U8_SCALE + _U8_OFF
            for sh in (0, 8, 16, 24)]


def clt4_normal(w: torch.Tensor, dtype) -> torch.Tensor:
    """Hash word -> standardized byte-sum normal (SWAR pairwise sum)."""
    t = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)
    s = (t & 0xFFFF) + (t >> 16)
    return s.to(dtype) * _CLT4_SCALE + _CLT4_OFF


def clt2_pair(w: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash word -> (lo, hi) standardized byte-pair normals: bytes 0+1
    and 2+3 summed in the two 16-bit halves of one add."""
    t = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)
    return ((t & 0xFFFF).to(dtype) * _CLT2_SCALE + _CLT2_OFF,
            (t >> 16).to(dtype) * _CLT2_SCALE + _CLT2_OFF)


def hash_uniform(w: torch.Tensor, dtype) -> torch.Tensor:
    """Hash word -> U(0, 1) strictly inside (0, 1): the top 24 bits
    scaled by 2^-24, plus half of that step."""
    return (w >> 8).to(dtype) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def bm_pair(u1: torch.Tensor, u2: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-Muller: (r cos th, r sin th) with r = sqrt(-2 log u1) and
    th = 2 pi u2."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = _TWO_PI * u2
    return r * torch.cos(th), r * torch.sin(th)


def check_noise_dist(noise_dist: str) -> None:
    """Raise ValueError for a generator name the port does not know."""
    if noise_dist not in NOISE_DISTS:
        raise ValueError(f"unknown noise_dist={noise_dist!r}; the kernels "
                         f"run {sorted(NOISE_DISTS)}")


# ---------------------------------------------------------------------------
# Plain versions of the kernels.
# ---------------------------------------------------------------------------

def k_step_reference(f: torch.Tensor, g: torch.Tensor, word: int, step: int,
                     params: LBMParams, noise_dist: str = "clt4",
                     ref: Optional[torch.Tensor] = None,
                     ext: Optional[Ext] = None,
                     strips: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K = collide∘stream of a post-collide state:
    stream -> hydrovars_bar -> hash noise (word, step) -> hydrovars (with
    the Shan-Chen force when alpha0 != 0 and the square-gradient force
    when alpha1 != 0) -> collide (exact or general
    relaxation, :func:`general_relax`).  ref: optional (2, X, Y, Z)
    COM-rolled (rho_eq, phi_eq) — the USE_REF_STATE noise amplitudes.
    ext: f, g (and ref) are a halo-extended block
    (:func:`blocked.step_on_block`); the result is its interior.  strips:
    the block's received y strips, read in place of its y pads."""
    check_noise_dist(noise_dist)
    if ext is not None:
        return blocked.step_on_block(*_mounted(f, g, strips), word, step,
                                     params, ext, noise_dist, ref)
    fs = stream_ops.stream(f)
    gs = stream_ops.stream(g)
    hbar = hydro_ops.hydrovars_bar(fs, gs, params)
    ref_state = None if ref is None else (ref[0], ref[1], None)
    xi_f, xi_g = noise_ops.thermal_noise_hash(word, step, hbar.rho, hbar.phi,
                                              params, ref_state, noise_dist)
    h = hydro_ops.hydrovars(fs, gs, xi_f, xi_g, params, hbar)
    return collide_ops.collide(fs, gs, h, xi_f, xi_g, params)


def density_psi_reference(f: torch.Tensor, g: torch.Tensor,
                          params: LBMParams, ext: Optional[Ext] = None,
                          strips: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain density pre-pass: (psi(rho_s), psi(phi_s)) of the streamed
    state, a (2, X, Y, Z) tensor; with ext, on the block's interior and
    p - 1 cells beyond it (:func:`blocked.density_psi_block`), the y halo
    read from `strips` when given."""
    if ext is not None:
        return blocked.density_psi_block(*_mounted(f, g, strips), params,
                                         ext)
    rho = moments_ops.density(stream_ops.stream(f))
    phi = moments_ops.density(stream_ops.stream(g))
    return torch.stack([
        stencil_ops.pseudopotential(n, params.use_sc_pseudo,
                                    params.sc_ref_density)
        for n in (rho, phi)])


def laplacian_psi_reference(psi: torch.Tensor,
                            ext: Optional[Ext] = None) -> torch.Tensor:
    """Plain laplacian pre-pass: the 19-point laplacian of each of the
    (2, X, Y, Z) psi fields (psi is already transformed); with ext, on the
    block's interior and p - 2 cells beyond it from a psi valid p - 1
    cells beyond (:func:`blocked.laplacian_psi_block`)."""
    if ext is not None:
        return blocked.laplacian_psi_block(psi, ext)
    return torch.stack([stencil_ops.laplacian(p) for p in psi])


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

# Launches of the K kernel (launch_k), the density pre-pass (density_psi)
# and the laplacian pre-pass (laplacian_psi), on CUDA tensors only, one per
# block (or window) of a decomposed domain; mode_launches counts the K
# launches by mode: "general" (K1d), "ref" (K1e), "alpha1" (K1c), "ext"
# (K7, on a halo-extended block), "window" (K7's win / owin: a box of the
# block, the overlap split), "ystrips" (K7's ystrips: the y halo from the
# received strips) and, for launches with noise, the generator's name.
# blocked_launches counts the launches of the blocked sweep
# (blocked_stream_collide, T steps each; also mode_launches["blocked"], and
# by mode "blocked ext", "blocked window" and "blocked ystrips").
launches = 0
density_launches = 0
laplacian_launches = 0
blocked_launches = 0
mode_launches: Dict[str, int] = {}


def reset_launch_counts() -> None:
    global launches, density_launches, laplacian_launches, blocked_launches
    launches = 0
    density_launches = 0
    laplacian_launches = 0
    blocked_launches = 0
    mode_launches.clear()


def unsupported_reason(params: LBMParams) -> Optional[str]:
    """Why the CUDA kernels cannot run this configuration, or None.  They
    run every configuration the JAX kernel takes, so this is always
    None."""
    return None


def general_relax(params: LBMParams) -> bool:
    """K relaxes all 19 moments (tau != 1/2, or the test hook
    ``ops.collide.FORCE_GENERAL_RELAX``) instead of the exact-relaxation
    specialization; the plain collide reads the same switch."""
    return (collide_ops.FORCE_GENERAL_RELAX
            or params.tau_f != 0.5 or params.tau_g != 0.5)


def is_coupled(params: LBMParams) -> bool:
    """A force is on (alpha0 or alpha1, the JAX kernel's ``has_force``):
    K needs the density pre-pass."""
    return params.alpha0 != 0.0 or params.alpha1 != 0.0


def has_alpha1(params: LBMParams) -> bool:
    """The square-gradient force is on: K needs the laplacian pre-pass
    too."""
    return params.alpha1 != 0.0


@functools.lru_cache(maxsize=16)
def _noise_coef(kBT: float, lam_f: float, lam_g: float,
                noise_dist: str) -> Tuple[float, ...]:
    """[pref_mom, cf(a=4..18), cg(a=4..18), deviate scale, offset]."""
    pref_f = 2.0 * (lam_f - 0.5 * lam_f * lam_f) * kBT
    pref_g = 2.0 * (lam_g - 0.5 * lam_g * lam_g) * kBT
    cf = [float(np.sqrt(pref_f / CS2 * B[a])) for a in range(4, Q)]
    cg = [float(np.sqrt(pref_g / CS2 * B[a])) for a in range(4, Q)]
    _, scale, off = NOISE_DISTS[noise_dist]
    return tuple([pref_f] + cf + cg + [scale, off])


def _as_i32(v: int) -> int:
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _check_field(name: str, t: torch.Tensor, like: torch.Tensor,
                 lead: int) -> None:
    """t is a contiguous float32 (lead, X, Y, Z) tensor on like's device,
    with like's (X, Y, Z)."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, f on {like.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 4 or t.shape[0] != lead or t.shape[1:] != like.shape[1:]:
        raise ValueError(f"{name} must have shape ({lead}, X, Y, Z) with f's "
                         f"X, Y, Z, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_no_alias(name: str, t: torch.Tensor, inputs) -> None:
    if any(t.data_ptr() == i.data_ptr() for i in inputs):
        raise ValueError(f"{name} aliases an input: the pull stream "
                         "cannot run in place")


def _geom(t: torch.Tensor, ext: Optional[Ext], cut: Optional[int],
          need: int = 1, window: Optional[Box] = None):
    """The launch geometry (extents, ``csrc/common.cuh`` Region, hash keys)
    of arrays shaped like t: {X, Y, Z, x0, y0, z0, nx, ny, nz, ox, oy, oz,
    GY, GZ, GX}.  The region starts `cut` cells inside the pads (None: the
    interior), or is `window`, which must lie inside that region;
    (ox, oy, oz) are the global coordinates of array cell (0, 0, 0) and
    (GY, GZ, GX) the global extents (the one-step kernels read the first
    14 entries).  Raises when the pads are shallower than `need`, the
    cells the launch reaches."""
    shape = tuple(int(s) for s in t.shape[1:])
    if ext is None:
        ext = Ext((0, 0, 0), (0, 0, 0), shape)
    ext.interior(shape)
    if any(0 < p < need for p in ext.pad):
        raise ValueError(f"the launch reaches {need} cells; the pads "
                         f"{ext.pad} are shallower")
    box = ext.bounds(shape, cut)
    if window is not None:
        window = tuple((int(a), int(b)) for a, b in window)
        if not blocked.inside(window, box):
            raise ValueError(f"window {window} is not a non-empty box "
                             f"inside the launch's region {box}")
        box = window
    start = [a for a, _ in box]
    region = [b - a for a, b in box]
    if region[0] > 65535 or region[1] > 65535:
        raise ValueError(f"the region's X and Y must be <= 65535 (grid "
                         f"limits), got {tuple(region[:2])}")
    origin = [o - p for o, p in zip(ext.origin, ext.pad)]
    domain = tuple(int(d) for d in ext.domain)
    geom = shape + tuple(start) + tuple(region) + tuple(origin) \
        + domain[1:] + domain[:1]
    return (ctypes.c_int * 15)(*geom)


def _check_box_args(f: torch.Tensor, ext: Optional[Ext],
                    window: Optional[Box], strips=()) -> None:
    """A window and y strips need a halo-extended block; strips need its
    y pads, and lie on f's device as float32 contiguous (2 sides,
    2 species, Q, X, rows, Z) arrays with rows the y pads' depth."""
    given = [t for t in strips if t is not None]
    if ext is None and (window is not None or given):
        raise ValueError("a window or y strips need ext=, a halo-extended "
                         "block")
    if not given:
        return
    rows = int(ext.pad[1])
    if not rows:
        raise ValueError("y strips need a block with y pads")
    want = (2, 2, Q, int(f.shape[1]), rows, int(f.shape[3]))
    for t in given:
        if t.device != f.device or t.dtype != f.dtype:
            raise ValueError(f"strips on {t.device} as {t.dtype}, f on "
                             f"{f.device} as {f.dtype}")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"strips must be contiguous {want}, got "
                             f"{tuple(t.shape)}")


def _mounted(f: torch.Tensor, g: torch.Tensor,
             strips: Optional[torch.Tensor]) -> Pair:
    """The plain versions' view of a strip-fed block: copies of f, g whose
    y pads hold the received strips."""
    if strips is None:
        return f, g
    return (blocked.mount_strips(f, strips, 0),
            blocked.mount_strips(g, strips, 1))


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.bflbm_error_string(rc).decode())


def _write_region(out: Optional[torch.Tensor], value: torch.Tensor,
                  like: torch.Tensor, lead: int, ext: Ext,
                  cut: Optional[int],
                  window: Optional[Box] = None) -> torch.Tensor:
    """A plain ext result on its region written into `out` (allocated
    like the kernels' arrays, zeroed, when None): the whole region, or
    only the cells of `window`."""
    if out is None:
        out = torch.zeros((lead,) + tuple(like.shape[1:]), dtype=like.dtype,
                          device=like.device)
    if window is None:
        ext.region(out, cut).copy_(value)
        return out
    region = ext.bounds(like.shape, cut)
    if not blocked.inside(window, region):
        raise ValueError(f"window {tuple(window)} is not a non-empty box "
                         f"inside the launch's region {region}")
    rel = tuple((a - s0, b - s0) for (a, b), (s0, _) in zip(window, region))
    blocked.box_view(out, window).copy_(blocked.box_view(value, rel))
    return out


def _write_strips(strips_out: torch.Tensor, fo: torch.Tensor,
                  go: torch.Tensor, ext: Ext, shape) -> None:
    """What K writes into its strips: the first and last `rows` interior
    rows of the plain K's interior result (fo, go), on the interior x and
    z cells of the strips."""
    rows = int(strips_out.shape[-2])
    ny = int(fo.shape[-2])
    (x0, x1), _, (z0, z1) = ext.bounds(shape)
    for s, o in enumerate((fo, go)):
        for side, y0 in ((0, 0), (1, ny - rows)):
            blocked.box_view(strips_out[side, s],
                             ((x0, x1), (0, rows), (z0, z1))).copy_(
                o[..., y0:y0 + rows, :])


def density_psi(f: torch.Tensor, g: torch.Tensor, params: LBMParams,
                out: Optional[torch.Tensor] = None,
                ext: Optional[Ext] = None, *,
                window: Optional[Box] = None,
                strips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """psi of the streamed densities of the post-collide pair (f, g), a
    (2, X, Y, Z) tensor (written into `out` when given; it must not
    alias f or g).  ext: f, g are a halo-extended block; psi is written
    on its interior and p - 1 cells beyond it, the rest of `out` is left
    as it was.  window: a box of the block's arrays (``ops.blocked.Box``)
    inside that region: only its cells are written (K7's ``win`` /
    ``owin``).  strips: the block's received y strips (the strips
    exchange, (2, 2, Q, X, rows, Z)): the y halo is read from them and
    never from the y pads.

    CPU tensors run :func:`density_psi_reference`.  CUDA tensors launch
    ``csrc/density_psi.cu`` or raise."""
    global density_launches
    if g.device != f.device:
        raise ValueError(f"g is on {g.device}, f on {f.device}")
    _check_box_args(f, ext, window, (strips,))
    if f.device.type == "cpu":
        ref = density_psi_reference(f, g, params, ext, strips)
        if ext is not None:
            return _write_region(out, ref, f, 2, ext, 1, window)
        if out is None:
            return ref
        return out.copy_(ref)
    if f.device.type != "cuda":
        raise ValueError(f"no density pre-pass for device {f.device}")
    _check_field("f", f, f, Q)
    _check_field("g", g, f, Q)
    if out is None:
        out = torch.empty((2,) + tuple(f.shape[1:]), dtype=f.dtype,
                          device=f.device)
    _check_field("psi", out, f, 2)
    _check_no_alias("psi", out, (f, g))
    geom = _geom(f, ext, 1, window=window)
    from . import _build

    lib = _build.load("density_psi", f.device)
    rc = lib.bflbm_density_psi(
        f.device.index, f.data_ptr(), g.data_ptr(), out.data_ptr(), geom,
        int(params.use_sc_pseudo), float(params.sc_ref_density),
        None if strips is None else strips.data_ptr(),
        0 if strips is None else int(strips.shape[-2]),
        torch.cuda.current_stream(f.device).cuda_stream)
    _raise_on(rc, lib, "density_psi")
    density_launches += 1
    return out


def laplacian_psi(psi: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  ext: Optional[Ext] = None, *,
                  window: Optional[Box] = None) -> torch.Tensor:
    """The 19-point laplacian of both (2, X, Y, Z) psi fields of the
    density pre-pass, a (2, X, Y, Z) tensor (written into `out` when
    given; it must not alias psi).  ext: psi is a halo-extended block's,
    valid p - 1 cells beyond its interior; the laplacian is written p - 2
    cells beyond it, the rest of `out` is left as it was.  window: a box
    inside that region: only its cells are written.

    CPU tensors run :func:`laplacian_psi_reference`.  CUDA tensors launch
    ``csrc/laplacian_psi.cu`` on :func:`stencil_tile`'s tiles or raise."""
    global laplacian_launches
    _check_box_args(psi, ext, window)
    if psi.device.type == "cpu":
        ref = laplacian_psi_reference(psi, ext)
        if ext is not None:
            return _write_region(out, ref, psi, 2, ext, 2, window)
        if out is None:
            return ref
        return out.copy_(ref)
    if psi.device.type != "cuda":
        raise ValueError(f"no laplacian pre-pass for device {psi.device}")
    _check_field("psi", psi, psi, 2)
    if out is None:
        out = torch.empty_like(psi)
    _check_field("lap", out, psi, 2)
    _check_no_alias("lap", out, (psi,))
    geom = _geom(psi, ext, 2, need=2, window=window)
    from . import _build

    lib = _build.load("laplacian_psi", psi.device)
    rc = lib.bflbm_laplacian_psi(
        psi.device.index, psi.data_ptr(), out.data_ptr(), geom,
        (ctypes.c_int * 3)(*stencil_tile("l")),
        torch.cuda.current_stream(psi.device).cuda_stream)
    _raise_on(rc, lib, "laplacian_psi")
    laplacian_launches += 1
    return out


Pair = Tuple[torch.Tensor, torch.Tensor]


def launch_k(f: torch.Tensor, g: torch.Tensor, word: int, step: int,
             params: LBMParams, out: Pair, psi: Optional[torch.Tensor],
             noise_dist: str = "clt4",
             ref: Optional[torch.Tensor] = None, *,
             lap: Optional[torch.Tensor] = None,
             ext: Optional[Ext] = None,
             window: Optional[Box] = None,
             strips: Optional[torch.Tensor] = None,
             strips_out: Optional[torch.Tensor] = None) -> Pair:
    """Launch the K kernel on CUDA tensors: f, g -> out.  psi: the
    pre-pass output of (f, g) for a coupled configuration, None for an
    uncoupled one.  lap: the laplacian pre-pass output of psi when
    alpha1 != 0, else None.  ref: the (2, X, Y, Z) USE_REF_STATE amplitude
    fields or None (ignored when kBT = 0, as in the JAX kernel).  ext: the
    arrays are a halo-extended block with pads at least sd_depth deep;
    the interior of out is written, its pads are left as they were.
    window: a box inside the interior: only its cells are written.
    strips: the received y strips ((2, 2, Q, X, rows, Z)), read for the
    y halo in place of the y pads; strips_out: strips of the same layout
    into which K also writes its first and last `rows` interior rows (on
    the interior x cells).  The library is the build of ``fused_step.cu``
    for the relaxation (:func:`general_relax`), the force and alpha1; with
    alpha1 its kernel runs on :func:`stencil_tile`'s tiles.  Raises for
    what the kernel does not take."""
    global launches
    check_noise_dist(noise_dist)
    if f.device.type != "cuda":
        raise ValueError(f"the K kernel runs on CUDA tensors, not {f.device}")
    _check_field("f", f, f, Q)
    _check_field("g", g, f, Q)
    for name, t in zip(("out[0]", "out[1]"), out):
        _check_field(name, t, f, Q)
        _check_no_alias(name, t, (f, g))
    if is_coupled(params) != (psi is not None):
        raise ValueError("psi must be given exactly when alpha0 or alpha1 "
                         "!= 0")
    if has_alpha1(params) != (lap is not None):
        raise ValueError("lap must be given exactly when alpha1 != 0")
    for name, t in (("psi", psi), ("lap", lap)):
        if t is not None:
            _check_field(name, t, f, 2)
            _check_no_alias(name, t, (f, g) + tuple(out))
    if ref is not None:
        _check_field("ref", ref, f, 2)
        _check_no_alias("ref", ref, tuple(out))
        if not params.noise_on:
            ref = None
    _check_box_args(f, ext, window, (strips, strips_out))
    if strips_out is not None:
        _check_no_alias("strips_out", strips_out,
                        (f, g) + tuple(t for t in (strips, psi, lap, ref)
                                       if t is not None))
    geom = _geom(f, ext, None, need=sd_depth(params), window=window)
    rows = next((int(t.shape[-2]) for t in (strips, strips_out)
                 if t is not None), 0)
    from . import _build

    lib = _build.load("fused_step" + ("_general" if general_relax(params)
                                      else "")
                      + ("_force" if psi is not None else "")
                      + ("_a1" if lap is not None else ""), f.device)
    coef = (ctypes.c_float * 33)(*_noise_coef(
        float(params.kBT), params.lam_f, params.lam_g, noise_dist))
    rc = lib.bflbm_fused_step(
        f.device.index, f.data_ptr(), g.data_ptr(),
        None if psi is None else psi.data_ptr(),
        None if lap is None else lap.data_ptr(),
        None if ref is None else ref.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), geom,
        _as_i32(word), _as_i32(step), params.div_eps,
        0.5 * params.lam_f, 0.5 * params.lam_g, params.lam_f, params.lam_g,
        int(params.noise_on), NOISE_DISTS[noise_dist][0], coef,
        -CS2 * params.alpha0, CS2 * params.alpha1,
        1.0 / (1.0 + 1.0 / (2.0 * params.tau_f)),
        1.0 / (1.0 + 1.0 / (2.0 * params.tau_g)),
        None if strips is None else strips.data_ptr(),
        None if strips_out is None else strips_out.data_ptr(), rows,
        None if lap is None else (ctypes.c_int * 3)(*stencil_tile("b_a1")),
        torch.cuda.current_stream(f.device).cuda_stream)
    _raise_on(rc, lib, "fused_step")
    launches += 1
    tags = ((["general"] if general_relax(params) else [])
            + (["alpha1"] if lap is not None else [])
            + (["ref"] if ref is not None else [])
            + (["ext"] if ext is not None else [])
            + (["window"] if window is not None else [])
            + (["ystrips"] if strips is not None else [])
            + ([noise_dist] if params.noise_on else []))
    for tag in tags:
        mode_launches[tag] = mode_launches.get(tag, 0) + 1
    return out


def bm_normals(word: int, step: int, shape, device=None) -> torch.Tensor:
    """The (33, X, Y, Z) float32 Box-Muller deviates K draws for noise word
    `word` at step label `step` on the (X, Y, Z) domain, in its draw
    order.  On a CUDA device from ``csrc/fused_step.cu``
    ``bm_normals_kernel`` (the generator of K's Box-Muller mode on its
    own; counted in ``mode_launches["bm normals"]``), on the CPU its plain
    version ``ops.noise.hash_normal_stack(..., "bm")``."""
    dev = torch.device("cuda" if device is None else device)
    shape = tuple(int(n) for n in shape)
    if dev.type != "cuda":
        return noise_ops.hash_normal_stack(word, step, shape, torch.float32,
                                           "bm", device=dev)
    from . import _build

    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty((noise_ops.N_CHANNELS,) + shape, dtype=torch.float32,
                      device=dev)
    lib = _build.load("fused_step", dev)
    rc = lib.bflbm_bm_normals(dev.index, out.data_ptr(),
                              (ctypes.c_int * 3)(*shape), _as_i32(word),
                              _as_i32(step),
                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "bm_normals")
    mode_launches["bm normals"] = mode_launches.get("bm normals", 0) + 1
    return out


def prepass_windows(params: LBMParams, ext: Ext, shape,
                    window: Box) -> Tuple[Box, Box]:
    """The windows of the pre-passes A and L in front of a K window: K's
    grown by sd - 1 and sd - 2 cells (the reach of its psi and lap reads
    and of L's psi reads), inside the regions A and L write.  Raises
    unless the window spans every axis without pads: there the rings
    would wrap around the block."""
    for d, ((a, b), p, n) in enumerate(zip(window, ext.pad,
                                           tuple(shape)[-3:])):
        if not p and (a, b) != (0, int(n)):
            raise ValueError(f"a K window must span axis {d}, which has no "
                             f"pads; got {(a, b)} of {n}")
    sd = sd_depth(params)
    return (blocked.grow(window, sd - 1, ext.bounds(shape, 1)),
            blocked.grow(window, max(sd - 2, 0), ext.bounds(shape, 2)))


def fused_stream_collide(f: torch.Tensor, g: torch.Tensor, word: int,
                         step: int, params: LBMParams,
                         out: Optional[Pair] = None, *,
                         noise_dist: str = "clt4",
                         psi: Optional[torch.Tensor] = None,
                         ref: Optional[torch.Tensor] = None,
                         lap: Optional[torch.Tensor] = None,
                         ext: Optional[Ext] = None,
                         window: Optional[Box] = None,
                         strips: Optional[torch.Tensor] = None,
                         strips_out: Optional[torch.Tensor] = None) -> Pair:
    """One K step of the post-collide pair (f, g) with noise word `word`
    at step label `step`; returns the new pair (written into `out` when
    given — it must not alias f or g: the pull reads neighbours).
    noise_dist: "clt4", "u8", "clt2" or "bm".  psi, lap: (2, X, Y, Z)
    float32 scratch for the density pre-pass of a coupled configuration
    and for the laplacian pre-pass when alpha1 != 0 (allocated when not
    given).  ref: the (2, X, Y, Z) COM-rolled (rho_eq, phi_eq) of
    USE_REF_STATE, or None.  ext: every array is a halo-extended block
    in one padded layout (:class:`~bflbm_tpu_torch.ops.blocked.Ext`,
    pads at least :func:`sd_depth` deep, filled); the step writes the
    interior of `out` and leaves its pads as they were (unset in an `out`
    allocated here).

    window (K7's ``win`` / ``owin`` / ``out_alias``): a box inside the
    interior, spanning every axis without pads; the step writes only its
    cells of `out`, and the pre-passes their rings in front of it
    (:func:`prepass_windows`) of psi and lap.  strips, strips_out (K7's
    ``ystrips``): the y halo of A and K is read from the received strips
    and never from the y pads, and K writes its edge rows into
    strips_out (:func:`launch_k`); neither goes with a window.

    CPU tensors run :func:`k_step_reference` (with a window it computes
    the whole interior and writes the window).  CUDA tensors launch the
    CUDA kernels on the current stream (the pre-passes A and, with
    alpha1, L, then K), or raise: ValueError or TypeError for tensors the
    kernels do not take, RuntimeError for a failed build or launch.
    """
    if g.device != f.device:
        raise ValueError(f"g is on {g.device}, f on {f.device}")
    _check_box_args(f, ext, window, (strips, strips_out))
    if window is not None and (strips is not None or strips_out is not None):
        raise ValueError("a window launch takes no y strips")
    a_win = l_win = None
    if window is not None:
        a_win, l_win = prepass_windows(params, ext, f.shape, window)
    if f.device.type == "cpu":
        fo, go = k_step_reference(f, g, word, step, params, noise_dist, ref,
                                  ext, strips)
        if strips_out is not None:
            _write_strips(strips_out, fo, go, ext, f.shape)
        if ext is not None:
            return (_write_region(None if out is None else out[0], fo, f, Q,
                                  ext, None, window),
                    _write_region(None if out is None else out[1], go, g, Q,
                                  ext, None, window))
        if out is None:
            return fo, go
        out[0].copy_(fo)
        out[1].copy_(go)
        return out
    if f.device.type != "cuda":
        raise ValueError(f"no K-step path for device {f.device}")
    check_noise_dist(noise_dist)
    if out is None:
        out = (torch.empty_like(f), torch.empty_like(g))
    psi = (density_psi(f, g, params, out=psi, ext=ext, window=a_win,
                       strips=strips) if is_coupled(params) else None)
    lap = (laplacian_psi(psi, out=lap, ext=ext, window=l_win)
           if has_alpha1(params) else None)
    return launch_k(f, g, word, step, params, out, psi, noise_dist, ref,
                    lap=lap, ext=ext, window=window, strips=strips,
                    strips_out=strips_out)


# ---------------------------------------------------------------------------
# K4: T steps per launch (temporal blocking, csrc/blocked_step.cu).
# ---------------------------------------------------------------------------

# Shared memory one thread block of an H100 may hold (227 KB, dynamic):
# what caps T.
SMEM_PER_BLOCK = 232448
_BLOCKED_MAX_THREADS = 384
# Blocks a thread-block cluster may hold (the portable limit).
MAX_CLUSTER = 8
# The (y, z) sub-tile of a block of a blocked launch per (stencil depth,
# T), the tile marching along all of x, and the cluster of blocks along
# (y, z) that shares its phases' planes (csrc/blocked_step.cu): the fastest
# measured pair at 256^3 on an H100 (tools/k4_tiles.py, PERF.md section 6)
# among those whose shared memory fits a block (each intermediate phase
# keeping sd + 3 population planes, with a force every phase 3 psi planes,
# 4 and 3 laplacian planes under alpha1).  Uncoupled T = 5 needs 423,424
# bytes on 8 x 8, coupled T = 4 (sd T = 8, which JAX takes) 368,624 on
# 4 x 4 and alpha1 T = 3 (sd T = 9, which JAX refuses) 358,080: all three
# are refused (check_block).
# Measured (NVIDIA H100 80GB HBM3, 700 W; ms a step, u8 uncoupled, clt4
# with a force): uncoupled T = 2 4 x 32 2.1885, T = 3 4 x 16 2.8453, T = 4
# 4 x 8 4.6619, every cluster of more than one block slower; coupled T = 2
# 8 x 16 on 1 x 2 clusters 5.3631 (5.2799 in a second run) against 1 x 1
# 5.3351 (5.3368), and faster on 1 x 2 with the noise off (3.9236 against
# 4.0234) and under general tau (5.4625 against 5.5512); T = 3 4 x 8 on
# 2 x 1 14.4940 against 15.3384;
# alpha1 T = 2 4 x 16 on 1 x 2 10.5248 against 10.9087; 2 x 2 and 4-block
# clusters slower everywhere.
_BLOCKED_SECTIONS = {(1, 2): (4, 32), (1, 3): (4, 16), (1, 4): (4, 8),
                     (2, 2): (8, 16), (2, 3): (4, 8), (3, 2): (4, 16)}
_BLOCKED_CLUSTERS = {(1, 2): (1, 1), (1, 3): (1, 1), (1, 4): (1, 1),
                     (2, 2): (1, 2), (2, 3): (2, 1), (3, 2): (1, 2)}

# The x-marching tiles of kernels L (csrc/laplacian_psi.cu) and B-A1 (the
# A1 builds of csrc/fused_step.cu; csrc/stencil_tile.cuh): a block owns a
# (ty, tz) tile of the launch's region in (y, z), ty * tz threads along z
# first, and marches xc planes of x, with a ring of STENCIL_RING planes of
# the fields it reads (psi for L; the laplacian and, with alpha0, psi for
# B-A1), both species with a 1-cell y / z halo, in shared memory.  The
# entries are the fastest of tools/stencil_tiles.py's survey at 256^3 on
# an H100 (PERF.md section 6), device ms a launch from a CUDA graph on
# NVIDIA H100 80GB HBM3, 700 W: L 4 x 32 marching 64 planes 0.1351 (8 x 32
# x 16 0.1618, 2 x 64 x 64 0.1362, every tile marching 8 planes 0.166 or
# more); B-A1 (clt4, alpha0 1.2) 2 x 64 x 16 2.1117 (8 x 32 x 16 2.1838,
# 4 x 64 x 8 2.1349, 8 x 16 tiles 2.30-3.02).
_STENCIL_TILES = {"l": (4, 32, 64), "b_a1": (2, 64, 16)}
STENCIL_RING = 6
STENCIL_MAX_THREADS = 256


def stencil_tile(kind: str) -> Tuple[int, int, int]:
    """(ty, tz, xc) of kernel `kind`'s blocks, "l" or "b_a1": the y and z
    cells of a block's tile and the x planes it marches."""
    return tuple(int(v) for v in _STENCIL_TILES[kind])


def stencil_grid(tile, region) -> Tuple[int, int, int]:
    """The grid of an L or B-A1 launch on a region of (nx, ny, nz) cells,
    as ``csrc/stencil_tile.cuh`` tile_grid computes it: (z tiles, y
    tiles, x chunks), the last of each past the region's end where the
    tile does not divide it."""
    ty, tz, xc = (int(v) for v in tile)
    nx, ny, nz = (int(n) for n in tuple(region)[-3:])
    return (-(-nz // tz), -(-ny // ty), -(-nx // xc))


def stencil_blocks(tile, region):
    """The cells each block of an L or B-A1 launch on a region of (nx, ny,
    nz) cells writes, one box ((x0, x1), (y0, y1), (z0, z1)) a block, from
    the region's first cell: its chunk's planes and its tile's cells, cut
    at the region's end (the kernels' threads past it write nothing)."""
    ty, tz, xc = (int(v) for v in tile)
    nx, ny, nz = (int(n) for n in tuple(region)[-3:])
    gz, gy, gx = stencil_grid(tile, region)
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                yield ((bx * xc, min(bx * xc + xc, nx)),
                       (by * ty, min(by * ty + ty, ny)),
                       (bz * tz, min(bz * tz + tz, nz)))


def stencil_fields(kind: str, params: Optional[LBMParams] = None) -> int:
    """The fields of two species kernel `kind`'s ring holds: psi for L;
    the laplacian for B-A1, and psi too when the configuration `params`
    has alpha0 != 0 (the Shan-Chen gradient)."""
    return 1 if kind == "l" or params.alpha0 == 0.0 else 2


def stencil_smem_bytes(tile, fields: int) -> int:
    """Dynamic shared memory of a block of an L or B-A1 launch on tiles
    `tile` whose ring holds `fields` fields (as ``csrc/laplacian_psi.cu``
    bflbm_laplacian_smem and ``fused_step.cu``'s bflbm_a1_smem): the
    STENCIL_RING slots of `fields` fields of two species on the (ty + 2)
    x (tz + 2) cells of the tile with its halo, 4 bytes a float."""
    ty, tz = (int(v) for v in tuple(tile)[:2])
    return STENCIL_RING * int(fields) * 2 * (ty + 2) * (tz + 2) * 4


def blocked_tile(T: int, shape, sd: int = 1) -> Tuple[int, int, int]:
    """The output tile of a block of a T-step sweep at stencil depth sd
    (:func:`sd_depth`) over arrays (.., X, Y, Z): all X planes, and the
    (y, z) sub-tile of ``_BLOCKED_SECTIONS`` (8 x 32 at T = 1; past the
    table the smallest tile considered, 8 x 8 uncoupled, 4 x 4 with a
    force)."""
    T, sd = int(T), int(sd)
    default = (8, 32) if T == 1 else ((8, 8) if sd == 1 else (4, 4))
    by, bz = _BLOCKED_SECTIONS.get((sd, T), default)
    return (int(tuple(shape)[-3]), by, bz)


def blocked_cluster(T: int, sd: int = 1) -> Tuple[int, int]:
    """The thread-block cluster (blocks along y, z) of a T-step sweep at
    stencil depth sd: ``_BLOCKED_CLUSTERS``' entry, 1 x 1 past it."""
    return tuple(_BLOCKED_CLUSTERS.get((int(sd), int(T)), (1, 1)))


# x planes a tile of a band across y or z marches (JAX's pick_band)
BAND_PLANES = 16


def launch_tile(T: int, region, sd: int = 1) -> Tuple[int, int, int]:
    """The tile of a block of a T-step launch on a region of (nx, ny, nz)
    cells: :func:`blocked_tile`'s, its (y, z) section no wider than the
    region, so that a thin seam band of the overlap split (sd T cells
    across) is one tile across; a region thinner than the section in y or
    z (a seam band across y or z) marches x in chunks of
    :data:`BAND_PLANES` planes, so that its launch still has a tile for
    most SMs (JAX's ``pick_band``, ``bflbm_tpu/parallel/kernel.py:505-516``:
    x tiles of 16 for its y bands, the interior's tiles for its x
    bands)."""
    nx, ny, nz = (int(n) for n in tuple(region)[-3:])
    _, by, bz = blocked_tile(T, (nx, ny, nz), sd)
    bx = nx if (ny >= by and nz >= bz) else min(nx, BAND_PLANES)
    return (bx, min(by, ny), min(bz, nz))


def launch_cluster(T: int, region, sd: int = 1) -> Tuple[int, int]:
    """The cluster of a T-step launch on a region of (nx, ny, nz) cells:
    :func:`blocked_cluster`'s where the region holds at least one cluster
    tile (:func:`blocked_tile`'s sub-tiles times the cluster) in y and z,
    else 1 x 1: a seam band thinner than a sub-tile across y or z (whose
    :func:`launch_tile` marches x in chunks), a region thinner than a
    cluster tile across an axis the cluster spans.  The launch covers the
    region with whole clusters, the last ones past its end where the tile
    does not divide it."""
    nx, ny, nz = (int(n) for n in tuple(region)[-3:])
    _, by, bz = blocked_tile(T, (nx, ny, nz), sd)
    cy, cz = blocked_cluster(T, sd)
    if ny < cy * by or nz < cz * bz:
        return (1, 1)
    return (cy, cz)


def _phase_regions(T: int, tile, sd: int):
    """(y, z) extents of each phase's region: the tile grown by
    sd (T - 1 - s) cells on each side."""
    _, by, bz = tile
    return [(by + 2 * sd * (T - 1 - s), bz + 2 * sd * (T - 1 - s))
            for s in range(int(T))]


def blocked_smem_bytes(T: int, tile, sd: int = 1) -> int:
    """Dynamic shared memory of a block of a T-step launch at stencil depth
    sd on sub-tiles `tile` (as ``csrc/blocked_step.cu`` bflbm_blocked_smem,
    the same in every block of any cluster): 8 bytes for each of the full
    and empty mbarriers of the sd + 3 slots of every intermediate phase,
    rounded up to 16, then float32 planes of each phase's region: sd + 3
    planes of 2 x 19 populations a cell of each intermediate phase; with a
    force, 3 planes of the two psi fields (4 under alpha1) on every
    phase's region grown by sd - 1, and under alpha1 3 planes of their
    laplacian grown by 1."""
    T = int(T)
    psi_ring = 4 if sd == 3 else 3
    floats = 0
    for s, (ny, nz) in enumerate(_phase_regions(T, tile, sd)):
        if s < T - 1:
            floats += (sd + 3) * 2 * Q * ny * nz
        if sd >= 2:
            floats += psi_ring * 2 * (ny + 2 * (sd - 1)) * (nz + 2 * (sd - 1))
        if sd == 3:
            floats += 3 * 2 * (ny + 2) * (nz + 2)
    barriers = -(-2 * (T - 1) * (sd + 3) * 8 // 16) * 16
    return barriers + 4 * floats


def blocked_threads(T: int, tile, sd: int = 1,
                    cluster=(1, 1)) -> Tuple[int, ...]:
    """The warp groups of a blocked launch, phase by phase: 384 threads
    (12 warps) at most, each phase at least one warp, the others given one
    at a time to the phase with the most cells a warp, until every phase
    has a thread a cell.  A phase's cells are those of its part in the
    cluster's corner block (its sub-tile grown by sd (T - 1 - s) on the
    cluster's outer sides, every side in a 1 x 1 cluster), the largest
    part of any block."""
    T = int(T)
    _, by, bz = tile
    cy, cz = cluster
    cells = []
    for s in range(T):
        p = sd * (T - 1 - s)
        cells.append((by + p * (1 if cy > 1 else 2))
                     * (bz + p * (1 if cz > 1 else 2)))
    warps = [1] * T
    for _ in range(_BLOCKED_MAX_THREADS // 32 - T):
        s = max(range(T), key=lambda r: cells[r] / warps[r])
        if 32 * warps[s] >= cells[s]:
            break
        warps[s] += 1
    return tuple(32 * w for w in warps)


def check_block(params: LBMParams, T) -> None:
    """Raise ValueError for a block T the port does not run: below 1, past
    the kernel's 8 steps, or more shared memory on its tile
    (:func:`blocked_tile` at the configuration's stencil depth) than a
    thread block holds."""
    if isinstance(T, bool) or not isinstance(T, (int, np.integer)) or T < 1:
        raise ValueError(f"block must be an integer >= 1, got {T!r}")
    T, sd = int(T), sd_depth(params)
    tile = blocked_tile(T, (1, 1, 1), sd)   # its x extent needs no memory
    need = blocked_smem_bytes(T, tile, sd)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"block = {T} at stencil depth {sd} on tiles of {tile[1]} x "
            f"{tile[2]} cells (y, z) needs {need} bytes of shared memory; a "
            f"thread block holds at most {SMEM_PER_BLOCK}")
    if T > 8:
        raise ValueError(f"block = {T}: the blocked kernel takes at most 8 "
                         "steps a launch")


def blocked_stream_collide(f: torch.Tensor, g: torch.Tensor,
                           words: Sequence[int], step0: int,
                           params: LBMParams, T: int,
                           out: Optional[Pair] = None, *,
                           noise_dist: str = "clt4",
                           ref: Optional[torch.Tensor] = None,
                           ext: Optional[Ext] = None,
                           window: Optional[Box] = None,
                           strips: Optional[torch.Tensor] = None,
                           strips_out: Optional[torch.Tensor] = None) -> Pair:
    """T K steps of the post-collide pair (f, g) in one sweep (K4): step
    s draws word ``words[s]`` at step label ``step0 + s``; returns the
    pair at label step0 + T (written into `out` when given; it must not
    alias f or g).  ref: the (2, X, Y, Z) USE_REF_STATE amplitude fields,
    held for the T steps, or None.  The kernel's output tiles are
    :func:`launch_tile`'s at the configuration's stencil depth.  With a
    force (alpha0 or alpha1 != 0) every phase recomputes psi (and its
    laplacian) from its own streamed input: neither pre-pass is launched.

    ext: every array (ref included) is a halo-extended block in one
    padded layout (:class:`~bflbm_tpu_torch.ops.blocked.Ext`) whose pads,
    at least sd T deep (:func:`sd_depth`), the halo exchange has filled:
    the sweep runs on the block's interior, its grown phases reading the
    pads, and writes the interior of `out`, leaving its pads as they
    were (unset in an `out` allocated here).

    window (the overlap split at block T): a box of the block inside its
    interior; the sweep's tiles cover it, it reads the arrays only within
    sd T of it, and it writes only its cells of `out`.  strips, strips_out
    (the y strips at block T): the y halo is read from the received
    strips ((2, 2, Q, X, rows, Z), rows the y pads' depth, sd T or more)
    and never from the y pads, and the sweep writes its first and last
    `rows` interior rows into strips_out too; ref is read from its own
    pads.  Neither goes with a window.

    CPU tensors run :func:`bflbm_tpu_torch.ops.blocked.
    blocked_sweep_reference` on one tile, the launch's region (it gives
    the cells of the kernel's tiles bitwise).  CUDA tensors launch
    ``csrc/blocked_step.cu`` once on the current stream (its EXT mode
    with ext), or raise: ValueError or TypeError for what the kernel does
    not take (a T past its shared memory, :func:`check_block`, pads
    shallower than sd T, a window outside the interior or with strips
    among it), RuntimeError for a failed build or launch.  Neither runs
    the steps one by one."""
    global blocked_launches
    if g.device != f.device:
        raise ValueError(f"g is on {g.device}, f on {f.device}")
    check_noise_dist(noise_dist)
    check_block(params, T)
    T, sd = int(T), sd_depth(params)
    words = [int(w) for w in words]
    if len(words) != T:
        raise ValueError(f"need {T} words, got {len(words)}")
    if window is not None and (strips is not None or strips_out is not None):
        raise ValueError("a window launch takes no y strips")
    _check_box_args(f, ext, window, (strips, strips_out))
    geom = _geom(f, ext, None, need=sd * T, window=window)
    region = tuple(geom[6:9])
    if f.device.type == "cpu":
        # one tile, the launch's region: every tiling computes a cell from
        # the same inputs, bitwise
        fo, go = blocked.blocked_sweep_reference(f, g, words, step0, params,
                                                 T, region, noise_dist, ref,
                                                 ext, window, strips)
        if strips_out is not None:
            _write_strips(strips_out, fo, go, ext, f.shape)
        if ext is not None:
            box = window if window is not None else ext.bounds(f.shape)
            outs = (out if out is not None else
                    (torch.zeros_like(f), torch.zeros_like(g)))
            for o, v in zip(outs, (fo, go)):
                blocked.box_view(o, box).copy_(v)
            return outs
        if out is None:
            return fo, go
        out[0].copy_(fo)
        out[1].copy_(go)
        return out
    if f.device.type != "cuda":
        raise ValueError(f"no blocked sweep for device {f.device}")
    _check_field("f", f, f, Q)
    _check_field("g", g, f, Q)
    if out is None:
        out = (torch.empty_like(f), torch.empty_like(g))
    for name, t in zip(("out[0]", "out[1]"), out):
        _check_field(name, t, f, Q)
        _check_no_alias(name, t, (f, g))
    if ref is not None:
        _check_field("ref", ref, f, 2)
        _check_no_alias("ref", ref, tuple(out))
        if not params.noise_on:
            ref = None
    if strips_out is not None:
        _check_no_alias("strips_out", strips_out,
                        (f, g) + tuple(t for t in (strips, ref)
                                       if t is not None))
    rows = next((int(t.shape[-2]) for t in (strips, strips_out)
                 if t is not None), 0)
    tile = launch_tile(T, region, sd)
    cluster = launch_cluster(T, region, sd)
    threads = blocked_threads(T, tile, sd, cluster)
    from . import _build

    lib = _build.load("blocked_step" + ("_general" if general_relax(params)
                                        else "")
                      + ("_force" if sd >= 2 else "")
                      + ("_a1" if sd == 3 else ""), f.device)
    coef = (ctypes.c_float * 33)(*_noise_coef(
        float(params.kBT), params.lam_f, params.lam_g, noise_dist))
    rc = lib.bflbm_blocked_step(
        f.device.index, f.data_ptr(), g.data_ptr(),
        None if ref is None else ref.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), geom,
        (ctypes.c_int * T)(*[_as_i32(w) for w in words]), T,
        _as_i32(step0), (ctypes.c_int * 5)(*tile, *cluster),
        (ctypes.c_int * T)(*threads), params.div_eps, 0.5 * params.lam_f,
        0.5 * params.lam_g, params.lam_f, params.lam_g,
        int(params.noise_on), NOISE_DISTS[noise_dist][0], coef,
        -CS2 * params.alpha0, CS2 * params.alpha1,
        1.0 / (1.0 + 1.0 / (2.0 * params.tau_f)),
        1.0 / (1.0 + 1.0 / (2.0 * params.tau_g)),
        int(params.use_sc_pseudo), float(params.sc_ref_density), sd,
        None if strips is None else strips.data_ptr(),
        None if strips_out is None else strips_out.data_ptr(), rows,
        torch.cuda.current_stream(f.device).cuda_stream)
    _raise_on(rc, lib, "blocked_step")
    blocked_launches += 1
    for tag in (["blocked"] + (["blocked ext"] if ext is not None else [])
                + (["blocked cluster"] if cluster != (1, 1) else [])
                + (["blocked window"] if window is not None else [])
                + (["blocked ystrips"] if strips is not None else [])):
        mode_launches[tag] = mode_launches.get(tag, 0) + 1
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


def make_ksteps(params: LBMParams, n: int, mass_restore=None, *,
                noise_dist: str = "clt4", block: int = 1):
    """fn(s, words=None, ref=None) -> s: n K steps of a post-collide
    SimState.  block = T > 1 (:func:`check_block`) runs n // T blocked
    sweeps (:func:`blocked_stream_collide`, one launch each, with no
    pre-pass), then n % T single steps, as JAX's ``make_ksteps`` (T is cut
    to n); block 1, and each single step, runs one K launch per step (a
    coupled configuration adds the density pre-pass, alpha1 the laplacian
    pre-pass too).  The mass restore is applied once per sweep or single
    step, after the one whose [prev, step) crossed a multiple of its
    interval: with T = 2 from an odd step it lands after step 1001, not
    1000, as in JAX.  Two buffer pairs ping-pong, and one psi (and lap)
    scratch serves the chunk's single steps.

    The input's buffers are reused as the second pair, so `s` is
    consumed.  words: the n per-step noise words (default: drawn from
    s.gen).  ref: the (2, X, Y, Z) USE_REF_STATE amplitude fields, held
    fixed for the n steps.  mass_restore: optional (interval, m0f,
    m0g)."""
    check_noise_dist(noise_dist)
    check_block(params, block)
    T = max(1, min(int(block), n)) if n else 1

    def run_k(s: SimState, words: Optional[Sequence[int]] = None,
              ref: Optional[torch.Tensor] = None) -> SimState:
        if words is None:
            words = draw_words(s.gen, n)
        if len(words) != n:
            raise ValueError(f"need {n} words, got {len(words)}")
        words = list(words)
        n_blocked = n // T if T > 1 else 0
        cur = s
        spare = None
        psi = lap = None
        if (is_coupled(params) and s.f.device.type == "cuda"
                and n > n_blocked * T):
            psi = torch.empty((2,) + tuple(s.f.shape[1:]), dtype=s.f.dtype,
                              device=s.f.device)
            if has_alpha1(params):
                lap = torch.empty_like(psi)
        for k in range(n_blocked):
            if spare is None:
                spare = (torch.empty_like(cur.f), torch.empty_like(cur.g))
            fo, go = blocked_stream_collide(
                cur.f, cur.g, words[k * T:(k + 1) * T], cur.step, params, T,
                out=spare, noise_dist=noise_dist, ref=ref)
            spare = (cur.f, cur.g)
            nxt = cur.replace(f=fo, g=go, step=cur.step + T)
            cur = _maybe_restore(cur.step, nxt, mass_restore)
        for w in words[n_blocked * T:]:
            if spare is None:
                spare = (torch.empty_like(cur.f), torch.empty_like(cur.g))
            fo, go = fused_stream_collide(cur.f, cur.g, w, cur.step, params,
                                          out=spare, noise_dist=noise_dist,
                                          psi=psi, ref=ref, lap=lap)
            spare = (cur.f, cur.g)
            nxt = cur.replace(f=fo, g=go, step=cur.step + 1)
            cur = _maybe_restore(cur.step, nxt, mass_restore)
        return cur

    return run_k
