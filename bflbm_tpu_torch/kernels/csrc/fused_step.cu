// K = collide o stream of the fluctuating binary-fluid LBM, for NVIDIA
// Hopper (sm_90a), one thread per cell; under A1 on x-marching tiles.
//
// Replaces the TPU kernel bflbm_tpu/kernels/fused_step.py:_step_kernel /
// _k_compute (the pl.pallas_call at fused_step.py:1956) at block 1, one
// step per launch, in its modes, each a template flag:
//   - FORCE: K1b, the Shan-Chen force of alpha0 != 0 (fused_step.py:
//     748-808, 922-934, 982-988, 1009-1050), with psi of the streamed
//     densities read from a (2, X, Y, Z) array that csrc/density_psi.cu
//     writes just before, on the same stream; without it K1a;
//   - A1: K1c, the alpha1 square-gradient force (fused_step.py:810-832,
//     927-934), with the laplacian of psi read from a (2, X, Y, Z) array
//     that csrc/laplacian_psi.cu writes between the density pre-pass and
//     this kernel: its 18-neighbour gradient, taken with the weights and
//     loop of the psi gradient, gives a_f -= cs^2 alpha1 grad lap psi(phi)
//     and a_g -= cs^2 alpha1 grad lap psi(rho), not divided by the
//     density; with alpha0 = 0 the Shan-Chen term is skipped.  A kernel of
//     its own design, a1_tile_kernel (below);
//   - GENERAL: K1d, general relaxation (fused_step.py:843-851, 1051-1064):
//     every moment k >= 1 of the streamed populations relaxes at the one
//     rate lam = 1 / (tau + 1/2), rows k < 10 towards m_eq and ghost rows
//     towards 0, the Guo rows and the noise added after.  Since M_INV M =
//     1, that is f' = (1 - lam) f + M_INV q with q = lam m_eq + Guo + xi
//     (q_0 = lam rho) in population space: the streamed populations are
//     kept from the pull and no forward transform is taken (k_cell.cuh
//     store_relaxed).  Without it the exact relaxation of tau_f = tau_g =
//     1/2;
//   - REF: K1e, USE_REF_STATE (fused_step.py:944-951, 1808-1817): the
//     noise amplitudes read the COM-rolled (rho_eq, phi_eq) from a
//     (2, X, Y, Z) operand instead of the live densities;
//   - NOISE and DIST: the coordinate-keyed hash noise with u8, clt4, clt2
//     (_clt2_pair :633) or Box-Muller (_bm_normals :668 over hash_uniforms
//     :535) deviates, or noise off.
//   - EXT: K7's ext mode (fused_step.py:1155-1160, 1290, 1348, 1878-1880):
//     the arrays are one block of a decomposed domain, extended by pads of
//     depth sd (fused_step.sd_depth) on its sharded axes, which the halo
//     exchange fills before the launch; the kernel writes the block's
//     interior into the same padded layout (JAX's owin), reads neighbours
//     inside the pads on the sharded axes and wraps the others in place,
//     and keys the noise by global coordinates (the block's origin and the
//     global (Y, Z) ride in the launch geometry).  Chosen at launch from
//     the geometry (common.cuh is_ext): the whole-domain instantiations
//     keep the single-device addressing, and both compile the same
//     arithmetic, so a block's cells come out as the whole domain's.
//     Two run-time options of the EXT instantiations carry K7's other
//     modes: the region may be any window of the interior (win / owin /
//     out_alias, fused_step.py:1167-1187, 1215-1218, 1886-1910: the
//     overlap split launches the interior's window and the seam bands
//     separately, each writing its cells in place in the one padded
//     output), and on a y-sharded block the y halo may come from
//     received strips while K writes its first and last interior rows a
//     second time into strips for the next exchange (ystrips, :1233-1245,
//     1501-1530, 1913-1919; common.cuh YStrips).
// GENERAL, FORCE and A1 are chosen per library: the source is compiled six
// times, with BFLBM_GENERAL_RELAX and BFLBM_FORCE each 0 and 1 and, in the
// two FORCE builds' copies, BFLBM_A1 = 1, so that the builds run in
// parallel and each holds the 18 instantiations of its modes (noise off,
// or one of four generators with or without REF; each with and without
// EXT).
//
// What bounds it: device memory by its bytes, instructions in practice.  A
// cell update reads the 19 float32 populations of each of two species and
// writes as many back, 2 * 19 * 4 * 2 = 304 bytes (312 coupled, with psi;
// 320 under A1, with the laplacian; 8 more with the ref operand), against
// roughly 1,500-3,000 operations (the two 18x19 back transforms, the hash
// words; GENERAL adds 19 FMAs a species).  The design keeps ONE
// pass over memory per step: each thread pulls its 38 inputs straight from
// device memory (the neighbours' overlapping reads, of populations, of psi
// and of its laplacian, are served by L1/L2), keeps every intermediate in
// registers, and writes its 38 outputs once.  Threads run along z, so a
// warp's loads and stores touch contiguous addresses.  A pull cannot run in
// place, so the output is a separate buffer (the caller ping-pongs two
// pairs).
//
// Per cell: pull stream (periodic wrap, or from the pads); the four
// conserved moments of each species (the densities summed in the order
// i = 0..18, as the density pre-pass sums them), and under GENERAL the 38
// streamed populations kept in registers; coupled: the 19-point isotropic
// gradient grad psi = sum_i (w_i / cs^2) c_i psi(x + c_i) and the
// accelerations a_f = -cs^2
// alpha0 psi(rho) grad psi(phi) / rho, a_g likewise; real velocities with
// the friction, force and 0.5 xi / rho noise terms; barycentric
// equilibrium; post-collide moments (under GENERAL their relaxed part q);
// back transform of rows 1..18 with M_INV (under GENERAL added to (1 -
// lam) times the streamed population) and the rest population by
// telescoping, f_0 = m_0 - sum_{i>=1} f_i.
//
// Noise bits are those of the JAX package's hash stream: h1 = mix32(cell ^
// word) with cell = (gx*GY + gy)*GZ + gz in uint32, (gx, gy, gz) the global
// coordinates of the cell and (GY, GZ) the global extents, and hash word k =
// mix32(h1 + (step*64 + k) * 0x9E3779B9).  Channel a of the 33 draws is
// byte a % 4 of word a / 4 under u8 (9 words a cell), the byte sum of word
// a under clt4 (33 words), half a % 2 of word a / 2 under clt2 (17 words),
// and under Box-Muller the cosine (even a) or sine (odd a) normal of pair
// a / 2, whose radius comes from the uniform of word 2p and whose angle
// from that of word 2p + 1 (34 words, the 34th normal unused), each pair
// made when the cell, which asks for the draws in order, first needs it.
//
// Tables: C, M, M_INV and the gradient weights w_i / cs^2 live in
// __constant__ memory, filled once per device by bflbm_set_tables from the
// Python lattice module.  Element offsets are size_t (19*X*Y*Z exceeds
// int32 at 512^3); the hashed cell index stays 32-bit, as in the JAX
// package.  Divisions are guarded, |x| > eps, and amplitudes take
// sqrt(|.|): near rho_lo = 0 a density can be 0 or slightly negative.
// Build without fast math: it would move both, and Box-Muller's logf and
// sincosf must stay the accurate library functions.
//
// The per-cell arithmetic after the pull, the tables and the generators
// live in k_cell.cuh (BFLBM_COLLIDE_CELL), which csrc/blocked_step.cu (T
// steps a launch, K4) includes too.
//
// The A1 builds (B-A1) take both gradients, of psi and of its laplacian,
// from shared memory instead: a thread per cell gathering 72 neighbour
// values through L2 with 64-bit address arithmetic ran 33% behind B on the
// same input, whose gradient is half as many gathers.  a1_tile_kernel: a
// block owns a (ty, tz) tile of the launch's region and marches x over a
// chunk of xc planes, with a ring of TILE_RING planes of the laplacian and
// (when alpha0 != 0) of psi, both species with a 1-cell y / z halo, in
// shared memory (stencil_tile.cuh TileWalk): the next planes are copied in
// with cp.async while the cells of plane x are collided, their gradients
// summed
// from planes x - 1, x, x + 1 with gradient2's products in its order
// (SHARED_FORCES).  The populations are pulled straight from device memory
// as above, each value once, warps along z; the lattice tables are
// immediates (ImmTables: loop-invariant __constant__ reads would be hoisted
// into registers), the same float32 values, so a cell comes out bitwise as
// the thread-per-cell kernel computed it.  The strips exchange's rows and
// copy_to_strips work as in k_step_kernel.

#ifndef BFLBM_GENERAL_RELAX
#define BFLBM_GENERAL_RELAX 0
#endif
#ifndef BFLBM_FORCE
#define BFLBM_FORCE 0
#endif
#ifndef BFLBM_A1
#define BFLBM_A1 0
#endif

#include "k_cell.cuh"
#if BFLBM_A1
#include "stencil_tile.cuh"
#endif

namespace {

// The strips exchange: a cell of the first or last `rows` interior rows
// writes its outputs a second time into the strips K writes, read back
// from the output this thread has just stored (a thread sees its own
// stores), so that the main path carries no strip pointers.
__device__ __forceinline__ void copy_to_strips(const YStrips& ys,
                                               const float* fout,
                                               const float* gout,
                                               size_t plane, size_t idx,
                                               int x, int y, int z, int X,
                                               int Z) {
  const size_t sp = strip_plane(ys, X, Z);
  for (int side = 0; side < 2; ++side) {
    const int r = side == 0 ? y - ys.y_lo : y - (ys.y_hi - ys.rows);
    if (r < 0 || r >= ys.rows) continue;
    float* dst = ys.out + strip_offset(ys, side, 0, 0, x, r, z, X, Z);
#pragma unroll 1
    for (int q = 0; q < Q; ++q) {
      dst[q * sp] = fout[q * plane + idx];
      dst[(Q + q) * sp] = gout[q * plane + idx];
    }
  }
}

template <bool NOISE, int DIST, bool FORCE, bool GENERAL, bool REF, bool A1,
          bool EXT>
__global__ void __launch_bounds__(BLOCK) k_step_kernel(const Args p) {
  const int X = p.X, Y = p.Y, Z = p.Z;
  int x, y, z;
  if (!region_cell<EXT>(Z, p.r, x, y, z)) return;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const size_t idx = cell_offset(x, y, z, Y, Z);

  // Pull stream: population i at x is the input's at x - c_i.  Only the
  // four conserved moments of the streamed populations are consumed,
  // accumulated as the loads arrive; GENERAL also stages the populations
  // in shared memory, [i][thread] (pulled), which its relaxation reads
  // back at the store: kept in registers instead they took the uncoupled
  // kernel to 127 registers against 72 and 9% more time (H100).
  float rho = 0.0f, phi = 0.0f;
  float jf[3] = {0.0f, 0.0f, 0.0f};
  float jg[3] = {0.0f, 0.0f, 0.0f};
  extern __shared__ float pulled[];   // GENERAL: [2 Q][BLOCK]
  if (EXT && p.ys.in != nullptr &&
      (y - 1 < p.ys.y_lo || y + 1 >= p.ys.y_hi)) {
    // a row next to the y halo (the strips exchange): a pull across it
    // reads the received strips; a loop of its own, so that the other
    // rows keep the main loop's code
#pragma unroll 1
    for (int i = 0; i < Q; ++i) {
      const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
      float fi, gi;
      int side, row;
      if (strip_row(p.ys, y - cy, side, row)) {
        const size_t o = strip_offset(p.ys, side, 0, i, wrap(x - cx, X),
                                      row, wrap(z - cz, Z), X, Z);
        fi = __ldg(p.ys.in + o);
        gi = __ldg(p.ys.in + o + Q * strip_plane(p.ys, X, Z));
      } else {
        const size_t src = i * plane + cell_offset(wrap(x - cx, X),
                                                   wrap(y - cy, Y),
                                                   wrap(z - cz, Z), Y, Z);
        fi = __ldg(p.fin + src);
        gi = __ldg(p.gin + src);
      }
      if (GENERAL) {
        pulled[i * BLOCK + threadIdx.x] = fi;
        pulled[(Q + i) * BLOCK + threadIdx.x] = gi;
      }
      pull_add(cx, cy, cz, fi, gi, rho, phi, jf, jg);
    }
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
      const size_t src = i * plane + cell_offset(wrap(x - cx, X),
                                                 wrap(y - cy, Y),
                                                 wrap(z - cz, Z), Y, Z);
      const float fi = __ldg(p.fin + src);
      const float gi = __ldg(p.gin + src);
      if (GENERAL) {
        pulled[i * BLOCK + threadIdx.x] = fi;
        pulled[(Q + i) * BLOCK + threadIdx.x] = gi;
      }
      pull_add(cx, cy, cz, fi, gi, rho, phi, jf, jg);
    }
  }

#define K_PULLED(S, I) pulled[((S) * Q + (I)) * BLOCK + threadIdx.x]
  BFLBM_COLLIDE_CELL(p, p.word, p.step, x, y, z, p.fout, p.gout, plane, idx,
                     ConstTables, K_PULLED);
#undef K_PULLED
  if (EXT && p.ys.out != nullptr &&
      (y < p.ys.y_lo + p.ys.rows || y >= p.ys.y_hi - p.ys.rows))
    copy_to_strips(p.ys, p.fout, p.gout, plane, idx, x, y, z, X, Z);
}

#if !BFLBM_GENERAL_RELAX && !BFLBM_FORCE
// Box-Muller's deviates on their own: the NDRAWS normals of every cell of
// an (X, Y, Z) domain (hash keys as K's whole-domain launch takes them),
// drawn in the order K draws them (Draws<DIST_BM>), into out[a * plane +
// idx].  On no step's path: it holds the generator against its plain
// version (bflbm_bm_normals).
__global__ void __launch_bounds__(BLOCK)
    bm_normals_kernel(float* __restrict__ out, const Region r, int Y, int Z,
                      uint32_t word, uint32_t step) {
  int x, y, z;
  if (!region_cell<false>(Z, r, x, y, z)) return;
  const size_t plane = static_cast<size_t>(r.nx) * Y * Z;
  const size_t idx = cell_offset(x, y, z, Y, Z);
  const uint32_t cell = (static_cast<uint32_t>(x) * static_cast<uint32_t>(Y) +
                         static_cast<uint32_t>(y)) * static_cast<uint32_t>(Z) +
                        static_cast<uint32_t>(z);
  const Draws<DIST_BM> draw(mix32(cell ^ word), step * DRAW_STRIDE);
  const NoiseCoef nc = {};
#pragma unroll
  for (int a = 0; a < NDRAWS; ++a) out[a * plane + idx] = draw(a, nc);
}
#endif

#if BFLBM_A1
constexpr int MAX_DEVICES = 64;
// Blocks of TILE_MAX_THREADS an SM the registers must allow (at most 128
// registers a thread): left free, the EXT instantiations took 255, one
// block of 8 warps an SM.
constexpr int A1_MIN_BLOCKS = 2;

// The fields of an A1 tile's ring: the laplacian, and psi for the
// Shan-Chen gradient unless alpha0 = 0 (force_k = 0), which skips it.
__host__ __device__ __forceinline__ int a1_fields(float force_k) {
  return force_k != 0.0f ? 2 : 1;
}

// B-A1 on x-marching tiles (the A1 builds' only kernel; the design is in
// the notes at the top).  Each thread owns one (y, z) cell of the block's
// tile and collides it in every plane of the chunk; a thread past the
// region's end collides none but copies its share of the ring.
template <bool NOISE, int DIST, bool GENERAL, bool REF, bool EXT>
__global__ void __launch_bounds__(TILE_MAX_THREADS, A1_MIN_BLOCKS)
    a1_tile_kernel(const Args p, const StencilTile t) {
  constexpr bool FORCE = true, A1 = true;
  extern __shared__ __align__(16) float ring[];   // [slot][field][species]
  const int X = p.X, Y = p.Y, Z = p.Z;
  const TileWalk w(t, p.r, Y, Z);
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const int xplane = Y * Z;
  const int fields = a1_fields(p.fc.k);
  const float* const base[2] = {p.lap, p.psi};
  const int n = w.xb - w.xa;
  const int y = w.y, z = w.z;
  // a row next to the y halo of the strips exchange
  const bool near_strips = EXT && p.ys.in != nullptr &&
                           (y - 1 < p.ys.y_lo || y + 1 >= p.ys.y_hi);
  // SHARED_FORCES' strides: the laplacian and psi share the slot layout
  const int ln = w.hn, lnz = w.hz, lc = w.cell;
  const int pn = w.hn, pnz = w.hz, pc = w.cell;
  // planes xa - 1 .. xa + TILE_AHEAD - 1 before the march (stencil_tile.cuh)
  for (int j = 0; j < TILE_RING - 1; ++j)
    w.copy(ring, j, base, fields, plane, X, xplane);
  for (int k = 0; k < n; ++k) {
    cp_async_wait_ahead();
    __syncthreads();
    w.copy(ring, k + TILE_RING - 1, base, fields, plane, X, xplane);
    if (!w.active) continue;
    const int x = w.xa + k;
    const size_t idx = cell_offset(x, y, z, Y, Z);

    // the pull, as k_step_kernel's
    float rho = 0.0f, phi = 0.0f;
    float jf[3] = {0.0f, 0.0f, 0.0f};
    float jg[3] = {0.0f, 0.0f, 0.0f};
    // GENERAL keeps the streamed populations for its relaxation, in
    // registers (the strips rows' loop unrolled for it), though they
    // spill: staged in shared memory after the ring instead, as
    // k_step_kernel stages them, the kernel ran 22% slower on the whole
    // domain and 20% on blocks (256^3, H100, tools/kernel_times.py
    // b_a1_general on both builds) and still spilled 30-230 B a thread
    float fv[Q], gv[Q];
    if (near_strips) {
#pragma unroll(GENERAL ? Q : 1)
      for (int i = 0; i < Q; ++i) {
        const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
        float fi, gi;
        int side, row;
        if (strip_row(p.ys, y - cy, side, row)) {
          const size_t o = strip_offset(p.ys, side, 0, i, wrap(x - cx, X),
                                        row, wrap(z - cz, Z), X, Z);
          fi = __ldg(p.ys.in + o);
          gi = __ldg(p.ys.in + o + Q * strip_plane(p.ys, X, Z));
        } else {
          const size_t src = i * plane + cell_offset(wrap(x - cx, X),
                                                     wrap(y - cy, Y),
                                                     wrap(z - cz, Z), Y, Z);
          fi = __ldg(p.fin + src);
          gi = __ldg(p.gin + src);
        }
        if (GENERAL) {
          fv[i] = fi;
          gv[i] = gi;
        }
        pull_add(cx, cy, cz, fi, gi, rho, phi, jf, jg);
      }
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int cx = ImmTables::c(i, 0), cy = ImmTables::c(i, 1),
                  cz = ImmTables::c(i, 2);
        const size_t src = i * plane + cell_offset(wrap(x - cx, X),
                                                   wrap(y - cy, Y),
                                                   wrap(z - cz, Z), Y, Z);
        fv[i] = __ldg(p.fin + src);
        gv[i] = __ldg(p.gin + src);
        pull_add(cx, cy, cz, fv[i], gv[i], rho, phi, jf, jg);
      }
    }

    // planes x - 1, x, x + 1 of the laplacian and of psi
    const float* lap_x[3];
    const float* psi_x[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lap_x[d] = ring + ((k + d) % TILE_RING) * (fields * 2 * w.hn);
      psi_x[d] = lap_x[d] + 2 * w.hn;
    }
#define K_PULLED(S, I) ((S) == 0 ? fv[I] : gv[I])
    BFLBM_COLLIDE_CELL_WITH(p, p.word, p.step, x, y, z, p.fout, p.gout,
                            plane, idx, ImmTables, SHARED_FORCES, K_PULLED);
#undef K_PULLED
    if (EXT && p.ys.out != nullptr &&
        (y < p.ys.y_lo + p.ys.rows || y >= p.ys.y_hi - p.ys.rows))
      copy_to_strips(p.ys, p.fout, p.gout, plane, idx, x, y, z, X, Z);
  }
}
#endif

// How a launch runs: its grid and stream; under A1 also the device, the
// tile and the dynamic shared memory of a block.
struct Launch {
  dim3 grid;
  cudaStream_t s;
  int device;
  int ty, tz, xc;
  long long smem;
};

#if BFLBM_A1
// Every instantiation of an A1 build is the tiled kernel, its dynamic
// shared memory limit raised to l.smem first when that is above 48 KB and
// above what was set on this device before (a launch above the limit is
// refused, and only cudaGetLastError reports it).
template <bool NOISE, int DIST, bool FORCE, bool GENERAL, bool REF, bool A1,
          bool EXT>
int launch(const Launch& l, const Args& a) {
  static_assert(FORCE && A1, "the A1 builds launch the tiled kernel");
  static long long allowed[MAX_DEVICES] = {};
  auto kern = a1_tile_kernel<NOISE, DIST, GENERAL, REF, EXT>;
  if (l.smem > 48 * 1024 && l.smem > allowed[l.device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(l.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[l.device] = l.smem;
  }
  kern<<<l.grid, l.ty * l.tz, static_cast<size_t>(l.smem), l.s>>>(
      a, StencilTile{l.ty, l.tz, l.xc});
  return static_cast<int>(cudaGetLastError());
}
#else
// GENERAL's staging of the streamed populations: 2 Q floats a thread
constexpr size_t PULLED_SMEM = 2 * Q * BLOCK * sizeof(float);

template <bool NOISE, int DIST, bool FORCE, bool GENERAL, bool REF, bool A1,
          bool EXT>
int launch(const Launch& l, const Args& a) {
  k_step_kernel<NOISE, DIST, FORCE, GENERAL, REF, A1, EXT>
      <<<l.grid, BLOCK, GENERAL ? PULLED_SMEM : 0, l.s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#endif

template <int DIST, bool FORCE, bool GENERAL, bool A1, bool EXT>
int launch_noise(const Launch& l, const Args& a) {
  if (a.ref != nullptr)
    return launch<true, DIST, FORCE, GENERAL, true, A1, EXT>(l, a);
  return launch<true, DIST, FORCE, GENERAL, false, A1, EXT>(l, a);
}

template <bool FORCE, bool GENERAL, bool A1, bool EXT>
int launch_mode(int noise_on, int dist, const Launch& l, const Args& a) {
  if (!noise_on)
    return launch<false, DIST_U8, FORCE, GENERAL, false, A1, EXT>(l, a);
  switch (dist) {
    case DIST_U8:
      return launch_noise<DIST_U8, FORCE, GENERAL, A1, EXT>(l, a);
    case DIST_CLT4:
      return launch_noise<DIST_CLT4, FORCE, GENERAL, A1, EXT>(l, a);
    case DIST_CLT2:
      return launch_noise<DIST_CLT2, FORCE, GENERAL, A1, EXT>(l, a);
    case DIST_BM:
      return launch_noise<DIST_BM, FORCE, GENERAL, A1, EXT>(l, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bflbm_set_tables(int device, const int* c, const float* m,
                                const float* minv, const float* gw) {
  DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_C, c, sizeof(int) * Q * 3);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_M, m, sizeof(float) * Q * Q);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(c_MINV, minv, sizeof(float) * Q * Q);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_GW, gw, sizeof(float) * Q);
  return static_cast<int>(e);
}

// One K step on device pointers (19, X, Y, Z) float32, z contiguous, over
// the region of geom: host array {X, Y, Z, x0, y0, z0, nx, ny, nz, ox, oy,
// oz, GY, GZ} (the extents, common.cuh Region, then the global coordinates
// of array cell (0, 0, 0) and the global y and z extents of the hash cell
// index).
// psi: the (2, X, Y, Z) psi densities of the streamed input for the coupled
// mode (the BFLBM_FORCE=1 builds), or null for the uncoupled one; lap: their
// (2, X, Y, Z) laplacian for the alpha1 mode (the BFLBM_A1=1 builds), or
// null; a pointer the library's mode does not take, or one it lacks, gives
// cudaErrorInvalidValue.  ref: the (2, X, Y, Z) COM-rolled
// (rho_eq, phi_eq) of USE_REF_STATE, or null (read only with noise on).
// dist: 0 u8, 1 clt4, 2 clt2, 3 Box-Muller.  coef: host array [pref_mom,
// cf[15], cg[15], scale, off].  lam_f, lam_g: 1 / (tau + 1/2), read by the
// general-relaxation build.  force_k = -cs^2 alpha0; a1 = cs^2 alpha1;
// s_f, s_g the Guo prefactors.  strips_in, strips_out: the received y
// strips and the strips K writes (common.cuh YStrips, depth strip_rows),
// or null.  tile: host array {ty, tz, xc} of the A1 builds' tiles
// (stencil_tile.cuh StencilTile), null for the other builds.  Returns
// cudaErrorInvalidValue for arguments it does not take (a tile given to a
// build without A1 or missing from one with it, a tile out of range, more
// shared memory than a block of the device holds), else
// cudaGetLastError() after the launch.
extern "C" int bflbm_fused_step(int device, const float* fin,
                                const float* gin, const float* psi,
                                const float* lap, const float* ref,
                                float* fout, float* gout,
                                const int* geom, int word, int step,
                                float eps, float half_lam_f, float half_lam_g,
                                float lam_f, float lam_g, int noise_on,
                                int dist, const float* coef, float force_k,
                                float a1, float s_f, float s_g,
                                const float* strips_in, float* strips_out,
                                int strip_rows, const int* tile,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  Args a;
  a.fin = fin;
  a.gin = gin;
  a.psi = psi;
  a.lap = lap;
  a.ref = ref;
  a.fout = fout;
  a.gout = gout;
  a.X = geom[0];
  a.Y = geom[1];
  a.Z = geom[2];
  a.r = region_of(geom);
  a.ox = geom[9];
  a.oy = geom[10];
  a.oz = geom[11];
  a.GY = static_cast<uint32_t>(geom[12]);
  a.GZ = static_cast<uint32_t>(geom[13]);
  a.ys = ystrips_of(strips_in, strips_out, strip_rows, a.Y);
  a.word = static_cast<uint32_t>(word);
  a.step = static_cast<uint32_t>(step);
  a.rx = Relax{eps, half_lam_f, half_lam_g, lam_f, lam_g};
  a.fc = Force{force_k, a1, s_f, s_g};
  a.nc.pref_mom = coef[0];
  for (int k = 0; k < NGHOST; ++k) {
    a.nc.cf[k] = coef[1 + k];
    a.nc.cg[k] = coef[1 + NGHOST + k];
  }
  a.nc.scale = coef[1 + 2 * NGHOST];
  a.nc.off = coef[2 + 2 * NGHOST];
  Launch l = {};
  l.s = static_cast<cudaStream_t>(stream);
  l.device = device;
  constexpr bool kGeneral = BFLBM_GENERAL_RELAX != 0;
  constexpr bool kForce = BFLBM_FORCE != 0;
  constexpr bool kA1 = BFLBM_A1 != 0;
  static_assert(kForce || !kA1, "BFLBM_A1 needs BFLBM_FORCE");
  if ((psi != nullptr) != kForce || (lap != nullptr) != kA1 ||
      (tile != nullptr) != kA1)
    return static_cast<int>(cudaErrorInvalidValue);   // another library's
#if BFLBM_A1
  const StencilTile t{tile[0], tile[1], tile[2]};
  if (!tile_ok(t) || device < 0 || device >= MAX_DEVICES || a.r.nx < 1 ||
      a.r.ny < 1 || a.r.nz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  l.ty = t.ty;
  l.tz = t.tz;
  l.xc = t.xc;
  l.smem = tile_smem(t.ty, t.tz, a1_fields(force_k));
  int optin = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (l.smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  l.grid = tile_grid(t, a.r);
#else
  l.grid = cell_grid(a.r);
#endif
  // the hash keys of a whole-domain launch are the array's own
  const bool ext = is_ext(a.X, a.Y, a.Z, a.r) || a.ox != 0 || a.oy != 0 ||
                   a.oz != 0 || a.GY != static_cast<uint32_t>(a.Y) ||
                   a.GZ != static_cast<uint32_t>(a.Z) ||
                   strips_in != nullptr || strips_out != nullptr;
  if (ext)
    return launch_mode<kForce, kGeneral, kA1, true>(noise_on, dist, l, a);
  return launch_mode<kForce, kGeneral, kA1, false>(noise_on, dist, l, a);
}

#if !BFLBM_GENERAL_RELAX && !BFLBM_FORCE
// The NDRAWS Box-Muller deviates of every cell of an (X, Y, Z) domain (shape
// = host {X, Y, Z}) for noise word `word` at step label `step`, into out
// (NDRAWS, X, Y, Z) float32 on the device, in K's draw order.
extern "C" int bflbm_bm_normals(int device, float* out, const int* shape,
                                int word, int step, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const Region r{0, 0, 0, shape[0], shape[1], shape[2]};
  bm_normals_kernel<<<cell_grid(r), BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      out, r, shape[1], shape[2], static_cast<uint32_t>(word),
      static_cast<uint32_t>(step));
  return static_cast<int>(cudaGetLastError());
}
#endif

#if BFLBM_A1
// Dynamic shared memory bytes of a block on (ty, tz) tiles whose ring
// holds `fields` fields (1: the laplacian; 2: and psi, alpha0 != 0) of
// both species: TILE_RING slots with a 1-cell y / z halo.
extern "C" long long bflbm_a1_smem(int ty, int tz, int fields) {
  return tile_smem(ty, tz, fields);
}
#endif

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
