// K = collide o stream of the fluctuating binary-fluid LBM, for NVIDIA
// Hopper (sm_90a), one thread per cell.
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
//     density; with alpha0 = 0 the Shan-Chen term is skipped;
//   - GENERAL: K1d, general relaxation (fused_step.py:843-851, 1051-1064):
//     all 19 moments of the streamed populations, rows k < 10 relaxed
//     towards m_eq at 1 / (tau + 1/2), ghost rows towards 0, the Guo rows
//     and the noise added after; without it the exact relaxation of
//     tau_f = tau_g = 1/2 (only the four conserved moments are consumed);
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
// words; GENERAL adds two 15x19 forward transforms).  The design keeps ONE
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
// i = 0..18, as the density pre-pass sums them), and under GENERAL the 15
// other rows through M; coupled: the 19-point isotropic gradient grad psi
// = sum_i (w_i / cs^2) c_i psi(x + c_i) and the accelerations a_f = -cs^2
// alpha0 psi(rho) grad psi(phi) / rho, a_g likewise; real velocities with
// the friction, force and 0.5 xi / rho noise terms; barycentric
// equilibrium; post-collide moments; back transform of rows 1..18 with
// M_INV and the rest population by telescoping, f_0 = m_0 - sum_{i>=1}
// f_i.
//
// Noise bits are those of the JAX package's hash stream: h1 = mix32(cell ^
// word) with cell = (gx*GY + gy)*GZ + gz in uint32, (gx, gy, gz) the global
// coordinates of the cell and (GY, GZ) the global extents, and hash word k =
// mix32(h1 + (step*64 + k) * 0x9E3779B9).  Channel a of the 33 draws is
// byte a % 4 of word a / 4 under u8 (9 words a cell), the byte sum of word
// a under clt4 (33 words), half a % 2 of word a / 2 under clt2 (17 words),
// and under Box-Muller the cosine (even a) or sine (odd a) normal of pair
// a / 2, whose radius comes from the uniform of word 2p and whose angle
// from that of word 2p + 1 (34 words, the 34th normal unused).
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

  // Pull stream: population i at x is the input's at x - c_i.  Exact
  // relaxation consumes only the four conserved moments of the streamed
  // populations; GENERAL also accumulates rows 4..18 through M.  All are
  // accumulated as the loads arrive.
  float rho = 0.0f, phi = 0.0f;
  float jf[3] = {0.0f, 0.0f, 0.0f};
  float jg[3] = {0.0f, 0.0f, 0.0f};
  float mf[Q], mg[Q];
  if (GENERAL) {
#pragma unroll
    for (int k = 4; k < Q; ++k) mf[k] = mg[k] = 0.0f;
  }
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
      pull_add<GENERAL>(i, cx, cy, cz, fi, gi, rho, phi, jf, jg, mf, mg);
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
      pull_add<GENERAL>(i, cx, cy, cz, fi, gi, rho, phi, jf, jg, mf, mg);
    }
  }

  BFLBM_COLLIDE_CELL(p, p.word, p.step, x, y, z, p.fout, p.gout, plane, idx,
                     ConstTables);
  if (EXT && p.ys.out != nullptr &&
      (y < p.ys.y_lo + p.ys.rows || y >= p.ys.y_hi - p.ys.rows))
    copy_to_strips(p.ys, p.fout, p.gout, plane, idx, x, y, z, X, Z);
}

template <bool NOISE, int DIST, bool FORCE, bool GENERAL, bool REF, bool A1,
          bool EXT>
int launch(dim3 grid, cudaStream_t s, const Args& a) {
  k_step_kernel<NOISE, DIST, FORCE, GENERAL, REF, A1, EXT>
      <<<grid, BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DIST, bool FORCE, bool GENERAL, bool A1, bool EXT>
int launch_noise(dim3 grid, cudaStream_t s, const Args& a) {
  if (a.ref != nullptr)
    return launch<true, DIST, FORCE, GENERAL, true, A1, EXT>(grid, s, a);
  return launch<true, DIST, FORCE, GENERAL, false, A1, EXT>(grid, s, a);
}

template <bool FORCE, bool GENERAL, bool A1, bool EXT>
int launch_mode(int noise_on, int dist, dim3 grid, cudaStream_t s,
                const Args& a) {
  if (!noise_on)
    return launch<false, DIST_U8, FORCE, GENERAL, false, A1, EXT>(grid, s,
                                                                  a);
  switch (dist) {
    case DIST_U8:
      return launch_noise<DIST_U8, FORCE, GENERAL, A1, EXT>(grid, s, a);
    case DIST_CLT4:
      return launch_noise<DIST_CLT4, FORCE, GENERAL, A1, EXT>(grid, s, a);
    case DIST_CLT2:
      return launch_noise<DIST_CLT2, FORCE, GENERAL, A1, EXT>(grid, s, a);
    case DIST_BM:
      return launch_noise<DIST_BM, FORCE, GENERAL, A1, EXT>(grid, s, a);
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
// or null.  Returns cudaGetLastError() after the launch.
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
                                int strip_rows, void* stream) {
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
  const dim3 grid = cell_grid(a.r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kGeneral = BFLBM_GENERAL_RELAX != 0;
  constexpr bool kForce = BFLBM_FORCE != 0;
  constexpr bool kA1 = BFLBM_A1 != 0;
  static_assert(kForce || !kA1, "BFLBM_A1 needs BFLBM_FORCE");
  if ((psi != nullptr) != kForce || (lap != nullptr) != kA1)
    return static_cast<int>(cudaErrorInvalidValue);   // another library's
  // the hash keys of a whole-domain launch are the array's own
  const bool ext = is_ext(a.X, a.Y, a.Z, a.r) || a.ox != 0 || a.oy != 0 ||
                   a.oz != 0 || a.GY != static_cast<uint32_t>(a.Y) ||
                   a.GZ != static_cast<uint32_t>(a.Z) ||
                   strips_in != nullptr || strips_out != nullptr;
  if (ext)
    return launch_mode<kForce, kGeneral, kA1, true>(noise_on, dist, grid, s,
                                                    a);
  return launch_mode<kForce, kGeneral, kA1, false>(noise_on, dist, grid, s,
                                                   a);
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
