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

#ifndef BFLBM_GENERAL_RELAX
#define BFLBM_GENERAL_RELAX 0
#endif
#ifndef BFLBM_FORCE
#define BFLBM_FORCE 0
#endif
#ifndef BFLBM_A1
#define BFLBM_A1 0
#endif

#include "common.cuh"

namespace {

constexpr int NGHOST = Q - 4;   // noisy stress + ghost modes a = 4..18
constexpr int NDRAWS = 33;      // 3 momentum + 15 f-ghost + 15 g-ghost
constexpr int NWORDS_U8 = 9;    // 33 u8 draws, four per hash word
constexpr int NWORDS_CLT2 = 17; // 33 clt2 draws, two per hash word
constexpr int NPAIR_BM = 17;    // Box-Muller pairs over 34 uniforms
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t DRAW_STRIDE = 64u;
constexpr float TWO_PI = 6.283185307179586f;

enum Dist : int { DIST_U8 = 0, DIST_CLT4 = 1, DIST_CLT2 = 2, DIST_BM = 3 };

__constant__ int c_C[Q][3];
__constant__ float c_M[Q][Q];
__constant__ float c_MINV[Q][Q];
__constant__ float c_GW[Q];     // w_i / cs^2, the gradient weights

struct NoiseCoef {
  float pref_mom;       // 2 (lam_f - lam_f^2 / 2) kBT
  float cf[NGHOST];     // sqrt(pref_f / cs^2 * b_a), a = 4..18
  float cg[NGHOST];     // sqrt(pref_g / cs^2 * b_a)
  float scale;          // deviate = b * scale + off: b a byte (u8), the
  float off;            // byte sum of a word (clt4) or of a half (clt2)
};

struct Relax {
  float eps;            // |rho| guard of the divisions (FLT_EPSILON)
  float half_lam_f;     // lam_f / 2
  float half_lam_g;
  float lam_f;          // 1 / (tau_f + 1/2), the GENERAL relaxation rate
  float lam_g;
};

struct Force {          // coupled mode only
  float k;              // -cs^2 alpha0
  float a1;             // cs^2 alpha1 (A1 only)
  float s_f;            // Guo prefactor 1 / (1 + 1 / (2 tau_f))
  float s_g;
};

struct Args {
  const float* fin;
  const float* gin;
  const float* psi;     // (2, X, Y, Z) or null (uncoupled)
  const float* lap;     // (2, X, Y, Z) laplacian of psi, or null (not A1)
  const float* ref;     // (2, X, Y, Z) or null (live amplitudes)
  float* fout;
  float* gout;
  int X, Y, Z;
  uint32_t word, step;
  Relax rx;
  NoiseCoef nc;
  Force fc;
  // EXT only, after the whole-domain kernel's fields (whose layout stays)
  Region r;             // the region written
  int ox, oy, oz;       // global coordinates of array cell (0, 0, 0)
  uint32_t GY, GZ;      // global extents the hash cell index runs over
  YStrips ys;           // the strips exchange's y halo, or null pointers
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_word(uint32_t h1, uint32_t sbase,
                                              int k) {
  return mix32(h1 + (sbase + static_cast<uint32_t>(k)) * GOLDEN);
}

__device__ __forceinline__ float safe_inv(float x, float eps) {
  return fabsf(x) > eps ? 1.0f / x : 0.0f;
}

// The 33 draws of a cell's stream: draw(a), a = 0..32.
template <int DIST>
struct Draws;

template <>
struct Draws<DIST_U8> {
  uint32_t w[NWORDS_U8];
  __device__ __forceinline__ Draws(uint32_t h1, uint32_t sbase) {
#pragma unroll
    for (int k = 0; k < NWORDS_U8; ++k) w[k] = hash_word(h1, sbase, k);
  }
  __device__ __forceinline__ float operator()(int a,
                                              const NoiseCoef& nc) const {
    const uint32_t b = (w[a >> 2] >> ((a & 3) * 8)) & 0xFFu;
    return static_cast<float>(b) * nc.scale + nc.off;
  }
};

template <>
struct Draws<DIST_CLT4> {
  uint32_t h1, sbase;
  __device__ __forceinline__ Draws(uint32_t h1_, uint32_t sbase_)
      : h1(h1_), sbase(sbase_) {}
  // SWAR byte sum: bytes 0+1 and 2+3 in the two 16-bit halves of one add,
  // then the halves fold.
  __device__ __forceinline__ float operator()(int a,
                                              const NoiseCoef& nc) const {
    const uint32_t w = hash_word(h1, sbase, a);
    const uint32_t t = (w & 0x00FF00FFu) + ((w >> 8) & 0x00FF00FFu);
    const uint32_t s = (t & 0xFFFFu) + (t >> 16);
    return static_cast<float>(s) * nc.scale + nc.off;
  }
};

template <>
struct Draws<DIST_CLT2> {
  uint32_t t[NWORDS_CLT2];   // the SWAR pair sums of each word
  __device__ __forceinline__ Draws(uint32_t h1, uint32_t sbase) {
#pragma unroll
    for (int k = 0; k < NWORDS_CLT2; ++k) {
      const uint32_t w = hash_word(h1, sbase, k);
      t[k] = (w & 0x00FF00FFu) + ((w >> 8) & 0x00FF00FFu);
    }
  }
  __device__ __forceinline__ float operator()(int a,
                                              const NoiseCoef& nc) const {
    const uint32_t v = (a & 1) ? (t[a >> 1] >> 16) : (t[a >> 1] & 0xFFFFu);
    return static_cast<float>(v) * nc.scale + nc.off;
  }
};

// A hash word's U(0, 1): the top 24 bits over 2^24 plus half a step, so
// never 0 (the product is exact, so a contracted FMA rounds the same).
__device__ __forceinline__ float hash_uniform(uint32_t w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f) +
         (0.5f / 16777216.0f);
}

template <>
struct Draws<DIST_BM> {
  float n[NDRAWS];
  __device__ __forceinline__ Draws(uint32_t h1, uint32_t sbase) {
#pragma unroll
    for (int p = 0; p < NPAIR_BM; ++p) {
      const float u1 = hash_uniform(hash_word(h1, sbase, 2 * p));
      const float u2 = hash_uniform(hash_word(h1, sbase, 2 * p + 1));
      const float r = sqrtf(-2.0f * logf(u1));
      const float th = TWO_PI * u2;
      if (2 * p + 1 < NDRAWS) {
        float sn, cs;
        sincosf(th, &sn, &cs);
        n[2 * p] = r * cs;
        n[2 * p + 1] = r * sn;
      } else {
        n[2 * p] = r * cosf(th);
      }
    }
  }
  __device__ __forceinline__ float operator()(int a,
                                              const NoiseCoef&) const {
    return n[a];
  }
};

// Equilibrium moments of one species at the barycentric velocity; the
// ghost rows 10..18 are zero.
__device__ __forceinline__ void eq_moments(float n, const float (&v)[3],
                                           float (&m)[Q]) {
  const float u2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  m[0] = n;
  m[1] = n * v[0];
  m[2] = n * v[1];
  m[3] = n * v[2];
  m[4] = n * u2;
  m[5] = n * (3.0f * v[0] * v[0] - u2);
  m[6] = n * (v[1] * v[1] - v[2] * v[2]);
  m[7] = n * v[0] * v[1];
  m[8] = n * v[1] * v[2];
  m[9] = n * v[0] * v[2];
#pragma unroll
  for (int k = 10; k < Q; ++k) m[k] = 0.0f;
}

// Guo force moments with the half-step prefactor s (rows 1..9; ph[0] is
// unused), at the species' own real velocity u and acceleration a.
__device__ __forceinline__ void guo_moments(float n, const float (&u)[3],
                                            const float (&a)[3], float s,
                                            float (&ph)[10]) {
  const float au = a[0] * u[0] + a[1] * u[1] + a[2] * u[2];
  const float sn = s * n;
  const float s2n = (s * 2.0f) * n;
  ph[0] = 0.0f;
  ph[1] = sn * a[0];
  ph[2] = sn * a[1];
  ph[3] = sn * a[2];
  ph[4] = s2n * au;
  ph[5] = sn * (6.0f * a[0] * u[0] - 2.0f * au);
  ph[6] = s2n * (a[1] * u[1] - a[2] * u[2]);
  ph[7] = sn * (a[0] * u[1] + a[1] * u[0]);
  ph[8] = sn * (a[1] * u[2] + a[2] * u[1]);
  ph[9] = sn * (a[0] * u[2] + a[2] * u[0]);
}

// Post-collide moments of one species.  Exact relaxation: momentum and
// stress rows m_eq + Guo + xi, ghost rows pure noise, the mass row without
// noise.  GENERAL (fused_step.py:1051-1064): rows k < 10 relax towards m_eq
// and ghost rows towards 0 at rate lam, r = lam (m_eq - m) (+ Guo on rows
// 1..9), m + r, then + xi.  m holds the streamed moments under GENERAL and
// is overwritten with the result.
template <bool NOISE, bool FORCE, bool GENERAL>
__device__ __forceinline__ void post_collide(float n, const float (&vb)[3],
                                             const float (&u)[3],
                                             const float (&a)[3], float s,
                                             float lam, const float (&xi)[Q],
                                             float (&m)[Q]) {
  float meq[Q];
  eq_moments(n, vb, meq);
  float ph[10];
  if (FORCE) guo_moments(n, u, a, s, ph);
  if (GENERAL) {
#pragma unroll
    for (int k = 1; k < Q; ++k) {
      float r = k < 10 ? lam * (meq[k] - m[k]) : -lam * m[k];
      if (FORCE && k < 10) r = r + ph[k];
      m[k] = m[k] + r;
      if (NOISE) m[k] = m[k] + xi[k];
    }
  } else {
    m[0] = meq[0];
#pragma unroll
    for (int k = 1; k < 10; ++k) {
      m[k] = meq[k];
      if (FORCE) m[k] = m[k] + ph[k];
      if (NOISE) m[k] = m[k] + xi[k];
    }
#pragma unroll
    for (int k = 10; k < Q; ++k) m[k] = NOISE ? xi[k] : 0.0f;
  }
}

// Moments -> populations: rows 1..18 through M_INV, the rest population by
// telescoping so the stored cell mass is m_0 up to one rounding.  Under
// exact relaxation without noise the ghost rows are zero and are skipped.
template <int NROWS>
__device__ __forceinline__ void store_pops(const float (&m)[Q],
                                           float* __restrict__ out,
                                           size_t plane, size_t idx) {
  float s = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    float fi = 0.0f;
#pragma unroll
    for (int k = 0; k < NROWS; ++k) fi += c_MINV[i][k] * m[k];
    s += fi;
    out[i * plane + idx] = fi;
  }
  out[idx] = m[0] - s;
}

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

// One pulled population pair (fi, gi) of direction i = (cx, cy, cz) into
// the densities and momenta, and under GENERAL the other rows of M.
template <bool GENERAL>
__device__ __forceinline__ void pull_add(int i, int cx, int cy, int cz,
                                         float fi, float gi, float& rho,
                                         float& phi, float (&jf)[3],
                                         float (&jg)[3], float (&mf)[Q],
                                         float (&mg)[Q]) {
  rho += fi;
  phi += gi;
  jf[0] += static_cast<float>(cx) * fi;
  jf[1] += static_cast<float>(cy) * fi;
  jf[2] += static_cast<float>(cz) * fi;
  jg[0] += static_cast<float>(cx) * gi;
  jg[1] += static_cast<float>(cy) * gi;
  jg[2] += static_cast<float>(cz) * gi;
  if (GENERAL) {
#pragma unroll
    for (int k = 4; k < Q; ++k) {
      mf[k] = fmaf(c_M[k][i], fi, mf[k]);
      mg[k] = fmaf(c_M[k][i], gi, mg[k]);
    }
  }
}

// The 19-point isotropic gradient sum_i (w_i / cs^2) c_i v(x + c_i) of
// both species of a (2, X, Y, Z) field v, at cell (x, y, z).
__device__ __forceinline__ void gradient2(const float* __restrict__ v,
                                          size_t plane, int x, int y, int z,
                                          int X, int Y, int Z,
                                          float (&g0)[3], float (&g1)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) g0[d] = g1[d] = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
    const size_t nb = cell_offset(wrap(x + cx, X), wrap(y + cy, Y),
                                  wrap(z + cz, Z), Y, Z);
    const float v0 = __ldg(v + nb);
    const float v1 = __ldg(v + plane + nb);
    const float w = c_GW[i];
    g0[0] += (w * static_cast<float>(cx)) * v0;
    g0[1] += (w * static_cast<float>(cy)) * v0;
    g0[2] += (w * static_cast<float>(cz)) * v0;
    g1[0] += (w * static_cast<float>(cx)) * v1;
    g1[1] += (w * static_cast<float>(cy)) * v1;
    g1[2] += (w * static_cast<float>(cz)) * v1;
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
  const Relax& rx = p.rx;

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

  const float inv_rho = safe_inv(rho, rx.eps);
  const float inv_phi = safe_inv(phi, rx.eps);
  const float inv_rhot = safe_inv(rho + phi, rx.eps);
  const float wf = phi * inv_rhot;
  const float wg = rho * inv_rhot;

  // Shan-Chen accelerations from psi of the streamed densities (skipped
  // under A1 with alpha0 = 0, as in the JAX kernel), then the alpha1
  // square-gradient force from the laplacian of psi.
  float af[3] = {0.0f, 0.0f, 0.0f}, ag[3] = {0.0f, 0.0f, 0.0f};
  if (FORCE && (!A1 || p.fc.k != 0.0f)) {
    float grad_rho[3], grad_phi[3];
    gradient2(p.psi, plane, x, y, z, X, Y, Z, grad_rho, grad_phi);
    const float psi_rho = __ldg(p.psi + idx);
    const float psi_phi = __ldg(p.psi + plane + idx);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      af[d] = p.fc.k * psi_rho * grad_phi[d] * inv_rho;
      ag[d] = p.fc.k * psi_phi * grad_rho[d] * inv_phi;
    }
  }
  if (A1) {
    float gl_rho[3], gl_phi[3];
    gradient2(p.lap, plane, x, y, z, X, Y, Z, gl_rho, gl_phi);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      af[d] = af[d] - p.fc.a1 * gl_phi[d];
      ag[d] = ag[d] - p.fc.a1 * gl_rho[d];
    }
  }

  // Noise moments xi_f, xi_g (rows 1..18; row 0 carries none), with the
  // amplitudes at the live densities or, under REF, at the stored ones.
  float xf[Q], xg[Q];
  if (NOISE) {
    const NoiseCoef& nc = p.nc;
    const uint32_t cell =
        EXT ? (static_cast<uint32_t>(x + p.ox) * p.GY +
               static_cast<uint32_t>(y + p.oy)) * p.GZ +
                  static_cast<uint32_t>(z + p.oz)
            : (static_cast<uint32_t>(x) * static_cast<uint32_t>(Y) +
               static_cast<uint32_t>(y)) * static_cast<uint32_t>(Z) +
                  static_cast<uint32_t>(z);
    const Draws<DIST> draw(mix32(cell ^ p.word), p.step * DRAW_STRIDE);
    float a_rho = rho, a_phi = phi, a_inv = inv_rhot;
    if (REF) {
      a_rho = __ldg(p.ref + idx);
      a_phi = __ldg(p.ref + plane + idx);
      a_inv = safe_inv(a_rho + a_phi, rx.eps);
    }
    const float amp_mom = sqrtf(nc.pref_mom * fabsf(a_rho * a_phi * a_inv));
    const float sq_rho = sqrtf(fabsf(a_rho));
    const float sq_phi = sqrtf(fabsf(a_phi));
    xf[0] = xg[0] = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float m = amp_mom * draw(d, nc);
      xf[1 + d] = m;
      xg[1 + d] = -m;
    }
#pragma unroll
    for (int a = 4; a < Q; ++a) {
      xf[a] = nc.cf[a - 4] * sq_rho * draw(a - 1, nc);
      xg[a] = nc.cg[a - 4] * sq_phi * draw(a + 14, nc);
    }
  }

  // Real velocities (LBM_binary.H:266-272) and the barycentric velocity.
  float uf[3], ug[3], vb[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float ufb = jf[d] * inv_rho;
    const float ugb = jg[d] * inv_phi;
    float dud = ufb - ugb;
    if (FORCE) dud = dud + 0.5f * (af[d] - ag[d]);
    uf[d] = ufb - rx.half_lam_f * wf * dud;
    ug[d] = ugb + rx.half_lam_g * wg * dud;
    if (FORCE) {
      uf[d] = uf[d] + 0.5f * af[d];
      ug[d] = ug[d] + 0.5f * ag[d];
    }
    if (NOISE) {
      uf[d] = uf[d] + 0.5f * xf[1 + d] * inv_rho;
      ug[d] = ug[d] + 0.5f * xg[1 + d] * inv_phi;
    }
    vb[d] = (rho * uf[d] + phi * ug[d]) * inv_rhot;
  }

  constexpr int NROWS = (NOISE || GENERAL) ? Q : 10;
  mf[0] = rho;
  mg[0] = phi;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    mf[1 + d] = jf[d];
    mg[1 + d] = jg[d];
  }
  post_collide<NOISE, FORCE, GENERAL>(rho, vb, uf, af, p.fc.s_f, rx.lam_f,
                                      xf, mf);
  store_pops<NROWS>(mf, p.fout, plane, idx);
  post_collide<NOISE, FORCE, GENERAL>(phi, vb, ug, ag, p.fc.s_g, rx.lam_g,
                                      xg, mg);
  store_pops<NROWS>(mg, p.gout, plane, idx);
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
