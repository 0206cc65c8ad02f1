// The arithmetic of one cell of K = collide o stream, shared by the
// kernels that run it: csrc/fused_step.cu (one step per launch) and
// csrc/blocked_step.cu (T steps per launch, the intermediate steps in
// shared memory).  A kernel pulls the 19 populations of each species from
// wherever it keeps them, summing them with pull_add in the order
// i = 0..18, and expands BFLBM_COLLIDE_CELL, which finishes the cell and
// stores its 38 post-collide populations: both kernels compile the same
// expressions, so a cell comes out of a blocked launch as it does out of a
// one-step launch.  The modes, the noise bits and the tables are
// described in csrc/fused_step.cu.  Everything here has internal linkage;
// each library fills its own __constant__ tables (bflbm_set_tables).

#pragma once

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
// M: no kernel reads it (general relaxation runs in population space, with
// M_INV alone); bflbm_set_tables fills it, and its place in the constant
// bank is the one the other tables' offsets are compiled against.
__constant__ float c_M[Q][Q];
__constant__ float c_MINV[Q][Q];
__constant__ float c_GW[Q];     // w_i / cs^2, the gradient weights

// Where the cell arithmetic reads the lattice tables: a class with static
// c(i, d) and minv(i, k).  ConstTables: the __constant__ tables above (the
// one-step kernels, where each read becomes a constant-bank operand);
// csrc/stencil_tile.cuh has ImmTables.
struct ConstTables {
  static __device__ __forceinline__ int c(int i, int d) { return c_C[i][d]; }
  static __device__ __forceinline__ float minv(int i, int k) {
    return c_MINV[i][k];
  }
};

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

// Box-Muller: the normals of pair p are the cosine (draw 2p) and sine (draw
// 2p + 1) of the angle 2 pi u(word 2p + 1) at radius sqrt(-2 log u(word
// 2p)).  A pair is made when its even draw is asked for, and its sine kept
// for the odd draw that must follow it: the cell asks for the draws in
// order (BFLBM_COLLIDE_CELL_WITH), so one normal is live at a time.  Draw
// 32 ends the stream: its pair's sine is never used, so it takes cosf.
// The order is the caller's contract, unchecked: odd draw a must come
// right after even draw a - 1 of the same object, or it returns another
// pair's sine.  Taking both normals of a pair at once (a stateless
// pair(p)) kept the one-step kernels' bits but moved B-A1's rounding
// away from the alpha1 K4 launch's (H100), so the stateful form stays.
template <>
struct Draws<DIST_BM> {
  uint32_t h1, sbase;
  mutable float sine;
  __device__ __forceinline__ Draws(uint32_t h1_, uint32_t sbase_)
      : h1(h1_), sbase(sbase_), sine(0.0f) {}
  __device__ __forceinline__ float operator()(int a,
                                              const NoiseCoef&) const {
    if (a & 1) return sine;
    const float u1 = hash_uniform(hash_word(h1, sbase, a));
    const float u2 = hash_uniform(hash_word(h1, sbase, a + 1));
    const float r = sqrtf(-2.0f * logf(u1));
    const float th = TWO_PI * u2;
    if (a + 1 < NDRAWS) {
      float sn, cs;
      sincosf(th, &sn, &cs);
      sine = r * sn;
      return r * cs;
    }
    return r * cosf(th);
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

// Post-collide moments of one species, exact relaxation: momentum and
// stress rows m_eq + Guo + xi, ghost rows pure noise, the mass row without
// noise.  Under GENERAL (fused_step.py:1051-1064) every row k >= 1 relaxes
// at the one rate lam, rows k < 10 towards m_eq and the ghost rows towards
// 0, so m' = (1 - lam) m + q with q = lam m_eq (+ Guo on rows 1..9) (+ xi)
// and q_0 = lam n (m'_0 = n): m is overwritten with q, which
// store_relaxed takes to populations beside the streamed ones.
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
  m[0] = GENERAL ? lam * n : meq[0];
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    m[k] = GENERAL ? lam * meq[k] : meq[k];
    if (FORCE) m[k] = m[k] + ph[k];
    if (NOISE) m[k] = m[k] + xi[k];
  }
#pragma unroll
  for (int k = 10; k < Q; ++k) m[k] = NOISE ? xi[k] : 0.0f;
}

// Moments -> populations: rows 1..18 through M_INV, the rest population by
// telescoping so the stored cell mass is m_0 up to one rounding.  Under
// exact relaxation without noise the ghost rows are zero and are skipped.
template <int NROWS, class Tab = ConstTables>
__device__ __forceinline__ void store_pops(const float (&m)[Q],
                                           float* __restrict__ out,
                                           size_t plane, size_t idx) {
  float s = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    float fi = 0.0f;
#pragma unroll
    for (int k = 0; k < NROWS; ++k) fi += Tab::minv(i, k) * m[k];
    s += fi;
    out[i * plane + idx] = fi;
  }
  out[idx] = m[0] - s;
}

// General relaxation in population space: f'_i = (1 - lam) f_i + [M_INV
// q]_i for i >= 1, the streamed f_i read through pop(i), and the rest
// population by telescoping to the cell mass n.  All 19 rows of q, the
// ghost rows zero without noise: skipping them (NROWS = 10) took the
// noise-off kernels to 157-168 registers (H100, ptxas).
template <int NROWS, class Tab = ConstTables, class Pop>
__device__ __forceinline__ void store_relaxed(float n, float keep,
                                              const Pop& pop,
                                              const float (&q)[Q],
                                              float* __restrict__ out,
                                              size_t plane, size_t idx) {
  float s = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < NROWS; ++k) t += Tab::minv(i, k) * q[k];
    const float fi = fmaf(keep, pop(i), t);
    s += fi;
    out[i * plane + idx] = fi;
  }
  out[idx] = n - s;
}

// One pulled population pair (fi, gi) of direction (cx, cy, cz) into the
// densities and momenta.
__device__ __forceinline__ void pull_add(int cx, int cy, int cz, float fi,
                                         float gi, float& rho, float& phi,
                                         float (&jf)[3], float (&jg)[3]) {
  rho += fi;
  phi += gi;
  jf[0] += static_cast<float>(cx) * fi;
  jf[1] += static_cast<float>(cy) * fi;
  jf[2] += static_cast<float>(cz) * fi;
  jg[0] += static_cast<float>(cx) * gi;
  jg[1] += static_cast<float>(cy) * gi;
  jg[2] += static_cast<float>(cz) * gi;
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

// Everything after the pull, written once for every kernel that runs K:
// expanded in place in the kernel (a __device__ function boundary here
// moved the one-step kernels' compiled code: one of them ran 3% slower), so
// a kernel that pulls its 38 populations into rho, phi, jf, jg finishes the
// cell with the same expressions as every other.  It reads the enclosing
// kernel's template flags NOISE, DIST, FORCE, GENERAL, REF, A1 and EXT and
// its locals X, Y, Z (the arrays' extents), plane and idx (the cell's
// element offset in the (2, X, Y, Z) operands psi, lap and ref, whose
// planes hold `plane` elements), rho, phi, jf and jg.  ARGS: the Args of
// the launch; WORD, STEP: the noise word and step label; (CX, CY, CZ): the
// cell in the arrays, its hash key (under EXT offset by the array's global
// origin, with the global extents) and the centre of the FORCE and A1
// gradients; the 19 post-collide populations of each species are stored
// as FOUT[i * OPLANE + OIDX] and GOUT[...]; TAB: where the back transform
// reads M_INV; POPS(S, I): the streamed population I of species S (0: f,
// 1: g), read under GENERAL only (store_relaxed).  The accelerations come
// from BFLBM_FORCES_FROM_ARRAYS; BFLBM_COLLIDE_CELL_WITH takes another
// macro of the same arguments in its place (FORCES), which sets af and ag
// from inv_rho and inv_phi with the same arithmetic on psi and lap kept
// elsewhere (csrc/blocked_step.cu, in shared memory).
#define BFLBM_COLLIDE_CELL(ARGS, WORD, STEP, CX, CY, CZ, FOUT, GOUT,       \
                           OPLANE, OIDX, TAB, POPS)                       \
  BFLBM_COLLIDE_CELL_WITH(ARGS, WORD, STEP, CX, CY, CZ, FOUT, GOUT, OPLANE, \
                          OIDX, TAB, BFLBM_FORCES_FROM_ARRAYS, POPS)

// Shan-Chen accelerations from psi of the streamed densities (skipped
// under A1 with alpha0 = 0, as in the JAX kernel), then the alpha1
// square-gradient force from the laplacian of psi: the (2, X, Y, Z)
// arrays ARGS.psi and ARGS.lap, neighbours through gradient2.
#define BFLBM_FORCES_FROM_ARRAYS(ARGS, CX, CY, CZ)                           \
  if (FORCE && (!A1 || ARGS.fc.k != 0.0f)) {                                  \
    float grad_rho[3], grad_phi[3];                                           \
    gradient2(ARGS.psi, plane, CX, CY, CZ, X, Y, Z, grad_rho, grad_phi);      \
    const float psi_rho = __ldg(ARGS.psi + idx);                              \
    const float psi_phi = __ldg(ARGS.psi + plane + idx);                      \
_Pragma("unroll")                                                             \
    for (int d = 0; d < 3; ++d) {                                             \
      af[d] = ARGS.fc.k * psi_rho * grad_phi[d] * inv_rho;                    \
      ag[d] = ARGS.fc.k * psi_phi * grad_rho[d] * inv_phi;                    \
    }                                                                         \
  }                                                                           \
  if (A1) {                                                                   \
    float gl_rho[3], gl_phi[3];                                               \
    gradient2(ARGS.lap, plane, CX, CY, CZ, X, Y, Z, gl_rho, gl_phi);          \
_Pragma("unroll")                                                             \
    for (int d = 0; d < 3; ++d) {                                             \
      af[d] = af[d] - ARGS.fc.a1 * gl_phi[d];                                 \
      ag[d] = ag[d] - ARGS.fc.a1 * gl_rho[d];                                 \
    }                                                                         \
  }

#define BFLBM_COLLIDE_CELL_WITH(ARGS, WORD, STEP, CX, CY, CZ, FOUT, GOUT,  \
                                OPLANE, OIDX, TAB, FORCES, POPS)          \
  do {                                                                        \
  const Relax& rx = ARGS.rx;                                                  \
  const float inv_rho = safe_inv(rho, rx.eps);                                \
  const float inv_phi = safe_inv(phi, rx.eps);                                \
  const float inv_rhot = safe_inv(rho + phi, rx.eps);                         \
  const float wf = phi * inv_rhot;                                            \
  const float wg = rho * inv_rhot;                                            \
                                                                              \
  float af[3] = {0.0f, 0.0f, 0.0f}, ag[3] = {0.0f, 0.0f, 0.0f};               \
  FORCES(ARGS, CX, CY, CZ)                                                    \
                                                                              \
  /* Noise moments xi_f, xi_g (rows 1..18; row 0 carries none), with the */   \
  /* amplitudes at the live densities or, under REF, at the stored ones. */   \
  float xf[Q], xg[Q];                                                         \
  if (NOISE) {                                                                \
    const NoiseCoef& nc = ARGS.nc;                                            \
    const uint32_t cell =                                                     \
        EXT ? (static_cast<uint32_t>(CX + ARGS.ox) * ARGS.GY +                \
               static_cast<uint32_t>(CY + ARGS.oy)) * ARGS.GZ +               \
                  static_cast<uint32_t>(CZ + ARGS.oz)                         \
            : (static_cast<uint32_t>(CX) * static_cast<uint32_t>(Y) +         \
               static_cast<uint32_t>(CY)) * static_cast<uint32_t>(Z) +        \
                  static_cast<uint32_t>(CZ);                                  \
    const Draws<DIST> draw(mix32(cell ^ (WORD)), (STEP) * DRAW_STRIDE);       \
    float a_rho = rho, a_phi = phi, a_inv = inv_rhot;                         \
    if (REF) {                                                                \
      a_rho = __ldg(ARGS.ref + idx);                                          \
      a_phi = __ldg(ARGS.ref + plane + idx);                                  \
      a_inv = safe_inv(a_rho + a_phi, rx.eps);                                \
    }                                                                         \
    const float amp_mom = sqrtf(nc.pref_mom * fabsf(a_rho * a_phi * a_inv));  \
    const float sq_rho = sqrtf(fabsf(a_rho));                                 \
    const float sq_phi = sqrtf(fabsf(a_phi));                                 \
    xf[0] = xg[0] = 0.0f;                                                     \
_Pragma("unroll")                                                             \
    for (int d = 0; d < 3; ++d) {                                             \
      const float m = amp_mom * draw(d, nc);                                  \
      xf[1 + d] = m;                                                          \
      xg[1 + d] = -m;                                                         \
    }                                                                         \
    if constexpr (DIST == DIST_BM) {                                          \
      /* the draws in order, as Draws<DIST_BM> makes them: xf's rows, */      \
      /* then xg's */                                                         \
_Pragma("unroll")                                                             \
      for (int a = 4; a < Q; ++a)                                             \
        xf[a] = nc.cf[a - 4] * sq_rho * draw(a - 1, nc);                      \
_Pragma("unroll")                                                             \
      for (int a = 4; a < Q; ++a)                                             \
        xg[a] = nc.cg[a - 4] * sq_phi * draw(a + 14, nc);                     \
    } else {                                                                  \
_Pragma("unroll")                                                             \
      for (int a = 4; a < Q; ++a) {                                           \
        xf[a] = nc.cf[a - 4] * sq_rho * draw(a - 1, nc);                      \
        xg[a] = nc.cg[a - 4] * sq_phi * draw(a + 14, nc);                     \
      }                                                                       \
    }                                                                         \
  }                                                                           \
                                                                              \
  /* Real velocities (LBM_binary.H:266-272) and the barycentric velocity. */  \
  float uf[3], ug[3], vb[3];                                                  \
_Pragma("unroll")                                                             \
  for (int d = 0; d < 3; ++d) {                                               \
    const float ufb = jf[d] * inv_rho;                                        \
    const float ugb = jg[d] * inv_phi;                                        \
    float dud = ufb - ugb;                                                    \
    if (FORCE) dud = dud + 0.5f * (af[d] - ag[d]);                            \
    uf[d] = ufb - rx.half_lam_f * wf * dud;                                   \
    ug[d] = ugb + rx.half_lam_g * wg * dud;                                   \
    if (FORCE) {                                                              \
      uf[d] = uf[d] + 0.5f * af[d];                                           \
      ug[d] = ug[d] + 0.5f * ag[d];                                           \
    }                                                                         \
    if (NOISE) {                                                              \
      uf[d] = uf[d] + 0.5f * xf[1 + d] * inv_rho;                             \
      ug[d] = ug[d] + 0.5f * xg[1 + d] * inv_phi;                             \
    }                                                                         \
    vb[d] = (rho * uf[d] + phi * ug[d]) * inv_rhot;                           \
  }                                                                           \
                                                                              \
  constexpr int NROWS = (NOISE || GENERAL) ? Q : 10;                          \
  float mf[Q], mg[Q];                                                         \
  post_collide<NOISE, FORCE, GENERAL>(rho, vb, uf, af, ARGS.fc.s_f, rx.lam_f, \
                                      xf, mf);                                \
  if constexpr (GENERAL)                                                      \
    store_relaxed<NROWS, TAB>(rho, 1.0f - rx.lam_f,                           \
                              [&](int i_) { return POPS(0, i_); }, mf, FOUT,  \
                              OPLANE, OIDX);                                  \
  else                                                                        \
    store_pops<NROWS, TAB>(mf, FOUT, OPLANE, OIDX);                           \
  post_collide<NOISE, FORCE, GENERAL>(phi, vb, ug, ag, ARGS.fc.s_g, rx.lam_g, \
                                      xg, mg);                                \
  if constexpr (GENERAL)                                                      \
    store_relaxed<NROWS, TAB>(phi, 1.0f - rx.lam_g,                           \
                              [&](int i_) { return POPS(1, i_); }, mg, GOUT,  \
                              OPLANE, OIDX);                                  \
  else                                                                        \
    store_pops<NROWS, TAB>(mg, GOUT, OPLANE, OIDX);                           \
  } while (0)

}  // namespace
