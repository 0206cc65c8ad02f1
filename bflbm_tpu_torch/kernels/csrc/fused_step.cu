// K = collide o stream of the fluctuating binary-fluid LBM, for NVIDIA
// Hopper (sm_90a), one thread per cell.
//
// Replaces the TPU kernel bflbm_tpu/kernels/fused_step.py:_step_kernel /
// _k_compute (the pl.pallas_call at fused_step.py:1956) in its exact-
// relaxation modes (tau_f = tau_g = 1/2), one step per launch:
//   - K1a, uncoupled (alpha0 = alpha1 = 0);
//   - K1b, coupled: the Shan-Chen force of alpha0 != 0 (fused_step.py:
//     748-808, 922-934, 982-988, 1009-1050), with psi of the streamed
//     densities read from a (2, X, Y, Z) array that csrc/density_psi.cu
//     writes just before, on the same stream;
// and the coordinate-keyed hash noise with u8 or clt4 deviates, or noise
// off.
//
// What bounds it: device memory.  A cell update reads the 19 float32
// populations of each of two species and writes as many back,
// 2 * 19 * 4 * 2 = 304 bytes (312 coupled, with psi), against roughly
// 1,500-2,000 flops (the two 18x19 back transforms dominate): about 5-6
// flops per byte, well below the card's float32 flop:byte balance.  So the
// design keeps ONE pass over memory per step: each thread pulls its 38
// inputs straight from device memory (the neighbours' overlapping reads,
// of populations and of psi, are served by L1/L2), keeps every
// intermediate in registers, and writes its 38 outputs once.  Threads run
// along z, so a warp's loads and stores touch contiguous addresses.  A pull
// cannot run in place, so the output is a separate buffer (the caller
// ping-pongs two pairs).
//
// Per cell: pull stream with periodic wrap; the four conserved moments of
// each species (the densities summed in the order i = 0..18, as the
// density pre-pass sums them); coupled: the 19-point isotropic gradient
// grad psi = sum_i (w_i / cs^2) c_i psi(x + c_i) and the accelerations
// a_f = -cs^2 alpha0 psi(rho) grad psi(phi) / rho, a_g likewise; real
// velocities with the friction, force and 0.5 xi / rho noise terms;
// barycentric equilibrium; post-collide moments (momentum and stress rows
// m_eq + Guo force moments + xi, ghost rows pure noise, mass row without
// noise); back transform of rows 1..18 with M_INV and the rest population
// by telescoping, f_0 = m_0 - sum_{i>=1} f_i.
//
// Noise bits are those of the JAX package's hash stream: h1 = mix32(cell ^
// word) with cell = (x*Y + y)*Z + z in uint32, and hash word k =
// mix32(h1 + (step*64 + k) * 0x9E3779B9).  Channel a of the 33 draws is
// byte a % 4 of word a / 4 under u8 (9 words a cell), and the byte sum of
// word a under clt4 (33 words a cell), scaled as b * scale + off.
//
// Tables: C, M_INV and the gradient weights w_i / cs^2 live in __constant__
// memory, filled once per device by bflbm_set_tables from the Python
// lattice module.  Element offsets are size_t (19*X*Y*Z exceeds int32 at
// 512^3); the hashed cell index stays 32-bit, as in the JAX package.
// Divisions are guarded, |x| > eps, and amplitudes take sqrt(|.|): near
// rho_lo = 0 a density can be 0 or slightly negative.  Build without fast
// math: it would move both.

#include "common.cuh"

namespace {

constexpr int NGHOST = Q - 4;   // noisy stress + ghost modes a = 4..18
constexpr int NWORDS_U8 = 9;    // 33 u8 draws, four per hash word
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t DRAW_STRIDE = 64u;

enum Dist : int { DIST_U8 = 0, DIST_CLT4 = 1 };

__constant__ int c_C[Q][3];
__constant__ float c_MINV[Q][Q];
__constant__ float c_GW[Q];     // w_i / cs^2, the gradient weights

struct NoiseCoef {
  float pref_mom;       // 2 (lam_f - lam_f^2 / 2) kBT
  float cf[NGHOST];     // sqrt(pref_f / cs^2 * b_a), a = 4..18
  float cg[NGHOST];     // sqrt(pref_g / cs^2 * b_a)
  float scale;          // deviate = b * scale + off: b a byte (u8) or
  float off;            // the byte sum of a word (clt4)
};

struct Relax {
  float eps;            // |rho| guard of the divisions (FLT_EPSILON)
  float half_lam_f;     // lam_f / 2
  float half_lam_g;
};

struct Force {          // coupled mode only
  float k;              // -cs^2 alpha0
  float s_f;            // Guo prefactor 1 / (1 + 1 / (2 tau_f))
  float s_g;
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

// Guo force moments with the half-step prefactor s (rows 1..9), added to m,
// at the species' own real velocity u and acceleration a.
__device__ __forceinline__ void add_guo(float n, const float (&u)[3],
                                        const float (&a)[3], float s,
                                        float (&m)[Q]) {
  const float au = a[0] * u[0] + a[1] * u[1] + a[2] * u[2];
  const float sn = s * n;
  const float s2n = (s * 2.0f) * n;
  m[1] = m[1] + sn * a[0];
  m[2] = m[2] + sn * a[1];
  m[3] = m[3] + sn * a[2];
  m[4] = m[4] + s2n * au;
  m[5] = m[5] + sn * (6.0f * a[0] * u[0] - 2.0f * au);
  m[6] = m[6] + s2n * (a[1] * u[1] - a[2] * u[2]);
  m[7] = m[7] + sn * (a[0] * u[1] + a[1] * u[0]);
  m[8] = m[8] + sn * (a[1] * u[2] + a[2] * u[1]);
  m[9] = m[9] + sn * (a[0] * u[2] + a[2] * u[0]);
}

// Noise kick under exact relaxation: momentum and stress rows m + xi, ghost
// rows pure noise, the mass row without noise.
__device__ __forceinline__ void add_noise(const float (&xi)[Q],
                                          float (&m)[Q]) {
#pragma unroll
  for (int k = 1; k < 10; ++k) m[k] = m[k] + xi[k];
#pragma unroll
  for (int k = 10; k < Q; ++k) m[k] = xi[k];
}

// Moments -> populations: rows 1..18 through M_INV, the rest population by
// telescoping so the stored cell mass is m_0 up to one rounding.  Without
// noise the ghost rows are zero and are skipped.
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

template <bool NOISE, int DIST, bool FORCE>
__global__ void __launch_bounds__(BLOCK)
k_step_kernel(const float* __restrict__ fin, const float* __restrict__ gin,
              const float* __restrict__ psi, float* __restrict__ fout,
              float* __restrict__ gout, int X, int Y, int Z, uint32_t word,
              uint32_t step, Relax rx, NoiseCoef nc, Force fc) {
  const int z = blockIdx.x * BLOCK + threadIdx.x;
  if (z >= Z) return;
  const int y = blockIdx.y;
  const int x = blockIdx.z;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const size_t idx = cell_offset(x, y, z, Y, Z);

  // Pull stream: population i at x is the input's at x - c_i.  Exact
  // relaxation consumes only the four conserved moments of the streamed
  // populations, so they are accumulated as the loads arrive.
  float rho = 0.0f, phi = 0.0f;
  float jf[3] = {0.0f, 0.0f, 0.0f};
  float jg[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
    const size_t src = i * plane + cell_offset(wrap(x - cx, X),
                                               wrap(y - cy, Y),
                                               wrap(z - cz, Z), Y, Z);
    const float fi = __ldg(fin + src);
    const float gi = __ldg(gin + src);
    rho += fi;
    phi += gi;
    jf[0] += static_cast<float>(cx) * fi;
    jf[1] += static_cast<float>(cy) * fi;
    jf[2] += static_cast<float>(cz) * fi;
    jg[0] += static_cast<float>(cx) * gi;
    jg[1] += static_cast<float>(cy) * gi;
    jg[2] += static_cast<float>(cz) * gi;
  }

  const float inv_rho = safe_inv(rho, rx.eps);
  const float inv_phi = safe_inv(phi, rx.eps);
  const float inv_rhot = safe_inv(rho + phi, rx.eps);
  const float wf = phi * inv_rhot;
  const float wg = rho * inv_rhot;

  // Shan-Chen accelerations from psi of the streamed densities.
  float af[3], ag[3];
  if (FORCE) {
    float grad_rho[3] = {0.0f, 0.0f, 0.0f};
    float grad_phi[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 1; i < Q; ++i) {
      const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
      const size_t nb = cell_offset(wrap(x + cx, X), wrap(y + cy, Y),
                                    wrap(z + cz, Z), Y, Z);
      const float pr = __ldg(psi + nb);
      const float pp = __ldg(psi + plane + nb);
      const float w = c_GW[i];
      grad_rho[0] += (w * static_cast<float>(cx)) * pr;
      grad_rho[1] += (w * static_cast<float>(cy)) * pr;
      grad_rho[2] += (w * static_cast<float>(cz)) * pr;
      grad_phi[0] += (w * static_cast<float>(cx)) * pp;
      grad_phi[1] += (w * static_cast<float>(cy)) * pp;
      grad_phi[2] += (w * static_cast<float>(cz)) * pp;
    }
    const float psi_rho = __ldg(psi + idx);
    const float psi_phi = __ldg(psi + plane + idx);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      af[d] = fc.k * psi_rho * grad_phi[d] * inv_rho;
      ag[d] = fc.k * psi_phi * grad_rho[d] * inv_phi;
    }
  }

  // Noise moments xi_f, xi_g (rows 1..18; row 0 carries none).
  float xf[Q], xg[Q];
  if (NOISE) {
    const uint32_t cell =
        (static_cast<uint32_t>(x) * static_cast<uint32_t>(Y) +
         static_cast<uint32_t>(y)) * static_cast<uint32_t>(Z) +
        static_cast<uint32_t>(z);
    const Draws<DIST> draw(mix32(cell ^ word), step * DRAW_STRIDE);
    const float amp_mom = sqrtf(nc.pref_mom * fabsf(rho * phi * inv_rhot));
    const float sq_rho = sqrtf(fabsf(rho));
    const float sq_phi = sqrtf(fabsf(phi));
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

  constexpr int NROWS = NOISE ? Q : 10;
  float m[Q];
  eq_moments(rho, vb, m);
  if (FORCE) add_guo(rho, uf, af, fc.s_f, m);
  if (NOISE) add_noise(xf, m);
  store_pops<NROWS>(m, fout, plane, idx);
  eq_moments(phi, vb, m);
  if (FORCE) add_guo(phi, ug, ag, fc.s_g, m);
  if (NOISE) add_noise(xg, m);
  store_pops<NROWS>(m, gout, plane, idx);
}

template <bool NOISE, int DIST, bool FORCE>
void launch(dim3 grid, cudaStream_t s, const float* fin, const float* gin,
            const float* psi, float* fout, float* gout, int X, int Y, int Z,
            uint32_t w, uint32_t st, const Relax& rx, const NoiseCoef& nc,
            const Force& fc) {
  k_step_kernel<NOISE, DIST, FORCE><<<grid, BLOCK, 0, s>>>(
      fin, gin, psi, fout, gout, X, Y, Z, w, st, rx, nc, fc);
}

template <bool FORCE>
int launch_mode(int noise_on, int dist, dim3 grid, cudaStream_t s,
                const float* fin, const float* gin, const float* psi,
                float* fout, float* gout, int X, int Y, int Z, uint32_t w,
                uint32_t st, const Relax& rx, const NoiseCoef& nc,
                const Force& fc) {
  if (!noise_on)
    launch<false, DIST_U8, FORCE>(grid, s, fin, gin, psi, fout, gout, X, Y,
                                  Z, w, st, rx, nc, fc);
  else if (dist == DIST_U8)
    launch<true, DIST_U8, FORCE>(grid, s, fin, gin, psi, fout, gout, X, Y,
                                 Z, w, st, rx, nc, fc);
  else if (dist == DIST_CLT4)
    launch<true, DIST_CLT4, FORCE>(grid, s, fin, gin, psi, fout, gout, X, Y,
                                   Z, w, st, rx, nc, fc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bflbm_set_tables(int device, const int* c, const float* minv,
                                const float* gw) {
  DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_C, c, sizeof(int) * Q * 3);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(c_MINV, minv, sizeof(float) * Q * Q);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_GW, gw, sizeof(float) * Q);
  return static_cast<int>(e);
}

// One K step on device pointers (19, X, Y, Z) float32, z contiguous.
// psi: the (2, X, Y, Z) psi densities of the streamed input for the coupled
// mode, or null for the uncoupled one.  dist: 0 u8, 1 clt4.
// coef: host array [pref_mom, cf[15], cg[15], scale, off].
// force_k = -cs^2 alpha0; s_f, s_g the Guo prefactors.
// Returns cudaGetLastError() after the launch.
extern "C" int bflbm_fused_step(int device, const float* fin,
                                const float* gin, const float* psi,
                                float* fout, float* gout, int X, int Y,
                                int Z, int word, int step, float eps,
                                float half_lam_f, float half_lam_g,
                                int noise_on, int dist, const float* coef,
                                float force_k, float s_f, float s_g,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const Relax rx{eps, half_lam_f, half_lam_g};
  const Force fc{force_k, s_f, s_g};
  NoiseCoef nc;
  nc.pref_mom = coef[0];
  for (int a = 0; a < NGHOST; ++a) {
    nc.cf[a] = coef[1 + a];
    nc.cg[a] = coef[1 + NGHOST + a];
  }
  nc.scale = coef[1 + 2 * NGHOST];
  nc.off = coef[2 + 2 * NGHOST];
  const dim3 grid = cell_grid(X, Y, Z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t w = static_cast<uint32_t>(word);
  const uint32_t st = static_cast<uint32_t>(step);
  if (psi != nullptr)
    return launch_mode<true>(noise_on, dist, grid, s, fin, gin, psi, fout,
                             gout, X, Y, Z, w, st, rx, nc, fc);
  return launch_mode<false>(noise_on, dist, grid, s, fin, gin, psi, fout,
                            gout, X, Y, Z, w, st, rx, nc, fc);
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
