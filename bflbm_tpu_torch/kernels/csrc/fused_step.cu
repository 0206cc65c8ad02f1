// K = collide o stream of the fluctuating binary-fluid LBM, for NVIDIA
// Hopper (sm_90a), one thread per cell.
//
// Replaces the TPU kernel bflbm_tpu/kernels/fused_step.py:_step_kernel /
// _k_compute (the pl.pallas_call at fused_step.py:1956) in the mode of the
// main path: uncoupled (alpha0 = alpha1 = 0), exact relaxation
// (tau_f = tau_g = 1/2), one step per launch, and the coordinate-keyed hash
// noise with u8 deviates, or noise off.
//
// What bounds it: device memory.  A cell update reads the 19 float32
// populations of each of two species and writes as many back,
// 2 * 19 * 4 * 2 = 304 bytes, against roughly 1,500 flops (the two 18x19
// back transforms dominate): about 5 flops per byte, well below the card's
// float32 flop:byte balance.  So the design keeps ONE pass over memory per
// step: each thread pulls its 38 inputs straight from device memory (the
// neighbours' overlapping reads are served by L1/L2), keeps every
// intermediate in registers, and writes its 38 outputs once.  Threads run
// along z, so a warp's loads and stores touch contiguous addresses.  A pull
// cannot run in place, so the output is a separate buffer (the caller
// ping-pongs two pairs).
//
// Per cell: pull stream with periodic wrap; the four conserved moments of
// each species; real velocities with the friction and 0.5 xi / rho noise
// terms; barycentric equilibrium; post-collide moments (momentum and stress
// rows m_eq + xi, ghost rows pure noise, mass row without noise); back
// transform of rows 1..18 with M_INV and the rest population by
// telescoping, f_0 = m_0 - sum_{i>=1} f_i.
//
// Noise bits are those of the JAX package's hash stream: h1 = mix32(cell ^
// word) with cell = (x*Y + y)*Z + z in uint32, and hash word k =
// mix32(h1 + (step*64 + k) * 0x9E3779B9).  Channel a of the 33 draws is byte
// a % 4 of word a / 4, scaled as b * u8_scale + u8_off.
//
// Tables: C and M_INV live in __constant__ memory, filled once per device
// by bflbm_set_tables from the Python lattice module.  Element offsets are
// size_t (19*X*Y*Z exceeds int32 at 512^3); the hashed cell index stays
// 32-bit, as in the JAX package.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int Q = 19;
constexpr int NGHOST = Q - 4;   // noisy stress + ghost modes a = 4..18
constexpr int NWORDS = 9;       // 33 u8 draws, four per hash word
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t DRAW_STRIDE = 64u;
constexpr int BLOCK = 128;

__constant__ int c_C[Q][3];
__constant__ float c_MINV[Q][Q];

struct NoiseCoef {
  float pref_mom;       // 2 (lam_f - lam_f^2 / 2) kBT
  float cf[NGHOST];     // sqrt(pref_f / cs^2 * b_a), a = 4..18
  float cg[NGHOST];     // sqrt(pref_g / cs^2 * b_a)
  float u8_scale;
  float u8_off;
};

struct Relax {
  float eps;            // |rho| guard of the divisions (FLT_EPSILON)
  float half_lam_f;     // lam_f / 2
  float half_lam_g;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float safe_inv(float x, float eps) {
  return fabsf(x) > eps ? 1.0f / x : 0.0f;
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Draw a (0..32) of the cell's u8 stream.
__device__ __forceinline__ float u8_draw(const uint32_t (&w)[NWORDS], int a,
                                         const NoiseCoef& nc) {
  const uint32_t b = (w[a >> 2] >> ((a & 3) * 8)) & 0xFFu;
  return static_cast<float>(b) * nc.u8_scale + nc.u8_off;
}

// Post-collide moments of one species under exact relaxation.
template <bool NOISE>
__device__ __forceinline__ void post_moments(float n, const float (&v)[3],
                                             const float (&xi)[Q],
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
  for (int k = 1; k < 10; ++k) m[k] = NOISE ? m[k] + xi[k] : m[k];
#pragma unroll
  for (int k = 10; k < Q; ++k) m[k] = NOISE ? xi[k] : 0.0f;
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

template <bool NOISE>
__global__ void __launch_bounds__(BLOCK)
k_step_kernel(const float* __restrict__ fin, const float* __restrict__ gin,
              float* __restrict__ fout, float* __restrict__ gout, int X,
              int Y, int Z, uint32_t word, uint32_t step, Relax rx,
              NoiseCoef nc) {
  const int z = blockIdx.x * BLOCK + threadIdx.x;
  if (z >= Z) return;
  const int y = blockIdx.y;
  const int x = blockIdx.z;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const size_t idx = (static_cast<size_t>(x) * Y + y) * Z + z;

  // Pull stream: population i at x is the input's at x - c_i.  Exact
  // relaxation consumes only the four conserved moments of the streamed
  // populations, so they are accumulated as the loads arrive.
  float rho = 0.0f, phi = 0.0f;
  float jf[3] = {0.0f, 0.0f, 0.0f};
  float jg[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int cx = c_C[i][0], cy = c_C[i][1], cz = c_C[i][2];
    const size_t src =
        i * plane +
        (static_cast<size_t>(wrap(x - cx, X)) * Y + wrap(y - cy, Y)) * Z +
        wrap(z - cz, Z);
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

  // Noise moments xi_f, xi_g (rows 1..18; row 0 carries none).
  float xf[Q], xg[Q];
  if (NOISE) {
    const uint32_t cell =
        (static_cast<uint32_t>(x) * static_cast<uint32_t>(Y) +
         static_cast<uint32_t>(y)) * static_cast<uint32_t>(Z) +
        static_cast<uint32_t>(z);
    const uint32_t h1 = mix32(cell ^ word);
    const uint32_t sbase = step * DRAW_STRIDE;
    uint32_t w[NWORDS];
#pragma unroll
    for (int k = 0; k < NWORDS; ++k)
      w[k] = mix32(h1 + (sbase + static_cast<uint32_t>(k)) * GOLDEN);
    const float amp_mom = sqrtf(nc.pref_mom * fabsf(rho * phi * inv_rhot));
    const float sq_rho = sqrtf(fabsf(rho));
    const float sq_phi = sqrtf(fabsf(phi));
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float m = amp_mom * u8_draw(w, d, nc);
      xf[1 + d] = m;
      xg[1 + d] = -m;
    }
#pragma unroll
    for (int a = 4; a < Q; ++a) {
      xf[a] = nc.cf[a - 4] * sq_rho * u8_draw(w, a - 1, nc);
      xg[a] = nc.cg[a - 4] * sq_phi * u8_draw(w, a + 14, nc);
    }
  }

  // Real velocities (LBM_binary.H:266-272) and the barycentric velocity.
  float vb[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float ufb = jf[d] * inv_rho;
    const float ugb = jg[d] * inv_phi;
    const float dud = ufb - ugb;
    float uf = ufb - rx.half_lam_f * wf * dud;
    float ug = ugb + rx.half_lam_g * wg * dud;
    if (NOISE) {
      uf = uf + 0.5f * xf[1 + d] * inv_rho;
      ug = ug + 0.5f * xg[1 + d] * inv_phi;
    }
    vb[d] = (rho * uf + phi * ug) * inv_rhot;
  }

  constexpr int NROWS = NOISE ? Q : 10;
  float m[Q];
  post_moments<NOISE>(rho, vb, xf, m);
  store_pops<NROWS>(m, fout, plane, idx);
  post_moments<NOISE>(phi, vb, xg, m);
  store_pops<NROWS>(m, gout, plane, idx);
}

// Makes `device` current for its lifetime and restores the caller's
// current device afterwards, so a call on another card leaves the thread's
// device (and so the caller's later allocations) where they were.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) err_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (err_ == cudaSuccess) cudaSetDevice(prev_);
  }
  cudaError_t status() const { return err_; }

 private:
  int prev_ = 0;
  cudaError_t err_;
};

}  // namespace

extern "C" int bflbm_set_tables(int device, const int* c, const float* minv) {
  DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_C, c, sizeof(int) * Q * 3);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(c_MINV, minv, sizeof(float) * Q * Q);
  return static_cast<int>(e);
}

// One K step on device pointers (19, X, Y, Z) float32, z contiguous.
// coef: host array [pref_mom, cf[15], cg[15], u8_scale, u8_off].
// Returns cudaGetLastError() after the launch.
extern "C" int bflbm_fused_step(int device, const float* fin,
                                const float* gin, float* fout, float* gout,
                                int X, int Y, int Z, int word, int step,
                                float eps, float half_lam_f, float half_lam_g,
                                int noise_on, const float* coef,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const Relax rx{eps, half_lam_f, half_lam_g};
  NoiseCoef nc;
  nc.pref_mom = coef[0];
  for (int a = 0; a < NGHOST; ++a) {
    nc.cf[a] = coef[1 + a];
    nc.cg[a] = coef[1 + NGHOST + a];
  }
  nc.u8_scale = coef[1 + 2 * NGHOST];
  nc.u8_off = coef[2 + 2 * NGHOST];
  const dim3 grid((Z + BLOCK - 1) / BLOCK, Y, X);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t w = static_cast<uint32_t>(word);
  const uint32_t st = static_cast<uint32_t>(step);
  if (noise_on)
    k_step_kernel<true><<<grid, BLOCK, 0, s>>>(fin, gin, fout, gout, X, Y, Z,
                                               w, st, rx, nc);
  else
    k_step_kernel<false><<<grid, BLOCK, 0, s>>>(fin, gin, fout, gout, X, Y,
                                                Z, w, st, rx, nc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
