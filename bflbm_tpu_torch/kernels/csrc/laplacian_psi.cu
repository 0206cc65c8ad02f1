// Laplacian pre-pass of the alpha1 K step, for NVIDIA Hopper (sm_90a), one
// thread per cell.
//
// Replaces the laplacian part of the TPU kernel's alpha1 mode (bflbm_tpu/
// kernels/fused_step.py:_k_compute, lines 810-826: lap_ext1 on the
// 1-cell-extended window of psi given on the 2-cell-extended one, inside
// the pl.pallas_call at fused_step.py:1956).  On the TPU the laplacian is
// recomputed on a halo inside one tile, at stencil depth 3; here the step
// runs in three passes on the same stream: the density pre-pass
// (csrc/density_psi.cu) writes psi, this pass writes its laplacian for the
// whole domain, and the K kernel (csrc/fused_step.cu, A1) reads its
// neighbours' laplacian back for the gradient.
//
// Per cell and species: lap psi(x) = (2 / cs^2) (sum_{i=1..18} w_i
// psi(x + c_i) - (sum_i w_i) psi(x)), periodic, the sum taken in the order
// i = 1..18 of lap_ext1.  Input and output: (2, X, Y, Z) float32, psi(rho)
// then psi(phi).
//
// On a block of a decomposed domain (the K7 ext mode) the arrays carry
// pads of depth p on the sharded axes, psi is valid p - 1 cells beyond the
// block (csrc/density_psi.cu), and this pass writes the laplacian p - 2
// cells beyond it: the ring the K kernel's gradient reads (p >= 3).  The
// launch geometry (common.cuh Region) says which region that is, or a
// window of it (K7's win / owin, the overlap split); such a launch runs
// the EXT instantiation.
//
// What bounds it: device memory.  It reads 8 bytes and writes 8 bytes per
// cell against ~80 flops; the neighbours' overlapping reads are served by
// L1/L2, so the design is one pass, coalesced along z.

#include "common.cuh"

namespace {

__constant__ int c_C[Q][3];

struct LapWeights {
  float w[Q];      // the lattice weights w_i (w[0] unused)
  float wsum;      // sum_{i=1..18} w_i
  float two_cs2;   // 2 / cs^2
};

template <bool EXT>
__global__ void __launch_bounds__(BLOCK)
laplacian_psi_kernel(const float* __restrict__ psi, float* __restrict__ lap,
                     int X, int Y, int Z, const LapWeights lw,
                     const Region r) {
  int x, y, z;
  if (!region_cell<EXT>(Z, r, x, y, z)) return;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const size_t idx = cell_offset(x, y, z, Y, Z);
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const size_t nb = cell_offset(wrap(x + c_C[i][0], X),
                                  wrap(y + c_C[i][1], Y),
                                  wrap(z + c_C[i][2], Z), Y, Z);
    acc[0] += lw.w[i] * __ldg(psi + nb);
    acc[1] += lw.w[i] * __ldg(psi + plane + nb);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const size_t o = s * plane + idx;
    lap[o] = lw.two_cs2 * (acc[s] - lw.wsum * __ldg(psi + o));
  }
}

}  // namespace

// Every kernel library takes the same table setter; this one needs only C.
extern "C" int bflbm_set_tables(int device, const int* c, const float*,
                                const float*, const float*) {
  DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_C, c, sizeof(int) * Q * 3);
  return static_cast<int>(e);
}

// lap (2, X, Y, Z) of psi (2, X, Y, Z) float32, z contiguous, over the
// region of geom: host array {X, Y, Z, x0, y0, z0, nx, ny, nz} (common.cuh
// Region).  w: host array of the 19 lattice weights; wsum = sum_{i>=1} w_i;
// two_cs2 = 2 / cs^2.  Returns cudaGetLastError() after the launch.
extern "C" int bflbm_laplacian_psi(int device, const float* psi, float* lap,
                                   const int* geom, const float* w,
                                   float wsum, float two_cs2, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const Region r = region_of(geom);
  LapWeights lw;
  for (int i = 0; i < Q; ++i) lw.w[i] = w[i];
  lw.wsum = wsum;
  lw.two_cs2 = two_cs2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_ext(X, Y, Z, r))
    laplacian_psi_kernel<true><<<cell_grid(r), BLOCK, 0, s>>>(psi, lap, X, Y,
                                                              Z, lw, r);
  else
    laplacian_psi_kernel<false><<<cell_grid(r), BLOCK, 0, s>>>(psi, lap, X,
                                                               Y, Z, lw, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
