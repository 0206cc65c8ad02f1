// Density pre-pass of the coupled K step, for NVIDIA Hopper (sm_90a), one
// thread per cell.
//
// Replaces the psi-density part of the TPU kernel's coupled mode
// (bflbm_tpu/kernels/fused_step.py:_k_compute, lines 748-783: density_ext
// and the pseudopotential on the 1-cell-extended window, inside the
// pl.pallas_call at fused_step.py:1956).  On the TPU those densities are
// recomputed on a halo inside one tile; here one pass writes them for the
// whole domain and the K kernel reads its neighbours' values back.
//
// Per cell: the streamed densities rho_s = sum_i f_in[i, x - c_i] and
// phi_s likewise, summed in the order i = 0..18 that the K kernel uses for
// its own centre densities (so both agree to the bit), then psi(n) = n, or
// n0 (1 - exp(-n / n0)) under the Shan-Chen pseudopotential.  Output: a
// (2, X, Y, Z) float32 array, psi(rho_s) then psi(phi_s).
//
// On a block of a decomposed domain (the K7 ext mode, fused_step.py:
// 1155-1160) the arrays carry pads of depth p on the sharded axes, filled
// by the halo exchange, and the pass writes psi over the block and p - 1
// cells beyond it on each padded side: the ring the K kernel's gradient
// (p >= 2) and the laplacian pre-pass (p >= 3) read.  The launch geometry
// (common.cuh Region) says which region that is; such a launch runs the
// EXT instantiation.  The region may also be a window of that ring (K7's
// win / owin, the overlap split): only its cells are written.  In the
// strips exchange (common.cuh YStrips, K7's ystrips) the pulls that land
// in the y halo read the received strips instead of the y pads.
//
// What bounds it: device memory.  It reads 2 * 19 * 4 = 152 bytes and
// writes 8 bytes per cell against ~40 flops, so the design is one pass,
// coalesced along z, with the neighbours' overlapping reads served by
// L1/L2.

#include "common.cuh"

namespace {

__constant__ int c_C[Q][3];

template <bool SC>
__device__ __forceinline__ float psi_of(float n, float n0) {
  return SC ? n0 * (1.0f - expf(-n / n0)) : n;
}

template <bool SC, bool EXT>
__global__ void __launch_bounds__(BLOCK)
density_psi_kernel(const float* __restrict__ fin,
                   const float* __restrict__ gin, float* __restrict__ psi,
                   int X, int Y, int Z, float n0, const Region r,
                   const YStrips ys) {
  int x, y, z;
  if (!region_cell<EXT>(Z, r, x, y, z)) return;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  float rho = 0.0f, phi = 0.0f;
  if (EXT && ys.in != nullptr && (y - 1 < ys.y_lo || y + 1 >= ys.y_hi)) {
    // a row next to the y halo (the strips exchange): a pull across it
    // reads the received strips; a loop of its own, so that the other
    // rows keep the main loop's code
#pragma unroll 1
    for (int i = 0; i < Q; ++i) {
      int side, row;
      if (strip_row(ys, y - c_C[i][1], side, row)) {
        const size_t o =
            strip_offset(ys, side, 0, i, wrap(x - c_C[i][0], X), row,
                         wrap(z - c_C[i][2], Z), X, Z);
        rho += __ldg(ys.in + o);
        phi += __ldg(ys.in + o + Q * strip_plane(ys, X, Z));
      } else {
        const size_t src =
            i * plane + cell_offset(wrap(x - c_C[i][0], X),
                                    wrap(y - c_C[i][1], Y),
                                    wrap(z - c_C[i][2], Z), Y, Z);
        rho += __ldg(fin + src);
        phi += __ldg(gin + src);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const size_t src =
          i * plane + cell_offset(wrap(x - c_C[i][0], X),
                                  wrap(y - c_C[i][1], Y),
                                  wrap(z - c_C[i][2], Z), Y, Z);
      rho += __ldg(fin + src);
      phi += __ldg(gin + src);
    }
  }
  const size_t idx = cell_offset(x, y, z, Y, Z);
  psi[idx] = psi_of<SC>(rho, n0);
  psi[plane + idx] = psi_of<SC>(phi, n0);
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

// psi (2, X, Y, Z) of the streamed densities of (19, X, Y, Z) float32 f, g,
// over the region of geom: host array {X, Y, Z, x0, y0, z0, nx, ny, nz}
// (common.cuh Region).  use_sc: the pseudopotential with reference density
// n0.  strips: the received y strips (common.cuh YStrips) of depth
// strip_rows, or null.  Returns cudaGetLastError() after the launch.
extern "C" int bflbm_density_psi(int device, const float* fin,
                                 const float* gin, float* psi,
                                 const int* geom, int use_sc, float n0,
                                 const float* strips, int strip_rows,
                                 void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const Region r = region_of(geom);
  const YStrips ys = ystrips_of(strips, nullptr, strip_rows, Y);
  const dim3 grid = cell_grid(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ext = is_ext(X, Y, Z, r) || strips != nullptr;
  if (use_sc && ext)
    density_psi_kernel<true, true><<<grid, BLOCK, 0, s>>>(fin, gin, psi, X, Y,
                                                          Z, n0, r, ys);
  else if (use_sc)
    density_psi_kernel<true, false><<<grid, BLOCK, 0, s>>>(fin, gin, psi, X,
                                                           Y, Z, n0, r, ys);
  else if (ext)
    density_psi_kernel<false, true><<<grid, BLOCK, 0, s>>>(fin, gin, psi, X,
                                                           Y, Z, n0, r, ys);
  else
    density_psi_kernel<false, false><<<grid, BLOCK, 0, s>>>(fin, gin, psi, X,
                                                            Y, Z, n0, r, ys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
