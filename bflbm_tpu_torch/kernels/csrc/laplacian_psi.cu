// Laplacian pre-pass of the alpha1 K step, for NVIDIA Hopper (sm_90a): a
// 2.5D stencil, x-marching tiles over a ring of psi planes in shared
// memory.
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
// i = 1..18 of lap_ext1, the weights compile-time constants
// (lattice_tables.cuh kLatW, kLatWSum, kLatTwoCs2: the float32 values of
// lap_ext1).  Input and output: (2, X, Y, Z) float32, psi(rho) then
// psi(phi).
//
// On a block of a decomposed domain (the K7 ext mode) the arrays carry
// pads of depth p on the sharded axes, psi is valid p - 1 cells beyond the
// block (csrc/density_psi.cu), and this pass writes the laplacian p - 2
// cells beyond it: the ring the K kernel's gradient reads (p >= 3).  The
// launch geometry (common.cuh Region) says which region that is, or a
// window of it (K7's win / owin, the overlap split).  One kernel serves
// every region: a neighbour on an axis without pads wraps, one on a padded
// axis lies inside the pads, where the same wrap leaves it alone.
//
// What bounds it: device memory, 8 bytes read and 8 written a cell against
// ~80 operations.  A thread per cell gathering its 36 neighbours through
// L2 moved ~76 bytes a cell there (a 128-cell z row reads 9 rows of each
// species) and ran at 18% of the byte bound.  The design (stencil_tile.cuh
// TileWalk): a block owns a (ty, tz) tile of the region and marches x over
// a chunk of xc planes; a ring of TILE_RING psi planes of both species,
// each with a 1-cell y / z halo, sits in shared memory; the next
// TILE_AHEAD planes are copied in with cp.async while plane x is summed
// from planes x - 1, x, x + 1; so a psi value leaves device memory once
// per tile and chunk, plus the halo's share, (ty + 2)(tz + 2)(xc + 2) /
// (ty tz xc).  Each thread reads the 3 x 3 (y, z) cells around its own
// from a plane's slot once, when the plane first enters the stencil, and
// keeps the last two planes' in registers: 18 shared loads a cell, not
// 38 (summing all 38 from shared memory held the kernel at 0.17 ms on
// 256^3 whatever the tile, chunk or copies in flight, NVIDIA H100 80GB
// HBM3, 700 W).  Offsets inside an x plane are 32-bit, one size_t product
// a plane.  Warps lie along z, so both the copies and the stores are
// contiguous.

#include "stencil_tile.cuh"

namespace {

constexpr int MAX_DEVICES = 64;

// The 3 x 3 (y, z) cells around `cell` in a slot, both species: [species]
// [(dy + 1) * 3 + dz + 1].
__device__ __forceinline__ void load_block(const float* slot, int hn, int hz,
                                           int cell, float (&b)[2][9]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz)
        b[s][(dy + 1) * 3 + dz + 1] = slot[s * hn + cell + dy * hz + dz];
}

__global__ void __launch_bounds__(TILE_MAX_THREADS)
laplacian_tile_kernel(const float* __restrict__ psi, float* __restrict__ lap,
                      int X, int Y, int Z, const Region r,
                      const StencilTile t) {
  extern __shared__ __align__(16) float ring[];   // [slot][species][cell]
  const TileWalk w(t, r, Y, Z);
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const int xplane = Y * Z;
  const float* const base[1] = {psi};
  const int n = w.xb - w.xa;
  // the 3 x 3 cells around this thread's in planes x - 1, x, x + 1: a
  // plane's slot is read once, as plane x + 1 (x + 2 at the first step)
  float pl[3][2][9];
  // planes xa - 1 .. xa + TILE_AHEAD - 1 before the march (stencil_tile.cuh)
  for (int j = 0; j < TILE_RING - 1; ++j)
    w.copy(ring, j, base, 1, plane, X, xplane);
  for (int k = 0; k < n; ++k) {
    cp_async_wait_ahead();
    __syncthreads();
    w.copy(ring, k + TILE_RING - 1, base, 1, plane, X, xplane);
    if (!w.active) continue;
    // planes x - 1 and x come from the registers of the last two steps
    if (k == 0) {
      load_block(ring, w.hn, w.hz, w.cell, pl[0]);
      load_block(ring + 2 * w.hn, w.hn, w.hz, w.cell, pl[1]);
    }
    load_block(ring + ((k + 2) % TILE_RING) * 2 * w.hn, w.hn, w.hz, w.cell,
               pl[2]);
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 1; i < Q; ++i) {
      const int d = kLatC[i][0] + 1;
      const int c = (kLatC[i][1] + 1) * 3 + kLatC[i][2] + 1;
      acc[0] += kLatW[i] * pl[d][0][c];
      acc[1] += kLatW[i] * pl[d][1][c];
    }
    const size_t o = static_cast<size_t>(w.xa + k) * xplane +
                     static_cast<size_t>(w.y * Z + w.z);
#pragma unroll
    for (int s = 0; s < 2; ++s)
      lap[s * plane + o] = kLatTwoCs2 * (acc[s] - kLatWSum * pl[1][s][4]);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        pl[0][s][c] = pl[1][s][c];
        pl[1][s][c] = pl[2][s][c];
      }
  }
}

}  // namespace

// Dynamic shared memory bytes of a block on (ty, tz) tiles: TILE_RING
// slots of both species' psi with a 1-cell y / z halo.
extern "C" long long bflbm_laplacian_smem(int ty, int tz) {
  return tile_smem(ty, tz, 1);
}

// lap (2, X, Y, Z) of psi (2, X, Y, Z) float32, z contiguous, over the
// region of geom: host array {X, Y, Z, x0, y0, z0, nx, ny, nz} (common.cuh
// Region).  tile: host array {ty, tz, xc} (stencil_tile.cuh StencilTile).
// Returns cudaErrorInvalidValue for a tile or region it does not take or
// more shared memory than a block of the device holds, else
// cudaGetLastError() after the launch.
extern "C" int bflbm_laplacian_psi(int device, const float* psi, float* lap,
                                   const int* geom, const int* tile,
                                   void* stream) {
  static long long allowed[MAX_DEVICES] = {};
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const Region r = region_of(geom);
  const StencilTile t{tile[0], tile[1], tile[2]};
  if (!tile_ok(t) || X < 1 || Y < 1 || Z < 1 || r.nx < 1 || r.ny < 1 ||
      r.nz < 1 || device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = bflbm_laplacian_smem(t.ty, t.tz);
  if (smem > 48 * 1024 && smem > allowed[device]) {
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(laplacian_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  laplacian_tile_kernel<<<tile_grid(t, r), t.ty * t.tz,
                          static_cast<size_t>(smem), s>>>(psi, lap, X, Y, Z,
                                                          r, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
