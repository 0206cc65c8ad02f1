// Pieces shared by the kernels that take the 19-point stencils of psi and
// of its laplacian from shared memory: csrc/blocked_step.cu (K4, rings
// recomputed inside every phase), csrc/laplacian_psi.cu (L) and the A1
// builds of csrc/fused_step.cu (B-A1), the last two as x-marching tiles.
//
// ImmTables: the lattice tables as compile-time constants
// (lattice_tables.cuh), read at indices known after unrolling.
// shared_gradient2 and SHARED_FORCES: the gradients of psi and of the
// laplacian, and the accelerations from them, with the products and the
// order of k_cell.cuh gradient2 and BFLBM_FORCES_FROM_ARRAYS, so that a
// kernel reading shared memory computes a cell bitwise as the one-step
// kernel reading device memory does.
//
// The x-marching tile (L and B-A1): a block owns a (ty, tz) tile of its
// launch's region in (y, z) and marches x over a chunk of xc planes.  A
// ring of TILE_RING plane slots in shared memory holds the fields the
// stencil reads (both species, a 1-cell y / z halo around the tile, the
// cells of the arrays wrapped periodically, or inside the pads of a
// halo-extended block): planes x - 1, x, x + 1 are read while planes
// x + 2 .. x + 1 + TILE_AHEAD are copied in with cp.async, so each value
// is read from device memory once per tile and chunk, plus its halo
// share.  The host picks (ty, tz, xc) from kernels/fused_step.py
// _STENCIL_TILES and computes the grid as stencil_grid does: (z tiles, y
// tiles, x chunks) over the region.
//
// The march, in both kernels: copy planes 0 .. TILE_RING - 2 of the chunk
// (counted from xa - 1); then at step k wait for plane k + 2
// (cp_async_wait_ahead), __syncthreads (every thread's copies visible,
// and every thread done with step k - 1's slots), copy plane
// k + TILE_RING - 1 into the slot plane k - 1 left, and compute plane
// k + 1 from the slots of planes k, k + 1, k + 2.

#pragma once

#include "common.cuh"
#include "lattice_tables.cuh"

namespace {

// The lattice tables as constant device arrays, read at indices known
// after unrolling (lattice_tables.cuh): each read folds to an immediate
// operand.  Read from __constant__ memory inside a loop, they would be
// hoisted out of it into hundreds of registers, and spill.
struct ImmTables {
  static __device__ __forceinline__ int c(int i, int d) {
    return kLatC[i][d];
  }
  static __device__ __forceinline__ float minv(int i, int k) {
    return kLatMinv[i][k];
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// gradient2's 19-point isotropic gradient of both species of a field kept
// in shared memory, at cell `cell` of planes vx[0..2] (x - 1, x, x + 1),
// whose rows hold `rowz` cells and whose second species starts n floats
// after the first: the same products summed in the same order.
__device__ __forceinline__ void shared_gradient2(const float* (&vx)[3], int n,
                                                 int cell, int rowz,
                                                 float (&g0)[3],
                                                 float (&g1)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) g0[d] = g1[d] = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int cx = ImmTables::c(i, 0), cy = ImmTables::c(i, 1),
              cz = ImmTables::c(i, 2);
    const float* v = vx[cx + 1] + cell + cy * rowz + cz;
    const float v0 = v[0];
    const float v1 = v[n];
    const float w = kLatGW[i];
    g0[0] += (w * static_cast<float>(cx)) * v0;
    g0[1] += (w * static_cast<float>(cy)) * v0;
    g0[2] += (w * static_cast<float>(cz)) * v0;
    g1[0] += (w * static_cast<float>(cx)) * v1;
    g1[1] += (w * static_cast<float>(cy)) * v1;
    g1[2] += (w * static_cast<float>(cz)) * v1;
  }
}

// k_cell.cuh BFLBM_FORCES_FROM_ARRAYS with psi and its laplacian read from
// shared memory: the kernel's locals psi_x, pn, pc, pnz (psi planes
// x - 1, x, x + 1, the floats between species, the cell, a row) and
// lap_x, ln, lc, lnz (the same for the laplacian).
#define SHARED_FORCES(ARGS, CX, CY, CZ)                                      \
  if (FORCE && (!A1 || ARGS.fc.k != 0.0f)) {                                  \
    float grad_rho[3], grad_phi[3];                                           \
    shared_gradient2(psi_x, pn, pc, pnz, grad_rho, grad_phi);                 \
    const float psi_rho = psi_x[1][pc];                                       \
    const float psi_phi = psi_x[1][pn + pc];                                  \
_Pragma("unroll")                                                             \
    for (int d = 0; d < 3; ++d) {                                             \
      af[d] = ARGS.fc.k * psi_rho * grad_phi[d] * inv_rho;                    \
      ag[d] = ARGS.fc.k * psi_phi * grad_rho[d] * inv_phi;                    \
    }                                                                         \
  }                                                                           \
  if (A1) {                                                                   \
    float gl_rho[3], gl_phi[3];                                               \
    shared_gradient2(lap_x, ln, lc, lnz, gl_rho, gl_phi);                     \
_Pragma("unroll")                                                             \
    for (int d = 0; d < 3; ++d) {                                             \
      af[d] = af[d] - ARGS.fc.a1 * gl_phi[d];                                 \
      ag[d] = ag[d] - ARGS.fc.a1 * gl_rho[d];                                 \
    }                                                                         \
  }

// -- the x-marching tile ----------------------------------------------------

// planes in flight while a plane is computed: a plane's copies are issued
// three march steps before it is first read
constexpr int TILE_AHEAD = 3;
constexpr int TILE_RING = TILE_AHEAD + 3;   // slots: x - 1, x, x + 1, ahead
constexpr int TILE_MAX_THREADS = 256;  // ty * tz, at most
// halo cells of a plane a thread copies, at most: (ty + 2)(tz + 2) over
// ty tz threads is at most 4 for ty, tz >= 2
constexpr int TILE_MAX_COPIES = 4;

struct StencilTile {
  int ty, tz;   // the (y, z) tile: ty * tz threads, z fastest
  int xc;       // x planes a block marches
};

// Cells of one species' field in a slot: the tile with a 1-cell y / z halo.
__host__ __device__ __forceinline__ int halo_cells(int ty, int tz) {
  return (ty + 2) * (tz + 2);
}

// Dynamic shared memory of a block that keeps `fields` fields of two
// species in the ring.
__host__ __device__ __forceinline__ long long tile_smem(int ty, int tz,
                                                        int fields) {
  return static_cast<long long>(TILE_RING) * fields * 2 *
         halo_cells(ty, tz) * static_cast<long long>(sizeof(float));
}

// A tile the kernels take: y and z at least 2 cells (TILE_MAX_COPIES), at
// most TILE_MAX_THREADS threads, at least one plane a chunk.
inline bool tile_ok(const StencilTile& t) {
  return t.ty >= 2 && t.tz >= 2 && t.xc >= 1 &&
         t.ty * t.tz <= TILE_MAX_THREADS;
}

// (z tiles, y tiles, x chunks) over the region.
inline dim3 tile_grid(const StencilTile& t, const Region& r) {
  return dim3((r.nz + t.tz - 1) / t.tz, (r.ny + t.ty - 1) / t.ty,
              (r.nx + t.xc - 1) / t.xc);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most TILE_AHEAD - 1 of this thread's copy groups (the
// newest) are in flight.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;" ::"n"(TILE_AHEAD - 1) : "memory");
}

// A block's place in the region and the halo cells of a plane its thread
// copies: which cells of the tile it owns (cell ly, lz; active when inside
// the region), the chunk's planes [xa, xb), and per copy the cell's index
// in a slot and its element offset in an x plane of the arrays (-1 for a
// halo cell past the region's end, which no active cell reads).
struct TileWalk {
  int y, z;          // the thread's cell in the arrays
  int xa, xb;        // the chunk's planes, in the arrays
  int hz, hn;        // a slot's row and species strides
  int cell;          // the thread's cell in a slot
  bool active;
  int sidx[TILE_MAX_COPIES];
  int goff[TILE_MAX_COPIES];

  __device__ __forceinline__ TileWalk(const StencilTile& t, const Region& r,
                                      int Y, int Z) {
    const int tid = static_cast<int>(threadIdx.x);
    const int ly = tid / t.tz, lz = tid - ly * t.tz;
    const int y0 = r.y0 + static_cast<int>(blockIdx.y) * t.ty;
    const int z0 = r.z0 + static_cast<int>(blockIdx.x) * t.tz;
    const int ye = min(y0 + t.ty, r.y0 + r.ny);
    const int ze = min(z0 + t.tz, r.z0 + r.nz);
    xa = r.x0 + static_cast<int>(blockIdx.z) * t.xc;
    xb = min(xa + t.xc, r.x0 + r.nx);
    y = y0 + ly;
    z = z0 + lz;
    active = y < ye && z < ze;
    hz = t.tz + 2;
    hn = halo_cells(t.ty, t.tz);
    cell = (ly + 1) * hz + (lz + 1);
    const int nth = t.ty * t.tz;
#pragma unroll
    for (int k = 0; k < TILE_MAX_COPIES; ++k) {
      const int e = tid + k * nth;
      const int hy = e / hz, hzz = e - hy * hz;
      const int gy = y0 - 1 + hy, gz = z0 - 1 + hzz;
      sidx[k] = e;
      goff[k] = (e < hn && gy <= ye && gz <= ze)
                    ? wrap(gy, Y) * Z + wrap(gz, Z)
                    : -1;
    }
  }

  // Copy plane xa - 1 + j of `fields` fields (field f of species s at
  // base[f] + s * species, x planes of `xplane` elements) into slot
  // j % TILE_RING, [field][species][halo cell], and commit the group; past
  // the chunk's last plane xb (j > xb - xa + 1) the group is empty, so
  // that every march step commits one.
  template <int MAXF>
  __device__ __forceinline__ void copy(float* ring, int j,
                                       const float* const (&base)[MAXF],
                                       int fields, size_t species, int X,
                                       int xplane) const {
    if (j > xb - xa + 1) {
      cp_async_commit();
      return;
    }
    const size_t xo =
        static_cast<size_t>(wrap(xa - 1 + j, X)) * static_cast<size_t>(xplane);
    float* dst = ring + (j % TILE_RING) * (fields * 2 * hn);
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      if (f >= fields) break;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* src = base[f] + s * species + xo;
#pragma unroll
        for (int k = 0; k < TILE_MAX_COPIES; ++k)
          if (goff[k] >= 0)
            cp_async4(dst + (f * 2 + s) * hn + sidx[k], src + goff[k]);
      }
    }
    cp_async_commit();
  }
};

}  // namespace
