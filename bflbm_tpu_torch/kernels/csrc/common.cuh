// Pieces shared by the port's CUDA kernels: the lattice size, the
// periodic wrap of a pull stream, the geometry of a launch, the launch
// shape and a device guard for the C entry points.  Each kernel source is
// its own shared library, so everything here has internal linkage.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int Q = 19;
constexpr int BLOCK = 128;   // threads per block, along z

// v in [-n, 2n) -> v mod n: a neighbour one cell away, periodic.
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Element offset of cell (x, y, z) in an (X, Y, Z) plane, z contiguous.
__device__ __forceinline__ size_t cell_offset(int x, int y, int z, int Y,
                                              int Z) {
  return (static_cast<size_t>(x) * Y + y) * Z + z;
}

// Where a launch's threads sit in the arrays it reads and writes.  Every
// array of one launch has the extents (X, Y, Z): the whole periodic
// domain, or one block of a decomposed domain extended by pads on its
// sharded axes (the K7 ext mode, bflbm_tpu/kernels/fused_step.py:
// 1155-1160).  The threads cover the region (nx, ny, nz) whose first cell
// is (x0, y0, z0) in the arrays.  A neighbour on an axis without pads
// wraps periodically; on a padded axis it lies inside the pads (the
// region keeps one cell from the edge per cell of reach), where the same
// wrap leaves it alone.  Kernels take the region as their last argument,
// after the arguments of the whole-domain kernel, whose layout stays.
struct Region {
  int x0, y0, z0;   // the region's first cell
  int nx, ny, nz;   // region extents
};

// The region of a host geometry array {X, Y, Z, x0, y0, z0, nx, ny, nz,
// ...}.
inline Region region_of(const int* geom) {
  return Region{geom[3], geom[4], geom[5], geom[6], geom[7], geom[8]};
}

// The region is not the whole array: the launch takes the kernels' EXT
// instantiation.  The whole-domain one keeps the single-device
// addressing, which the region offsets would slow by 1-2% (registers).
inline bool is_ext(int X, int Y, int Z, const Region& r) {
  return r.x0 != 0 || r.y0 != 0 || r.z0 != 0 || r.nx != X || r.ny != Y ||
         r.nz != Z;
}

// One thread per cell of the region: z along threadIdx.x, y and x along
// the grid.
inline dim3 cell_grid(const Region& r) {
  return dim3((r.nz + BLOCK - 1) / BLOCK, r.ny, r.nx);
}

// The calling thread's cell in arrays of z extent Z, or false past the
// region's z end; without EXT the region is the whole array.
template <bool EXT>
__device__ __forceinline__ bool region_cell(int Z, const Region& r, int& x,
                                            int& y, int& z) {
  z = blockIdx.x * BLOCK + threadIdx.x;
  if (z >= (EXT ? r.nz : Z)) return false;
  y = blockIdx.y;
  x = blockIdx.z;
  if (EXT) {
    x += r.x0;
    y += r.y0;
    z += r.z0;
  }
  return true;
}

// The y halo of a launch on a block of a y-sharded mesh in the strips
// exchange (K7's ystrips, bflbm_tpu/kernels/fused_step.py:1233-1245,
// 1501-1530, 1913-1919).  The block's y pads are not read: the rows below
// and above its interior come from received strips, which the exchange
// ships whole between y neighbours, and K writes its first and last
// `rows` interior rows a second time into strips of the same layout for
// the next exchange.  A strip array is (2 sides, 2 species, Q, X, rows,
// Z), z contiguous: side 0 holds the rows [y_lo - rows, y_lo) below the
// interior (received) or its first rows (written), side 1 the rows
// [y_hi, y_hi + rows) above it or its last rows.  With both pointers null
// (every launch but the strips exchange's) the halo is the pads'.
struct YStrips {
  const float* in;   // received strips, or null
  float* out;        // strips K writes, or null
  int rows;          // strip depth: the y pads' depth
  int y_lo, y_hi;    // the interior rows [y_lo, y_hi) of the arrays
};

inline YStrips ystrips_of(const float* in, float* out, int rows, int Y) {
  return YStrips{in, out, rows, rows, Y - rows};
}

// Elements between two populations of a strip array, and between its two
// species.
__device__ __forceinline__ size_t strip_plane(const YStrips& st, int X,
                                              int Z) {
  return static_cast<size_t>(X) * st.rows * Z;
}

// Element offset of population q of species s at (x, strip row r, z) of
// side `side`.
__device__ __forceinline__ size_t strip_offset(const YStrips& st, int side,
                                               int s, int q, int x, int r,
                                               int z, int X, int Z) {
  return ((static_cast<size_t>(side) * 2 + s) * Q + q) *
             strip_plane(st, X, Z) +
         (static_cast<size_t>(x) * st.rows + r) * Z + z;
}

// Row y of a read lies in the y halo and comes from the received strips:
// which side, and which row r of it.
__device__ __forceinline__ bool strip_row(const YStrips& st, int y,
                                          int& side, int& r) {
  if (st.in == nullptr) return false;
  if (y < st.y_lo) {
    side = 0;
    r = y - (st.y_lo - st.rows);
    return true;
  }
  if (y >= st.y_hi) {
    side = 1;
    r = y - st.y_hi;
    return true;
  }
  return false;
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
