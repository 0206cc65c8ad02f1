// Pieces shared by the port's CUDA kernels: the lattice size, the
// periodic wrap of a pull stream, the launch shape and a device guard for
// the C entry points.  Each kernel source is its own shared library, so
// everything here has internal linkage.

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

// One thread per cell: z along threadIdx.x, y and x along the grid.
inline dim3 cell_grid(int X, int Y, int Z) {
  return dim3((Z + BLOCK - 1) / BLOCK, Y, X);
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
