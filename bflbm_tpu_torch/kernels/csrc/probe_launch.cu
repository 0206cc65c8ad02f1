// Launch-overhead probe for NVIDIA Hopper (sm_90a): y = x + 1 on an (8, 128)
// float32 tile, one block of 1024 threads, a thread an element.
//
// Replaces the TPU probe benchmarks/tpu_overlap_r5.py:launch_micro.one (the
// pl.pallas_call at :87), which copied an (8, 128) tile plus one and was
// chained 400 times under one jit'ed scan.  Here the host chains 400
// launches two ways (bflbm_tpu_torch/probes/launch.py): eagerly through the
// ctypes wrapper, the path the port's Python loops pay, and replayed from a
// CUDA graph captured once, the counterpart of the TPU's launches under one
// compiled scan, with no host dispatch between them.
//
// What bounds it: launch latency.  The 8 KB it moves (4 KB read, 4 KB
// written) take a few nanoseconds of device memory time; the launch itself
// takes microseconds.

#include "common.cuh"

namespace {

constexpr int LAUNCH_THREADS = 1024;

__global__ void __launch_bounds__(LAUNCH_THREADS)
add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace

// y = x + 1, n <= 1024 float32 elements, y not aliasing x.  Returns
// cudaGetLastError() after the launch.
extern "C" int bflbm_probe_add_one(int device, const float* x, float* y,
                                   int n, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (n <= 0 || n > LAUNCH_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  add_one_kernel<<<1, LAUNCH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
