// Copy probe for NVIDIA Hopper (sm_90a): a (19, X, Y, Z) float32 array
// copied device memory -> shared memory -> device memory, one block a chunk
// of 19 x n cells (n = 512, 1024 or 2048 of the X * Y * Z cells, 39-156 KB
// of dynamic shared memory), the last chunk ragged.
//
// Replaces the TPU probe benchmarks/tpu_probe.py:_pallas_roundtrip (the
// pl.pallas_call at :75, driven by probe_dma :84-92): the DMA engine
// copies a (19, bx, by, 256) tile HBM -> VMEM, waits, and copies it back,
// one tile a grid step, for three descriptor shapes.  Here the three chunk
// sizes stand in for the descriptor shapes, and two variants move a chunk:
//   - BULK: the Tensor Memory Accelerator, the H100's DMA engine.  Lanes
//     0..18 of the block's one warp each issue cp.async.bulk global ->
//     shared for one population row of the chunk onto one mbarrier, whose
//     expected transaction count is the chunk's bytes; the warp waits on
//     the barrier's phase 0, the same lanes issue cp.async.bulk shared ->
//     global, commit the bulk group and wait until its reads of shared
//     memory are done (wait_group.read 0) before the block exits.  No
//     thread touches the data.
//   - STAGED: 256 threads move 16-byte vectors global -> shared, a
//     barrier, then shared -> global.
// Both give the input back bitwise.  Bulk copies need 16-byte-aligned
// addresses and sizes that are multiples of 16 bytes: the host requires
// the cell count and n to be multiples of 4.
//
// What bounds it: device memory, 152 bytes a cell (19 x 4 read, 19 x 4
// written), no arithmetic.  Each block holds a chunk in flight; the
// smaller chunks let more blocks share an SM (5 at n = 512, 1 at 2048).

#include "common.cuh"

namespace {

constexpr int STAGED_THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
copy_bulk_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long long cells, int n) {
  extern __shared__ __align__(128) float buf[];   // Q rows of n floats
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * n;
  const uint32_t row_bytes =
      static_cast<uint32_t>(min(static_cast<long long>(n), cells - c0)) * 4u;
  const uint32_t b = smem_addr(&bar);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
        "r"(row_bytes * Q)
        : "memory");
  }
  __syncwarp();
  if (lane < Q) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_addr(buf + lane * n)),
        "l"(in + lane * cells + c0), "r"(row_bytes), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(b) : "memory");
  }
  if (lane < Q) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            out + lane * cells + c0),
        "r"(smem_addr(buf + lane * n)), "r"(row_bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

__global__ void __launch_bounds__(STAGED_THREADS)
copy_staged_kernel(const float* __restrict__ in, float* __restrict__ out,
                   long long cells, int n) {
  extern __shared__ __align__(128) float buf[];   // Q rows of n floats
  const long long c0 = static_cast<long long>(blockIdx.x) * n;
  const int v4 = static_cast<int>(min(static_cast<long long>(n), cells - c0)) / 4;
  float4* s4 = reinterpret_cast<float4*>(buf);
  for (int v = threadIdx.x; v < Q * v4; v += STAGED_THREADS) {
    const int q = v / v4, k = v - q * v4;
    s4[q * (n / 4) + k] =
        __ldg(reinterpret_cast<const float4*>(in + q * cells + c0) + k);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < Q * v4; v += STAGED_THREADS) {
    const int q = v / v4, k = v - q * v4;
    reinterpret_cast<float4*>(out + q * cells + c0)[k] = s4[q * (n / 4) + k];
  }
}

}  // namespace

// out = in, both (19, cells) float32, through shared memory in chunks of
// n cells: bulk != 0 the TMA variant, else the staged one.  cells and n
// must be multiples of 4.  Returns cudaGetLastError() after the launch.
extern "C" int bflbm_probe_copy(int device, const float* in, float* out,
                                long long cells, int n, int bulk,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (cells <= 0 || cells % 4 != 0 || n <= 0 || n % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Q) * n * sizeof(float);
  auto kern = bulk ? copy_bulk_kernel : copy_staged_kernel;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((cells + n - 1) / n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk)
    copy_bulk_kernel<<<blocks, 32, smem, s>>>(in, out, cells, n);
  else
    copy_staged_kernel<<<blocks, STAGED_THREADS, smem, s>>>(in, out, cells,
                                                            n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
