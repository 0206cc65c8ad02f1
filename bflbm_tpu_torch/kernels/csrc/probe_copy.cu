// Copy probe for NVIDIA Hopper (sm_90a): a (19, X, Y, Z) float32 array
// copied device memory -> shared memory -> device memory in chunks of 19 x
// n cells (n a multiple of 4; 256-2048 in the probe), the last chunk
// ragged, by a persistent grid whose blocks each keep a ring of S stages
// of a chunk in dynamic shared memory (S x 19 x n x 4 bytes).
//
// Replaces the TPU probe benchmarks/tpu_probe.py:_pallas_roundtrip (the
// pl.pallas_call at :75, driven by probe_dma :84-92): the DMA engine
// copies a (19, bx, by, 256) tile HBM -> VMEM, waits, and copies it back,
// one tile a grid step, for three descriptor shapes.  Here the chunk sizes
// and stage counts stand in for the descriptor shapes, and two variants
// move a chunk:
//   - BULK: the Tensor Memory Accelerator, the H100's DMA engine, driven by
//     the block's one warp.  Stage i % S holds chunk i of the block (its
//     chunks are blockIdx.x, + gridDim.x, ...) and has a "full" mbarrier.
//     Before it waits for chunk i, the warp issues the loads of chunk i +
//     S - 1 into the stage chunk i - 1 used: each lane first waits, by
//     cp.async.bulk.wait_group.read 0, until its bulk store of chunk i - 1
//     has read that stage; lane 0 sets the stage's expected bytes
//     (mbarrier.arrive.expect_tx) before any copy is issued; lanes 0..18
//     each issue cp.async.bulk global -> shared for one population row.
//     Then the warp waits on chunk i's full barrier, and lanes 0..18 each
//     issue, after fence.proxy.async, cp.async.bulk shared -> global for
//     their row and commit it as a bulk group.  S - 1 chunks' loads are in
//     flight while one is stored; no thread touches the data.  Before the
//     block exits every lane waits until its stores have read shared
//     memory (wait_group.read 0).
//   - STAGED: 256 threads, the same ring with cp.async.cg 16-byte copies
//     global -> shared committed a chunk a group: the loads of chunk i + S
//     - 1 are issued, cp.async.wait_group S - 1 waits for chunk i's, a
//     block barrier, chunk i stored with 16-byte vectors from shared
//     memory, a barrier before the stage is loaded again.
// Both give the input back bitwise.  Bulk copies need 16-byte-aligned
// addresses and sizes that are multiples of 16 bytes: the host requires
// the cell count and n to be multiples of 4.
//
// What bounds it: device memory, 152 bytes a cell (19 x 4 read, 19 x 4
// written), no arithmetic.  The grid is persistent, the blocks a
// multiprocessor holds at this stage count (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor) times cudaDevAttrMultiProcessorCount, at most one
// block a chunk, so that every block keeps its stages' loads in flight
// while it stores.

#include "common.cuh"

namespace {

constexpr int STAGED_THREADS = 256;
constexpr int MAX_STAGES = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The chunks of block b of a grid of g blocks: b, b + g, ...
__device__ __forceinline__ long long own_chunks(long long chunks) {
  const long long b = blockIdx.x, g = gridDim.x;
  return b < chunks ? (chunks - b + g - 1) / g : 0;
}

__global__ void __launch_bounds__(32)
copy_bulk_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long long cells, int n, int S) {
  extern __shared__ __align__(128) float buf[];   // S stages of Q rows of n
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  const int lane = threadIdx.x;
  const long long chunks = (cells + n - 1) / n;
  const long long m = own_chunks(chunks);
  if (lane == 0) {
    for (int st = 0; st < S; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&full[st]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  // the loads of the block's i-th chunk into its stage
  auto load = [&](long long i) {
    const int st = static_cast<int>(i % S);
    const long long c0 = (blockIdx.x + i * gridDim.x) * n;
    const uint32_t row_bytes =
        static_cast<uint32_t>(min(static_cast<long long>(n), cells - c0)) *
        4u;
    const uint32_t b = smem_addr(&full[st]);
    if (lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
          "r"(row_bytes * Q)
          : "memory");
    __syncwarp();
    if (lane < Q)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(
              smem_addr(buf + (static_cast<long long>(st) * Q + lane) * n)),
          "l"(in + lane * cells + c0), "r"(row_bytes), "r"(b)
          : "memory");
  };
  for (long long i = 0; i + 1 < S && i < m; ++i) load(i);
  for (long long i = 0; i < m; ++i) {
    if (i + S - 1 < m) {
      // the stage of chunk i - 1 is free once its store has read it
      if (i > 0 && lane < Q)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load(i + S - 1);
    }
    const int st = static_cast<int>(i % S);
    const uint32_t parity = static_cast<uint32_t>((i / S) & 1);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem_addr(&full[st])), "r"(parity)
          : "memory");
    }
    if (lane < Q) {
      const long long c0 = (blockIdx.x + i * gridDim.x) * n;
      const uint32_t row_bytes =
          static_cast<uint32_t>(min(static_cast<long long>(n), cells - c0)) *
          4u;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              out + lane * cells + c0),
          "r"(smem_addr(buf + (static_cast<long long>(st) * Q + lane) * n)),
          "r"(row_bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (lane < Q) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <int S>
__global__ void __launch_bounds__(STAGED_THREADS)
copy_staged_kernel(const float* __restrict__ in, float* __restrict__ out,
                   long long cells, int n) {
  extern __shared__ __align__(128) float buf[];   // S stages of Q rows of n
  const long long chunks = (cells + n - 1) / n;
  const long long m = own_chunks(chunks);
  const int n4 = n / 4;
  float4* s4 = reinterpret_cast<float4*>(buf);
  // the 16-byte loads of the block's i-th chunk into its stage, one group
  // (empty past the block's chunks, so that the group count stays in step)
  auto load = [&](long long i) {
    if (i < m) {
      const int st = static_cast<int>(i % S);
      const long long c0 = (blockIdx.x + i * gridDim.x) * n;
      const int v4 =
          static_cast<int>(min(static_cast<long long>(n), cells - c0)) / 4;
      for (int v = threadIdx.x; v < Q * v4; v += STAGED_THREADS) {
        const int q = v / v4, k = v - q * v4;
        const float4* src =
            reinterpret_cast<const float4*>(in + q * cells + c0) + k;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_addr(s4 + (st * Q + q) * n4 + k)),
                     "l"(src)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (long long i = 0; i + 1 < S; ++i) load(i);
  for (long long i = 0; i < m; ++i) {
    load(i + S - 1);
    // chunk i's group is done when at most S - 1 newer ones are pending
    asm volatile("cp.async.wait_group %0;" ::"n"(S - 1) : "memory");
    __syncthreads();
    const int st = static_cast<int>(i % S);
    const long long c0 = (blockIdx.x + i * gridDim.x) * n;
    const int v4 =
        static_cast<int>(min(static_cast<long long>(n), cells - c0)) / 4;
    for (int v = threadIdx.x; v < Q * v4; v += STAGED_THREADS) {
      const int q = v / v4, k = v - q * v4;
      reinterpret_cast<float4*>(out + q * cells + c0)[k] =
          s4[(st * Q + q) * n4 + k];
    }
    __syncthreads();   // the stage is loaded again S - 1 chunks on
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <typename K>
int persistent_launch(K kern, int device, int threads, size_t smem,
                      long long chunks, unsigned& grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long g = static_cast<long long>(per_sm) * sms;
  grid = static_cast<unsigned>(g < chunks ? g : chunks);
  return 0;
}

template <int S>
int launch_staged(int device, const float* in, float* out, long long cells,
                  int n, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(S) * Q * n * sizeof(float);
  const long long chunks = (cells + n - 1) / n;
  unsigned grid = 0;
  const int e = persistent_launch(copy_staged_kernel<S>, device,
                                  STAGED_THREADS, smem, chunks, grid);
  if (e != 0) return e;
  copy_staged_kernel<S><<<grid, STAGED_THREADS, smem, s>>>(in, out, cells,
                                                           n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = in, both (19, cells) float32, through shared memory in chunks of
// n cells with `stages` stages a block: bulk != 0 the TMA variant, else
// the staged one.  cells and n must be multiples of 4, stages 1..8 and
// stages x 19 x n x 4 bytes no more than a block may hold.  Returns
// cudaErrorInvalidValue for what it does not take, else
// cudaGetLastError() after the launch.
extern "C" int bflbm_probe_copy(int device, const float* in, float* out,
                                long long cells, int n, int stages, int bulk,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (cells <= 0 || cells % 4 != 0 || n <= 0 || n % 4 != 0 || stages < 1 ||
      stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stages) * Q * n * sizeof(float);
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk) {
    const long long chunks = (cells + n - 1) / n;
    unsigned grid = 0;
    const int rc =
        persistent_launch(copy_bulk_kernel, device, 32, smem, chunks, grid);
    if (rc != 0) return rc;
    copy_bulk_kernel<<<grid, 32, smem, s>>>(in, out, cells, n, stages);
    return static_cast<int>(cudaGetLastError());
  }
  switch (stages) {
    case 1: return launch_staged<1>(device, in, out, cells, n, s);
    case 2: return launch_staged<2>(device, in, out, cells, n, s);
    case 3: return launch_staged<3>(device, in, out, cells, n, s);
    case 4: return launch_staged<4>(device, in, out, cells, n, s);
    case 5: return launch_staged<5>(device, in, out, cells, n, s);
    case 6: return launch_staged<6>(device, in, out, cells, n, s);
    case 7: return launch_staged<7>(device, in, out, cells, n, s);
    default: return launch_staged<8>(device, in, out, cells, n, s);
  }
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
