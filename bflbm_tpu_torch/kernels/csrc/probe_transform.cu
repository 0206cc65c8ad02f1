// Transform probe for NVIDIA Hopper (sm_90a): out = M_INV (M f) for each
// cell of a (19, X, Y, Z) float32 array, the D3Q19 moment transform and its
// inverse, in two variants.
//
// Replaces the TPU probe benchmarks/tpu_probe.py:probe_transform.make (the
// pl.pallas_call at :162), which ran the same function per (8, 32, 256)
// tile on the VPU ("unrolled": zero coefficients skipped, +-1 as add or
// subtract) and on the MXU ("mxu": two dot_generals at Precision.HIGHEST).
// Here:
//   - UNROLLED: one thread a cell.  It loads the 19 populations (coalesced
//     across the warp), forms the 19 moments and then the 19 populations,
//     and stores them.  M and M_INV are compile-time immediates
//     (lattice_tables.cuh's kLatM and kLatMinv, read at indices known after
//     unrolling), so the zero coefficients vanish at compile time and a
//     +-1 coefficient is an add or a subtract: M has 207 nonzeros, 183 of
//     them +-1; M_INV has 207.
//   - MMA: tensor cores, mma.sync.aligned.m16n8k8 in TF32, one warp 16
//     cells at a time.  The cells are the rows: moments^T (16 x 24) =
//     f^T (16 x 24) M^T (24 x 24), then out^T = moments^T M_INV^T, M and
//     M_INV zero-padded to 24 x 24 (three k-steps of 8, three n-tiles of
//     8).  The first product's accumulator fragment (row groupID, columns
//     2 tid and 2 tid + 1) is the second product's A fragment (row
//     groupID, columns tid and tid + 4) under the permutation of each
//     k-step's eight moments that maps column tid to moment 2 tid and
//     tid + 4 to 2 tid + 1; the second product's B fragment takes the same
//     permutation, so the moments never leave registers.  Each product
//     runs as 3xTF32 (every operand split into a TF32 high part and the
//     TF32 of the remainder, d += a_lo b_hi + a_hi b_lo + a_hi b_hi), which
//     keeps float32 accuracy as Precision.HIGHEST did on the TPU; plain
//     TF32 keeps about three digits and is not the same function.
//
// What bounds it: device memory, 152 bytes a cell (19 populations read, 19
// written) against 645 operations a cell unrolled (a +-1 coefficient one
// add, any other an FMA) or 54 m16n8k8 products a 16 cells on the tensor
// cores.

#include "common.cuh"
#include "lattice_tables.cuh"

namespace {

constexpr int TBLOCK = 256;
constexpr int KP = 24;   // 19 padded to three k-steps / n-tiles of 8

__global__ void __launch_bounds__(TBLOCK)
transform_unrolled_kernel(const float* __restrict__ in,
                          float* __restrict__ out, long long cells) {
  const long long c = static_cast<long long>(blockIdx.x) * TBLOCK +
                      threadIdx.x;
  if (c >= cells) return;
  float f[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) f[q] = __ldg(in + q * cells + c);
  float m[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float acc = 0.0f;
    bool first = true;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float coef = kLatM[k][q];
      if (coef == 0.0f) continue;
      const float t =
          coef == 1.0f ? f[q] : (coef == -1.0f ? -f[q] : coef * f[q]);
      acc = first ? t : acc + t;
      first = false;
    }
    m[k] = acc;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float acc = 0.0f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const float coef = kLatMinv[q][k];
      if (coef == 0.0f) continue;
      acc = first ? coef * m[k] : acc + coef * m[k];
      first = false;
    }
    out[q * cells + c] = acc;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a 3xTF32 product: the small terms first.
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const BFrag& b) {
  mma_tf32(d, alo, b.hi[0], b.hi[1]);
  mma_tf32(d, ahi, b.lo[0], b.lo[1]);
  mma_tf32(d, ahi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ float m_at(int k, int q) {
  return k < Q && q < Q ? kLatM[k][q] : 0.0f;
}

__device__ __forceinline__ float minv_at(int q, int k) {
  return k < Q && q < Q ? kLatMinv[q][k] : 0.0f;
}

__device__ __forceinline__ BFrag b_frag(float v0, float v1) {
  BFrag b;
  split(v0, b.hi[0], b.lo[0]);
  split(v1, b.hi[1], b.lo[1]);
  return b;
}

__global__ void __launch_bounds__(TBLOCK)
transform_mma_kernel(const float* __restrict__ in, float* __restrict__ out,
                     long long cells) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // groupID
  const int t = lane & 3;    // thread in group
  // B fragments, b0 at row t, b1 at row t + 4, column g of each 8 x 8
  // tile.  Product 1, k-step s over populations, n-tile j over moments:
  // B = M^T.  Product 2, k-step j over moments (permuted: row t is moment
  // 8j + 2t, row t + 4 moment 8j + 2t + 1), n-tile n over populations:
  // B = M_INV^T.
  BFrag b1[3][3], b2[3][3];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b1[s][j] = b_frag(m_at(8 * j + g, 8 * s + t),
                        m_at(8 * j + g, 8 * s + t + 4));
      b2[s][j] = b_frag(minv_at(8 * j + g, 8 * s + 2 * t),
                        minv_at(8 * j + g, 8 * s + 2 * t + 1));
    }
  const long long groups = (cells + 15) / 16;
  const long long warps =
      static_cast<long long>(gridDim.x) * (TBLOCK / 32);
  for (long long w = static_cast<long long>(blockIdx.x) * (TBLOCK / 32) +
                     (threadIdx.x >> 5);
       w < groups; w += warps) {
    const long long c_lo = w * 16 + g, c_hi = c_lo + 8;
    const bool in_lo = c_lo < cells, in_hi = c_hi < cells;
    // A fragments of f^T: a0 (cell g, pop 8s + t), a1 (cell g + 8, same
    // pop), a2 (cell g, pop 8s + t + 4), a3 (cell g + 8, pop 8s + t + 4).
    uint32_t ahi[3][4], alo[3][4];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int q0 = 8 * s + t, q1 = q0 + 4;
      const float v[4] = {
          q0 < Q && in_lo ? __ldg(in + q0 * cells + c_lo) : 0.0f,
          q0 < Q && in_hi ? __ldg(in + q0 * cells + c_hi) : 0.0f,
          q1 < Q && in_lo ? __ldg(in + q1 * cells + c_lo) : 0.0f,
          q1 < Q && in_hi ? __ldg(in + q1 * cells + c_hi) : 0.0f};
#pragma unroll
      for (int r = 0; r < 4; ++r) split(v[r], ahi[s][r], alo[s][r]);
    }
    float mom[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) mom[j][r] = 0.0f;
#pragma unroll
      for (int s = 0; s < 3; ++s) mma3(mom[j], ahi[s], alo[s], b1[s][j]);
    }
    // moments^T n-tile j as the A fragment of product 2's k-step j:
    // a0 = c0, a1 = c2, a2 = c1, a3 = c3.
    uint32_t mhi[3][4], mlo[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      split(mom[j][0], mhi[j][0], mlo[j][0]);
      split(mom[j][2], mhi[j][1], mlo[j][1]);
      split(mom[j][1], mhi[j][2], mlo[j][2]);
      split(mom[j][3], mhi[j][3], mlo[j][3]);
    }
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 3; ++j) mma3(o, mhi[j], mlo[j], b2[j][n]);
      // d0 (cell g, pop 8n + 2t), d1 (cell g, pop 8n + 2t + 1), d2 and d3
      // the same at cell g + 8.
      const int q0 = 8 * n + 2 * t, q1 = q0 + 1;
      if (in_lo && q0 < Q) out[q0 * cells + c_lo] = o[0];
      if (in_lo && q1 < Q) out[q1 * cells + c_lo] = o[1];
      if (in_hi && q0 < Q) out[q0 * cells + c_hi] = o[2];
      if (in_hi && q1 < Q) out[q1 * cells + c_hi] = o[3];
    }
  }
}

}  // namespace

// out = M_INV (M in) per cell, both (19, cells) float32, out not aliasing
// in: mma != 0 the tensor-core variant, else the unrolled one.  Returns
// cudaGetLastError() after the launch.
extern "C" int bflbm_probe_transform(int device, const float* in, float* out,
                                     long long cells, int mma,
                                     void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (cells <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    // about 16 groups of 16 cells a warp
    const long long groups = (cells + 15) / 16;
    const long long want = (groups + 16 * (TBLOCK / 32) - 1) /
                           (16 * (TBLOCK / 32));
    const unsigned blocks =
        static_cast<unsigned>(want < 1 ? 1 : (want > 65535 ? 65535 : want));
    transform_mma_kernel<<<blocks, TBLOCK, 0, s>>>(in, out, cells);
  } else {
    const unsigned blocks = static_cast<unsigned>((cells + TBLOCK - 1) /
                                                  TBLOCK);
    transform_unrolled_kernel<<<blocks, TBLOCK, 0, s>>>(in, out, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
