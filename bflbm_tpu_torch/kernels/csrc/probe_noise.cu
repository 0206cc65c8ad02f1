// Noise-generator probe for NVIDIA Hopper (sm_90a): for each cell of an
// (X, Y, Z) float32 output, the sum of the 34 draws of one generator case,
// one thread a cell.
//
// Replaces the TPU probe benchmarks/tpu_noise_micro.py:run_case (the
// pl.pallas_call at :294) with its generator cases (CASES, :260-273).  The
// TPU kernel draws, for each (8, 32) tile (i, j) of the domain, 34 variates
// a cell over the tile's phase-0 region (12, 36, Z), keyed by the tile's
// word = seed[0] + 7919 i + 104729 j and step = seed[1], sums them, and
// writes the tile's interior v[2:10, 2:34, :].  Here a thread computes only
// its own cell, keyed as the TPU region keyed it (_cellwords): region-local
// ix = x - 8 i + 2, iy = y - 32 j + 2 and cell = (ix Y + iy) Z + iz, in
// uint32 with wrap.  The TPU's ring of 2 discarded cells (1.69x the
// interior's cells, 12 * 36 / (8 * 32)) has no counterpart.
//
// The cases (CASE = the index in bflbm_tpu_torch/probes/noise_micro.py
// CASES):
//   0 hash_cur           the physics stream: hash words, CLT-4 byte sums
//                        (k_cell.cuh Draws<DIST_CLT4>), summed as
//                        n[0::2] + n[1::2]
//   1 hash_uniform_only  34 hash uniforms (k_cell.cuh hash_uniform)
//   2 hash_u16           one full mix a pair, two 16-bit uniforms,
//                        Box-Muller r (cos th + sin th)
//   3 hash_1mul24        a single-multiply mix a draw, 24-bit uniforms, BM
//   4 hash_1mul16        a single-multiply mix a pair, 16-bit split, BM
//   5 hash_nomul         four add-rotate-xor rounds a pair, 16-bit split, BM
//   6 clt4_hash          hash words, CLT-4 sums of the four bytes
//   7 clt4_hash_1mul     single-multiply second stage, CLT-4
//   8 clt4_hash_nomul    three add-rotate-xor rounds, CLT-4
//   9 philox             Philox4x32-10 bits, 24-bit uniforms, BM over the
//                        pairs (p, 17 + p)
//  10 philox_bits_only   Philox bits as 34 24-bit uniforms
//  11 clt4_philox        Philox words, CLT-4
// Cases 9-11 stand where the TPU cases hw, hw_bits_only and clt4_hw
// (:164-214) drew the TPU's hardware bits: a counter-based Philox4x32-10
// (Salmon et al., SC'11) with key (word, step) and counter (cell, draw / 4,
// 0, 0), the draw's word the (draw % 4)-th of the block.  The physics path
// keeps the hash stream; Philox is measured here only.
//
// Past the reused k_cell.cuh pieces the float arithmetic is written with
// round-to-nearest intrinsics, one rounding per operation in the order of
// the plain PyTorch version, so that the cases without transcendentals
// come out bitwise.
//
// The Box-Muller pair (bm) evaluates its angle once: one sincosf of th =
// fl(2 pi u2), the plain version's angle (one argument reduction and one
// polynomial pass for both), bitwise the plain version's cos and sin on
// the card.  The radius stays one logf and one sqrtf a pair (__logf's
// absolute error near u = 1 would break the tolerance).  Philox consumes
// each block's four words as it is made, case 9 holding the block of each
// half of its pairs (p, 17 + p) only.  Measured and not taken (PERF.md):
// one sincospif of 2 u2 (exact in its argument, so off the plain version
// by the rounding of fl(2 pi u2)) and Philox's products as one 64-bit
// widening multiply.

#include "k_cell.cuh"

namespace {

constexpr int NDRAW = 34;       // 2 * NPAIR_BM draws a cell
constexpr int PAD = 2;          // the TPU tile's phase-0 ring
constexpr float U24 = 1.0f / 16777216.0f;
constexpr float U16 = 1.0f / 65536.0f;

struct Clt4 {
  float scale, off;             // byte sum -> standardized normal
};

__device__ __forceinline__ uint32_t mix32_1mul(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

// One add-rotate-xor round of the multiply-free mixers.
__device__ __forceinline__ uint32_t arx(uint32_t x, int k, int s) {
  x += rotl(x, k);
  return x ^ (x >> s);
}

__device__ __forceinline__ float u24(uint32_t w) {   // (0, 1), + half a step
  return __fadd_rn(__fmul_rn(static_cast<float>(w >> 8), U24), 0.5f * U24);
}

__device__ __forceinline__ float u16(uint32_t v) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), U16), 0.5f * U16);
}

__device__ __forceinline__ float bm(float u1, float u2) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincosf(__fmul_rn(TWO_PI, u2), &s, &c);
  return __fmul_rn(r, __fadd_rn(c, s));
}

// The four bytes of w summed, standardized (the JAX probe's _clt4).
__device__ __forceinline__ float clt4(uint32_t w, const Clt4& c) {
  const uint32_t s = (w & 0xFFu) + ((w >> 8) & 0xFFu) +
                     ((w >> 16) & 0xFFu) + (w >> 24);
  return __fadd_rn(__fmul_rn(static_cast<float>(s), c.scale), c.off);
}

__device__ __forceinline__ uint32_t draw_count(uint32_t sbase, int a) {
  return (sbase + static_cast<uint32_t>(a)) * GOLDEN;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Block b of a cell's Philox words: draws 4 b .. 4 b + 3.
__device__ __forceinline__ uint4 philox_block(uint32_t cell, int b,
                                              uint32_t word, uint32_t step) {
  return philox4x32_10(make_uint4(cell, static_cast<uint32_t>(b), 0u, 0u),
                       word, step);
}

__device__ __forceinline__ uint32_t lane(const uint4& o, int i) {
  return i == 0 ? o.x : i == 1 ? o.y : i == 2 ? o.z : o.w;
}

template <int CASE>
__device__ __forceinline__ float case_sum(uint32_t cell, uint32_t word,
                                          uint32_t step, const NoiseCoef& nc,
                                          const Clt4& c4) {
  const uint32_t sbase = step * DRAW_STRIDE;
  if (CASE == 9) {
    // pair p: u1 from word p, u2 from word 17 + p; the blocks of both
    // halves made as the pairs reach them (block 4 holds words 16-19:
    // its word 16 is kept for the last pair)
    constexpr int H = NDRAW / 2;
    float acc = 0.0f;
    uint4 first = philox_block(cell, 0, word, step);
    uint4 second = philox_block(cell, H / 4, word, step);
    const uint32_t w16 = second.x;
#pragma unroll
    for (int p = 0; p < H; ++p) {
      if (p > 0 && p % 4 == 0 && p / 4 != H / 4)
        first = philox_block(cell, p / 4, word, step);
      if ((H + p) % 4 == 0) second = philox_block(cell, (H + p) / 4, word, step);
      const uint32_t w1 = p / 4 == H / 4 ? w16 : lane(first, p % 4);
      const float u1 = u24(w1);
      const float u2 = __fmul_rn(
          static_cast<float>(lane(second, (H + p) % 4) >> 8), U24);
      const float v = bm(u1, u2);
      acc = p == 0 ? v : __fadd_rn(acc, v);
    }
    return acc;
  }
  if (CASE >= 10) {
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < (NDRAW + 3) / 4; ++b) {
      const uint4 o = philox_block(cell, b, word, step);
#pragma unroll
      for (int i = 0; i < 4 && 4 * b + i < NDRAW; ++i) {
        const uint32_t w = lane(o, i);
        const float v = CASE == 10
                            ? __fmul_rn(static_cast<float>(w >> 8), U24)
                            : clt4(w, c4);
        acc = b == 0 && i == 0 ? v : __fadd_rn(acc, v);
      }
    }
    return acc;
  }
  const uint32_t h1 = mix32(cell ^ word);
  if (CASE == 0) {
    const Draws<DIST_CLT4> draw(h1, sbase);
    float even = draw(0, nc), odd = draw(1, nc);
#pragma unroll
    for (int p = 1; p < NDRAW / 2; ++p) {
      even = __fadd_rn(even, draw(2 * p, nc));
      odd = __fadd_rn(odd, draw(2 * p + 1, nc));
    }
    return __fadd_rn(even, odd);
  }
  float acc = 0.0f;
  if (CASE == 1 || CASE >= 6) {   // a word a draw
#pragma unroll
    for (int a = 0; a < NDRAW; ++a) {
      const uint32_t x = h1 + draw_count(sbase, a);
      float v;
      if (CASE == 1) {
        v = hash_uniform(mix32(x));
      } else if (CASE == 6) {
        v = clt4(mix32(x), c4);
      } else if (CASE == 7) {
        v = clt4(mix32_1mul(x), c4);
      } else {
        v = clt4(arx(arx(arx(x, 13, 9), 17, 9), 7, 9), c4);
      }
      acc = a == 0 ? v : __fadd_rn(acc, v);
    }
    return acc;
  }
  if (CASE == 3) {   // a single-multiply mix a draw, 24-bit uniforms
#pragma unroll
    for (int p = 0; p < NDRAW / 2; ++p) {
      const float v = bm(u24(mix32_1mul(h1 + draw_count(sbase, 2 * p))),
                         u24(mix32_1mul(h1 + draw_count(sbase, 2 * p + 1))));
      acc = p == 0 ? v : __fadd_rn(acc, v);
    }
    return acc;
  }
#pragma unroll
  for (int p = 0; p < NDRAW / 2; ++p) {   // a word a pair, 16-bit halves
    uint32_t x = h1 + draw_count(sbase, p);
    if (CASE == 2) {
      x = mix32(x);
    } else if (CASE == 4) {
      x = mix32_1mul(x);
    } else {
      x = arx(arx(arx(arx(x, 13, 7), 17, 7), 5, 7), 11, 7);
    }
    const float v = bm(u16(x & 0xFFFFu), u16(x >> 16));
    acc = p == 0 ? v : __fadd_rn(acc, v);
  }
  return acc;
}

template <int CASE>
__global__ void __launch_bounds__(BLOCK)
noise_kernel(float* __restrict__ out, int Y, int Z, int bx, int by,
             uint32_t seed0, uint32_t seed1, const NoiseCoef nc,
             const Clt4 c4) {
  const int z = blockIdx.x * BLOCK + threadIdx.x;
  if (z >= Z) return;
  const int y = blockIdx.y, x = blockIdx.z;
  const int i = x / bx, j = y / by;
  const uint32_t word = seed0 + 7919u * static_cast<uint32_t>(i) +
                        104729u * static_cast<uint32_t>(j);
  const uint32_t ix = static_cast<uint32_t>(x - bx * i + PAD);
  const uint32_t iy = static_cast<uint32_t>(y - by * j + PAD);
  const uint32_t cell = (ix * static_cast<uint32_t>(Y) + iy) *
                            static_cast<uint32_t>(Z) +
                        static_cast<uint32_t>(z);
  out[cell_offset(x, y, z, Y, Z)] = case_sum<CASE>(cell, word, seed1, nc, c4);
}

template <int CASE>
void launch_case(float* out, int X, int Y, int Z, int bx, int by, uint32_t s0,
            uint32_t s1, const NoiseCoef& nc, const Clt4& c4,
            cudaStream_t s) {
  const dim3 grid((Z + BLOCK - 1) / BLOCK, Y, X);
  noise_kernel<CASE><<<grid, BLOCK, 0, s>>>(out, Y, Z, bx, by, s0, s1, nc,
                                            c4);
}

}  // namespace

// out (X, Y, Z) float32: case `case_id`'s 34-draw sum at every cell, the
// tile (bx, by) of the cell keying its word from seed0 and its step from
// seed1 (both int32 bits).  scale / off: the physics stream's CLT-4
// deviate (case 0); c4_scale / c4_off: the probe's own CLT-4 (cases 6-8,
// 11).  Returns cudaGetLastError() after the launch.
extern "C" int bflbm_probe_noise(int device, float* out, int X, int Y, int Z,
                                 int bx, int by, int seed0, int seed1,
                                 int case_id, float scale, float off,
                                 float c4_scale, float c4_off, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (X <= 0 || Y <= 0 || Z <= 0 || bx <= 0 || by <= 0 || X % bx != 0 ||
      Y % by != 0 || Y > 65535 || X > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  NoiseCoef nc = {};
  nc.scale = scale;
  nc.off = off;
  const Clt4 c4{c4_scale, c4_off};
  const uint32_t s0 = static_cast<uint32_t>(seed0);
  const uint32_t s1 = static_cast<uint32_t>(seed1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (case_id) {
    case 0: launch_case<0>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 1: launch_case<1>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 2: launch_case<2>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 3: launch_case<3>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 4: launch_case<4>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 5: launch_case<5>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 6: launch_case<6>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 7: launch_case<7>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 8: launch_case<8>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 9: launch_case<9>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 10: launch_case<10>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    case 11: launch_case<11>(out, X, Y, Z, bx, by, s0, s1, nc, c4, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
