// K4: T steps of K = collide o stream per launch, for NVIDIA Hopper
// (sm_90a), the intermediate steps kept in shared memory.
//
// Replaces the TPU kernel bflbm_tpu/kernels/fused_step.py:_step_kernel at
// block = T > 1 (the pl.pallas_call at fused_step.py:1956, its phases at
// :1799-1823) for the uncoupled configurations (alpha0 = alpha1 = 0,
// stencil depth 1): noise off or the hash stream with u8, clt4, clt2 or
// Box-Muller deviates, the USE_REF_STATE operand (REF, read at every
// phase, fused_step.py:1808-1817), and exact or general relaxation (the
// BFLBM_GENERAL_RELAX=1 build).  The coupled and alpha1 modes would need
// the density and laplacian pre-passes recomputed inside every phase; they
// are not taken.
//
// What bounds it: a launch moves the 304 bytes a cell of one step (the 38
// float32 populations read once, written once) for T steps, 304 / T a
// cell a step, against T times the ~2,100 operations of a step plus those
// of the recomputed ring cells.  The design keeps the T - 1 intermediate
// steps out of device memory.
//
// Design: x-marching columns.  One thread block per output tile of bx
// x-planes by (by, bz) cells in y and z.  Phase s = 0..T-1 computes, plane
// by plane, the tile grown by p_s = T - 1 - s cells on every side (the
// JAX kernel's phase regions, stencil depth 1): (by + 2 p_s) x (bz + 2 p_s)
// cells of planes x0 - p_s .. x0 + bx + p_s - 1.  Phase 0 pulls from device
// memory with the periodic wrap; phase s >= 1 pulls from the planes phase
// s - 1 keeps in shared memory, a ring of three (the x - 1, x, x + 1 of its
// pull); the last phase (p = 0) writes the tile's cells that lie in the
// domain, so a tile at the high edge of an axis it does not divide writes
// only its cells inside the domain.  At march step t, phase s computes its
// plane x0 - p_s + t - 2 s: phase s - 1 has just written the plane after
// it, and the ring still holds the two before.  The phases of a march step
// run in order with a barrier after each.  The march runs along x, the
// arrays' slowest axis, so that the threads of a warp take neighbouring
// cells along z and phase 0's device loads are contiguous.
//
// Recomputed cells (the rings that neighbouring tiles compute too, and a
// ring past the domain's edge, which wraps) are keyed by their wrapped
// global coordinates: every computation of a cell pulls the same inputs and
// draws bitwise the same noise, word s and step step0 + s at phase s.  The
// cell arithmetic after the pull is k_cell.cuh's BFLBM_COLLIDE_CELL, the
// code of the one-step kernel csrc/fused_step.cu, summed in the same order,
// so a
// blocked launch equals T one-step launches with the same words.  It
// reads the lattice tables as compile-time constants (k_cell.cuh
// ImmTables, the same float32 values): loop-invariant reads of the
// __constant__ tables would be hoisted out of the cell loop into hundreds
// of registers.
//
// Shared memory: an intermediate phase keeps 3 planes x 2 species x 19
// populations x 4 bytes = 456 bytes a cell of its plane; the launch needs
// the sum over s < T - 1, dynamic shared memory, allowed above 48 KB by
// cudaFuncSetAttribute once per instantiation and device.  The host picks
// the tile per T (kernels/fused_step.py blocked_tile): T = 2 (8 x 32),
// 155,040 bytes; T = 3 (8 x 16), 191,520; T = 4 (8 x 8), 200,640, under the
// 232,448 a block may hold.

#ifndef BFLBM_GENERAL_RELAX
#define BFLBM_GENERAL_RELAX 0
#endif

#include "k_cell.cuh"
#include "lattice_tables.cuh"

namespace {

// The lattice tables as constant device arrays, read at indices known
// after unrolling (lattice_tables.cuh): each read folds to an immediate
// operand.  Read from __constant__ memory inside the cell loop, they would
// be hoisted out of it into hundreds of registers, and spill.
struct ImmTables {
  static __device__ __forceinline__ int c(int i, int d) {
    return kLatC[i][d];
  }
  static __device__ __forceinline__ float m(int k, int i) {
    return kLatM[k][i];
  }
  static __device__ __forceinline__ float minv(int i, int k) {
    return kLatMinv[i][k];
  }
};

constexpr int KMAX = 8;            // most steps one launch takes
constexpr int MAX_THREADS = 384;   // threads of a block, at most
constexpr int RING = 3;            // planes an intermediate phase keeps
constexpr int MAX_DEVICES = 64;

struct BArgs {
  Args a;                  // fin, gin, ref, fout, gout, X, Y, Z, rx, nc
  uint32_t words[KMAX];    // the noise word of each step
  uint32_t step0;          // the first step's label
  int T;                   // steps
  int bx, by, bz;          // the tile: x-planes, y and z cells
};

// v mod n for any v, n > 0.
__device__ __forceinline__ int wrap_any(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// The ring slot of x-plane x of the tile whose first plane is x0; a phase's
// planes start at x0 - (T - 1) at the lowest.
__device__ __forceinline__ int ring_slot(int x, int x0, int T) {
  return (x - x0 + RING * T) % RING;
}

template <bool NOISE, int DIST, bool GENERAL, bool REF>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    blocked_kernel(const BArgs p) {
  constexpr bool FORCE = false, A1 = false, EXT = false;   // uncoupled
  extern __shared__ float ring[];
  const Args& args = p.a;
  const int X = args.X, Y = args.Y, Z = args.Z, T = p.T;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  const int x0 = blockIdx.x * p.bx;
  const int y0 = blockIdx.y * p.by;
  const int z0 = blockIdx.z * p.bz;
  const int nt = p.bx + 2 * (T - 1);   // march steps
  for (int t = 0; t < nt; ++t) {
    const float* prev = nullptr;       // phase s - 1's ring
    float* mine = ring;                // phase s's ring
    for (int s = 0; s < T; ++s) {
      const int ps = T - 1 - s;
      const int ny = p.by + 2 * ps, nz = p.bz + 2 * ps;
      const int ncell = ny * nz;
      const int k = t - 2 * s;         // the phase's plane, from its first
      const bool last = s == T - 1;
      const int x = x0 - ps + k;       // unwrapped
      if (k >= 0 && k < p.bx + 2 * ps && !(last && x >= X)) {
        const int xw = wrap_any(x, X);
        // word s, selected without indexing the parameter array at run time
        uint32_t word = p.words[0];
#pragma unroll
        for (int q = 1; q < KMAX; ++q)
          if (q == s) word = p.words[q];
        const uint32_t step = p.step0 + static_cast<uint32_t>(s);
        // phase s - 1's planes x - 1, x, x + 1, one cell wider on each side
        const int pnz = nz + 2, pn = (ny + 2) * pnz;
        const float* below = nullptr;
        const float* here = nullptr;
        const float* above = nullptr;
        if (s > 0) {
          below = prev + ring_slot(x - 1, x0, T) * (2 * Q * pn);
          here = prev + ring_slot(x, x0, T) * (2 * Q * pn);
          above = prev + ring_slot(x + 1, x0, T) * (2 * Q * pn);
        }
        for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
          const int j = c / nz, l = c - j * nz;
          const int y = y0 - ps + j, z = z0 - ps + l;
          if (last && (y >= Y || z >= Z)) continue;
          const int yw = wrap_any(y, Y), zw = wrap_any(z, Z);
          float rho = 0.0f, phi = 0.0f;
          float jf[3] = {0.0f, 0.0f, 0.0f};
          float jg[3] = {0.0f, 0.0f, 0.0f};
          float mf[Q], mg[Q];
          if (GENERAL) {
#pragma unroll
            for (int q = 4; q < Q; ++q) mf[q] = mg[q] = 0.0f;
          }
          if (s == 0) {
            // pull from device memory, periodic
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              const int cx = ImmTables::c(i, 0), cy = ImmTables::c(i, 1),
                        cz = ImmTables::c(i, 2);
              const size_t src = i * plane + cell_offset(wrap(xw - cx, X),
                                                         wrap(yw - cy, Y),
                                                         wrap(zw - cz, Z),
                                                         Y, Z);
              const float fi = __ldg(args.fin + src);
              const float gi = __ldg(args.gin + src);
              pull_add<GENERAL, ImmTables>(i, cx, cy, cz, fi, gi, rho, phi,
                                           jf, jg, mf, mg);
            }
          } else {
            // pull from phase s - 1's plane x - cx in shared memory
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              const int cx = ImmTables::c(i, 0), cy = ImmTables::c(i, 1),
                        cz = ImmTables::c(i, 2);
              const float* src = (cx > 0 ? below : (cx < 0 ? above : here)) +
                                 (j + 1 - cy) * pnz + (l + 1 - cz);
              const float fi = src[i * pn];
              const float gi = src[(Q + i) * pn];
              pull_add<GENERAL, ImmTables>(i, cx, cy, cz, fi, gi, rho, phi,
                                           jf, jg, mf, mg);
            }
          }
          const size_t idx = cell_offset(xw, yw, zw, Y, Z);
          float* fo;
          float* go;
          size_t oplane, oidx;
          if (last) {
            fo = args.fout;
            go = args.gout;
            oplane = plane;
            oidx = idx;
          } else {
            fo = mine + ring_slot(x, x0, T) * (2 * Q * ncell);
            go = fo + Q * ncell;
            oplane = static_cast<size_t>(ncell);
            oidx = static_cast<size_t>(c);
          }
          BFLBM_COLLIDE_CELL(args, word, step, xw, yw, zw, fo, go, oplane,
                             oidx, ImmTables);
        }
      }
      // phase s + 1 reads what phase s wrote, and the next march step's
      // phase s overwrites a plane phase s + 1 has just read
      __syncthreads();
      prev = mine;
      mine += RING * 2 * Q * ncell;
    }
  }
}

// Launch one instantiation: its dynamic shared memory limit raised to
// `smem` first when that is above 48 KB and above what was set on this
// device before (a launch above the limit is refused, and only
// cudaGetLastError reports it).
template <bool NOISE, int DIST, bool GENERAL, bool REF>
int launch(int device, dim3 grid, int threads, size_t smem, cudaStream_t s,
           const BArgs& b) {
  static size_t allowed[MAX_DEVICES] = {};
  auto kern = blocked_kernel<NOISE, DIST, GENERAL, REF>;
  if (smem > 48 * 1024 && smem > allowed[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[device] = smem;
  }
  kern<<<grid, threads, smem, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

template <int DIST, bool GENERAL>
int launch_noise(int device, dim3 grid, int threads, size_t smem,
                 cudaStream_t s, const BArgs& b) {
  if (b.a.ref != nullptr)
    return launch<true, DIST, GENERAL, true>(device, grid, threads, smem, s,
                                             b);
  return launch<true, DIST, GENERAL, false>(device, grid, threads, smem, s,
                                            b);
}

template <bool GENERAL>
int launch_mode(int noise_on, int dist, int device, dim3 grid, int threads,
                size_t smem, cudaStream_t s, const BArgs& b) {
  if (!noise_on)
    return launch<false, DIST_U8, GENERAL, false>(device, grid, threads, smem,
                                                  s, b);
  switch (dist) {
    case DIST_U8:
      return launch_noise<DIST_U8, GENERAL>(device, grid, threads, smem, s,
                                            b);
    case DIST_CLT4:
      return launch_noise<DIST_CLT4, GENERAL>(device, grid, threads, smem, s,
                                              b);
    case DIST_CLT2:
      return launch_noise<DIST_CLT2, GENERAL>(device, grid, threads, smem, s,
                                              b);
    case DIST_BM:
      return launch_noise<DIST_BM, GENERAL>(device, grid, threads, smem, s,
                                            b);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bflbm_set_tables(int device, const int* c, const float* m,
                                const float* minv, const float* gw) {
  DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_C, c, sizeof(int) * Q * 3);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_M, m, sizeof(float) * Q * Q);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(c_MINV, minv, sizeof(float) * Q * Q);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_GW, gw, sizeof(float) * Q);
  return static_cast<int>(e);
}

// Dynamic shared memory bytes of a launch of T steps on tiles of (by, bz)
// cells in y and z: 456 bytes a cell of each intermediate phase's plane.
extern "C" long long bflbm_blocked_smem(int T, int by, int bz) {
  long long cells = 0;
  for (int s = 0; s + 1 < T; ++s) {
    const int ps = T - 1 - s;
    cells += static_cast<long long>(by + 2 * ps) * (bz + 2 * ps);
  }
  return cells * RING * 2 * Q * static_cast<long long>(sizeof(float));
}

// T K steps on device pointers (19, X, Y, Z) float32, z contiguous, whole
// periodic domain: fin, gin -> fout, gout (which must not alias them).
// words: host array of the T int32 noise words, the step of word s being
// step0 + s.  tile: host array {bx, by, bz}, the output tile (x-planes, y
// and z cells); threads: the block's threads, a multiple of 32 up to 384.
// ref: the (2, X, Y, Z) COM-rolled (rho_eq, phi_eq) of USE_REF_STATE, or
// null (read only with noise on).  dist: 0 u8, 1 clt4, 2 clt2, 3
// Box-Muller.  coef: host array [pref_mom, cf[15], cg[15], scale, off].
// lam_f, lam_g: 1 / (tau + 1/2), read by the general-relaxation build.
// Returns cudaErrorInvalidValue for arguments it does not take (T outside
// 1..8, a tile or thread count out of range, more shared memory than a
// block of the device may hold), else cudaGetLastError() after the launch.
extern "C" int bflbm_blocked_step(int device, const float* fin,
                                  const float* gin, const float* ref,
                                  float* fout, float* gout, int X, int Y,
                                  int Z, const int* words, int T, int step0,
                                  const int* tile, int threads, float eps,
                                  float half_lam_f, float half_lam_g,
                                  float lam_f, float lam_g, int noise_on,
                                  int dist, const float* coef, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (T < 1 || T > KMAX || tile[0] < 1 || tile[1] < 1 || tile[2] < 1 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      X < 1 || Y < 1 || Z < 1 || device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = bflbm_blocked_smem(T, tile[1], tile[2]);
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  BArgs b = {};
  b.a.fin = fin;
  b.a.gin = gin;
  b.a.ref = ref;
  b.a.fout = fout;
  b.a.gout = gout;
  b.a.X = X;
  b.a.Y = Y;
  b.a.Z = Z;
  b.a.rx = Relax{eps, half_lam_f, half_lam_g, lam_f, lam_g};
  b.a.nc.pref_mom = coef[0];
  for (int k = 0; k < NGHOST; ++k) {
    b.a.nc.cf[k] = coef[1 + k];
    b.a.nc.cg[k] = coef[1 + NGHOST + k];
  }
  b.a.nc.scale = coef[1 + 2 * NGHOST];
  b.a.nc.off = coef[2 + 2 * NGHOST];
  for (int s = 0; s < T; ++s) b.words[s] = static_cast<uint32_t>(words[s]);
  b.step0 = static_cast<uint32_t>(step0);
  b.T = T;
  b.bx = tile[0];
  b.by = tile[1];
  b.bz = tile[2];
  const dim3 grid((X + b.bx - 1) / b.bx, (Y + b.by - 1) / b.by,
                  (Z + b.bz - 1) / b.bz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kGeneral = BFLBM_GENERAL_RELAX != 0;
  return launch_mode<kGeneral>(noise_on, dist, device, grid, threads,
                               static_cast<size_t>(smem), s, b);
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
