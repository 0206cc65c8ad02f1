// K4: T steps of K = collide o stream per launch, for NVIDIA Hopper
// (sm_90a), the intermediate steps kept in shared memory.
//
// Replaces the TPU kernel bflbm_tpu/kernels/fused_step.py:_step_kernel at
// block = T > 1 (the pl.pallas_call at fused_step.py:1956, its phases at
// :1790-1823): noise off or the hash stream with u8, clt4, clt2 or
// Box-Muller deviates, the USE_REF_STATE operand (REF, read at every
// phase, fused_step.py:1808-1817), exact or general relaxation (the
// BFLBM_GENERAL_RELAX=1 builds), and every stencil depth sd
// (fused_step.sd_depth): uncoupled (alpha0 = alpha1 = 0, sd = 1), the
// Shan-Chen force (alpha0 != 0, sd = 2, the BFLBM_FORCE=1 builds) and the
// alpha1 square-gradient force (sd = 3, BFLBM_A1=1).  With a force each
// phase recomputes what the one-step path takes from its pre-passes, from
// its own streamed input, as _k_compute does inside every phase (:753-832):
// psi of the streamed densities (csrc/density_psi.cu's arithmetic, the
// optional Shan-Chen pseudopotential among it) on the phase's region grown
// by sd - 1 cells, and under A1 their laplacian (csrc/laplacian_psi.cu's)
// grown by 1; psi and the laplacian never reach device memory.
//
// What bounds it: a launch moves the 304 bytes a cell of one step (the 38
// float32 populations read once, written once) for T steps, 304 / T a
// cell a step, against T times the ~2,100-3,000 operations of a step plus
// those of the recomputed ring cells.  The design keeps the T - 1
// intermediate steps, and every psi and laplacian, out of device memory.
//
// Design: x-marching columns, one warp group a phase, thread-block
// clusters across y and z.  A cluster of cy x cz blocks (a launch argument,
// 1 x 1 included) marches an output tile of bx x-planes by (cy by, cz bz)
// cells in y and z; each block owns a (by, bz) sub-tile of it.  Phase s =
// 0..T-1 computes, plane by plane, the cluster's tile grown by p_s = sd (T -
// 1 - s) cells on every side (the JAX kernel's phase regions, planes x0 -
// p_s .. x0 + bx + p_s - 1); a block computes only its own part of it, its
// sub-tile grown by p_s on the sides that are the cluster's outer sides.
// Phase 0 pulls from device memory with the periodic wrap; phase s >= 1
// pulls from the planes phase s - 1 keeps in shared memory; the last phase
// (p = 0) writes the tile's cells that lie in the domain, so a tile at the
// high edge of an axis it does not divide writes only its cells inside the
// domain.  Each block keeps every phase's planes on the whole (by + 2 p_s)
// x (bz + 2 p_s) region of its sub-tile (one layout in every block): the
// cells of a neighbour's part within sd of its sub-tile, which its next
// phase pulls, are written there by the neighbour (pushed through
// distributed shared memory by all the threads of its phase, in a stage
// after each collide), so no block recomputes a cell that another block of
// its cluster owns.  Its psi and laplacian rings it computes itself from
// those planes, on its part grown by sd - 1 and by 1 (38 adds a cell, a
// fortieth of a collide), which keeps their reuse local to the phase.
//
// Each phase runs on a warp group of its own (threads a launch argument,
// sized by the phase's cells), marching its planes concurrently with the
// others: per plane (psi) psi of the plane sd - 1 ahead of the one it
// collides, (lap, A1) the laplacian of the plane one ahead, (collide) its
// plane, each stage closed by a named barrier of the group alone (bar.sync
// id, n), then (push, in a cluster) its cells that neighbours pull.  Phase
// s - 1 hands its planes to phase s through a ring of sd + 3 slots (the
// x - 1 of the collide's pull to the x + sd of the psi stage's, and one
// more, so that phase s - 1 runs a plane ahead), with two mbarriers a
// slot: "full", armed once a plane by the producing group of the block (an
// arrive after its barrier, with the bytes its neighbours push into the
// plane as expected transactions), the neighbours' pushes being st.async
// stores that complete their bytes on it, waited on by the consumers
// before the psi stage of the plane two sd ahead of the one they collide
// (every plane before it at the first step: pushes of different planes
// may land in any order); "empty", arrived on by the consuming group of
// the block (at CTA scope) and of every neighbour it pushes into (release
// at cluster scope) once the plane's last reader is done (the march step
// that collides the plane after it, or for the planes before phase s's
// first collide the psi stage one plane later), waited on by the producer
// before it writes the slot or pushes into it again.  Every group arrives
// on every barrier of its planes whether or not it computed a cell (a tile
// past the region's end under EXT computes none), so the groups' march
// counts may differ and no barrier waits for ever.  No block-wide barrier
// runs inside the march: one cluster barrier before it (the mbarriers
// initialised in every block) and one after (no block exits while a
// neighbour may still push into it or arrive on its barriers).  The march
// runs along x, the arrays' slowest axis, so that the threads of a warp
// take neighbouring cells along z and phase 0's device loads are
// contiguous.
//
// Recomputed cells (the rings that neighbouring tiles compute too, and a
// ring past the domain's edge, which wraps) are keyed by their wrapped
// global coordinates: every computation of a cell pulls the same inputs and
// draws bitwise the same noise, word s and step step0 + s at phase s.  The
// cell arithmetic after the pull is k_cell.cuh's BFLBM_COLLIDE_CELL_WITH,
// the code of the one-step kernel csrc/fused_step.cu, with the gradients
// of psi and of the laplacian summed from shared memory in gradient2's
// order (stencil_tile.cuh SHARED_FORCES), the densities in the pre-pass's
// order i = 0..18, the laplacian in laplacian_psi.cu's, so a blocked
// launch equals T one-step launches (A, L and K) with the same words.  It
// reads the lattice tables as compile-time constants (stencil_tile.cuh
// ImmTables and lattice_tables.cuh, the same float32 values):
// loop-invariant reads of the __constant__ tables would be hoisted out of
// the cell loop into hundreds of registers.
//
// Shared memory, per block: 2 (T - 1) (sd + 3) mbarriers, then per
// intermediate phase sd + 3 planes x 2 species x 19 populations x 4 bytes a
// cell of its (by + 2 p_s) x (bz + 2 p_s) region; per phase with a force: 3
// (4 under A1) psi planes x 2 x 4 bytes a cell of its region grown by sd -
// 1, and under A1 3 laplacian planes a cell of its region grown by 1.  The
// launch needs the sum (bflbm_blocked_smem), dynamic shared memory, allowed
// above 48 KB by cudaFuncSetAttribute once per instantiation and device;
// the host picks the sub-tile and the cluster per (sd, T) (kernels/
// fused_step.py blocked_tile, blocked_cluster) under the 232,448 bytes a
// block may hold; a cluster adds none.
//
// EXT (a template flag, chosen at launch from the geometry as the one-step
// kernels choose theirs, common.cuh is_ext): JAX's sharded sweep at block
// T (bflbm_tpu/parallel/kernel.py:737-770, the ext_mode of the pallas_call
// at :1142-1867 with the seed operand's origin at :1878-1880).  The arrays
// are one block of a decomposed domain, extended by pads at least sd T
// deep on its sharded axes, which one halo exchange fills before the
// launch; on the other axes the block spans the domain.  The tiles cover
// the block's interior (the launch's Region) from its first cell at the
// pad offset, so phase 0's pulls and its psi stage reach into the pads on
// a padded axis (the array coordinate of a grown region's cell is already
// inside the arrays, where the periodic wrap leaves it alone) and wrap in
// place on the others; the last phase writes only interior cells, into
// the other buffer of the pair at the pad offset (JAX's owin).  A ring
// cell of phase s < T - 1 may lie in the pads: its hash key is its global
// coordinate ((array + origin - pad) mod the global extent, on every axis,
// so the launch carries the global X beside the one-step kernels' GY, GZ),
// and the USE_REF_STATE operand is read there, so its pads must hold the
// neighbours' values too.  Whole-domain launches keep the instantiations
// without EXT and their code.
//
// JAX's other sharded sweeps at block T (bflbm_tpu/parallel/kernel.py:
// 466-481, 541-569, 646-729) ride on EXT, as they do in csrc/fused_step.cu
// at block 1:
//   - a window, a run-time option: the region may be any box of the
//     interior (the overlap split's interior window, the interior shrunk by
//     sd T on each split axis, and its seam bands).  The tiles cover the
//     region from its first cell; under EXT every phase computes only the
//     cells of its tile's region that lie within p_s of the launch's region
//     (a tile past the region's end skips the rest), so phase 0 reads
//     device memory only within sd T of the region: the interior window
//     reads no pad, and may run while the exchange writes them;
//   - y strips (common.cuh YStrips, `rows` = sd T), the template flag
//     STRIPS of the EXT instantiations (as a run-time option, its code in
//     every EXT instantiation made the serial ext launches 3-4% slower,
//     chip_smoke.py phase 13 on NVIDIA H100 80GB HBM3, 700 W): phase 0
//     reads every population whose source row lies in the y halo from the
//     received strips, the y pads are never read (the psi and laplacian
//     rings are computed from those reads), and the last phase writes its
//     first and last `rows` interior rows a second time into the strips it
//     sends, its 38 outputs read back in one batch before any store.  The
//     ref operand is still read from its own pads.  Every phase-0 cell of
//     a strip-fed launch finds its three source rows (in the arrays or in
//     the strips, StripRows) once, then issues its 38 loads together as a
//     serial launch does: a branch per population on the rows next to the
//     halo held every plane's barrier, and a selected address per
//     population was slower too; with StripRows the strip-fed launches of
//     a sweep take 1.09x the serial ones (chip_smoke.py phase 14b, 256^3
//     on (2, 2, 1), on the card above).

#ifndef BFLBM_GENERAL_RELAX
#define BFLBM_GENERAL_RELAX 0
#endif
#ifndef BFLBM_FORCE
#define BFLBM_FORCE 0
#endif
#ifndef BFLBM_A1
#define BFLBM_A1 0
#endif

#include <cooperative_groups.h>

#include "k_cell.cuh"
#include "stencil_tile.cuh"

namespace {

constexpr int KMAX = 8;            // most steps one launch takes
constexpr int MAX_THREADS = 384;   // threads of a block, at most
constexpr int MAX_CLUSTER = 8;     // blocks of a cluster, at most (portable)
constexpr int MAX_DEVICES = 64;
constexpr bool kForce = BFLBM_FORCE != 0;
constexpr bool kA1 = BFLBM_A1 != 0;
static_assert(kForce || !kA1, "BFLBM_A1 needs BFLBM_FORCE");
// This library's stencil depth: the pull 1, the psi gradient a second,
// the gradient of the laplacian a third.
constexpr int SD = kA1 ? 3 : (kForce ? 2 : 1);
constexpr int POP_RING = SD + 3;   // population planes a phase keeps
constexpr int PSI_RING = kA1 ? 4 : 3;
constexpr int LAP_RING = 3;

struct BArgs {
  Args a;                  // fin, gin, ref, fout, gout, X, Y, Z, rx, nc, fc;
                           // under EXT also r (the interior) and GY, GZ,
                           // with ox = oy = oz = 0: the keys passed to the
                           // cell arithmetic are already global
  uint32_t words[KMAX];    // the noise word of each step
  uint32_t step0;          // the first step's label
  int T;                   // steps
  int bx, by, bz;          // a block's sub-tile: x-planes, y and z cells
  int cy, cz;              // the cluster: blocks along y and z
  int first[KMAX + 1];     // phase s's warp group: threads first[s] ..
                           // first[s + 1] - 1; first[T] = blockDim.x
  int use_sc;              // psi is the Shan-Chen pseudopotential
  float n0;                // its reference density
  int gx0, gy0, gz0;       // EXT: global coordinates of array cell (0, 0, 0)
  int GX;                  // EXT: the global x extent
};

// v mod n for any v, n > 0.
__device__ __forceinline__ int wrap_any(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// The floats one phase keeps in shared memory, on a region of ny x nz
// cells: its population ring when it is not the last, its psi ring, its
// laplacian ring.
__host__ __device__ __forceinline__ long long phase_floats(int ny, int nz,
                                                          bool last) {
  long long n = 0;
  if (!last) n += static_cast<long long>(POP_RING) * 2 * Q * ny * nz;
  if (kForce)
    n += static_cast<long long>(PSI_RING) * 2 * (ny + 2 * (SD - 1)) *
         (nz + 2 * (SD - 1));
  if (kA1) n += static_cast<long long>(LAP_RING) * 2 * (ny + 2) * (nz + 2);
  return n;
}

// Bytes of the mbarriers in front of the rings: a full and an empty one
// per slot of every intermediate phase's population ring, rounded up to 16.
__host__ __device__ __forceinline__ int barrier_bytes(int T) {
  return (2 * (T - 1) * POP_RING * 8 + 15) / 16 * 16;
}

// The floats in front of phase s's rings: the phases before it.
__device__ __forceinline__ long long phase_base(int T, int s, int by,
                                                int bz) {
  long long n = 0;
  for (int r = 0; r < s; ++r) {
    const int pr = SD * (T - 1 - r);
    n += phase_floats(by + 2 * pr, bz + 2 * pr, r == T - 1);
  }
  return n;
}

// Wait until the phase of parity `parity` of the mbarrier at b has
// completed; its arrivals' writes (at cluster scope) are then visible.
__device__ __forceinline__ void bar_wait(const uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive, releasing at cluster scope, on the mbarrier at b's offset in the
// shared memory of the cluster's block `rank` (this block's own included).
__device__ __forceinline__ void bar_arrive(const uint64_t* b, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_u32(b)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(r)
      : "memory");
}

// The barrier of warp group `id` (1..KMAX) of n threads.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The blocks of a cluster next to block (iy, iz), diagonals included.
__device__ __forceinline__ int neighbour_count(int iy, int iz, int cy,
                                               int cz) {
  const int ny = (iy > 0) + 1 + (iy < cy - 1);
  const int nz = (iz > 0) + 1 + (iz < cz - 1);
  return ny * nz - 1;
}

// The cells that block (ay, az) of a cluster of cy x cz blocks pushes to
// block (ny, nz) in a phase grown by p: those of its part (its sub-tile,
// grown by p on the cluster's outer sides) inside the other's part of the
// next phase grown by SD (p on the outer sides, SD on the inner ones), a
// box [y0, y1) x [z0, z1) from block (ay, az)'s sub-tile origin; returns
// its cells (0 for an empty box).
__device__ __forceinline__ int push_box(int ay, int az, int ny, int nz,
                                        int cy, int cz, int by, int bz,
                                        int p, int& y0, int& y1, int& z0,
                                        int& z1) {
  const int dy = ny - ay, dz = nz - az;
  y0 = max(ay == 0 ? -p : 0, (ny == 0 ? -p : -SD) + dy * by);
  y1 = min(by + (ay == cy - 1 ? p : 0), by + (ny == cy - 1 ? p : SD) + dy * by);
  z0 = max(az == 0 ? -p : 0, (nz == 0 ? -p : -SD) + dz * bz);
  z1 = min(bz + (az == cz - 1 ? p : 0), bz + (nz == cz - 1 ? p : SD) + dz * bz);
  return (y1 > y0 && z1 > z0) ? (y1 - y0) * (z1 - z0) : 0;
}

// The shared::cluster address of `a` (a shared::cta address of this block)
// in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// Where phase 0 of a strip-fed launch pulls from, for a cell in row y:
// per source row y - cy (cy = -1, 0, 1), that row's first element of each
// species in the arrays or, where the row lies in the y halo, in the
// received strips.  Built once a cell, so that a population's load costs
// what a load from the arrays does.
struct StripRows {
  const float* f[3];
  const float* g[3];
  bool strip[3];

  __device__ __forceinline__ StripRows(const Args& a, int y) {
    const size_t sp = strip_plane(a.ys, a.X, a.Z);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int src = y + 1 - d;   // the source row of cy = d - 1
      int side = 0, row = 0;
      strip[d] = strip_row(a.ys, src, side, row);
      const size_t so = static_cast<size_t>(side) * 2 * Q * sp +
                        static_cast<size_t>(row) * a.Z;
      const size_t ao = static_cast<size_t>(src) * a.Z;
      f[d] = strip[d] ? a.ys.in + so : a.fin + ao;
      g[d] = strip[d] ? a.ys.in + so + Q * sp : a.gin + ao;
    }
  }

  // Population i of both species pulled from (x, y - cy, z), x and z
  // wrapped into the arrays.
  __device__ __forceinline__ void load(const Args& a, int i, int cy, int x,
                                       int z, size_t plane, float& fi,
                                       float& gi) const {
    const int d = cy + 1;
    const size_t o =
        static_cast<size_t>(i) *
            (strip[d] ? strip_plane(a.ys, a.X, a.Z) : plane) +
        static_cast<size_t>(x) * (strip[d] ? a.ys.rows * a.Z : a.Y * a.Z) +
        z;
    fi = __ldg(f[d] + o);
    gi = __ldg(g[d] + o);
  }
};

// A cell of the last phase in the first or last `rows` interior rows of a
// strip-fed launch: its outputs, which this thread has just stored at idx
// (a thread sees its own stores), written a second time into the strips it
// sends.  The 38 reads are issued before any store, so that they wait for
// the stores to land once, not once each.
__device__ __forceinline__ void cell_to_strips(const YStrips& ys,
                                               const float* fout,
                                               const float* gout,
                                               size_t plane, size_t idx,
                                               int x, int y, int z, int X,
                                               int Z) {
  float v[2 * Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = fout[q * plane + idx];
    v[Q + q] = gout[q * plane + idx];
  }
  const size_t sp = strip_plane(ys, X, Z);
  for (int side = 0; side < 2; ++side) {
    const int r = side == 0 ? y - ys.y_lo : y - (ys.y_hi - ys.rows);
    if (r < 0 || r >= ys.rows) continue;
    float* dst = ys.out + strip_offset(ys, side, 0, 0, x, r, z, X, Z);
#pragma unroll
    for (int q = 0; q < 2 * Q; ++q) dst[q * sp] = v[q];
  }
}

// psi (with the Shan-Chen pseudopotential when use_sc) of a streamed
// density: csrc/density_psi.cu psi_of.
__device__ __forceinline__ float psi_of(float n, int use_sc, float n0) {
  return use_sc ? n0 * (1.0f - expf(-n / n0)) : n;
}

template <bool NOISE, int DIST, bool GENERAL, bool REF, bool EXT,
          bool STRIPS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    blocked_kernel(const BArgs p) {
  static_assert(EXT || !STRIPS, "y strips feed a halo-extended block");
  constexpr bool FORCE = kForce, A1 = kA1;
  constexpr int LEAD = 2 * SD - 2;  // planes the psi stage runs ahead
  extern __shared__ __align__(16) unsigned char smem[];
  const Args& args = p.a;
  const int X = args.X, Y = args.Y, Z = args.Z, T = p.T;
  const size_t plane = static_cast<size_t>(X) * Y * Z;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  // this block's place in its cluster (clusters span y and z only), and
  // its neighbours there
  const int cy = p.cy, cz = p.cz;
  const int iy = static_cast<int>(blockIdx.y) % cy;
  const int iz = static_cast<int>(blockIdx.z) % cz;
  if (cluster.block_rank() != static_cast<unsigned>(iy + iz * cy)) __trap();
  const int nnb = neighbour_count(iy, iz, cy, cz);
  // the sub-tile's first cell in the arrays, and the end of the region the
  // last phase writes: the whole domain, or under EXT the launch's region
  // (the interior or a window of it), past which every phase s computes
  // only the ps cells its successors read
  const int x0 = (EXT ? args.r.x0 : 0) + blockIdx.x * p.bx;
  const int y0 = (EXT ? args.r.y0 : 0) + blockIdx.y * p.by;
  const int z0 = (EXT ? args.r.z0 : 0) + blockIdx.z * p.bz;
  const int xe = EXT ? args.r.x0 + args.r.nx : X;
  const int ye = EXT ? args.r.y0 + args.r.ny : Y;
  const int ze = EXT ? args.r.z0 + args.r.nz : Z;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [T - 1][POP_RING]
  uint64_t* empty = full + (T - 1) * POP_RING;          // [T - 1][POP_RING]
  float* ring = reinterpret_cast<float*>(smem + barrier_bytes(T));
  if (threadIdx.x == 0) {
    for (int i = 0; i < (T - 1) * POP_RING; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(full + i))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(empty + i)),
                   "r"(1 + nnb)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();   // every block's barriers are ready before any arrives

  // this thread's phase, its warp group
  int s = 0;
  while (s + 1 < T && static_cast<int>(threadIdx.x) >= p.first[s + 1]) ++s;
  const int tid = static_cast<int>(threadIdx.x) - p.first[s];
  const int nth = p.first[s + 1] - p.first[s];
  const bool last = s == T - 1;
  const int ps = SD * (T - 1 - s);
  const int ny = p.by + 2 * ps, nz = p.bz + 2 * ps;
  const int nx = p.bx + 2 * ps;
  const int ncell = ny * nz;
  // its part of the cluster's phase region, in its region's (j, l)
  // coordinates: the sub-tile, grown by ps on the cluster's outer sides
  const int jlo = iy == 0 ? 0 : ps, jhi = iy == cy - 1 ? ny : ny - ps;
  const int llo = iz == 0 ? 0 : ps, lhi = iz == cz - 1 ? nz : nz - ps;
  // phase s - 1's planes: its region, SD cells wider on each side
  const int qnz = nz + 2 * SD, qn = (ny + 2 * SD) * qnz;
  // this phase's rings: populations, psi (grown by SD - 1), laplacian
  // (grown by 1)
  float* mine = ring + phase_base(T, s, p.by, p.bz);
  const float* prev =
      s > 0 ? ring + phase_base(T, s - 1, p.by, p.bz) : nullptr;
  const int pnz = nz + 2 * (SD - 1), pn = (ny + 2 * (SD - 1)) * pnz;
  float* psi_ring = mine + (last ? 0 : POP_RING * 2 * Q * ncell);
  const int lnz = nz + 2, ln = (ny + 2) * lnz;
  float* lap_ring = psi_ring + (FORCE ? PSI_RING * 2 * pn : 0);
  uint64_t* my_full = full + s * POP_RING;
  uint64_t* my_empty = empty + s * POP_RING;
  const uint64_t* prev_full = full + (s - 1) * POP_RING;
  uint64_t* prev_empty = empty + (s - 1) * POP_RING;
  // the sizes of its stages' cell ranges
  const int pwz = lhi - llo + 2 * (SD - 1);
  const int pw = (jhi - jlo + 2 * (SD - 1)) * pwz;
  const int lwz = lhi - llo + 2;
  const int lw = (jhi - jlo + 2) * lwz;
  const int cwz = lhi - llo;
  const int cw = (jhi - jlo) * cwz;
  // word s, selected without indexing the parameter array at run time
  uint32_t word = p.words[0];
#pragma unroll
  for (int q = 1; q < KMAX; ++q)
    if (q == s) word = p.words[q];
  const uint32_t step = p.step0 + static_cast<uint32_t>(s);
  // the bytes the neighbours push into each of this phase's planes
  uint32_t pushed_in = 0;
  if (!last)
    for (int ddz = -1; ddz <= 1; ++ddz)
      for (int ddy = -1; ddy <= 1; ++ddy) {
        const int ay = iy + ddy, az = iz + ddz;
        if ((ddy == 0 && ddz == 0) || ay < 0 || ay >= cy || az < 0 ||
            az >= cz)
          continue;
        int y0_, y1_, z0_, z1_;
        pushed_in += 2 * Q * 4 *
                     push_box(ay, az, iy, iz, cy, cz, p.by, p.bz, ps, y0_,
                              y1_, z0_, z1_);
      }

  // plane k of this phase (x0 - ps + k) at march step k; its psi stage
  // runs SD - 1 planes ahead
  for (int k = -LEAD; k < nx; ++k) {
    if (s > 0) {
      // phase s - 1 has written (and its neighbours have pushed) the last
      // plane this step pulls from, its plane k + 2 SD counted from its
      // first, and at the first step every plane before it: the pushes of
      // different planes may land in any order
      for (int jp = k == -LEAD ? 0 : k + 2 * SD; jp <= k + 2 * SD; ++jp)
        bar_wait(prev_full + jp % POP_RING, (jp / POP_RING) & 1);
    }
    if (FORCE) {
      // (psi) plane x0 - ps + kp of psi, on the part grown by SD - 1
      const int kp = k + SD - 1;
      if (!(EXT && x0 - ps + kp >= xe + ps + SD - 1)) {
        const int x = x0 - ps + kp;
        const int xw = wrap_any(x, X);
        float* out = psi_ring + wrap_any(x - x0, PSI_RING) * (2 * pn);
        const float* below = nullptr;
        const float* here = nullptr;
        const float* above = nullptr;
        if (s > 0) {
          const int jq = x - x0 + ps + SD;   // from phase s - 1's first
          below = prev + ((jq - 1) % POP_RING) * (2 * Q * qn);
          here = prev + (jq % POP_RING) * (2 * Q * qn);
          above = prev + ((jq + 1) % POP_RING) * (2 * Q * qn);
        }
        for (int c = tid; c < pw; c += nth) {
          const int jj = c / pwz;
          const int j = jlo + jj, l = llo + (c - jj * pwz);
          if (EXT && (y0 - ps - (SD - 1) + j >= ye + ps + SD - 1 ||
                      z0 - ps - (SD - 1) + l >= ze + ps + SD - 1))
            continue;
          float rho = 0.0f, phi = 0.0f;
          if (s == 0) {
            const int yw = wrap_any(y0 - ps - (SD - 1) + j, Y);
            const int zw = wrap_any(z0 - ps - (SD - 1) + l, Z);
            if (STRIPS) {
              // strip-fed: every load first, then the sums
              const StripRows rows(args, yw);
              float fv[Q], gv[Q];
#pragma unroll
              for (int i = 0; i < Q; ++i)
                rows.load(args, i, ImmTables::c(i, 1),
                          wrap(xw - ImmTables::c(i, 0), X),
                          wrap(zw - ImmTables::c(i, 2), Z), plane, fv[i],
                          gv[i]);
#pragma unroll
              for (int i = 0; i < Q; ++i) {
                rho += fv[i];
                phi += gv[i];
              }
            } else {
#pragma unroll
              for (int i = 0; i < Q; ++i) {
                const size_t src =
                    i * plane +
                    cell_offset(wrap(xw - ImmTables::c(i, 0), X),
                                wrap(yw - ImmTables::c(i, 1), Y),
                                wrap(zw - ImmTables::c(i, 2), Z), Y, Z);
                rho += __ldg(args.fin + src);
                phi += __ldg(args.gin + src);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              const int cx = ImmTables::c(i, 0), cy_ = ImmTables::c(i, 1),
                        cz_ = ImmTables::c(i, 2);
              const float* src =
                  (cx > 0 ? below : (cx < 0 ? above : here)) +
                  (j + 1 - cy_) * qnz + (l + 1 - cz_);
              rho += src[i * qn];
              phi += src[(Q + i) * qn];
            }
          }
          const int pc = j * pnz + l;
          out[pc] = psi_of(rho, p.use_sc, p.n0);
          out[pn + pc] = psi_of(phi, p.use_sc, p.n0);
        }
      }
      group_sync(s + 1, nth);
      if (A1) {
        // (lap) plane x0 - ps + kl of the laplacian, on the part grown by
        // 1: laplacian_psi.cu's sum over the psi ring
        const int kl = k + 1;
        if (kl >= -1 && !(EXT && x0 - ps + kl >= xe + ps + 1)) {
          const int x = x0 - ps + kl;
          float* out = lap_ring + wrap_any(x - x0, LAP_RING) * (2 * ln);
          for (int c = tid; c < lw; c += nth) {
            const int jj = c / lwz;
            const int j = jlo + jj, l = llo + (c - jj * lwz);
            if (EXT && (y0 - ps - 1 + j >= ye + ps + 1 ||
                        z0 - ps - 1 + l >= ze + ps + 1))
              continue;
            const int pc = (j + SD - 2) * pnz + (l + SD - 2);
            float acc[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 1; i < Q; ++i) {
              const int cx = ImmTables::c(i, 0), cy_ = ImmTables::c(i, 1),
                        cz_ = ImmTables::c(i, 2);
              const float* v = psi_ring +
                               wrap_any(x + cx - x0, PSI_RING) * (2 * pn) +
                               pc + cy_ * pnz + cz_;
              acc[0] += kLatW[i] * v[0];
              acc[1] += kLatW[i] * v[pn];
            }
            const float* v =
                psi_ring + wrap_any(x - x0, PSI_RING) * (2 * pn);
#pragma unroll
            for (int sp = 0; sp < 2; ++sp)
              out[sp * ln + j * lnz + l] =
                  kLatTwoCs2 * (acc[sp] - kLatWSum * v[sp * pn + pc]);
          }
        }
        group_sync(s + 1, nth);
      }
    }

    // (collide) plane x0 - ps + k
    const int x = x0 - ps + k;       // unwrapped
    if (k >= 0) {
      if (!last && k >= POP_RING)   // its slot's last readers are done
        bar_wait(my_empty + k % POP_RING, ((k / POP_RING) - 1) & 1);
      if (!(EXT ? x >= xe + ps : (last && x >= xe))) {
        const int xw = wrap_any(x, X);
        // phase s - 1's planes x - 1, x, x + 1
        const float* below = nullptr;
        const float* here = nullptr;
        const float* above = nullptr;
        if (s > 0) {
          const int jq = k + SD;   // plane x from phase s - 1's first
          below = prev + ((jq - 1) % POP_RING) * (2 * Q * qn);
          here = prev + (jq % POP_RING) * (2 * Q * qn);
          above = prev + ((jq + 1) % POP_RING) * (2 * Q * qn);
        }
        // psi and laplacian planes x - 1, x, x + 1
        const float* psi_x[3] = {nullptr, nullptr, nullptr};
        const float* lap_x[3] = {nullptr, nullptr, nullptr};
        if (FORCE) {
#pragma unroll
          for (int d = 0; d < 3; ++d)
            psi_x[d] =
                psi_ring + wrap_any(x + d - 1 - x0, PSI_RING) * (2 * pn);
        }
        if (A1) {
#pragma unroll
          for (int d = 0; d < 3; ++d)
            lap_x[d] =
                lap_ring + wrap_any(x + d - 1 - x0, LAP_RING) * (2 * ln);
        }
        float* slot = mine + (k % POP_RING) * (2 * Q * ncell);
        for (int c = tid; c < cw; c += nth) {
          const int jj = c / cwz;
          const int j = jlo + jj, l = llo + (c - jj * cwz);
          const int y = y0 - ps + j, z = z0 - ps + l;
          if (EXT ? (y >= ye + ps || z >= ze + ps)
                  : (last && (y >= ye || z >= ze)))
            continue;
          const int yw = wrap_any(y, Y), zw = wrap_any(z, Z);
          // the hash key: the cell's global coordinates
          int kx = xw, ky = yw, kz = zw;
          if (EXT) {
            kx = wrap_any(xw + p.gx0, p.GX);
            ky = wrap_any(yw + p.gy0, static_cast<int>(args.GY));
            kz = wrap_any(zw + p.gz0, static_cast<int>(args.GZ));
          }
          float rho = 0.0f, phi = 0.0f;
          float jf[3] = {0.0f, 0.0f, 0.0f};
          float jg[3] = {0.0f, 0.0f, 0.0f};
          // the streamed populations, kept for GENERAL's relaxation
          float fv[Q], gv[Q];
          if (s == 0 && STRIPS) {
            // strip-fed: every load first (from the strips where its row
            // lies in the y halo), then the sums
            const StripRows rows(args, yw);
#pragma unroll
            for (int i = 0; i < Q; ++i)
              rows.load(args, i, ImmTables::c(i, 1),
                        wrap(xw - ImmTables::c(i, 0), X),
                        wrap(zw - ImmTables::c(i, 2), Z), plane, fv[i],
                        gv[i]);
#pragma unroll
            for (int i = 0; i < Q; ++i)
              pull_add(ImmTables::c(i, 0), ImmTables::c(i, 1),
                       ImmTables::c(i, 2), fv[i], gv[i], rho, phi, jf, jg);
          } else if (s == 0) {
            // pull from device memory, periodic
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              const int cx = ImmTables::c(i, 0), cy_ = ImmTables::c(i, 1),
                        cz_ = ImmTables::c(i, 2);
              const size_t src = i * plane + cell_offset(wrap(xw - cx, X),
                                                         wrap(yw - cy_, Y),
                                                         wrap(zw - cz_, Z),
                                                         Y, Z);
              fv[i] = __ldg(args.fin + src);
              gv[i] = __ldg(args.gin + src);
              pull_add(cx, cy_, cz_, fv[i], gv[i], rho, phi, jf, jg);
            }
          } else {
            // pull from phase s - 1's plane x - cx in shared memory
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              const int cx = ImmTables::c(i, 0), cy_ = ImmTables::c(i, 1),
                        cz_ = ImmTables::c(i, 2);
              const float* src = (cx > 0 ? below : (cx < 0 ? above : here)) +
                                 (j + SD - cy_) * qnz + (l + SD - cz_);
              fv[i] = src[i * qn];
              gv[i] = src[(Q + i) * qn];
              pull_add(cx, cy_, cz_, fv[i], gv[i], rho, phi, jf, jg);
            }
          }
          const size_t idx = cell_offset(xw, yw, zw, Y, Z);
          // the cell in this phase's region and in its psi and laplacian
          // rings
          const int cell = j * nz + l;
          const int pc = (j + SD - 1) * pnz + (l + SD - 1);
          const int lc = (j + 1) * lnz + (l + 1);
          float* fo;
          float* go;
          size_t oplane, oidx;
          if (last) {
            fo = args.fout;
            go = args.gout;
            oplane = plane;
            oidx = idx;
          } else {
            fo = slot;
            go = slot + Q * ncell;
            oplane = static_cast<size_t>(ncell);
            oidx = static_cast<size_t>(cell);
          }
#define K_PULLED(S, I) ((S) == 0 ? fv[I] : gv[I])
          BFLBM_COLLIDE_CELL_WITH(args, word, step, kx, ky, kz, fo, go,
                                  oplane, oidx, ImmTables,
                                  SHARED_FORCES, K_PULLED);
#undef K_PULLED
          if (STRIPS && last && args.ys.out != nullptr &&
              (yw < args.ys.y_lo + args.ys.rows ||
               yw >= args.ys.y_hi - args.ys.rows))
            cell_to_strips(args.ys, args.fout, args.gout, plane, idx, xw, yw,
                           zw, X, Z);
        }
      }
    }
    // the stage's reads of phase s - 1's planes and of the psi ring, and
    // its writes, are done
    group_sync(s + 1, nth);
    if (!last && k >= 0 && nnb > 0) {
      // (push) the cells of plane k that a neighbour's next phase pulls
      // (push_box), written into its region (the same layout as this
      // one's) by st.async, each store counted on the neighbour's full
      // barrier of the slot (complete_tx), which its own producer arms
      const float* slot = mine + (k % POP_RING) * (2 * Q * ncell);
      for (int ddz = -1; ddz <= 1; ++ddz)
        for (int ddy = -1; ddy <= 1; ++ddy) {
          const int ny_ = iy + ddy, nz_ = iz + ddz;
          if ((ddy == 0 && ddz == 0) || ny_ < 0 || ny_ >= cy || nz_ < 0 ||
              nz_ >= cz)
            continue;
          int ya, yb, za, zb;
          const int nb = push_box(iy, iz, ny_, nz_, cy, cz, p.by, p.bz, ps,
                                  ya, yb, za, zb);
          if (nb == 0) continue;
          const int bw = zb - za;
          const uint32_t rank = static_cast<uint32_t>(ny_ + nz_ * cy);
          const uint32_t peer = peer_addr(smem_u32(slot), rank);
          const uint32_t rbar = peer_addr(smem_u32(my_full + k % POP_RING),
                                          rank);
          const int shift = ddy * p.by * nz + ddz * p.bz;
          for (int c = tid; c < nb; c += nth) {
            const int jj = c / bw;
            const int cell = (ya + jj + ps) * nz + (za + (c - jj * bw) + ps);
            float v[2 * Q];
#pragma unroll
            for (int q = 0; q < 2 * Q; ++q) v[q] = slot[q * ncell + cell];
            const uint32_t dst = peer + 4u * static_cast<uint32_t>(cell - shift);
#pragma unroll
            for (int q = 0; q < 2 * Q; ++q)
              asm volatile(
                  "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32"
                  " [%0], %1, [%2];" ::"r"(dst + 4u * q * ncell),
                  "f"(v[q]), "r"(rbar)
                  : "memory");
          }
        }
    }
    // one thread of the group hands the planes on: plane k is written
    // (its full barrier armed for the bytes the neighbours push), phase
    // s - 1's plane k + SD - 1 (x - 1 of the collide's pull) is read for
    // the last time here and in every neighbour this block pushes into
    const int jr = k + SD - 1;
    if (tid == 0) {
      if (!last && k >= 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_u32(my_full + k % POP_RING)),
            "r"(pushed_in)
            : "memory");
      if (s > 0 && jr >= 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                         smem_u32(prev_empty + jr % POP_RING))
                     : "memory");
        for (int ddz = -1; ddz <= 1; ++ddz)
          for (int ddy = -1; ddy <= 1; ++ddy) {
            const int ny_ = iy + ddy, nz_ = iz + ddz;
            if ((ddy == 0 && ddz == 0) || ny_ < 0 || ny_ >= cy || nz_ < 0 ||
                nz_ >= cz)
              continue;
            bar_arrive(prev_empty + jr % POP_RING,
                       static_cast<uint32_t>(ny_ + nz_ * cy));
          }
      }
    }
  }
  // no block exits while a neighbour may still push into it or arrive on
  // its barriers
  cluster.sync();
}

// Launch one instantiation on clusters of 1 x cy x cz blocks: its dynamic
// shared memory limit raised to `smem` first when that is above 48 KB and
// above what was set on this device before (a launch above the limit is
// refused, and only cudaGetLastError reports it); for a cluster of more
// than one block, cudaOccupancyMaxActiveClusters checked first (the last
// answer kept per device and shape): a cluster the device cannot place
// refuses the launch (cudaErrorInvalidConfiguration) and nothing runs.
template <bool NOISE, int DIST, bool GENERAL, bool REF, bool EXT,
          bool STRIPS>
int launch(int device, dim3 grid, int threads, size_t smem, cudaStream_t s,
           const BArgs& b) {
  static size_t allowed[MAX_DEVICES] = {};
  static long long placed[MAX_DEVICES] = {};   // the last shape that fits
  auto kern = blocked_kernel<NOISE, DIST, GENERAL, REF, EXT, STRIPS>;
  if (smem > 48 * 1024 && smem > allowed[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[device] = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(b.cy);
  attr[0].val.clusterDim.z = static_cast<unsigned>(b.cz);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long shape = (static_cast<long long>(smem) << 24) |
                          (static_cast<long long>(threads) << 8) |
                          (b.cy << 4) | b.cz;
  if (b.cy * b.cz > 1 && placed[device] != shape) {
    int clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    placed[device] = shape;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, b);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int DIST, bool GENERAL, bool EXT, bool STRIPS>
int launch_noise(int device, dim3 grid, int threads, size_t smem,
                 cudaStream_t s, const BArgs& b) {
  if (b.a.ref != nullptr)
    return launch<true, DIST, GENERAL, true, EXT, STRIPS>(device, grid,
                                                          threads, smem, s, b);
  return launch<true, DIST, GENERAL, false, EXT, STRIPS>(device, grid,
                                                         threads, smem, s, b);
}

template <bool GENERAL, bool EXT, bool STRIPS>
int launch_mode(int noise_on, int dist, int device, dim3 grid, int threads,
                size_t smem, cudaStream_t s, const BArgs& b) {
  if (!noise_on)
    return launch<false, DIST_U8, GENERAL, false, EXT, STRIPS>(
        device, grid, threads, smem, s, b);
  switch (dist) {
    case DIST_U8:
      return launch_noise<DIST_U8, GENERAL, EXT, STRIPS>(device, grid,
                                                         threads, smem, s, b);
    case DIST_CLT4:
      return launch_noise<DIST_CLT4, GENERAL, EXT, STRIPS>(device, grid,
                                                           threads, smem, s,
                                                           b);
    case DIST_CLT2:
      return launch_noise<DIST_CLT2, GENERAL, EXT, STRIPS>(device, grid,
                                                           threads, smem, s,
                                                           b);
    case DIST_BM:
      return launch_noise<DIST_BM, GENERAL, EXT, STRIPS>(device, grid,
                                                         threads, smem, s, b);
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

// Dynamic shared memory bytes a block of a launch of T steps at stencil
// depth sd on sub-tiles of (by, bz) cells in y and z: the barriers
// (barrier_bytes) and the sum of every phase's rings (phase_floats), the
// same in every block of any cluster; or -1 for a depth this library does
// not run.
extern "C" long long bflbm_blocked_smem(int sd, int T, int by, int bz) {
  if (sd != SD || T < 1 || T > KMAX) return -1;
  long long floats = 0;
  for (int s = 0; s < T; ++s) {
    const int ps = SD * (T - 1 - s);
    floats += phase_floats(by + 2 * ps, bz + 2 * ps, s == T - 1);
  }
  return barrier_bytes(T) + floats * static_cast<long long>(sizeof(float));
}

// T K steps on device pointers (19, X, Y, Z) float32, z contiguous: fin,
// gin -> fout, gout (which must not alias them), at the stencil depth sd of
// this library's build (1; 2 with BFLBM_FORCE; 3 with BFLBM_A1), over the
// region of geom: host array {X, Y, Z, x0, y0, z0, nx, ny, nz, ox, oy, oz,
// GY, GZ, GX} (the array extents, common.cuh Region, the global coordinates
// of array cell (0, 0, 0) and the global extents).  The whole periodic
// domain is the region (0, 0, 0, X, Y, Z) with origin 0 and global extents
// (X, Y, Z); anything else is a halo-extended block (the EXT mode above),
// whose region is its interior or a window of it, its pads at least sd T
// deep on the padded axes and the region spanning the others.
// words: host array of the T int32 noise words, the step of word s being
// step0 + s.  tile: host array {bx, by, bz, cy, cz}, a block's sub-tile
// (x-planes, y and z cells) and the cluster (blocks along y and z, at most
// 8 in all; a sub-tile at least sd cells across an axis the cluster
// spans); the grid covers the region with whole clusters.  threads: host
// array of the T warp groups' threads, phase by phase, each a positive
// multiple of 32, at most 384 in all.  ref: the (2, X, Y, Z) COM-rolled
// (rho_eq, phi_eq) of USE_REF_STATE, or null (read only with noise on).
// dist: 0 u8, 1 clt4, 2 clt2, 3 Box-Muller.  coef: host array [pref_mom,
// cf[15], cg[15], scale, off].  lam_f, lam_g: 1 / (tau + 1/2), read by the
// general-relaxation build.  force_k = -cs^2 alpha0; a1 = cs^2 alpha1;
// s_f, s_g the Guo prefactors; use_sc, n0: psi is the pseudopotential with
// reference density n0 (read by the force builds).  strips_in, strips_out:
// the received y strips and the strips the last phase writes (common.cuh
// YStrips, depth strip_rows, the y pads' depth), or null.  Returns
// cudaErrorInvalidValue for arguments it does not take (another sd, T
// outside 1..8, a tile, cluster or thread split out of range, strips
// shallower than 1 row or covering the arrays' y, more shared memory than
// a block of the device may hold), cudaErrorInvalidConfiguration for a
// cluster the device cannot place, else cudaGetLastError() after the
// launch.
extern "C" int bflbm_blocked_step(int device, const float* fin,
                                  const float* gin, const float* ref,
                                  float* fout, float* gout, const int* geom,
                                  const int* words, int T, int step0,
                                  const int* tile, const int* threads,
                                  float eps, float half_lam_f,
                                  float half_lam_g, float lam_f, float lam_g,
                                  int noise_on, int dist, const float* coef,
                                  float force_k, float a1, float s_f,
                                  float s_g, int use_sc, float n0, int sd,
                                  const float* strips_in, float* strips_out,
                                  int strip_rows, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const Region r = region_of(geom);
  if (sd != SD || T < 1 || T > KMAX || tile[0] < 1 || tile[1] < 1 ||
      tile[2] < 1 || tile[3] < 1 || tile[4] < 1 ||
      tile[3] * tile[4] > MAX_CLUSTER || (tile[3] > 1 && tile[1] < SD) ||
      (tile[4] > 1 && tile[2] < SD) || X < 1 || Y < 1 || Z < 1 ||
      r.nx < 1 || r.ny < 1 || r.nz < 1 || geom[12] < 1 || geom[13] < 1 ||
      geom[14] < 1 || device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidValue);
  int nthreads = 0;
  for (int s = 0; s < T; ++s) {
    if (threads[s] < 32 || threads[s] % 32 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    nthreads += threads[s];
  }
  if (nthreads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const bool strips = strips_in != nullptr || strips_out != nullptr;
  if (strips && (strip_rows < 1 || 2 * strip_rows >= Y))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = bflbm_blocked_smem(sd, T, tile[1], tile[2]);
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
  b.a.fc = Force{force_k, a1, s_f, s_g};
  b.use_sc = use_sc;
  b.n0 = n0;
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
  b.cy = tile[3];
  b.cz = tile[4];
  b.first[0] = 0;
  for (int s = 0; s < T; ++s) b.first[s + 1] = b.first[s] + threads[s];
  b.a.r = r;
  b.a.GY = static_cast<uint32_t>(geom[12]);
  b.a.GZ = static_cast<uint32_t>(geom[13]);
  b.gx0 = geom[9];
  b.gy0 = geom[10];
  b.gz0 = geom[11];
  b.GX = geom[14];
  b.a.ys = ystrips_of(strips_in, strips_out, strip_rows, Y);
  // whole clusters over the region
  const int cty = b.by * b.cy, ctz = b.bz * b.cz;
  const dim3 grid((r.nx + b.bx - 1) / b.bx, (r.ny + cty - 1) / cty * b.cy,
                  (r.nz + ctz - 1) / ctz * b.cz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kGeneral = BFLBM_GENERAL_RELAX != 0;
  // the hash keys of a whole-domain launch are the array's own
  const bool ext = is_ext(X, Y, Z, r) || b.gx0 != 0 || b.gy0 != 0 ||
                   b.gz0 != 0 || b.GX != X || geom[12] != Y ||
                   geom[13] != Z || strips;
  if (strips)
    return launch_mode<kGeneral, true, true>(noise_on, dist, device, grid,
                                             nthreads,
                                             static_cast<size_t>(smem), s, b);
  if (ext)
    return launch_mode<kGeneral, true, false>(noise_on, dist, device, grid,
                                              nthreads,
                                              static_cast<size_t>(smem), s, b);
  return launch_mode<kGeneral, false, false>(noise_on, dist, device, grid,
                                             nthreads,
                                             static_cast<size_t>(smem), s, b);
}

extern "C" const char* bflbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
