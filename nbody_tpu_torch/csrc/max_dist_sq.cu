// Global max of the raw pairwise squared distance on Hopper (sm_90a).
//
// Replaces: nbody_tpu/ops/pallas_nbody.py, _max_kernel (the kernel body)
// and pallas_max_dist_sq (its wrapper): the upper-triangle max of raw d^2
// that the int-sim log grid needs as its tensor-global upper bound. The
// wrapper adds eps^2 in PyTorch afterwards.
//
// Design: one launch (max_d2_single). Particles are cut into tiles of S
// points, S = 64 for small N (the pruned bounds pass's 1024 candidates make
// 136 tile pairs, about one a SM, where 256-point tiles made 10) and 256
// beyond; a grid of at most `capacity` blocks walks the T (T + 1) / 2 tile
// pairs I <= J in a grid-stride loop (thread per receiver row, source tile
// staged in shared memory), each block keeps its running max and stores
// it, and the block that takes the last integer ticket takes the max of
// those values in the same launch and resets the ticket (fold_by_ticket,
// max_reduce.cuh). Max is exact, so the result does not depend on the
// order and is bitwise the plain version's.
//
// d^2 is subtract-form and never contracted into an FMA:
// __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)) (+ dz^2), op for op what
// PyTorch's eager ops and the force kernel compute, so the bound the grid
// gets is the max of the d^2 the force kernel quantizes.
//
// `skip` (nullable, on the device) makes every block return at once when
// *skip != 0 (block 0 writes the 0): the candidate-pruned bounds pass
// launches the full set unconditionally and lets the device decide
// whether the candidates already sufficed, so the step never waits on the
// host. With 256-point tiles a skipped launch over 5000 points reads the
// flag in 210 blocks.
// `count` (nullable, on the device) gains 1 whenever the launch ran, so a
// run can read afterwards how often the pruned pass took its full-set
// fallback.
//
// Large N: this kernel also replaces _max_kernel_streamed /
// pallas_max_dist_sq_streamed (TPU kernel #3), the fallback past 8 MB of
// VMEM-resident positions. It never holds the source set resident: each
// block stages one MT-tile of sources at a time from device memory, the
// tile-pair index is 64-bit and the grid is capped at `capacity` blocks,
// so N is bounded only by int32 particle indices.
//
// What bounds it on the H100: arithmetic, ~6 fp32 ops per pair over
// N^2/2 pairs; positions are O(N) bytes. On the main path it runs on the
// 1024 candidates (~0.5M pairs, a bound of 0.05 us) and the full-set
// launch exits at once unless the geometry defeats the candidates: there
// the fixed costs of a launch set its time, hence one launch that spreads
// over the card.
//
// Two sets: nbody_pair_max_tiled replaces _pair_max_kernel /
// pallas_pair_max (TPU kernel #9), the tile of the multi-device ring's
// bounds pass: the max of raw d^2 over every (receiver, source) pair of two
// sets, where a pair counts only if both ends are valid (the TPU kernel
// multiplies d^2 by v_i * v_j; d^2 >= 0 and the max starts at 0, so
// skipping an invalid pair is the same). Its max of one set against
// itself, all valid, is bitwise max_d2's. What bounds it: ~6 fp32 ops per
// pair, na * nb pairs (the ring's pass visits S * (S/2 + 1) shard pairs,
// N^2 / 2 pairs and more in all). The design (pair_max_tiled):
//   * one launch: each block stores its max and the block that takes the
//     last ticket folds them (fold_by_ticket, as max_d2_single does; the
//     ticket is max_d2's, hopper_nbody.TICKETS);
//   * PM_R = 4 receivers a thread in registers, 128 threads a block (512
//     receivers), each source of a 128-point tile staged once in shared
//     memory as one vector (float2, or float4 at D = 3) and read as a
//     broadcast: one shared load serves 4 pairs, 4 independent max chains;
//   * validity off the pair loop: an invalid receiver or source (and a
//     point past the end of its set) is loaded as NaN, so each of its d^2
//     is NaN, which fmaxf drops (it returns the other operand). A valid
//     pair's d^2 is finite for finite positions, so the max is that of the
//     valid pairs, 0 when there is none, with no test in the loop and no
//     masked copy of it for the tiles that hold the ring's phantoms;
//   * a grid of receiver blocks x source segments, a fixed function of
//     (na, nb) (hopper_nbody.pair_max_segments, beside row_segments) that
//     aims at PAIR_MAX_TARGET_BLOCKS blocks: 256 x 64 at 131072^2.
// Per pair D subtracts, D multiplies, D - 1 adds and a max, none of which
// may fuse (subtract-form d^2), so at D = 2 six issue slots a pair and a
// quarter of a shared load: ~3.2 ms at 131072^2 by the FP32 issue rate,
// twice pair_ops' bound, whose 67 TFLOP/s peak counts an FMA as two ops.
//
// One set past 16384 points (max_d2_tiled; nbody_max_d2_tiled, the route
// of hopper_nbody.max_d2_design), replacing max_d2_single's 256-point tile
// there (one thread a receiver, one shared load a coordinate a pair, one
// max chain a thread: 2.19 ms at 131072, 200 ms at 1M D=3, where
// pair_max_tiled computes the same max over twice the pairs at 131072^2
// in 3.65 ms). It runs pair_max_tiled's body over one set's upper
// triangle of 512-point units: a work item is a unit pair I <= J (J-major,
// tri_tile), 512 receivers in registers (4 a thread) against the 512
// sources of unit J staged once in shared memory; a diagonal item walks
// its full square (d^2 of x_j - x_i and of x_i - x_j are the same bits,
// a self pair gives 0, so the max is unchanged). A point past n is staged
// as NaN, which fmaxf drops. The grid is capped (persistent blocks
// walking the items in a grid-stride loop), so a skipped launch reads the
// flag in no more blocks than max_d2_single's capped grid; every block
// folds by max_d2's ticket in the same launch, and `skip` and `count`
// keep their contract. Max is exact: bitwise max_d2_single's.

#include "max_reduce.cuh"
#include "nbody_common.cuh"

namespace {

constexpr int MT = MAX_RT;

// The single launch: tiles of S receivers and S sources, a grid of at most
// `capacity` blocks walking the T (T + 1) / 2 tile pairs I <= J (J-major,
// tri_tile), each pair's d^2 subtract-form as above; then each block
// stores its max, takes an integer ticket, and the block that takes the
// last one folds the per-block maxima into out (max is exact: any
// block, any order, the same bits), counts the run and leaves the ticket 0.
// A skipped launch returns at once in every block; block 0 writes the 0.
template <int D, int S>
__global__ void __launch_bounds__(S)
max_d2_single(const float* __restrict__ pos, int n, const int* __restrict__ skip,
              int* __restrict__ count, float* __restrict__ block_max,
              int* __restrict__ ticket, float* __restrict__ out) {
  const int t = threadIdx.x;
  if (skip != nullptr && *skip != 0) {
    if (blockIdx.x == 0 && t == 0) out[0] = 0.f;
    return;
  }
  const long long T = (n + S - 1) / S;
  __shared__ float xj_s[D][S];
  float best = 0.f;
  for (long long k = blockIdx.x; k < T * (T + 1) / 2; k += gridDim.x) {
    int I, J;
    tri_tile(k, I, J);
    const int j0 = J * S;
    const int jcnt = min(S, n - j0);
    __syncthreads();  // the previous pair's readers are done with xj_s
    if (t < jcnt) {
#pragma unroll
      for (int d = 0; d < D; ++d) xj_s[d][t] = pos[(size_t)(j0 + t) * D + d];
    }
    __syncthreads();
    const int i = I * S + t;
    if (i < n) {
      float xi[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xi[d] = pos[(size_t)i * D + d];
      for (int j = 0; j < jcnt; ++j) {
        const float dx0 = __fsub_rn(xj_s[0][j], xi[0]);
        float d2 = __fmul_rn(dx0, dx0);
#pragma unroll
        for (int d = 1; d < D; ++d) {
          const float dx = __fsub_rn(xj_s[d][j], xi[d]);
          d2 = __fadd_rn(d2, __fmul_rn(dx, dx));
        }
        best = fmaxf(best, d2);
      }
    }
  }
  fold_by_ticket<S>(best, block_max, blockIdx.x, gridDim.x, ticket, count,
                    out);
}

template <int D>
void launch_single(const float* pos, int n, int tile, const int* skip,
                   int* count, float* block_max, int capacity, int* ticket,
                   float* out, cudaStream_t s) {
  const long long T = (n + tile - 1) / tile;
  const long long pairs = T * (T + 1) / 2;
  const int nb = (int)(pairs < capacity ? pairs : capacity);
  if (tile == 64)
    max_d2_single<D, 64><<<nb, 64, 0, s>>>(pos, n, skip, count, block_max,
                                           ticket, out);
  else
    max_d2_single<D, MT><<<nb, MT, 0, s>>>(pos, n, skip, count, block_max,
                                           ticket, out);
}

// The register-tiled pair_max (pair_max_tiled), one launch.
constexpr int PM_R = 4;                      // receivers a thread
constexpr int PM_THREADS = 128;              // threads a block
constexpr int PM_RW = PM_R * PM_THREADS;     // receivers a block: 512
constexpr int PM_TILE = 128;                 // sources a staged tile
static_assert(PM_TILE == PM_THREADS, "one thread a source stages");

// A staged source: D = 2 a float2, D = 3 a float4 (one 16-byte load).
template <int D>
using PmVec = typename std::conditional<D == 2, float2, float4>::type;

// Point j of p as the staged vector where ok, else NaNs: its every d^2 is
// then NaN, which fmaxf drops.
template <int D>
__device__ __forceinline__ PmVec<D> pm_point(const float* __restrict__ p,
                                             bool ok, int j) {
  const float nan = __int_as_float(0x7fffffff);
  const float* q = p + (size_t)j * D;
  if constexpr (D == 2)
    return ok ? make_float2(q[0], q[1]) : make_float2(nan, nan);
  else
    return ok ? make_float4(q[0], q[1], q[2], 0.f)
              : make_float4(nan, nan, nan, nan);
}

// Point j of p, NaNs where it is invalid or past n.
template <int D>
__device__ __forceinline__ PmVec<D> pm_load(const float* __restrict__ p,
                                            const unsigned char* __restrict__ v,
                                            int n, int j) {
  return pm_point<D>(p, j < n && v[j], j);
}

// Receiver block b = blockIdx.x (receivers b 512 + 128 r + t, r = 0..3, in
// registers) against segment S = blockIdx.y (source tiles S seg .. S seg +
// seg - 1, each staged once, double-buffered, one barrier a tile); each
// pair's raw d^2 as max_d2_single forms it, into one running max a
// receiver; then the fold by ticket over the gridDim.x gridDim.y blocks.
template <int D>
__global__ void __launch_bounds__(PM_THREADS)
pair_max_tiled(const float* __restrict__ pa,
               const unsigned char* __restrict__ va, int na,
               const float* __restrict__ pb,
               const unsigned char* __restrict__ vb, int nb, int seg,
               float* __restrict__ block_max, int* __restrict__ ticket,
               float* __restrict__ out) {
  __shared__ PmVec<D> xs[2][PM_TILE];
  const int t = threadIdx.x;
  const int i_lo = blockIdx.x * PM_RW;
  const int tiles = (nb + PM_TILE - 1) / PM_TILE;
  const int Jb = blockIdx.y * seg;
  const int Je = min(tiles, Jb + seg);

  float xi[PM_R][D], best[PM_R];
#pragma unroll
  for (int r = 0; r < PM_R; ++r) {
    const PmVec<D> p = pm_load<D>(pa, va, na, i_lo + PM_THREADS * r + t);
    xi[r][0] = p.x;
    xi[r][1] = p.y;
    if constexpr (D == 3) xi[r][D - 1] = p.z;
    best[r] = 0.f;
  }
  xs[0][t] = pm_load<D>(pb, vb, nb, Jb * PM_TILE + t);
  __syncthreads();
  for (int J = Jb, k = 0; J < Je; ++J, ++k) {
    const int buf = k & 1;
    PmVec<D> nxt{};
    if (J + 1 < Je) nxt = pm_load<D>(pb, vb, nb, (J + 1) * PM_TILE + t);
#pragma unroll 8
    for (int j = 0; j < PM_TILE; ++j) {
      const PmVec<D> sj = xs[buf][j];
      float xj[D];
      xj[0] = sj.x;
      xj[1] = sj.y;
      if constexpr (D == 3) xj[D - 1] = sj.z;
#pragma unroll
      for (int r = 0; r < PM_R; ++r) {
        float dx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj[d], xi[r][d]);
        best[r] = fmaxf(best[r], raw_d2<D>(dx));
      }
    }
    xs[buf ^ 1][t] = nxt;
    __syncthreads();
  }
  float m = best[0];
#pragma unroll
  for (int r = 1; r < PM_R; ++r) m = fmaxf(m, best[r]);
  fold_by_ticket<PM_THREADS>(m, block_max,
                             blockIdx.y * gridDim.x + blockIdx.x,
                             gridDim.x * gridDim.y, ticket, nullptr, out);
}

// One set's max d^2 on pair_max_tiled's body: each block walks the unit
// pairs k = blockIdx.x, + gridDim.x, ... of the U (U + 1) / 2 pairs I <= J
// of 512-point units (tri_tile), receivers of unit I in registers against
// the sources of unit J staged in shared memory, each pair's raw d^2 as
// max_d2_single forms it; then the fold by ticket (counting the run). A
// skipped launch returns at once in every block; block 0 writes the 0.
template <int D>
__global__ void __launch_bounds__(PM_THREADS)
max_d2_tiled(const float* __restrict__ pos, int n,
             const int* __restrict__ skip, int* __restrict__ count,
             float* __restrict__ block_max, int* __restrict__ ticket,
             float* __restrict__ out) {
  const int t = threadIdx.x;
  if (skip != nullptr && *skip != 0) {
    if (blockIdx.x == 0 && t == 0) out[0] = 0.f;
    return;
  }
  __shared__ PmVec<D> xs[PM_RW];
  const long long U = (n + PM_RW - 1) / PM_RW;
  float best[PM_R];
#pragma unroll
  for (int r = 0; r < PM_R; ++r) best[r] = 0.f;
  for (long long k = blockIdx.x; k < U * (U + 1) / 2; k += gridDim.x) {
    int I, J;
    tri_tile(k, I, J);
    float xi[PM_R][D];
#pragma unroll
    for (int r = 0; r < PM_R; ++r) {
      const int i = I * PM_RW + PM_THREADS * r + t;
      const PmVec<D> p = pm_point<D>(pos, i < n, i);
      xi[r][0] = p.x;
      xi[r][1] = p.y;
      if constexpr (D == 3) xi[r][D - 1] = p.z;
    }
    __syncthreads();  // the previous item's readers are done with xs
#pragma unroll
    for (int r = 0; r < PM_R; ++r) {
      const int j = J * PM_RW + PM_THREADS * r + t;
      xs[PM_THREADS * r + t] = pm_point<D>(pos, j < n, j);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < PM_RW; ++j) {
      const PmVec<D> sj = xs[j];
      float xj[D];
      xj[0] = sj.x;
      xj[1] = sj.y;
      if constexpr (D == 3) xj[D - 1] = sj.z;
#pragma unroll
      for (int r = 0; r < PM_R; ++r) {
        float dx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj[d], xi[r][d]);
        best[r] = fmaxf(best[r], raw_d2<D>(dx));
      }
    }
  }
  float m = best[0];
#pragma unroll
  for (int r = 1; r < PM_R; ++r) m = fmaxf(m, best[r]);
  fold_by_ticket<PM_THREADS>(m, block_max, blockIdx.x, gridDim.x, ticket,
                             count, out);
}

}  // namespace

// pos (n, dim) f32 on the device; skip, count: nullable device ints;
// block_max: scratch of `capacity` floats; ticket: one device int, 0, left
// 0; out: one float, the raw max d^2 (0 when skipped). The single launch
// with tiles of `tile` (64 or 256) points. Returns cudaGetLastError().
extern "C" int nbody_max_d2(const float* pos, int n, int dim, const int* skip,
                            int* count, float* block_max, int capacity,
                            int* ticket, int tile, float* out, void* stream) {
  if (n <= 0 || (dim != 2 && dim != 3) || capacity <= 0 ||
      ticket == nullptr || (tile != 64 && tile != MT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2)
    launch_single<2>(pos, n, tile, skip, count, block_max, capacity, ticket,
                     out, s);
  else
    launch_single<3>(pos, n, tile, skip, count, block_max, capacity, ticket,
                     out, s);
  return (int)cudaGetLastError();
}

// Receivers pa (na, dim), sources pb (nb, dim) f32; va (na,), vb (nb,)
// validity bytes (0 or 1), all on the device; seg >= 1 source tiles (of
// PM_TILE) a segment, nseg = ceil(ceil(nb / PM_TILE) / seg) segments,
// grid (ceil(na / PM_RW), nseg); block_max: scratch of one float a block;
// ticket: one device int, 0, left 0 (shared with nbody_max_d2's single
// launch: the two must run on one stream); out: one float, the max raw d^2
// over valid pairs (0 if there is none). One launch. Returns
// cudaGetLastError().
extern "C" int nbody_pair_max_tiled(const float* pa, const unsigned char* va,
                                    int na, const float* pb,
                                    const unsigned char* vb, int nb, int dim,
                                    int seg, float* block_max, int* ticket,
                                    float* out, void* stream) {
  if (na <= 0 || nb <= 0 || (dim != 2 && dim != 3) || seg <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (nb + PM_TILE - 1) / PM_TILE;
  const int nseg = (tiles + seg - 1) / seg;
  if (nseg > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((na + PM_RW - 1) / PM_RW, nseg);
  if (dim == 2)
    pair_max_tiled<2><<<grid, PM_THREADS, 0, s>>>(pa, va, na, pb, vb, nb, seg,
                                                  block_max, ticket, out);
  else
    pair_max_tiled<3><<<grid, PM_THREADS, 0, s>>>(pa, va, na, pb, vb, nb, seg,
                                                  block_max, ticket, out);
  return (int)cudaGetLastError();
}

// One set past 16384 points on pair_max_tiled's body (max_d2_tiled): pos
// (n, dim) f32; skip, count: nullable device ints as nbody_max_d2's;
// block_max: scratch of `capacity` floats, the grid's cap; ticket: one
// device int, 0, left 0 (max_d2's); out: one float, the raw max d^2 (0
// when skipped). One launch. Returns cudaGetLastError().
extern "C" int nbody_max_d2_tiled(const float* pos, int n, int dim,
                                  const int* skip, int* count,
                                  float* block_max, int capacity, int* ticket,
                                  float* out, void* stream) {
  if (n <= 0 || (dim != 2 && dim != 3) || capacity <= 0 || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long U = (n + PM_RW - 1) / PM_RW;
  const long long items = U * (U + 1) / 2;
  const int grid = (int)(items < capacity ? items : capacity);
  if (dim == 2)
    max_d2_tiled<2><<<grid, PM_THREADS, 0, s>>>(pos, n, skip, count,
                                                block_max, ticket, out);
  else
    max_d2_tiled<3><<<grid, PM_THREADS, 0, s>>>(pos, n, skip, count,
                                                block_max, ticket, out);
  return (int)cudaGetLastError();
}

// Blocks of max_d2_tiled<dim> a SM holds at once (-1: none).
extern "C" int nbody_max_d2_tiled_resident(int dim) {
  int blocks = -1;
  cudaError_t rc = cudaErrorInvalidValue;
  if (dim == 2)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, max_d2_tiled<2>, PM_THREADS, 0);
  else if (dim == 3)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, max_d2_tiled<3>, PM_THREADS, 0);
  return rc == cudaSuccess ? blocks : -1;
}

// Receivers a block, sources a tile of the register-tiled pair_max
// (hopper_nbody.PAIR_MAX_RECEIVERS, PAIR_MAX_SOURCE_TILE): rw * 65536 + tile.
extern "C" int nbody_pair_max_geometry() { return PM_RW * 65536 + PM_TILE; }

// Blocks of pair_max_tiled<dim> a SM holds at once (-1: none).
extern "C" int nbody_pair_max_tiled_resident(int dim) {
  int blocks = -1;
  cudaError_t rc = cudaErrorInvalidValue;
  if (dim == 2)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pair_max_tiled<2>, PM_THREADS, 0);
  else if (dim == 3)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pair_max_tiled<3>, PM_THREADS, 0);
  return rc == cudaSuccess ? blocks : -1;
}
