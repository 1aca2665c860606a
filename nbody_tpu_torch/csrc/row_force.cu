// Row-sweep softened gravity on Hopper (sm_90a): the accelerations of a
// receiver set due to a source set, every (receiver, source) pair.
//
// Replaces: nbody_tpu/ops/pallas_nbody.py, _force_kernel_streamed /
// pallas_accelerations_streamed (TPU kernel #4) and _force_kernel /
// pallas_accelerations (#8), where receivers and sources are one set, and
// _force_kernel / pallas_pair_force (#10, the multi-device ring's rows
// schedule tile), where they are two sets, disjoint or equal. The TPU
// kernels compute the same sums; #4 and #8 differ only in whether the
// (D+1, N) source array stays resident in VMEM or is streamed from HBM a
// block per grid step, and #10 is #8's body on two arrays. Here one kernel
// serves all three: sources are staged through shared memory tile by tile
// from device memory, whatever their count.
//
// acc_i = sum_j G m_j w_ij (x_j - x_i), w = quantized |r|^-3 of the
// softened d^2. eps^2 is read from bounds[2] on the device, so a run-time
// softening needs no new launch parameters, and self_masked skips j == i
// by index (one set only: zero or run-time softening,
// pallas_nbody.py:586, the diagonal would be 0 * inf there). #10 never
// masks: at eps^2 > 0 a receiver that is also a source meets itself at
// diff = 0, an exact zero term, and the ring gives zero softening's
// diagonal block to the self-masked one-set form.
//
// The earlier design (row_force_kernel, parent=True): one thread per
// receiver row, RB rows per block. The block walks all sources in tiles of
// RB staged in shared memory, j ascending; each tile's terms are summed
// with fmaf in registers and the tile sum is then added to the row: a
// fixed order, so two runs give the same bits. The
// two-level sum keeps the rounding error near that of the sym kernel's
// per-tile partials: one fmaf chain over all N terms rounded ~5x worse
// where terms cancel (softening 0.05, N = 5000), beyond the plain
// version's tolerance. A ragged tail is handled by counts, with no padded
// pairs.
//
// Numerics: csrc/nbody_common.cuh.
//
// What bounds either design on the H100: arithmetic, N^2 pair evaluations
// (twice the sym kernel's N^2 / 2) of 14 fp32 ops (D = 2 float32) plus an
// rsqrt (float modes) or a logf + expf (int modes). Every thread of a
// block reads the same source from shared memory (a broadcast); device
// memory sees N / RB passes over the (N, D) positions and G*m, which at
// N = 1M is ~16 MB a pass, held in the 50 MB L2. Receivers and sources are
// separate pointers and counts, so the two-set form costs nothing over the
// one-set form.

// The register-tiled design (row_tiled; nbody_row_force_tiled), the
// wrappers' default since the earlier one-thread-a-receiver kernel above
// (row_force_kernel; nbody_row_force, reached by parent=True) spent ~23
// issue slots a pair against the function's ~12 instructions (14 fp32 ops,
// pair_ops "rows", D = 2 float32): D + 1 shared loads a pair and the
// self-mask's index test on every pair of every launch, #10's too. What it
// does about each:
//   * R = ROW_R = 4 receivers a thread, ROW_THREADS = 128 threads a block
//     (512 receivers: thread t holds b 512 + 128 r + t), in registers with
//     their sums: one shared load a source serves 4 pairs;
//   * each source staged once as a float4 {x, y, (z), G m} (D = 2:
//     {x, y, G m, 0}): one broadcast load a source, double-buffered, one
//     barrier a tile of ROW_TILE = 128 sources;
//   * the self-mask a template parameter, applied only on the source tiles
//     that overlap the block's receivers (4 of a segment's tiles at most; a
//     block-uniform branch into a masked copy of the tile loop, where a
//     select zeroes w of the pair j == i before G m multiplies it, so a
//     zero-softening self pair is never 0 * inf). Every other tile, and
//     every #10 launch, runs with no per-pair test;
//   * 4 receivers a thread leave ~8 warps a SM at 131072 receivers, so the
//     sources are cut into segments of consecutive tiles: a grid of
//     receiver blocks x segments (hopper_nbody.row_segments, a fixed
//     function of (n_i, n_j) that aims at ROW_TARGET_BLOCKS blocks), each
//     block writing its rows' segment sums to rpart (ceil(n_i / 512), nseg,
//     512, D) f32, which reduce_partials sums over the segments in order
//     (one segment: the block writes the rows themselves, no reduction).
// The accuracy structure stays: each 128-source tile's terms are summed by
// fmaf in registers, then added to the row's sum (one long chain fails the
// plain version's tolerance, as above). A ragged last source tile is
// padded in shared memory with inert far sentinels (x = 2e18, the TPU
// kernels' far sentinel, G m = 0: d^2 ~ 8e36 stays finite and its w and
// its term are 0); receivers past
// n_i compute and are never written.

#include "nbody_common.cuh"

namespace {

constexpr int RB = 128;

template <int MODE, int D>
__global__ void __launch_bounds__(RB)
row_force_kernel(const float* __restrict__ pos_i, int n_i,
                 const float* __restrict__ pos_j, const float* __restrict__ gm,
                 int n, const float* __restrict__ bounds, int levels,
                 float arg_cap, float min_d2, int self_masked,
                 float* __restrict__ out) {
  __shared__ float xj_s[D][RB];
  __shared__ float gmj_s[RB];
  const int t = threadIdx.x;
  const int i = blockIdx.x * RB + t;
  const bool live = i < n_i;

  const float soft = bounds[2];
  IntGrid g{};
  if (MODE == MODE_INT) g = int_grid(bounds, levels, arg_cap, min_d2);

  float xi[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xi[d] = live ? pos_i[(size_t)i * D + d] : 0.f;
    acc[d] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += RB) {
    const int jcnt = min(RB, n - j0);
    __syncthreads();  // the previous tile's readers are done
    if (t < jcnt) {
#pragma unroll
      for (int d = 0; d < D; ++d) xj_s[d][t] = pos_j[(size_t)(j0 + t) * D + d];
      gmj_s[t] = gm[j0 + t];
    }
    __syncthreads();
    if (!live) continue;
    float part[D];
#pragma unroll
    for (int d = 0; d < D; ++d) part[d] = 0.f;
    for (int j = 0; j < jcnt; ++j) {
      if (self_masked && j0 + j == i) continue;
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj_s[d][j], xi[d]);
      const float w = pair_w<MODE>(__fadd_rn(raw_d2<D>(dx), soft), g);
      const float fr = __fmul_rn(gmj_s[j], w);
#pragma unroll
      for (int d = 0; d < D; ++d) part[d] = fmaf(fr, dx[d], part[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = __fadd_rn(acc[d], part[d]);
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[(size_t)i * D + d] = acc[d];
  }
}

constexpr int ROW_R = 4;          // receivers a thread
constexpr int ROW_THREADS = 128;  // threads a block
constexpr int ROW_RW = ROW_R * ROW_THREADS;  // receivers a block: 512
constexpr int ROW_TILE = 128;     // sources a staged tile (the inner sum)
static_assert(ROW_TILE == ROW_THREADS, "one thread a source stages");

// One staged tile of ROW_TILE sources (first index j0) against a thread's
// ROW_R receivers (indices i0 + 128 r): the tile's terms summed by fmaf
// in j order, then added to acc. MASK zeroes w of the pair j == i.
template <int MODE, int D, bool MASK>
__device__ __forceinline__ void row_tile(const float4* __restrict__ xs,
                                         const float (&xi)[ROW_R][D],
                                         float (&acc)[ROW_R][D], float soft,
                                         const IntGrid& g, int j0, int i0) {
  float part[ROW_R][D];
#pragma unroll
  for (int r = 0; r < ROW_R; ++r)
#pragma unroll
    for (int d = 0; d < D; ++d) part[r][d] = 0.f;
#pragma unroll 4
  for (int j = 0; j < ROW_TILE; ++j) {
    const float4 sj = xs[j];
    const float xj[3] = {sj.x, sj.y, sj.z};
    const float gmj = D == 2 ? sj.z : sj.w;
#pragma unroll
    for (int r = 0; r < ROW_R; ++r) {
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj[d], xi[r][d]);
      float w = pair_w<MODE>(__fadd_rn(raw_d2<D>(dx), soft), g);
      if (MASK) w = j0 + j == i0 + ROW_THREADS * r ? 0.f : w;
      const float fr = __fmul_rn(gmj, w);
#pragma unroll
      for (int d = 0; d < D; ++d) part[r][d] = fmaf(fr, dx[d], part[r][d]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROW_R; ++r)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[r][d] = __fadd_rn(acc[r][d], part[r][d]);
}

// Receiver block b = blockIdx.x (receivers b 512 .. b 512 + 511) against
// segment S = blockIdx.y (source tiles S seg .. S seg + seg - 1); the rows'
// segment sums to rpart[b][S][512][D] (with one segment: out itself).
template <int MODE, int D, bool MASKED>
__global__ void __launch_bounds__(ROW_THREADS)
row_tiled(const float* __restrict__ pos_i, int n_i,
          const float* __restrict__ pos_j, const float* __restrict__ gm,
          int n_j, const float* __restrict__ bounds, int levels,
          float arg_cap, float min_d2, int seg, float* __restrict__ rpart) {
  __shared__ float4 xs[2][ROW_TILE];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int S = blockIdx.y;
  const int i_lo = b * ROW_RW;
  const int tiles = (n_j + ROW_TILE - 1) / ROW_TILE;
  const int Jb = S * seg;
  const int Je = min(tiles, Jb + seg);

  const float soft = bounds[2];
  const IntGrid g = mode_grid<MODE>(bounds, levels, arg_cap, min_d2);
  float xi[ROW_R][D], acc[ROW_R][D];
#pragma unroll
  for (int r = 0; r < ROW_R; ++r) {
    const int i = i_lo + ROW_THREADS * r + t;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xi[r][d] = i < n_i ? pos_i[(size_t)i * D + d] : 0.f;
      acc[r][d] = 0.f;
    }
  }
  xs[0][t] = load_src4<D>(pos_j, gm, n_j, Jb * ROW_TILE + t);
  __syncthreads();
  for (int J = Jb, k = 0; J < Je; ++J, ++k) {
    const int buf = k & 1;
    float4 nxt{};
    if (J + 1 < Je)
      nxt = load_src4<D>(pos_j, gm, n_j, (J + 1) * ROW_TILE + t);
    const int j0 = J * ROW_TILE;
    if (MASKED && j0 < i_lo + ROW_RW && j0 + ROW_TILE > i_lo)  // block-uniform
      row_tile<MODE, D, true>(xs[buf], xi, acc, soft, g, j0, i_lo + t);
    else
      row_tile<MODE, D, false>(xs[buf], xi, acc, soft, g, j0, i_lo + t);
    xs[buf ^ 1][t] = nxt;
    __syncthreads();
  }
  float* out = rpart + ((size_t)b * gridDim.y + S) * ROW_RW * D;
#pragma unroll
  for (int r = 0; r < ROW_R; ++r) {
    if (i_lo + ROW_THREADS * r + t >= n_i) continue;
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[(ROW_THREADS * r + t) * D + d] = acc[r][d];
  }
}

}  // namespace

// Receivers pos_i (n_i, dim), sources pos_j (n_j, dim) with gm (n_j,) =
// G * m, all f32 (pos_i may be pos_j: one set); bounds (3,) f32 =
// [log_lo, log_hi, eps^2] on the device; out (n_i, dim) f32. self_masked
// skips source j == receiver i by index. Returns cudaGetLastError().
extern "C" int nbody_row_force(const float* pos_i, int n_i, const float* pos_j,
                               const float* gm, int n_j, const float* bounds,
                               int dim, int mode, int levels, float arg_cap,
                               float min_d2, int self_masked, float* out,
                               void* stream) {
  if (n_i <= 0 || n_j <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_i + RB - 1) / RB;
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    row_force_kernel<M, DD><<<blocks, RB, 0, s>>>(
        pos_i, n_i, pos_j, gm, n_j, bounds, levels, arg_cap, min_d2,
        self_masked, out);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The register-tiled design: the same arguments as nbody_row_force, plus
// seg >= 1 source tiles (of ROW_TILE) a segment, nseg = ceil(ceil(n_j /
// ROW_TILE) / seg) segments, and rpart: (ceil(n_i / ROW_RW), nseg, ROW_RW,
// dim) f32 scratch, unused (may be null) when nseg == 1. One launch, or two
// with the fixed-order reduction over the segments. Returns
// cudaGetLastError().
extern "C" int nbody_row_force_tiled(const float* pos_i, int n_i,
                                     const float* pos_j, const float* gm,
                                     int n_j, const float* bounds, int dim,
                                     int mode, int levels, float arg_cap,
                                     float min_d2, int self_masked, int seg,
                                     float* rpart, float* out, void* stream) {
  if (n_i <= 0 || n_j <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n_j + ROW_TILE - 1) / ROW_TILE;
  const int nseg = (tiles + seg - 1) / seg;
  if (nseg > 65535 || (nseg > 1 && rpart == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_i + ROW_RW - 1) / ROW_RW, nseg);
  float* part = nseg == 1 ? out : rpart;
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    if (self_masked)
      row_tiled<M, DD, true><<<grid, ROW_THREADS, 0, s>>>(
          pos_i, n_i, pos_j, gm, n_j, bounds, levels, arg_cap, min_d2, seg,
          part);
    else
      row_tiled<M, DD, false><<<grid, ROW_THREADS, 0, s>>>(
          pos_i, n_i, pos_j, gm, n_j, bounds, levels, arg_cap, min_d2, seg,
          part);
    if (nseg > 1) launch_reduce<DD, ROW_RW>(rpart, n_i, nseg, out, s);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Receivers a block, sources a tile of the register-tiled design
// (hopper_nbody.ROW_BLOCK_RECEIVERS, ROW_SOURCE_TILE): rw * 65536 + tile.
extern "C" int nbody_row_force_geometry() { return ROW_RW * 65536 + ROW_TILE; }

// Blocks of row_tiled<mode, dim, masked> a SM holds at once (-1: none).
extern "C" int nbody_row_force_tiled_resident(int mode, int dim, int masked) {
  int blocks = -1;
  dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    auto k = masked ? &row_tiled<M, DD, true> : &row_tiled<M, DD, false>;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      ROW_THREADS, 0) !=
        cudaSuccess)
      blocks = -1;
  });
  return blocks;
}
