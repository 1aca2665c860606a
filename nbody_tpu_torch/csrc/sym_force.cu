// Newton's-third-law softened gravity on Hopper (sm_90a).
//
// Replaces: nbody_tpu/ops/pallas_nbody.py, _force_kernel_sym (the kernel
// body) and pallas_accelerations_sym (its wrapper), TPU kernel #1, with its
// equal-mass fast path (uniform_gm) and its fused max (emit_max). It
// computes what that kernel computes, each unordered pair's weight
// w = quantized |r|^-3 once, rows += G m_j w diff and reactions
// -= G m_i w diff, but not its block structure: the TPU kernel carries the
// reaction columns across a sequential grid, and Hopper's blocks run in no
// order.
//
// Design (simple and deterministic, no atomics):
//   * particles are cut into tiles of BT; one block of BT threads per
//     tile pair (I, J) with I <= J (blocks with I > J exit at once);
//   * an off-diagonal block computes w for its BT x BT pairs once, keeps
//     it in shared memory, writes tile I's row sums to part[I][J] (thread
//     per receiver row) and then tile J's reactions to part[J][I] (thread
//     per source column, reading the stored w);
//   * a diagonal block (I, I) computes full row sums into part[I][I],
//     skipping i == j when self_masked (zero or run-time softening);
//   * a launch given a skip flag and no fused max (the cached-bounds
//     scan's redo, skipped on most ticks) walks the T (T + 1) / 2 tile
//     pairs I <= J instead, with WALK_WAVES times as many blocks as the
//     card holds at once, each taking every grid-th pair: a skipped walk
//     reads the flag in a few thousand blocks, not in T * T. A walk that
//     runs is slower than one block per pair on the H100, the more so the
//     fewer its blocks, so no other launch walks; which block takes a pair
//     changes no bit;
//   * reduce_partials sums part[a][0..T-1] for every row in a fixed
//     order, so two runs give the same bits.
//   part holds 4 * D * T * T * BT bytes, T = ceil(N / BT): the scratch
//   that hopper_nbody.sym_force_scratch_bytes reckons and the "auto"
//   routing holds to a budget (the chunked path takes larger N).
//
// Two grids for an unflagged launch (no skip, count or fused max: the
// engine's tick), the same tile pairs, the same bits:
//   * the T x T grid (above), whose T (T - 1) / 2 blocks with I > J exit at
//     once: the earlier design, kept for the flagged and lab variants and
//     for large T;
//   * the triangular grid (`triangle`; sym_force_tri): one block per tile
//     pair I <= J. At N=5000 (T = 79) the 3081 empty blocks are ~10% of
//     the T x T grid's device time; at T in the thousands they cost
//     nothing and the triangle was up to 2% slower (PERF.md, PR 8).
//   Both are followed by reduce_partials; the wrapper picks the grid by a
//   fixed rule of T (hopper_nbody.sym_schedule): the triangle for
//   T <= 256 (N <= 16384), the T x T grid beyond.
// One launch with the reduction inside, the fixed order kept, was built
// and measured on the H100 and not kept (PERF.md, PR 8): the block that
// takes a tile's T-th integer ticket summed its rows, so every block
// fenced and took tickets, and the last tiles' sums (chains of T adds
// over loads from L2) finished after every tile pair; it was slower than
// the second launch at every N measured. A cooperative launch whose
// resident blocks walk the tile pairs and meet at one grid barrier, and
// w kept in shared memory 32 columns at a time (32 resident warps a SM
// instead of 24), were slower still.

// Equal masses (`uniform`, all G m equal; pallas_nbody.py:287-292): rows
// take sum_j w diff and reactions -sum_i w diff, the same product t = w
// diff on both sides with no G m loaded per pair; reduce_partials sums the
// partials in the same fixed order and then multiplies once by G m_0, read
// on the device from gm[0] (pallas_nbody.py:632-634). The wrapper serves
// it only when N is a multiple of BT (hopper_nbody.sym_force's full-tile
// rule, the counterpart of the TPU wrapper's degrade-on-padding).
//
// The equal-mass variant's one-pass design (nbody_sym_force_one_pass;
// csrc/one_pass.cuh), for an unflagged launch past T = 256 tiles, the
// engine's tick at N >= 16448, the chunked path's 1M chunks and the ring's
// diagonal. It replaces the same TPU kernel under uniform_gm
// (pallas_nbody.py:454 / _force_kernel_sym :260, its equal-mass body
// :287-292) and computes what it computes, in the TPU body's one pass.
// What bounds it on the H100: issue slots. The FP32 rate is one warp
// instruction a clock per SM sub-partition, so every shared load, shuffle
// and address computation costs a pair as much as an add; the function
// needs 15 fp32 ops a pair (21 int4) at D = 2, the int chain's accurate
// logf / expf take ~40 slots. The two-pass tile above held the design back
// three ways, and the one-pass design answers each:
//   1. two passes over every 64 x 64 tile: w stored to shared memory, then
//      reloaded with D positions to recompute the D subtracts and FMAs of
//      the reactions (~22 slots a pair float32 against 15). One pass forms
//      t = w diff once and adds it into the receiver's row sums and the
//      source's reaction partials in the same iteration (~16.6 slots);
//   2. few warps (64-thread blocks holding a 16.6 KB w tile; 24 resident
//      warps a SM, and the earlier one-pass lab kernel wideacc held 64
//      reaction partials a thread at 128 registers and 12 warps). Here
//      each lane holds 4 receivers (register tiling: one source load
//      serves 4 pairs, 4 independent chains) and only C = 8 source columns
//      of reaction partials (4 at D = 3), folded across the 32 lanes after
//      each batch by a reduce-scatter without selects (~1.1 slots a pair):
//      80 registers, 24 resident warps, no w tile, no spills;
//   3. partials that cross HBM twice: part (T, T, 64, D) is 2.15 GB at
//      131072. A block owns 256 receivers and walks 16 source tiles, so the
//      row partials shrink 16x and the reaction partials 4x (0.67 GB at
//      131072); sym_one_pass_reduce sums them in a fixed order.
// Which launch takes it: hopper_nbody.sym_design, by uniform_design's
// fixed rule of (T, mode, D): T > ONE_PASS_MIN_TILES (256, the triangle's
// edge) and the (mode family, D) in ONE_PASS_ROUTES; parent=True takes the
// T x T grid of the two-pass tile. The same body with G m per particle
// (one_pass.cuh's GM) serves the general launch under the same rule, and
// its EMIT flag the fused max of either kind: the T x T grid's two-pass
// tile for unequal masses held ~23% / 15% of its bound (float32 / int4)
// at 131072, and its fused max took four launches whose partials crossed
// HBM twice (2.15 GB at 131072, D = 2). Ragged N, launches with
// skip or count (the cached redo's walk), the fused max at T <= 256, walk
// and lab launches keep the two-pass tile, bit for bit.
//
// Fused max on the T x T grid (`tile_max` set; emit_max,
// pallas_nbody.py:294-303; past 256 tiles the one-pass design's EMIT
// instead): a variant built for the int modes only (the kernels without it
// carry no trace of it), whose every block also takes the max of the raw
// d^2 of the pairs it visits, formed op for op as max_dist_sq.cu forms it
// (diagonal tiles included: i == j gives 0, harmless since the max starts
// at 0), and stores it in tile_max[J (J + 1) / 2 + I]; max_stage and
// max_d2_reduce (max_reduce.cuh, max_dist_sq.cu's own reduction) fold the
// T (T + 1) / 2 values, so the result is bitwise max_d2's. The forces are
// the same bits with or without it. No pair is padded here, so the TPU
// wrapper's padding with duplicates of particle 0 has no counterpart.
//
// `skip` (nullable, on the device): when *skip != 0 every pass returns at
// once, out is zeros and the max 0, so a step can launch a redo
// unconditionally and let the device decide (the cached-bounds scan's
// lax.cond). `count` (nullable) gains 1 when the launch ran.
//
// Lab variants (nbody_sym_force_lab; tools/kernel_lab.py:51-171, equal
// masses, D = 2, float32 and int modes): SEED seeds the softening into the
// d^2 chain, (dx^2 + eps^2) + dy^2; U > 1 keeps U independent row (and
// reaction) accumulators per thread, pair k into accumulator k % U, joined
// in order at the end of the tile: the cross-pair instruction-level
// parallelism that the TPU kernel's 2- to 4-wide tile interleave buys.
// Variant 5 (tools/kernel_lab_r4.py:108-122, the r4 lab's knob A, int modes
// only) is the production equal-mass kernel with the base-2 chain
// (MODE_INT_B2, csrc/nbody_common.cuh); the r4 lab's other variants live in
// csrc/sym_force_lab.cu.
//
// Numerics: csrc/nbody_common.cuh.
//
// What bounds the two-pass tile on the H100: arithmetic, in issue slots.
// Each pair costs ~21 fp32 ops (~19 with equal masses; csrc counts, D = 2;
// the function itself needs 15 with equal masses) plus one rsqrt (float
// modes) or a logf + expf (int modes) against 8-12 bytes of
// shared-memory traffic; device memory sees only O(N) positions plus the
// part buffer (read once by the reduce).
// The BT x BT tile of w in shared memory (padded to BT+1 columns, so both
// phases are free of bank conflicts) lets the reaction pass reuse every w
// instead of recomputing the transcendental.

#include "max_reduce.cuh"
#include "nbody_common.cuh"
#include "one_pass.cuh"

namespace {

// Blocks of a walk per block the card holds at once (see the notes above).
constexpr int WALK_WAVES = 32;

// One tile pair (I, J), I <= J, by one block: row partials into
// part[I][J], reactions into part[J][I], the block's max into tile_max.
template <int MODE, int D, bool UNI, bool EMIT, bool SEED, int U>
__device__ __forceinline__ void sym_tile_pair(
    const float* __restrict__ pos, const float* __restrict__ gm,
    const float* __restrict__ bounds, int n, int T, int I, int J, int levels,
    float arg_cap, float min_d2, int self_masked, float* __restrict__ part,
    float* __restrict__ tile_max) {
  const int t = threadIdx.x;
  const int i0 = I * BT;
  const int j0 = J * BT;
  const int icnt = min(BT, n - i0);
  const int jcnt = min(BT, n - j0);

  __shared__ float xi_s[D][BT];
  __shared__ float xj_s[D][BT];
  __shared__ float gmi_s[BT];
  __shared__ float gmj_s[BT];
  __shared__ float w_s[BT][BT + 1];

  if (t < icnt) {
#pragma unroll
    for (int d = 0; d < D; ++d) xi_s[d][t] = pos[(size_t)(i0 + t) * D + d];
    if (!UNI) gmi_s[t] = gm[i0 + t];
  }
  if (t < jcnt) {
#pragma unroll
    for (int d = 0; d < D; ++d) xj_s[d][t] = pos[(size_t)(j0 + t) * D + d];
    if (!UNI) gmj_s[t] = gm[j0 + t];
  }

  const float soft = bounds[2];
  const IntGrid g = mode_grid<MODE>(bounds, levels, arg_cap, min_d2);
  __syncthreads();

  const bool diag = (I == J);
  float acc[U][D];
#pragma unroll
  for (int k = 0; k < U; ++k)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[k][d] = 0.f;
  float best = 0.f;
  if (t < icnt) {
    float xi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = xi_s[d][t];
    // Pair (t, j) into the accumulator a.
    auto row_pair = [&](int j, float(&a)[D]) {
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj_s[d][j], xi[d]);
      float d2;
      if constexpr (SEED) {
        d2 = __fadd_rn(__fmul_rn(dx[0], dx[0]), soft);
#pragma unroll
        for (int d = 1; d < D; ++d)
          d2 = __fadd_rn(d2, __fmul_rn(dx[d], dx[d]));
      } else {
        const float r2 = raw_d2<D>(dx);
        if constexpr (EMIT) best = fmaxf(best, r2);
        d2 = __fadd_rn(r2, soft);
      }
      const float w = pair_w<MODE>(d2, g);
      if (diag) {
        if (self_masked && j == t) return;
      } else {
        w_s[t][j] = w;
      }
      const float fr = UNI ? w : __fmul_rn(gmj_s[j], w);
#pragma unroll
      for (int d = 0; d < D; ++d) a[d] = fmaf(fr, dx[d], a[d]);
    };
    if constexpr (U == 1) {
      for (int j = 0; j < jcnt; ++j) row_pair(j, acc[0]);
    } else {
      for (int jb = 0; jb < jcnt; jb += U) {
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (jb + k < jcnt) row_pair(jb + k, acc[k]);
      }
    }
  }
  float* out_row = part + (((size_t)I * T + J) * BT + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = acc[0][d];
#pragma unroll
    for (int k = 1; k < U; ++k) s = __fadd_rn(s, acc[k][d]);
    out_row[d] = s;
  }
  if constexpr (EMIT) store_block_max<BT>(best, tile_max + tri_index(I, J));
  if (diag) return;  // block-uniform

  __syncthreads();
  // Reactions on tile J: -(sum_i G m_i w_ij diff_ij), from the stored w.
#pragma unroll
  for (int k = 0; k < U; ++k)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[k][d] = 0.f;
  if (t < jcnt) {
    float xj[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xj[d] = xj_s[d][t];
    // Pair (i, t)'s reaction into the accumulator a.
    auto col_pair = [&](int i, float(&a)[D]) {
      const float fc = UNI ? w_s[i][t] : __fmul_rn(gmi_s[i], w_s[i][t]);
#pragma unroll
      for (int d = 0; d < D; ++d)
        a[d] = fmaf(fc, __fsub_rn(xj[d], xi_s[d][i]), a[d]);
    };
    if constexpr (U == 1) {
      for (int i = 0; i < icnt; ++i) col_pair(i, acc[0]);
    } else {
      for (int ib = 0; ib < icnt; ib += U) {
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (ib + k < icnt) col_pair(ib + k, acc[k]);
      }
    }
  }
  float* out_col = part + (((size_t)J * T + I) * BT + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = acc[0][d];
#pragma unroll
    for (int k = 1; k < U; ++k) s = __fadd_rn(s, acc[k][d]);
    out_col[d] = -s;
  }
}

template <int MODE, int D, bool UNI, bool EMIT, bool SEED, int U>
__global__ void __launch_bounds__(BT)
sym_force_tiles(const float* __restrict__ pos, const float* __restrict__ gm,
                const float* __restrict__ bounds, int n, int levels,
                float arg_cap, float min_d2, int self_masked,
                const int* __restrict__ skip, float* __restrict__ part,
                float* __restrict__ tile_max) {
  const int I = blockIdx.y;
  const int J = blockIdx.x;
  if (I > J) return;
  if (skip != nullptr && *skip != 0) return;
  sym_tile_pair<MODE, D, UNI, EMIT, SEED, U>(pos, gm, bounds, n, gridDim.x, I,
                                             J, levels, arg_cap, min_d2,
                                             self_masked, part, tile_max);
}

// The tiles of the triangular grid: block k takes the k-th tile pair
// I <= J (tri_tile, column by column), each sym_tile_pair as in the T x T
// grid (the same partials); no block exits at once.
template <int MODE, int D, bool UNI>
__global__ void __launch_bounds__(BT)
sym_force_tri(const float* __restrict__ pos, const float* __restrict__ gm,
              const float* __restrict__ bounds, int n, int T, int levels,
              float arg_cap, float min_d2, int self_masked,
              float* __restrict__ part) {
  int I, J;
  tri_tile(blockIdx.x, I, J);
  sym_tile_pair<MODE, D, UNI, false, false, 1>(pos, gm, bounds, n, T, I, J,
                                               levels, arg_cap, min_d2,
                                               self_masked, part, nullptr);
}

// The walk over tile pairs k = blockIdx.x, blockIdx.x + gridDim.x, ...
template <int MODE, int D, bool UNI>
__global__ void __launch_bounds__(BT)
sym_force_walk(const float* __restrict__ pos, const float* __restrict__ gm,
               const float* __restrict__ bounds, int n, int T, int levels,
               float arg_cap, float min_d2, int self_masked,
               const int* __restrict__ skip, float* __restrict__ part) {
  if (*skip != 0) return;
  const long long pairs = tri_index(0, T);
  for (long long k = blockIdx.x; k < pairs; k += gridDim.x) {
    int I, J;
    tri_tile(k, I, J);
    sym_tile_pair<MODE, D, UNI, false, false, 1>(pos, gm, bounds, n, T, I, J,
                                                 levels, arg_cap, min_d2,
                                                 self_masked, part, nullptr);
    __syncthreads();  // this pair's readers are done with shared memory
  }
}

template <int M, int D, bool UNI, bool EMIT, bool SEED, int U>
void launch_sym(const float* pos, const float* gm, const float* bounds, int n,
                int T, int levels, float arg_cap, float min_d2,
                int self_masked, const int* skip, int* count, float* part,
                float* tile_max, float* out, cudaStream_t s) {
  sym_force_tiles<M, D, UNI, EMIT, SEED, U><<<dim3(T, T), BT, 0, s>>>(
      pos, gm, bounds, n, levels, arg_cap, min_d2, self_masked, skip, part,
      tile_max);
  launch_reduce<D>(part, n, T, out, s, UNI ? gm : nullptr, skip, count);
}

template <int M, int D, bool UNI>
void launch_tri(const float* pos, const float* gm, const float* bounds, int n,
                int T, int levels, float arg_cap, float min_d2,
                int self_masked, float* part, float* out, cudaStream_t s) {
  const long long pairs = (long long)T * (T + 1) / 2;
  sym_force_tri<M, D, UNI><<<(unsigned)pairs, BT, 0, s>>>(
      pos, gm, bounds, n, T, levels, arg_cap, min_d2, self_masked, part);
  launch_reduce<D>(part, n, T, out, s, UNI ? gm : nullptr);
}

template <int M, int D, bool UNI>
void launch_walk(const float* pos, const float* gm, const float* bounds, int n,
                 int T, int levels, float arg_cap, float min_d2,
                 int self_masked, const int* skip, int* count, float* part,
                 float* out, cudaStream_t s) {
  static int per_sm = 0;  // resident blocks per SM, queried once
  auto kernel = sym_force_walk<M, D, UNI>;
  if (per_sm <= 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BT, 0) !=
          cudaSuccess)
    per_sm = 1;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long pairs = (long long)T * (T + 1) / 2;
  const long long cap = (long long)WALK_WAVES * (per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<(int)(pairs < cap ? pairs : cap), BT, 0, s>>>(
      pos, gm, bounds, n, T, levels, arg_cap, min_d2, self_masked, skip,
      part);
  launch_reduce<D>(part, n, T, out, s, UNI ? gm : nullptr, skip, count);
}

}  // namespace

extern "C" int nbody_sym_force_tile() { return BT; }

// Blocks of one kernel instance that a SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): the T x T grid's
// sym_force_tiles, or with `triangle` sym_force_tri; -1 for an instance
// that does not exist.
extern "C" int nbody_sym_force_resident(int mode, int dim, int uniform,
                                        int triangle) {
  int blocks = -1;
  dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    auto query = [&](auto kernel) {
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BT,
                                                        0) != cudaSuccess)
        blocks = -1;
    };
    auto by_uni = [&](auto uni) {
      constexpr bool U = decltype(uni)::value;
      if (triangle)
        query(sym_force_tri<M, DD, U>);
      else
        query(sym_force_tiles<M, DD, U, false, false, 1>);
    };
    if (uniform)
      by_uni(std::true_type{});
    else
      by_uni(std::false_type{});
  });
  return blocks;
}

// pos (n, dim) f32, gm (n,) f32 = G * m, bounds (3,) f32 = [log_lo,
// log_hi, eps^2] on the device; uniform != 0 asserts all gm equal (the
// result is scaled by gm[0]); skip, count: nullable device ints; part
// (T, T, BT, dim) f32 scratch with T = ceil(n / BT); out (n, dim) f32.
// Fused max: tile_max (T (T + 1) / 2 floats) and block_max (`capacity`
// floats) scratch and max_out (one float, the raw max d^2), all null for
// none. A skip flag without the fused max takes the walk. `triangle`
// takes the triangular grid: only for a launch with no skip, count or
// fused max. Returns cudaGetLastError().
extern "C" int nbody_sym_force(const float* pos, const float* gm,
                               const float* bounds, int n, int dim, int mode,
                               int levels, float arg_cap, float min_d2,
                               int self_masked, int uniform, const int* skip,
                               int* count, float* part, float* tile_max,
                               float* block_max, int capacity, float* max_out,
                               int triangle, float* out, void* stream) {
  const int T = (n + BT - 1) / BT;
  if (n <= 0 || T > 65535) return (int)cudaErrorInvalidValue;
  if (tile_max != nullptr && (mode != MODE_INT || block_max == nullptr ||
                              max_out == nullptr || capacity <= 0))
    return (int)cudaErrorInvalidValue;
  if (triangle &&
      (skip != nullptr || count != nullptr || tile_max != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    if (triangle) {
      if (uniform)
        launch_tri<M, DD, true>(pos, gm, bounds, n, T, levels, arg_cap,
                                min_d2, self_masked, part, out, s);
      else
        launch_tri<M, DD, false>(pos, gm, bounds, n, T, levels, arg_cap,
                                 min_d2, self_masked, part, out, s);
      return;
    }
    auto run = [&](auto uni, auto emit) {
      launch_sym<M, DD, decltype(uni)::value, decltype(emit)::value, false,
                 1>(pos, gm, bounds, n, T, levels, arg_cap, min_d2,
                    self_masked, skip, count, part, tile_max, out, s);
    };
    if constexpr (M == MODE_INT) {
      if (tile_max != nullptr) {
        if (uniform)
          run(std::true_type{}, std::true_type{});
        else
          run(std::false_type{}, std::true_type{});
        return;
      }
    }
    if (skip != nullptr) {
      auto walk = [&](auto uni) {
        launch_walk<M, DD, decltype(uni)::value>(
            pos, gm, bounds, n, T, levels, arg_cap, min_d2, self_masked, skip,
            count, part, out, s);
      };
      if (uniform)
        walk(std::true_type{});
      else
        walk(std::false_type{});
      return;
    }
    if (uniform)
      run(std::true_type{}, std::false_type{});
    else
      run(std::false_type{}, std::false_type{});
  });
  if (!known) return (int)cudaErrorInvalidValue;
  if (tile_max != nullptr) {
    const long long tiles = (long long)T * (T + 1) / 2;
    const int nb = (int)(tiles < capacity ? tiles : capacity);
    max_stage<<<nb, MAX_RT, 0, s>>>(tile_max, tiles, skip, block_max);
    max_d2_reduce<<<1, MAX_RT, 0, s>>>(block_max, nb, skip, nullptr,
                                       max_out);
  }
  return (int)cudaGetLastError();
}

// The lab variants of the equal-mass kernel, D = 2 only: variant 1 seeds
// the softening into the d^2 chain, variant u in {2, 3, 4} keeps u row
// accumulators per thread, variant 5 takes the base-2 int chain (an int
// mode only; arg_cap comes folded by log2(e)). mode is float32 (0) or an
// int mode (3); the other arguments as nbody_sym_force's (no skip, count
// or fused max).
extern "C" int nbody_sym_force_lab(const float* pos, const float* gm,
                                   const float* bounds, int n, int mode,
                                   int levels, float arg_cap, float min_d2,
                                   int self_masked, int variant, float* part,
                                   float* out, void* stream) {
  const int T = (n + BT - 1) / BT;
  if (n <= 0 || T > 65535 || (mode != MODE_F32 && mode != MODE_INT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto m) {
    constexpr int M = decltype(m)::value;
    switch (variant) {
      case 1:
        launch_sym<M, 2, true, false, true, 1>(pos, gm, bounds, n, T, levels,
                                        arg_cap, min_d2, self_masked, nullptr,
                                        nullptr, part, nullptr, out, s);
        return true;
      case 2:
        launch_sym<M, 2, true, false, false, 2>(pos, gm, bounds, n, T, levels,
                                         arg_cap, min_d2, self_masked,
                                         nullptr, nullptr, part, nullptr, out,
                                         s);
        return true;
      case 3:
        launch_sym<M, 2, true, false, false, 3>(pos, gm, bounds, n, T, levels,
                                         arg_cap, min_d2, self_masked,
                                         nullptr, nullptr, part, nullptr, out,
                                         s);
        return true;
      case 4:
        launch_sym<M, 2, true, false, false, 4>(pos, gm, bounds, n, T, levels,
                                         arg_cap, min_d2, self_masked,
                                         nullptr, nullptr, part, nullptr, out,
                                         s);
        return true;
      case 5:
        if constexpr (M == MODE_INT) {
          launch_sym<MODE_INT_B2, 2, true, false, false, 1>(
              pos, gm, bounds, n, T, levels, arg_cap, min_d2, self_masked,
              nullptr, nullptr, part, nullptr, out, s);
          return true;
        }
        return false;
      default:
        return false;
    }
  };
  const bool known = mode == MODE_F32 ? run(Const<MODE_F32>{})
                                      : run(Const<MODE_INT>{});
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The one-pass design (csrc/one_pass.cuh) of an unflagged launch or one
// with the fused max alone: pos (n, dim) f32 with n a multiple of BT, gm
// (n,) f32 (uniform != 0: only gm[0] is read, on the device, the sums
// scaled by it; uniform == 0: every G m read in the pairs, nothing
// scaled), bounds (3,) f32 = [log_lo, log_hi, eps^2]; seg >= 1 source
// tiles a block; scratch rpart (TI, nsegmax, OP_RW, dim) and cpart (T, TI,
// BT, dim) f32 with T = n / BT, TI = ceil(T / OP_SUB), nsegmax =
// ceil(T / seg); out (n, dim) f32. The fused max (int mode only): max_out
// (one float, the raw max d^2), block_max (TI nsegmax floats) and ticket
// (one device int, 0, left 0: max_d2's, so the launches share a stream),
// all null for none. Two launches: the body and its reduction. Returns
// cudaGetLastError().
extern "C" int nbody_sym_force_one_pass(const float* pos, const float* gm,
                                        const float* bounds, int n, int dim,
                                        int mode, int levels, float arg_cap,
                                        float min_d2, int self_masked,
                                        int uniform, int seg, float* rpart,
                                        float* cpart, float* block_max,
                                        int* ticket, float* max_out,
                                        float* out, void* stream) {
  if (n <= 0 || n % BT != 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  const bool fused = max_out != nullptr;
  if (fused && (mode != MODE_INT || block_max == nullptr || ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  const int T = n / BT;
  const int TI = (T + OP_SUB - 1) / OP_SUB;
  const int nsegmax = (T + seg - 1) / seg;
  if (TI > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nsegmax, TI);
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    auto run = [&](auto gm_flag, auto emit) {
      sym_one_pass<M, DD, decltype(gm_flag)::value, decltype(emit)::value>
          <<<grid, OP_THREADS, 0, s>>>(pos, gm, bounds, n, levels, arg_cap,
                                       min_d2, self_masked, seg, rpart, cpart,
                                       block_max, ticket, max_out);
    };
    auto by_gm = [&](auto emit) {
      if (uniform)
        run(std::false_type{}, emit);
      else
        run(std::true_type{}, emit);
    };
    if constexpr (M == MODE_INT) {
      if (fused)
        by_gm(std::true_type{});
      else
        by_gm(std::false_type{});
    } else {
      by_gm(std::false_type{});
    }
    sym_one_pass_reduce<DD><<<(n + 255) / 256, 256, 0, s>>>(
        rpart, cpart, n, TI, nsegmax, seg, uniform ? gm : nullptr, out);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Receivers a block of the one-pass design (hopper_nbody.ONE_PASS_RECEIVERS).
extern "C" int nbody_one_pass_receivers() { return OP_RW; }

// Blocks of sym_one_pass<mode, dim, !uniform, fused> a SM holds at once
// (-1: no instance; the fused max exists for the int mode only).
extern "C" int nbody_sym_force_one_pass_resident(int mode, int dim,
                                                 int uniform, int fused) {
  int blocks = -1;
  dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    auto query = [&](auto gm_flag, auto emit) {
      blocks = op_resident(sym_one_pass<M, DD, decltype(gm_flag)::value,
                                        decltype(emit)::value>);
    };
    auto by_gm = [&](auto emit) {
      if (uniform)
        query(std::false_type{}, emit);
      else
        query(std::true_type{}, emit);
    };
    if (!fused)
      by_gm(std::false_type{});
    else if constexpr (M == MODE_INT)
      by_gm(std::true_type{});
  });
  return blocks;
}
