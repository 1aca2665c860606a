// Newton's-third-law pair forces between two disjoint particle sets on
// Hopper (sm_90a).
//
// Replaces: nbody_tpu/ops/pallas_nbody.py, _pair_force_sym_kernel (the
// kernel body) and pallas_pair_force_sym (its wrapper), TPU kernel #6, with
// its equal-mass fast path (uniform_gm):
// receivers A and sources B; each pair's w = quantized |r|^-3 is
// evaluated once and gives both
//   rows[i] =  sum_j G m_j w_ij (x_j - x_i)   (A's accelerations due to B)
//   cols[j] = -sum_i G m_i w_ij (x_j - x_i)   (B's reactions due to A).
// The TPU kernel keeps the reaction columns in a VMEM buffer revisited by
// a sequential grid; Hopper's blocks run in no order.
//
// Design (deterministic, no atomics), on tiles of BT particles:
//   * a block of BT threads owns receiver tile I and a segment of up to
//     seg_tiles consecutive source tiles J; per source tile it computes
//     the BT x BT w once into shared memory, accumulates the rows in
//     registers (thread per receiver, j ascending), then the reactions
//     of tile J from the stored w (thread per source, i ascending) and
//     writes them to cpart[J][I];
//   * after its segment the block writes its row sums to rpart[I][S];
//   * reduce_partials sums rpart[I][0..nseg-1] and cpart[J][0..Ta-1] in a
//     fixed order, so two runs give the same bits.
//   Ragged tails of either set are handled by counts: no padded pairs.
//   Scratch: rpart (Ta, nseg, BT, D) and cpart (Tb, Ta, BT, D) f32, with
//   Ta = ceil(na / BT), Tb = ceil(nb / BT), nseg = ceil(Tb / seg_tiles)
//   (hopper_nbody.pair_sym_force_scratch_bytes). Segments keep tens of
//   thousands of blocks in flight at the chunk sizes of the chunked path,
//   so no wave of blocks runs mostly idle.
//
// Equal masses (`uniform`; pallas_nbody.py:974-978, :1022-1031): rows and
// reactions reduce the same product t = w diff with no G m loaded per pair;
// reduce_partials scales the rows once by G m_b[0] and the reactions by
// G m_a[0], read on the device (pallas_nbody.py:1160-1161). The wrapper
// serves it only when both set sizes are multiples of BT (the full-tile
// rule, the counterpart of the TPU wrapper's degrade-on-padding).
//
// The equal-mass variant's one-pass design (nbody_pair_sym_force_one_pass;
// csrc/one_pass.cuh), for the chunked path's chunk pairs and the ring's
// pair tiles past 256 receiver tiles. It replaces the same TPU kernel under
// uniform_gm (pallas_nbody.py:1066 / _pair_force_sym_kernel :956, its
// equal-mass body :1022-1031) and computes what it computes, in that body's
// one pass. What bounds it on the H100: issue slots (one warp instruction a
// clock per SM sub-partition, the FP32 rate); the function needs 15 fp32
// ops a pair (21 int4) at D = 2. The tile above held it back three ways:
//   1. two passes: w stored to shared memory, then the reaction pass
//      reloads it with D positions and recomputes D subtracts and FMAs.
//      One pass forms t = w diff once and adds it into the row sums and the
//      reaction partials in the same iteration;
//   2. few warps (a 16.6 KB w tile a 64-thread block). Each lane holds 4
//      receivers and C = 8 (D = 3: 4) source columns of reaction partials,
//      folded across the warp after each batch by a reduce-scatter without
//      selects: 80 registers, 24 resident warps a SM, no w tile;
//   3. partials through HBM twice: cpart (Tb, Ta, 64, D) is 5.5 GB at
//      209728^2. A block owns 256 receivers and walks 16 source tiles:
//      reaction partials (Tb, TI, 64, D), TI = ceil(Ta / 4), 4x smaller,
//      stored negated so that reduce_partials sums both as above.
// Which launch takes it: hopper_nbody.uniform_design of the receiver tiles
// (T > 256) and (mode family, D); parent=True takes the tile above. A
// ragged last receiver tile (Ta not a multiple of 4: 209728 is 3277 tiles)
// skips its rows past na, so every multiple of BT is served.
//
// The general function in the same one-pass design (nbody_pair_sym_force_
// one_pass with uniform = 0; pair_one_pass<MODE, D, true>): it replaces
// the TPU kernel's general branch (pallas_nbody.py:1032-1039, fr = G m_j w
// on the rows and fc = G m_i w on the reactions) and computes what that
// branch computes. Each source's G m rides in its staged float4 and each
// lane holds its receivers' G m_i, so a pair costs 2 multiplies and 2 D
// FMAs on top of d^2 and w: 19 fp32 ops a pair at D = 2 float32
// (pair_ops "sym_gm"), against ~21 plus the w tile's store and reload on
// the two-pass tile below. No scale in the reduction. The same rule routes
// it (hopper_nbody.pair_design, uniform or not): both sets multiples of
// BT, more than 256 receiver tiles and (mode family, D) in ONE_PASS_ROUTES;
// ragged or phantom sets (the ring's 131075) keep the two-pass tile, and
// parent=True reaches it.
//
// Requires eps^2 > 0 (bounds[2]), as the TPU kernel does: the sets are
// disjoint, so no pair is masked, and a coincident pair at zero softening
// would be 0 * inf. The chunked path routes zero and run-time softening to
// the row sweep.
//
// Numerics: csrc/nbody_common.cuh.
//
// What bounds the two-pass tile on the H100: arithmetic, as the sym
// kernel: ~21 fp32 ops (~19 with equal masses, against the function's own
// 15; csrc counts, D = 2) plus one rsqrt or logf + expf per pair, na * nb
// pairs, against O(na + nb) positions and 4 * D * BT bytes of partials per
// block and source tile.

#include "nbody_common.cuh"
#include "one_pass.cuh"

namespace {

template <int MODE, int D, bool UNI>
__global__ void __launch_bounds__(BT)
pair_sym_tiles(const float* __restrict__ pa, const float* __restrict__ gma,
               int na, const float* __restrict__ pb,
               const float* __restrict__ gmb, int nb,
               const float* __restrict__ bounds, int levels, float arg_cap,
               float min_d2, int seg_tiles, float* __restrict__ rpart,
               float* __restrict__ cpart) {
  const int S = blockIdx.x;  // segment of source tiles
  const int I = blockIdx.y;  // receiver tile
  const int nseg = gridDim.x;
  const int Ta = gridDim.y;
  const int Tb = (nb + BT - 1) / BT;
  const int t = threadIdx.x;
  const int i0 = I * BT;
  const int icnt = min(BT, na - i0);

  __shared__ float xi_s[D][BT];
  __shared__ float xj_s[D][BT];
  __shared__ float gmi_s[BT];
  __shared__ float gmj_s[BT];
  __shared__ float w_s[BT][BT + 1];

  if (t < icnt) {
#pragma unroll
    for (int d = 0; d < D; ++d) xi_s[d][t] = pa[(size_t)(i0 + t) * D + d];
    if (!UNI) gmi_s[t] = gma[i0 + t];
  }
  const float soft = bounds[2];
  IntGrid g{};
  if (MODE == MODE_INT) g = int_grid(bounds, levels, arg_cap, min_d2);

  float row[D];
#pragma unroll
  for (int d = 0; d < D; ++d) row[d] = 0.f;
  const int J_end = min(Tb, (S + 1) * seg_tiles);
  for (int J = S * seg_tiles; J < J_end; ++J) {
    const int j0 = J * BT;
    const int jcnt = min(BT, nb - j0);
    __syncthreads();  // the previous tile's readers are done with xj_s, w_s
    if (t < jcnt) {
#pragma unroll
      for (int d = 0; d < D; ++d) xj_s[d][t] = pb[(size_t)(j0 + t) * D + d];
      if (!UNI) gmj_s[t] = gmb[j0 + t];
    }
    __syncthreads();
    if (t < icnt) {
      float xi[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xi[d] = xi_s[d][t];
      for (int j = 0; j < jcnt; ++j) {
        float dx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj_s[d][j], xi[d]);
        const float w = pair_w<MODE>(__fadd_rn(raw_d2<D>(dx), soft), g);
        w_s[t][j] = w;
        const float fr = UNI ? w : __fmul_rn(gmj_s[j], w);
#pragma unroll
        for (int d = 0; d < D; ++d) row[d] = fmaf(fr, dx[d], row[d]);
      }
    }
    __syncthreads();
    // Reactions on tile J: -(sum_i G m_i w_ij diff_ij), from the stored w.
    float col[D];
#pragma unroll
    for (int d = 0; d < D; ++d) col[d] = 0.f;
    if (t < jcnt) {
      float xj[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xj[d] = xj_s[d][t];
      for (int i = 0; i < icnt; ++i) {
        const float fc = UNI ? w_s[i][t] : __fmul_rn(gmi_s[i], w_s[i][t]);
#pragma unroll
        for (int d = 0; d < D; ++d)
          col[d] = fmaf(fc, __fsub_rn(xj[d], xi_s[d][i]), col[d]);
      }
    }
    float* out_col = cpart + (((size_t)J * Ta + I) * BT + t) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) out_col[d] = -col[d];
  }
  float* out_row = rpart + (((size_t)I * nseg + S) * BT + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out_row[d] = row[d];
}

}  // namespace

// pa (na, dim), gma (na,), pb (nb, dim), gmb (nb,) f32 with gm = G * m;
// uniform != 0 asserts each set's gm equal (rows scaled by gmb[0], cols by
// gma[0]); bounds (3,) f32 = [log_lo, log_hi, eps^2]; seg_tiles >= 1; scratch
// rpart (Ta, nseg, BT, dim) and cpart (Tb, Ta, BT, dim) f32 as in the
// header comment; rows (na, dim), cols (nb, dim) f32. All on the device.
// Returns cudaGetLastError().
extern "C" int nbody_pair_sym_force(const float* pa, const float* gma, int na,
                                    const float* pb, const float* gmb, int nb,
                                    const float* bounds, int dim, int mode,
                                    int levels, float arg_cap, float min_d2,
                                    int uniform, int seg_tiles, float* rpart,
                                    float* cpart,
                                    float* rows, float* cols, void* stream) {
  if (na <= 0 || nb <= 0 || seg_tiles <= 0) return (int)cudaErrorInvalidValue;
  const int Ta = (na + BT - 1) / BT;
  const int Tb = (nb + BT - 1) / BT;
  const int nseg = (Tb + seg_tiles - 1) / seg_tiles;
  if (Ta > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    if (uniform)
      pair_sym_tiles<M, DD, true><<<dim3(nseg, Ta), BT, 0, s>>>(
          pa, gma, na, pb, gmb, nb, bounds, levels, arg_cap, min_d2,
          seg_tiles, rpart, cpart);
    else
      pair_sym_tiles<M, DD, false><<<dim3(nseg, Ta), BT, 0, s>>>(
          pa, gma, na, pb, gmb, nb, bounds, levels, arg_cap, min_d2,
          seg_tiles, rpart, cpart);
    launch_reduce<DD>(rpart, na, nseg, rows, s, uniform ? gmb : nullptr);
    launch_reduce<DD>(cpart, nb, Ta, cols, s, uniform ? gma : nullptr);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The one-pass design (csrc/one_pass.cuh): na and nb multiples of BT;
// uniform != 0 is the equal-mass variant (gma, gmb read at [0] only: rows
// scaled by gmb[0], reactions by gma[0]), uniform == 0 the general function
// (every G m read, nothing scaled); seg >= 1 source tiles a block; scratch
// rpart (TI, nseg, OP_RW, dim) and cpart (Tb, TI, BT, dim) f32 with
// Ta = na / BT, Tb = nb / BT, TI = ceil(Ta / OP_SUB), nseg = ceil(Tb / seg);
// rows (na, dim), cols (nb, dim) f32. Returns cudaGetLastError().
extern "C" int nbody_pair_sym_force_one_pass(
    const float* pa, const float* gma, int na, const float* pb,
    const float* gmb, int nb, const float* bounds, int dim, int mode,
    int levels, float arg_cap, float min_d2, int uniform, int seg,
    float* rpart, float* cpart, float* rows, float* cols, void* stream) {
  if (na <= 0 || nb <= 0 || na % BT != 0 || nb % BT != 0 || seg <= 0)
    return (int)cudaErrorInvalidValue;
  const int TI = (na / BT + OP_SUB - 1) / OP_SUB;
  const int nseg = (nb / BT + seg - 1) / seg;
  if (TI > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    const dim3 grid(nseg, TI);
    if (uniform)
      pair_one_pass<M, DD, false><<<grid, OP_THREADS, 0, s>>>(
          pa, gma, na, pb, gmb, nb, bounds, levels, arg_cap, min_d2, seg,
          rpart, cpart);
    else
      pair_one_pass<M, DD, true><<<grid, OP_THREADS, 0, s>>>(
          pa, gma, na, pb, gmb, nb, bounds, levels, arg_cap, min_d2, seg,
          rpart, cpart);
    launch_reduce<DD, OP_RW>(rpart, na, nseg, rows, s,
                             uniform ? gmb : nullptr);
    launch_reduce<DD>(cpart, nb, TI, cols, s, uniform ? gma : nullptr);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Blocks of pair_one_pass<mode, dim, !uniform> a SM holds at once (-1: no
// instance).
extern "C" int nbody_pair_sym_force_one_pass_resident(int mode, int dim,
                                                      int uniform) {
  int blocks = -1;
  dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    blocks = uniform ? op_resident(pair_one_pass<M, DD, false>)
                     : op_resident(pair_one_pass<M, DD, true>);
  });
  return blocks;
}
