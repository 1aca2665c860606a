// The round-4 lab's variants of the equal-mass sym kernel on Hopper
// (sm_90a): register tiling and the one-pass wide accumulator.
//
// Replaces: tools/kernel_lab_r4.py, _force_kernel_r4 (the kernel body) and
// accelerations_r4 (its wrapper), knobs B and D; knob A is variant 5 of
// nbody_sym_force_lab (csrc/sym_force.cu) and knob C is its variant 2
// (wide2). Each computes what csrc/sym_force.cu's equal-mass variant
// computes: rows take sum_j w diff and reactions -sum_i w diff, the same
// t = w diff on both sides, per-tile partials summed by reduce_partials in
// a fixed order and scaled once by G m_0 read from gm[0] on the device. D =
// 2 only, no padding: N a multiple of the tile side (the wrapper raises
// otherwise), no atomics, so two runs give the same bits.
//
// rt<R> (knob B, tools/kernel_lab_r4.py:432-438: 384-row blocks for a 3-wide
// interleave; on Hopper, register tiling): square tiles of side S = 64 R,
// one block of 64 threads per tile pair (I, J), I <= J. Thread t owns the
// receivers t, t + 64, ..., so each source coordinate read from shared
// memory serves R pairs, with R independent row chains. w goes to shared
// memory one 64-column slab at a time, the row pass and the reaction pass
// (thread t takes the slab's column t over all S rows) alternating per
// slab, so shared memory grows with R and not R^2: (4 S + 65 S) floats,
// 35 KB at R = 2 and 53 KB at R = 3 (dynamic, past the 48 KB default).
// Part scratch (T', T', S, 2), T' = N / S.
//
// wideacc<MODE> (knob D, tools/kernel_lab_r4.py:149-193: an elementwise
// (BI, BJ) accumulator with one cross-lane reduction in the epilogue; on
// Hopper, one pass and no w in shared memory): tiles of 64, one block of
// 64 threads per tile pair. Thread t owns receiver t, walks the 64 sources
// of tile J once (fully unrolled), adds each t = w diff to its row sums and
// keeps it in a register array of reaction partials colp[64][2]. At the end
// of the tile one block reduction writes the reactions, in a fixed order:
// within each warp a reduce-scatter by halving (five __shfl_xor_sync
// rounds, 124 shuffles a thread, after which lane l holds the warp's sums
// of entries 4 l .. 4 l + 3), then the two warps in order through shared
// memory. Instances: float32, MODE_INT and the base-2 chain
// MODE_INT_B2 (knob A + D, tools/kernel_lab_r4.py:443-444).
//
// Numerics: csrc/nbody_common.cuh (subtract-form d^2 with __fadd_rn /
// __fmul_rn, accurate logf / expf or log2f / exp2f, rintf).
//
// What bounds it: arithmetic, as csrc/sym_force.cu (~19 fp32 ops a pair
// float32, ~25 int, plus the shared-memory traffic of w). Register tiling
// cuts the source loads of the row pass by R and adds R-way ILP, at the
// price of occupancy (64-thread blocks with 35-53 KB of shared memory);
// wideacc drops the w store, the reaction pass and its loads (~15 ops a
// pair float32) but holds 128 partials in registers (expect spills) and
// pays ~2 shuffles a pair in its epilogue.

#include "nbody_common.cuh"

namespace {

// One tile pair (I, J) of side S = BT R by BT threads.
template <int MODE, int R>
__global__ void __launch_bounds__(BT)
sym_force_rt(const float* __restrict__ pos, const float* __restrict__ bounds,
             int levels, float arg_cap, float min_d2, int self_masked,
             float* __restrict__ part) {
  constexpr int S = BT * R;
  const int I = blockIdx.y;
  const int J = blockIdx.x;
  if (I > J) return;
  const int T = gridDim.x;
  const int t = threadIdx.x;

  extern __shared__ float smem[];
  float* xi_s = smem;          // [2][S]
  float* xj_s = smem + 2 * S;  // [2][S]
  float* w_s = smem + 4 * S;   // [S][BT + 1]: one 64-column slab of w
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = t + BT * r;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      xi_s[d * S + k] = pos[((size_t)I * S + k) * 2 + d];
      xj_s[d * S + k] = pos[((size_t)J * S + k) * 2 + d];
    }
  }
  const float soft = bounds[2];
  const IntGrid g = mode_grid<MODE>(bounds, levels, arg_cap, min_d2);
  __syncthreads();

  float xi[R][2], acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      xi[r][d] = xi_s[d * S + t + BT * r];
      acc[r][d] = 0.f;
    }
  // Pair (t + BT r, j): its w, accumulated into row r.
  auto row_pair = [&](int r, int j, float xj0, float xj1) {
    const float dx[2] = {__fsub_rn(xj0, xi[r][0]), __fsub_rn(xj1, xi[r][1])};
    const float w = pair_w<MODE>(__fadd_rn(raw_d2<2>(dx), soft), g);
#pragma unroll
    for (int d = 0; d < 2; ++d) acc[r][d] = fmaf(w, dx[d], acc[r][d]);
    return w;
  };

  if (I == J) {  // block-uniform: full row sums, no reactions
    for (int j = 0; j < S; ++j) {
      const float xj0 = xj_s[j], xj1 = xj_s[S + j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (self_masked && j == t + BT * r) continue;
        row_pair(r, j, xj0, xj1);
      }
    }
  } else {
    for (int c = 0; c < R; ++c) {  // slab c: columns c BT .. c BT + 63
      for (int jj = 0; jj < BT; ++jj) {
        const int j = c * BT + jj;
        const float xj0 = xj_s[j], xj1 = xj_s[S + j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          w_s[(t + BT * r) * (BT + 1) + jj] = row_pair(r, j, xj0, xj1);
      }
      __syncthreads();
      // Reactions on column c BT + t: -(sum_i w_ij diff_ij) over all S rows.
      const int j = c * BT + t;
      const float xj0 = xj_s[j], xj1 = xj_s[S + j];
      float ca0 = 0.f, ca1 = 0.f;
      for (int i = 0; i < S; ++i) {
        const float w = w_s[i * (BT + 1) + t];
        ca0 = fmaf(w, __fsub_rn(xj0, xi_s[i]), ca0);
        ca1 = fmaf(w, __fsub_rn(xj1, xi_s[S + i]), ca1);
      }
      float* out_col = part + (((size_t)J * T + I) * S + j) * 2;
      out_col[0] = -ca0;
      out_col[1] = -ca1;
      __syncthreads();  // the next slab overwrites w_s
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* out_row = part + (((size_t)I * T + J) * S + t + BT * r) * 2;
    out_row[0] = acc[r][0];
    out_row[1] = acc[r][1];
  }
}

// One round of wideacc's reduce-scatter: of the 2 H live entries v[0..2H),
// a lane keeps the lower half (lane bit H / 4 clear) or the upper half
// (set) in v[0..H) and adds the partner's copy of it (lane ^ H / 4).
template <int H>
__device__ __forceinline__ void halve(float (&v)[2 * BT], int lane) {
  constexpr int OFF = H / 4;
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float keep = upper ? v[m + H] : v[m];
    const float send = upper ? v[m] : v[m + H];
    v[m] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
  }
}

// One tile pair (I, J) of side BT by BT threads, in one pass.
template <int MODE>
__global__ void __launch_bounds__(BT)
sym_force_wideacc(const float* __restrict__ pos,
                  const float* __restrict__ bounds, int levels, float arg_cap,
                  float min_d2, int self_masked, float* __restrict__ part) {
  static_assert(BT == 64, "the epilogue reduces 2 BT = 128 partials");
  const int I = blockIdx.y;
  const int J = blockIdx.x;
  if (I > J) return;
  const int T = gridDim.x;
  const int t = threadIdx.x;

  __shared__ float xj_s[2][BT];
  __shared__ float red_s[BT / 32][2 * BT];  // per warp: its column sums
  const float xi0 = pos[((size_t)I * BT + t) * 2];
  const float xi1 = pos[((size_t)I * BT + t) * 2 + 1];
  xj_s[0][t] = pos[((size_t)J * BT + t) * 2];
  xj_s[1][t] = pos[((size_t)J * BT + t) * 2 + 1];
  const float soft = bounds[2];
  const IntGrid g = mode_grid<MODE>(bounds, levels, arg_cap, min_d2);
  __syncthreads();

  const bool diag = (I == J);
  float r0 = 0.f, r1 = 0.f;
  float v[2 * BT];  // colp: v[2 j + d] = t_(t, j) component d
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    const float dx[2] = {__fsub_rn(xj_s[0][j], xi0),
                         __fsub_rn(xj_s[1][j], xi1)};
    float w = pair_w<MODE>(__fadd_rn(raw_d2<2>(dx), soft), g);
    if (diag && self_masked && j == t) w = 0.f;
    const float tx = __fmul_rn(w, dx[0]);
    const float ty = __fmul_rn(w, dx[1]);
    r0 = __fadd_rn(r0, tx);
    r1 = __fadd_rn(r1, ty);
    v[2 * j] = tx;
    v[2 * j + 1] = ty;
  }
  float* out_row = part + (((size_t)I * T + J) * BT + t) * 2;
  out_row[0] = r0;
  out_row[1] = r1;
  if (diag) return;  // block-uniform: a diagonal tile has no reactions

  // Reduce-scatter within the warp, halving the live entries five times:
  // lane l ends with the warp's sums of entries 4 l .. 4 l + 3.
  const int lane = t & 31;
  halve<64>(v, lane);
  halve<32>(v, lane);
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
#pragma unroll
  for (int m = 0; m < 4; ++m) red_s[t >> 5][4 * lane + m] = v[m];
  __syncthreads();
  // Reactions on column t of tile J: -(warp 0 + warp 1).
  float* out_col = part + (((size_t)J * T + I) * BT + t) * 2;
  out_col[0] = -__fadd_rn(red_s[0][2 * t], red_s[1][2 * t]);
  out_col[1] = -__fadd_rn(red_s[0][2 * t + 1], red_s[1][2 * t + 1]);
}

template <int M, int R>
int launch_rt(const float* pos, const float* gm, const float* bounds, int n,
              int levels, float arg_cap, float min_d2, int self_masked,
              float* part, float* out, cudaStream_t s) {
  constexpr int S = BT * R;
  if (n % S != 0) return (int)cudaErrorInvalidValue;
  const int T = n / S;
  const int smem = (int)sizeof(float) * S * (4 + BT + 1);
  auto kernel = sym_force_rt<M, R>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(T, T), BT, smem, s>>>(pos, bounds, levels, arg_cap, min_d2,
                                      self_masked, part);
  launch_reduce<2, S>(part, n, T, out, s, gm);
  return 0;
}

template <int M>
int launch_wideacc(const float* pos, const float* gm, const float* bounds,
                   int n, int levels, float arg_cap, float min_d2,
                   int self_masked, float* part, float* out, cudaStream_t s) {
  if (n % BT != 0) return (int)cudaErrorInvalidValue;
  const int T = n / BT;
  sym_force_wideacc<M><<<dim3(T, T), BT, 0, s>>>(
      pos, bounds, levels, arg_cap, min_d2, self_masked, part);
  launch_reduce<2, BT>(part, n, T, out, s, gm);
  return 0;
}

}  // namespace

// The r4 lab variants, D = 2, equal masses: variant 1 wideacc, 2 wideacc on
// the base-2 chain (an int mode only; arg_cap comes folded by log2(e)), 3
// rt<2>, 4 rt<3>. pos (n, 2) f32 with n a multiple of the variant's tile
// side (64, 64, 128, 192), gm (n,) f32 (only gm[0] is read), bounds (3,)
// f32 = [log_lo, log_hi, eps^2] on the device; mode float32 (0) or an int
// mode (3); part (T', T', side, 2) f32 scratch, T' = n / side; out (n, 2)
// f32. Returns a CUDA error code (cudaGetLastError() after the launches).
extern "C" int nbody_sym_force_lab_r4(const float* pos, const float* gm,
                                      const float* bounds, int n, int mode,
                                      int levels, float arg_cap, float min_d2,
                                      int self_masked, int variant,
                                      float* part, float* out, void* stream) {
  if (n <= 0 || n / BT > 65535 || (mode != MODE_F32 && mode != MODE_INT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto m) -> int {
    constexpr int M = decltype(m)::value;
    switch (variant) {
      case 1:
        return launch_wideacc<M>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                                 self_masked, part, out, s);
      case 2:
        if constexpr (M == MODE_INT)
          return launch_wideacc<MODE_INT_B2>(pos, gm, bounds, n, levels,
                                             arg_cap, min_d2, self_masked,
                                             part, out, s);
        return (int)cudaErrorInvalidValue;
      case 3:
        return launch_rt<M, 2>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                               self_masked, part, out, s);
      case 4:
        return launch_rt<M, 3>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                               self_masked, part, out, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  };
  const int rc = mode == MODE_F32 ? run(Const<MODE_F32>{})
                                  : run(Const<MODE_INT>{});
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
