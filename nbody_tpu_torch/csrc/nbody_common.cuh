// Device code shared by the kernels of nbody_tpu_torch (sym_force.cu,
// row_force.cu, pair_sym_force.cu, pair_pe_rows.cu, max_dist_sq.cu): the
// precision hook of one pair, the staged source of a register-tiled tile,
// the fixed-order reduction of per-tile partials, and the dispatch from
// the runtime (mode, dim) to a kernel instance.
//
// Numerics, matched to the plain PyTorch versions (ops/hopper_nbody.py):
//   * d^2 is subtract-form and never contracted into an FMA:
//     __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)) (+ dz^2), then + eps^2;
//   * float32: w = rsqrtf(d2)^3; CUDA documents rsqrtf at 2 ulp, and
//     torch.rsqrt on the card calls the same function;
//   * bf16 / f16: __float2bfloat16_rn / __float2half_rn and back (IEEE
//     round-to-nearest-even, f16 subnormals, inf at |x| >= 65520);
//   * int-sim: the folded log-grid chain of the TPU kernels
//     (pallas_nbody.py:176-219), max, log, mul-add, rint, mul-add, min,
//     exp, with the grid scalars hoisted per block. logf / expf are the
//     accurate versions and rintf rounds half to even (as jnp.round):
//     never build with --use_fast_math, a different log moves the bin
//     edges. The two multiply-adds round twice (mul, then add) as the JAX
//     chain and the plain version do, so a kernel and its plain version
//     agree bin for bin. one_pass.cuh's table kernels take the same
//     weights from per-launch tables of the chain's own bin edges and
//     weights, bit for bit.
//   * int-sim base 2 (MODE_INT_B2, the r4 lab's knob A only,
//     tools/kernel_lab_r4.py:108-122): the same chain on log2f / exp2f
//     (the accurate versions) with ln 2 folded into norm_a and log2(e)
//     into arg_k and arg_0 (one f32 multiply each, as the TPU lab folds
//     them); the caller passes arg_cap already folded. The fold moves a bin
//     edge by up to an ulp, so it never replaces the production chain.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

// Tile of the Newton's-third-law kernels: a block of BT threads owns BT
// receivers, and per-tile partials hold BT rows (hopper_nbody.TILE).
constexpr int BT = 64;

enum Mode {
  MODE_F32 = 0,
  MODE_BF16 = 1,
  MODE_F16 = 2,
  MODE_INT = 3,
  MODE_INT_B2 = 4  // lab only: never taken by dispatch()
};

struct IntGrid {
  float norm_a, norm_b, arg_k, arg_0, arg_cap, min_d2;
};

// The folded int chain's grid scalars from bounds = [log_lo, log_hi, eps^2]
// (pallas_nbody.py:321-328), each op a single IEEE rounding.
__device__ __forceinline__ IntGrid int_grid(const float* bounds, int levels,
                                            float arg_cap, float min_d2) {
  const float log_lo = bounds[0];
  const float log_hi = bounds[1];
  const float lvl = (float)(levels - 1);
  const float safe_span = fmaxf(__fsub_rn(log_hi, log_lo), 1e-10f);
  IntGrid g;
  g.norm_a = __fdiv_rn(lvl, safe_span);
  g.norm_b = __fmul_rn(-log_lo, g.norm_a);
  g.arg_k = __fdiv_rn(__fmul_rn(-1.5f, safe_span), lvl);
  g.arg_0 = __fmul_rn(-1.5f, log_lo);
  g.arg_cap = arg_cap;
  g.min_d2 = min_d2;
  return g;
}

// The grid scalars a block of mode MODE hoists: none for the float modes,
// int_grid's for MODE_INT, and for MODE_INT_B2 int_grid's with the base-2
// folds (arg_cap comes folded).
template <int MODE>
__device__ __forceinline__ IntGrid mode_grid(const float* bounds, int levels,
                                             float arg_cap, float min_d2) {
  IntGrid g{};
  if (MODE == MODE_INT || MODE == MODE_INT_B2)
    g = int_grid(bounds, levels, arg_cap, min_d2);
  if (MODE == MODE_INT_B2) {
    g.norm_a = __fmul_rn(g.norm_a, 0.693147180559945309f);  // ln 2
    g.arg_k = __fmul_rn(g.arg_k, 1.442695040888963407f);    // log2(e)
    g.arg_0 = __fmul_rn(g.arg_0, 1.442695040888963407f);
  }
  return g;
}

// Index of tile pair (I, J), I <= J, in the upper triangle (J-major), and
// back.
__device__ __forceinline__ long long tri_index(int I, int J) {
  return (long long)J * (J + 1) / 2 + I;
}

__device__ __forceinline__ void tri_tile(long long k, int& I, int& J) {
  long long j = (long long)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > k) --j;
  while ((j + 1) * (j + 2) / 2 <= k) ++j;
  J = (int)j;
  I = (int)(k - j * (j + 1) / 2);
}

// The inert far sentinel that pads a ragged source tile
// (pallas_nbody.py:55-64's): d^2 ~ 8e36 stays finite, and the weight 0
// zeroes its term.
constexpr float FAR_SENTINEL = 2e18f;

// Source j of pos with its weight w[j] (G m or m) as one staged float4
// {x, y, w, 0} (D = 3: {x, y, z, w}), or the sentinel with weight 0 past
// n: the register-tiled row sweep's and pair_pe_rows' source tiles.
template <int D>
__device__ __forceinline__ float4 load_src4(const float* __restrict__ pos,
                                            const float* __restrict__ w,
                                            int n, int j) {
  if (j >= n) return make_float4(FAR_SENTINEL, FAR_SENTINEL, 0.f, 0.f);
  const float* p = pos + (size_t)j * D;
  return D == 2 ? make_float4(p[0], p[1], w[j], 0.f)
                : make_float4(p[0], p[1], p[D - 1], w[j]);
}

template <int D>
__device__ __forceinline__ float raw_d2(const float (&dx)[D]) {
  float s = __fmul_rn(dx[0], dx[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(dx[d], dx[d]));
  return s;
}

// The int chain's two halves: the grid index k (a float holding an integer)
// of x = max(d^2, min_d2), and the weight of an index. one_pass.cuh's
// per-launch tables are built from these same operations.
template <int MODE>
__device__ __forceinline__ float int_chain_k(float x, const IntGrid& g) {
  const float log_d2 = MODE == MODE_INT_B2 ? log2f(x) : logf(x);
  return rintf(__fadd_rn(__fmul_rn(log_d2, g.norm_a), g.norm_b));
}

template <int MODE>
__device__ __forceinline__ float int_chain_w(float k, const IntGrid& g) {
  const float arg = fminf(__fadd_rn(__fmul_rn(k, g.arg_k), g.arg_0),
                          g.arg_cap);
  return MODE == MODE_INT_B2 ? exp2f(arg) : expf(arg);
}

// w = quantized |r|^-3 of the softened d^2.
template <int MODE>
__device__ __forceinline__ float pair_w(float d2, const IntGrid& g) {
  if (MODE == MODE_INT || MODE == MODE_INT_B2)
    return int_chain_w<MODE>(int_chain_k<MODE>(fmaxf(d2, g.min_d2), g), g);
  float d2q = d2;
  if (MODE == MODE_BF16) d2q = __bfloat162float(__float2bfloat16_rn(d2));
  if (MODE == MODE_F16) d2q = __half2float(__float2half_rn(d2));
  const float inv = rsqrtf(d2q);
  return __fmul_rn(__fmul_rn(inv, inv), inv);
}

// out[row] = sum over b = 0..nb-1 of part[row / TS][b][row % TS], in that
// order: part is (ceil(n / TS), nb, TS, D), TS the tile side (BT but for
// the register-tiled lab variants). A fixed order, so two runs give
// the same bits (the multiverse experiments read summation order as
// physics). Optional device pointers: `scale` multiplies each sum once by
// scale[0] (the equal-mass variants' G m_0, never read on the host); when
// *skip != 0 the launch was skipped and out is zeros; `count` gains 1 when
// it was not.
template <int D, int TS = BT>
__global__ void reduce_partials(const float* __restrict__ part, int n, int nb,
                                const float* __restrict__ scale,
                                const int* __restrict__ skip,
                                int* __restrict__ count,
                                float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool skipped = skip != nullptr && *skip != 0;
  if (row == 0 && count != nullptr && !skipped) *count += 1;
  if (row >= n) return;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  if (!skipped) {
    const size_t a = row / TS;
    const size_t r = row % TS;
    for (int b = 0; b < nb; ++b) {
      const float* p = part + ((a * nb + b) * TS + r) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = __fadd_rn(s[d], p[d]);
    }
    if (scale != nullptr) {
      const float g = scale[0];
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = __fmul_rn(s[d], g);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) out[(size_t)row * D + d] = s[d];
}

template <int D, int TS = BT>
void launch_reduce(const float* part, int n, int nb, float* out,
                   cudaStream_t stream, const float* scale = nullptr,
                   const int* skip = nullptr, int* count = nullptr) {
  reduce_partials<D, TS><<<(n + 255) / 256, 256, 0, stream>>>(
      part, n, nb, scale, skip, count, out);
}

template <int V>
using Const = std::integral_constant<int, V>;

// Calls f(Const<MODE>{}, Const<D>{}) for the runtime mode and dim; returns
// false (and calls nothing) for a mode or dim no kernel is built for.
template <typename F>
bool dispatch(int mode, int dim, F&& f) {
  if (dim != 2 && dim != 3) return false;
  auto by_dim = [&](auto m) {
    if (dim == 2)
      f(m, Const<2>{});
    else
      f(m, Const<3>{});
  };
  switch (mode) {
    case MODE_F32:
      by_dim(Const<MODE_F32>{});
      return true;
    case MODE_BF16:
      by_dim(Const<MODE_BF16>{});
      return true;
    case MODE_F16:
      by_dim(Const<MODE_F16>{});
      return true;
    case MODE_INT:
      by_dim(Const<MODE_INT>{});
      return true;
    default:
      return false;
  }
}

}  // namespace
