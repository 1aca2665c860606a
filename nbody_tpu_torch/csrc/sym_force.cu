// Newton's-third-law softened gravity on Hopper (sm_90a).
//
// Replaces: nbody_tpu/ops/pallas_nbody.py, _force_kernel_sym (the kernel
// body) and pallas_accelerations_sym (its wrapper). It computes what that
// kernel computes, each unordered pair's weight w = quantized |r|^-3 once,
// rows += G m_j w diff and reactions -= G m_i w diff, but not its block
// structure: the TPU kernel carries the reaction columns across a
// sequential grid, and Hopper's blocks run in no order.
//
// Design (simple and deterministic, no atomics):
//   * particles are cut into tiles of BT; one block of BT threads per
//     tile pair (I, J) with I <= J (blocks with I > J exit at once);
//   * an off-diagonal block computes w for its BT x BT pairs once, keeps
//     it in shared memory, writes tile I's row sums to part[I][J] (thread
//     per receiver row) and then tile J's reactions to part[J][I] (thread
//     per source column, reading the stored w);
//   * a diagonal block (I, I) computes full row sums into part[I][I];
//   * sym_force_reduce sums part[a][0..T-1] for every row in a fixed
//     order, so two runs give the same bits (multiverse experiments read
//     summation order as physics).
//   part holds 4 * D * N * ceil(N / BT) bytes.
//
// Numerics, matched to the plain PyTorch version (ops/hopper_nbody.py):
//   * d^2 is subtract-form and never contracted into an FMA:
//     __fadd_rn(__fmul_rn(dx,dx), __fmul_rn(dy,dy)) (+ dz^2), then + eps^2;
//   * float32: w = rsqrtf(d2)^3; CUDA documents rsqrtf at 2 ulp, and
//     torch.rsqrt on the card calls the same function;
//   * bf16 / f16: __float2bfloat16_rn / __float2half_rn and back (IEEE
//     round-to-nearest-even, f16 subnormals, inf at |x| >= 65520);
//   * int-sim: the folded log-grid chain of the TPU kernel, max, log,
//     mul-add, rint, mul-add, min, exp, with the grid scalars hoisted per
//     block. logf / expf are the accurate versions and rintf rounds half
//     to even (as jnp.round): never build with --use_fast_math, a
//     different log moves the bin edges. The two multiply-adds round
//     twice (mul, then add) as the JAX chain and the plain version do, so
//     the kernel and its plain version agree bin for bin.
//
// What bounds it on the H100: arithmetic. Each pair costs ~20 fp32 ops
// plus one rsqrt (float modes) or a logf + expf (int modes) against 8-12
// bytes of shared-memory traffic; device memory sees only O(N) positions
// plus the part buffer (read once by the reduce). The BT x BT tile of w
// in shared memory (padded to BT+1 columns, so both phases are free of
// bank conflicts) lets the reaction pass reuse every w instead of
// recomputing the transcendental.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_F16 = 2, MODE_INT = 3 };

struct IntGrid {
  float norm_a, norm_b, arg_k, arg_0, arg_cap, min_d2;
};

template <int D>
__device__ __forceinline__ float raw_d2(const float (&dx)[D]) {
  float s = __fmul_rn(dx[0], dx[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(dx[d], dx[d]));
  return s;
}

template <int MODE>
__device__ __forceinline__ float pair_w(float d2, const IntGrid& g) {
  if (MODE == MODE_INT) {
    const float log_d2 = logf(fmaxf(d2, g.min_d2));
    const float k = rintf(__fadd_rn(__fmul_rn(log_d2, g.norm_a), g.norm_b));
    const float arg = fminf(__fadd_rn(__fmul_rn(k, g.arg_k), g.arg_0),
                            g.arg_cap);
    return expf(arg);
  }
  float d2q = d2;
  if (MODE == MODE_BF16) d2q = __bfloat162float(__float2bfloat16_rn(d2));
  if (MODE == MODE_F16) d2q = __half2float(__float2half_rn(d2));
  const float inv = rsqrtf(d2q);
  return __fmul_rn(__fmul_rn(inv, inv), inv);
}

template <int MODE, int D>
__global__ void __launch_bounds__(BT)
sym_force_tiles(const float* __restrict__ pos, const float* __restrict__ gm,
                const float* __restrict__ bounds, int n, int levels,
                float arg_cap, float min_d2, int self_masked,
                float* __restrict__ part) {
  const int I = blockIdx.y;
  const int J = blockIdx.x;
  if (I > J) return;
  const int T = gridDim.x;
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
    gmi_s[t] = gm[i0 + t];
  }
  if (t < jcnt) {
#pragma unroll
    for (int d = 0; d < D; ++d) xj_s[d][t] = pos[(size_t)(j0 + t) * D + d];
    gmj_s[t] = gm[j0 + t];
  }

  // Grid scalars hoisted out of the pair loop (pallas_nbody.py:321-328).
  const float soft = bounds[2];
  IntGrid g{};
  if (MODE == MODE_INT) {
    const float log_lo = bounds[0];
    const float log_hi = bounds[1];
    const float lvl = (float)(levels - 1);
    const float safe_span = fmaxf(__fsub_rn(log_hi, log_lo), 1e-10f);
    g.norm_a = __fdiv_rn(lvl, safe_span);
    g.norm_b = __fmul_rn(-log_lo, g.norm_a);
    g.arg_k = __fdiv_rn(__fmul_rn(-1.5f, safe_span), lvl);
    g.arg_0 = __fmul_rn(-1.5f, log_lo);
    g.arg_cap = arg_cap;
    g.min_d2 = min_d2;
  }
  __syncthreads();

  const bool diag = (I == J);
  float row[D];
#pragma unroll
  for (int d = 0; d < D; ++d) row[d] = 0.f;
  if (t < icnt) {
    float xi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = xi_s[d][t];
    for (int j = 0; j < jcnt; ++j) {
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj_s[d][j], xi[d]);
      const float w = pair_w<MODE>(__fadd_rn(raw_d2<D>(dx), soft), g);
      if (diag) {
        if (self_masked && j == t) continue;
      } else {
        w_s[t][j] = w;
      }
      const float fr = __fmul_rn(gmj_s[j], w);
#pragma unroll
      for (int d = 0; d < D; ++d) row[d] = fmaf(fr, dx[d], row[d]);
    }
  }
  float* out_row = part + ((size_t)(I * T + J) * BT + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out_row[d] = row[d];
  if (diag) return;  // block-uniform

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
      const float fc = __fmul_rn(gmi_s[i], w_s[i][t]);
#pragma unroll
      for (int d = 0; d < D; ++d)
        col[d] = fmaf(fc, __fsub_rn(xj[d], xi_s[d][i]), col[d]);
    }
  }
  float* out_col = part + ((size_t)(J * T + I) * BT + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out_col[d] = -col[d];
}

// acc[row] = sum over b = 0..T-1 of part[row / BT][b][row % BT], in order.
template <int D>
__global__ void sym_force_reduce(const float* __restrict__ part, int n, int T,
                                 float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int a = row / BT;
  const int r = row % BT;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  for (int b = 0; b < T; ++b) {
    const float* p = part + ((size_t)(a * T + b) * BT + r) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = __fadd_rn(s[d], p[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) out[(size_t)row * D + d] = s[d];
}

template <int MODE, int D>
void launch(const float* pos, const float* gm, const float* bounds, int n,
            int levels, float arg_cap, float min_d2, int self_masked,
            float* part, float* out, cudaStream_t stream) {
  const int T = (n + BT - 1) / BT;
  sym_force_tiles<MODE, D><<<dim3(T, T), BT, 0, stream>>>(
      pos, gm, bounds, n, levels, arg_cap, min_d2, self_masked, part);
  sym_force_reduce<D><<<(n + 255) / 256, 256, 0, stream>>>(part, n, T, out);
}

template <int D>
void launch_mode(int mode, const float* pos, const float* gm,
                 const float* bounds, int n, int levels, float arg_cap,
                 float min_d2, int self_masked, float* part, float* out,
                 cudaStream_t stream) {
  switch (mode) {
    case MODE_F32:
      launch<MODE_F32, D>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                          self_masked, part, out, stream);
      break;
    case MODE_BF16:
      launch<MODE_BF16, D>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                           self_masked, part, out, stream);
      break;
    case MODE_F16:
      launch<MODE_F16, D>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                          self_masked, part, out, stream);
      break;
    default:
      launch<MODE_INT, D>(pos, gm, bounds, n, levels, arg_cap, min_d2,
                          self_masked, part, out, stream);
  }
}

}  // namespace

extern "C" int nbody_sym_force_tile() { return BT; }

// pos (n, dim) f32, gm (n,) f32 = G * m, bounds (3,) f32 = [log_lo,
// log_hi, eps^2] on the device; part (T, T, BT, dim) f32 scratch with
// T = ceil(n / BT); out (n, dim) f32. Returns cudaGetLastError().
extern "C" int nbody_sym_force(const float* pos, const float* gm,
                               const float* bounds, int n, int dim, int mode,
                               int levels, float arg_cap, float min_d2,
                               int self_masked, float* part, float* out,
                               void* stream) {
  if (n <= 0 || (dim != 2 && dim != 3) || mode < MODE_F32 ||
      mode > MODE_INT || (n + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2)
    launch_mode<2>(mode, pos, gm, bounds, n, levels, arg_cap, min_d2,
                   self_masked, part, out, s);
  else
    launch_mode<3>(mode, pos, gm, bounds, n, levels, arg_cap, min_d2,
                   self_masked, part, out, s);
  return (int)cudaGetLastError();
}
