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
//   * a diagonal block (I, I) computes full row sums into part[I][I],
//     skipping i == j when self_masked (zero or run-time softening);
//   * reduce_partials sums part[a][0..T-1] for every row in a fixed
//     order, so two runs give the same bits.
//   part holds 4 * D * T * T * BT bytes, T = ceil(N / BT): the scratch
//   that hopper_nbody.sym_force_scratch_bytes reckons and the "auto"
//   routing holds to a budget (the chunked path takes larger N).
//
// Numerics: csrc/nbody_common.cuh.
//
// What bounds it on the H100: arithmetic. Each pair costs ~20 fp32 ops
// plus one rsqrt (float modes) or a logf + expf (int modes) against 8-12
// bytes of shared-memory traffic; device memory sees only O(N) positions
// plus the part buffer (read once by the reduce). The BT x BT tile of w
// in shared memory (padded to BT+1 columns, so both phases are free of
// bank conflicts) lets the reaction pass reuse every w instead of
// recomputing the transcendental.

#include "nbody_common.cuh"

namespace {

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

  const float soft = bounds[2];
  IntGrid g{};
  if (MODE == MODE_INT) g = int_grid(bounds, levels, arg_cap, min_d2);
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
  float* out_row = part + (((size_t)I * T + J) * BT + t) * D;
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
  float* out_col = part + (((size_t)J * T + I) * BT + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out_col[d] = -col[d];
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
  const int T = (n + BT - 1) / BT;
  if (n <= 0 || T > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = dispatch(mode, dim, [&](auto m, auto d) {
    constexpr int M = decltype(m)::value;
    constexpr int DD = decltype(d)::value;
    sym_force_tiles<M, DD><<<dim3(T, T), BT, 0, s>>>(
        pos, gm, bounds, n, levels, arg_cap, min_d2, self_masked, part);
    launch_reduce<DD>(part, n, T, out, s);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
