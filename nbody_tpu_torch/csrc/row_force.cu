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
// Design: one thread per receiver row, RB rows per block. The block walks
// all sources in tiles of RB staged in shared memory, j ascending; each
// tile's terms are summed with fmaf in registers and the tile sum is then
// added to the row: a fixed order, so two runs give the same bits. The
// two-level sum keeps the rounding error near that of the sym kernel's
// per-tile partials: one fmaf chain over all N terms rounded ~5x worse
// where terms cancel (softening 0.05, N = 5000), beyond the plain
// version's tolerance. A ragged tail is handled by counts, with no padded
// pairs.
//
// Numerics: csrc/nbody_common.cuh.
//
// What bounds it on the H100: arithmetic, N^2 pair evaluations (twice the
// sym kernel's N^2 / 2) of ~20 fp32 ops plus an rsqrt (float modes) or a
// logf + expf (int modes). Every thread of a block reads the same source
// from shared memory (a broadcast); device memory sees N / RB passes over
// the (N, D) positions and G*m, which at N = 1M is ~16 MB a pass, held in
// the 50 MB L2. Receivers and sources are separate pointers and counts,
// so the two-set form costs nothing over the one-set form.

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
