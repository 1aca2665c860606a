// Per-receiver potential-energy row sums between two particle sets on
// Hopper (sm_90a).
//
// Replaces: nbody_tpu/ops/pallas_nbody.py, _pair_pe_kernel (the kernel
// body) and pallas_pair_pe_rows (its wrapper), TPU kernel #7, the tile of
// the multi-device ring's energy pass:
//   rows[i] = sum_j m_i m_j / sqrt(|x_j - x_i|^2 + eps^2) over j, id_j != id_i
// The caller sums the rows (in f64) and halves: every unordered pair is
// visited twice across the ring.
//
// Ids are int32 here. The TPU kernel carries them as f32 in its staged
// arrays, exact only below 2^24, so the JAX ring switches the tile off past
// 2^24 particles (parallel/ring.py:320-323); int32 ids compute the same
// function (an equality mask on the self-pair) with no such limit.
// eps^2 is read from a device scalar, so a run-time softening needs no new
// launch parameters.
//
// Design: one thread per receiver row, RB rows per block, as in
// row_force.cu. The block walks all sources in tiles of RB staged in
// shared memory, j ascending; each tile's terms are summed in registers and
// the tile sum is then added to the row: a fixed order, so two runs give
// the same bits, and a two-level sum whose rounding error grows with
// RB + (tiles) rather than with the row's length. A ragged tail is handled
// by counts, with no padded pairs.
//
// Numerics: d^2 is subtract-form and never contracted into an FMA
// (csrc/nbody_common.cuh), plus eps^2; the term is fmaf(m_i m_j,
// rsqrtf(d^2), partial), rsqrtf documented at 2 ulp.
//
// What bounds it on the H100: arithmetic, ~10 fp32 ops plus one rsqrt per
// pair, n_i * n_j pairs; every thread of a block reads the same source from
// shared memory (a broadcast), and device memory sees n_i / RB passes over
// the sources' (D + 2) words each.

#include "nbody_common.cuh"

namespace {

constexpr int RB = 128;

template <int D>
__global__ void __launch_bounds__(RB)
pair_pe_rows_kernel(const float* __restrict__ pa, const float* __restrict__ ma,
                    const int* __restrict__ ida, int na,
                    const float* __restrict__ pb, const float* __restrict__ mb,
                    const int* __restrict__ idb, int nb,
                    const float* __restrict__ soft_p, float* __restrict__ out) {
  __shared__ float xj_s[D][RB];
  __shared__ float mj_s[RB];
  __shared__ int idj_s[RB];
  const int t = threadIdx.x;
  const int i = blockIdx.x * RB + t;
  const bool live = i < na;

  const float soft = *soft_p;
  float xi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xi[d] = live ? pa[(size_t)i * D + d] : 0.f;
  const float mi = live ? ma[i] : 0.f;
  const int idi = live ? ida[i] : 0;

  float acc = 0.f;
  for (int j0 = 0; j0 < nb; j0 += RB) {
    const int jcnt = min(RB, nb - j0);
    __syncthreads();  // the previous tile's readers are done
    if (t < jcnt) {
#pragma unroll
      for (int d = 0; d < D; ++d) xj_s[d][t] = pb[(size_t)(j0 + t) * D + d];
      mj_s[t] = mb[j0 + t];
      idj_s[t] = idb[j0 + t];
    }
    __syncthreads();
    if (!live) continue;
    float part = 0.f;
    for (int j = 0; j < jcnt; ++j) {
      if (idj_s[j] == idi) continue;
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj_s[d][j], xi[d]);
      const float d2 = __fadd_rn(raw_d2<D>(dx), soft);
      part = fmaf(__fmul_rn(mi, mj_s[j]), rsqrtf(d2), part);
    }
    acc = __fadd_rn(acc, part);
  }
  if (live) out[i] = acc;
}

}  // namespace

// Receivers pa (na, dim), ma (na,) f32, ida (na,) int32; sources pb
// (nb, dim), mb (nb,) f32, idb (nb,) int32; soft: one f32, eps^2; out
// (na,) f32. All on the device. Returns cudaGetLastError().
extern "C" int nbody_pair_pe_rows(const float* pa, const float* ma,
                                  const int* ida, int na, const float* pb,
                                  const float* mb, const int* idb, int nb,
                                  int dim, const float* soft, float* out,
                                  void* stream) {
  if (na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (na + RB - 1) / RB;
  if (dim == 2)
    pair_pe_rows_kernel<2><<<blocks, RB, 0, s>>>(pa, ma, ida, na, pb, mb, idb,
                                                 nb, soft, out);
  else if (dim == 3)
    pair_pe_rows_kernel<3><<<blocks, RB, 0, s>>>(pa, ma, ida, na, pb, mb, idb,
                                                 nb, soft, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
