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
//
// The register-tiled design (pair_pe_tiled; nbody_pair_pe_rows_tiled), the
// wrapper's route past 16384 receivers (hopper_nbody.pe_design). The first
// design above (pair_pe_rows_kernel; nbody_pair_pe_rows, every smaller
// launch and parent=True) spends four shared loads a pair (x, y, m, id) and
// an integer compare and branch, `idj_s[j] == idi`, on every pair: 15.2 ms
// at 131072^2 against the register-tiled row sweep's 8.9 over the same
// pairs with more arithmetic (PERF.md). What this one does about each:
//   * PE_R = 4 receivers a thread in registers, 128 threads a block (512
//     receivers: thread t holds b 512 + 128 r + t), each source of a
//     128-point tile staged once in shared memory as one float4 {x, y, m,
//     0} (D = 3: {x, y, z, m}) and read as a broadcast: one shared load
//     serves 4 pairs and 4 independent sums;
//   * the id mask off the pair loop: the wrapper hands the kernel the id
//     range [min, max] of each receiver block and of each source tile
//     (hopper_nbody.id_ranges, PyTorch ops on the device, no host read).
//     A tile whose range does not meet the block's cannot hold an equal
//     pair and runs the loop with no compare; one whose range meets it
//     runs a masked copy (block-uniform branch), where a select zeroes the
//     pair's rsqrt before m_j multiplies it (a zero-softening self pair is
//     never 0 * inf). Exact for any ids, since it can only over-mask; one
//     set, or the ring's contiguous shard ids, masks the diagonal tiles
//     only (4 of a block's);
//   * sources cut into segments of consecutive tiles: a grid of receiver
//     blocks x segments, a fixed function of (n_i, n_j)
//     (hopper_nbody.pe_segments, beside row_segments), each block writing
//     its rows' segment sums to rpart (ceil(n_i / 512), nseg, 512) f32,
//     which reduce_partials adds over the segments in order (one segment:
//     the block writes the rows itself). No atomics: two runs give the
//     same bits.
// Order and rounding: each tile's m_j rsqrt(d^2 + eps^2) are summed by
// fmaf in j order, the tile sums added to the segment's sum, the segment
// sum multiplied by m_i once, and the segments added in order. For
// positive terms the relative rounding of a row is at most (128 + seg +
// nseg + 5) u with u = 2^-24 (the tile's chain, the tile adds, the
// segment adds, the m_i multiply and the term's own roundings: rsqrtf's
// 2 ulp, d^2); chip_smoke.pe_rtol_tiled holds it at twice that.
// A ragged last source tile is padded with the inert far sentinel (x =
// 2e18, m = 0: d^2 ~ 8e36 stays finite, its term is 0); receivers past
// n_i compute and are never written (two coincident sentinels at zero
// softening would give 0 * inf there, never in a stored row).
// Per pair at D = 2: 2 subtracts, 2 multiplies and an add for d^2 (not
// contracted), the eps^2 add, the rsqrt (MUFU, 16 a clock a SM, plus
// rsqrtf's denormal guard) and the accumulating FMA: ~4.1 ms at
// 131072^2 by the MUFU rate, ~5.6 by the FP32 issue of ~11 slots a pair.

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

constexpr int PE_R = 4;                      // receivers a thread
constexpr int PE_THREADS = 128;              // threads a block
constexpr int PE_RW = PE_R * PE_THREADS;     // receivers a block: 512
constexpr int PE_TILE = 128;                 // sources a staged tile
static_assert(PE_TILE == PE_THREADS, "one thread a source stages");

// One staged tile of PE_TILE sources against a thread's PE_R receivers
// (indices i0 + 128 r): the tile's m_j rsqrt(d^2 + eps^2) summed by fmaf
// in j order, then added to acc. MASK zeroes the rsqrt of a pair whose ids
// are equal; only it reads the receivers' ids (from ida, a few tiles a
// block), so the unmasked loop holds no id in a register.
template <int D, bool MASK>
__device__ __forceinline__ void pe_tile(const float4* __restrict__ xs,
                                        const int* __restrict__ js,
                                        const float (&xi)[PE_R][D],
                                        const int* __restrict__ ida, int na,
                                        int i0, float (&acc)[PE_R],
                                        float soft) {
  float part[PE_R];
  int idi[PE_R];
#pragma unroll
  for (int r = 0; r < PE_R; ++r) {
    part[r] = 0.f;
    if (MASK) {
      const int i = i0 + PE_THREADS * r;
      idi[r] = i < na ? ida[i] : 0;
    }
  }
#pragma unroll 4
  for (int j = 0; j < PE_TILE; ++j) {
    const float4 sj = xs[j];
    const float xj[3] = {sj.x, sj.y, sj.z};
    const float mj = D == 2 ? sj.z : sj.w;
    const int idj = MASK ? js[j] : 0;
#pragma unroll
    for (int r = 0; r < PE_R; ++r) {
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj[d], xi[r][d]);
      float inv = rsqrtf(__fadd_rn(raw_d2<D>(dx), soft));
      if (MASK) inv = idj == idi[r] ? 0.f : inv;
      part[r] = fmaf(mj, inv, part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < PE_R; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
}

// Receiver block b = blockIdx.x (receivers b 512 .. b 512 + 511) against
// segment S = blockIdx.y (source tiles S seg .. S seg + seg - 1, each
// staged once, double-buffered, one barrier a tile); rrange[b] and
// srange[J] the id ranges [min, max] of the block's receivers and of
// source tile J. The rows' segment sums times m_i to rpart[b][S][512]
// (with one segment: the rows themselves). m_i and the receivers' ids are
// read from device memory where they are used, not held through the loop:
// 10 blocks a SM at D = 2 (on the H100 at 131072^2: 6.50 ms, against
// 7.10 with them held, 9 blocks a SM; forcing 12 blocks into 40 registers
// spilled and ran 7.03).
template <int D>
__global__ void __launch_bounds__(PE_THREADS)
pair_pe_tiled(const float* __restrict__ pa, const float* __restrict__ ma,
              const int* __restrict__ ida, int na,
              const float* __restrict__ pb, const float* __restrict__ mb,
              const int* __restrict__ idb, int nb,
              const float* __restrict__ soft_p,
              const int2* __restrict__ rrange,
              const int2* __restrict__ srange, int seg,
              float* __restrict__ rpart) {
  __shared__ float4 xs[2][PE_TILE];
  __shared__ int js[2][PE_TILE];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int S = blockIdx.y;
  const int i_lo = b * PE_RW;
  const int tiles = (nb + PE_TILE - 1) / PE_TILE;
  const int Jb = S * seg;
  const int Je = min(tiles, Jb + seg);

  const float soft = *soft_p;
  const int2 rr = rrange[b];
  float xi[PE_R][D], acc[PE_R];
#pragma unroll
  for (int r = 0; r < PE_R; ++r) {
    const int i = i_lo + PE_THREADS * r + t;
#pragma unroll
    for (int d = 0; d < D; ++d)
      xi[r][d] = i < na ? pa[(size_t)i * D + d] : 0.f;
    acc[r] = 0.f;
  }
  {
    const int j = Jb * PE_TILE + t;
    xs[0][t] = load_src4<D>(pb, mb, nb, j);
    js[0][t] = j < nb ? idb[j] : 0;
  }
  __syncthreads();
  for (int J = Jb, k = 0; J < Je; ++J, ++k) {
    const int buf = k & 1;
    float4 nxt{};
    int nid = 0;
    if (J + 1 < Je) {
      const int j = (J + 1) * PE_TILE + t;
      nxt = load_src4<D>(pb, mb, nb, j);
      nid = j < nb ? idb[j] : 0;
    }
    const int2 sr = srange[J];
    if (sr.y >= rr.x && sr.x <= rr.y)  // block-uniform: the ranges meet
      pe_tile<D, true>(xs[buf], js[buf], xi, ida, na, i_lo + t, acc, soft);
    else
      pe_tile<D, false>(xs[buf], js[buf], xi, ida, na, i_lo + t, acc, soft);
    xs[buf ^ 1][t] = nxt;
    js[buf ^ 1][t] = nid;
    __syncthreads();
  }
  float* out = rpart + ((size_t)b * gridDim.y + S) * PE_RW;
#pragma unroll
  for (int r = 0; r < PE_R; ++r) {
    const int i = i_lo + PE_THREADS * r + t;
    if (i < na) out[PE_THREADS * r + t] = __fmul_rn(ma[i], acc[r]);
  }
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

// The register-tiled design: the same arguments as nbody_pair_pe_rows,
// plus rrange (ceil(na / PE_RW), 2) and srange (ceil(nb / PE_TILE), 2)
// int32, the [min, max] of the ids of each receiver block and source tile
// (any range that holds them is exact; a wider one only masks more
// tiles); seg >= 1 source tiles a segment, nseg = ceil(ceil(nb / PE_TILE)
// / seg) segments; rpart: (ceil(na / PE_RW), nseg, PE_RW) f32 scratch,
// unused (may be null) when nseg == 1. One launch, or two with the
// fixed-order reduction over the segments. Returns cudaGetLastError().
extern "C" int nbody_pair_pe_rows_tiled(const float* pa, const float* ma,
                                        const int* ida, int na,
                                        const float* pb, const float* mb,
                                        const int* idb, int nb, int dim,
                                        const float* soft, const int* rrange,
                                        const int* srange, int seg,
                                        float* rpart, float* out,
                                        void* stream) {
  if (na <= 0 || nb <= 0 || seg <= 0 || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  const int tiles = (nb + PE_TILE - 1) / PE_TILE;
  const int nseg = (tiles + seg - 1) / seg;
  if (nseg > 65535 || (nseg > 1 && rpart == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((na + PE_RW - 1) / PE_RW, nseg);
  float* part = nseg == 1 ? out : rpart;
  const int2* rr = reinterpret_cast<const int2*>(rrange);
  const int2* sr = reinterpret_cast<const int2*>(srange);
  if (dim == 2)
    pair_pe_tiled<2><<<grid, PE_THREADS, 0, s>>>(pa, ma, ida, na, pb, mb, idb,
                                                 nb, soft, rr, sr, seg, part);
  else
    pair_pe_tiled<3><<<grid, PE_THREADS, 0, s>>>(pa, ma, ida, na, pb, mb, idb,
                                                 nb, soft, rr, sr, seg, part);
  if (nseg > 1) launch_reduce<1, PE_RW>(rpart, na, nseg, out, s);
  return (int)cudaGetLastError();
}

// Receivers a block, sources a tile of the register-tiled design
// (hopper_nbody.PE_RECEIVERS, PE_SOURCE_TILE): rw * 65536 + tile.
extern "C" int nbody_pair_pe_geometry() { return PE_RW * 65536 + PE_TILE; }

// Blocks of pair_pe_tiled<dim> a SM holds at once (-1: none).
extern "C" int nbody_pair_pe_tiled_resident(int dim) {
  int blocks = -1;
  cudaError_t rc = cudaErrorInvalidValue;
  if (dim == 2)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pair_pe_tiled<2>, PE_THREADS, 0);
  else if (dim == 3)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pair_pe_tiled<3>, PE_THREADS, 0);
  return rc == cudaSuccess ? blocks : -1;
}
