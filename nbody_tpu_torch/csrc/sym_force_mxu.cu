// The round-5 lab's accumulation-offload sym kernel on Hopper (sm_90a): the
// equal-mass sym kernel's row and column sums as bf16 tensor-core products,
// at three dot precisions.
//
// Replaces: tools/kernel_lab_r5.py, _force_kernel_mxu (:163, the kernel
// body) and accelerations_mxu (:236, its wrapper), knob C. The function, f32
// with one G m: w_ij = rsqrt(d^2 + eps^2)^3 with subtract-form d^2
// (nbody_common.cuh's raw_d2 and pair_w<MODE_F32>, unchanged); for each
// receiver i, row = sum_j w_ij [x_j | 1] and acc_i,d = row_d - x_i,d row_D;
// for each source j, col = sum_i w_ij [x_i | 1] and acc_j,d += col_d -
// x_j,d col_D; the whole times G m, read from gm[0] on the device.
//
// Coverage, as the TPU kernel's (:211-231) at this kernel's tile side TS =
// 64: a diagonal tile (I, I) by rows only, both directions, the self-pair
// included and unmasked (w_ii x_i - x_i w_ii leaves its rounding residue in
// the result, as on the TPU); a tile pair I < J by rows (receivers of I)
// and columns (sources of J). One block of 128 threads a tile pair; the
// blocks with I > J return at once.
//
// Per tile: the 128 threads compute the 64 x 64 w in f32 and store its bf16
// planes in shared memory; the positions of both tiles, extended by a ones
// column and zero-padded to 16 columns, are stored as bf16 planes too. Each
// of the 4 warps then takes one 16-row slab of both products, 64 x 64 times
// 64 x 16 on the tensor cores (nvcuda::wmma, m16n16k16, bf16 operands, one
// f32 accumulator each): rows W [x_j | 1] from W read row-major, columns
// W^T [x_i | 1] from the same array read column-major. The precision P sets
// the passes over the planes (a0 = bf16_rn(a), a1 = bf16_rn(a - a0), a2 =
// bf16_rn(a - a0 - a1), the subtracts exact in f32), XLA's bf16 pass
// schemes: default (P = 0) a0 b0; high (1, bf16_3x) a0 b0 + a0 b1 + a1 b0;
// highest (2, bf16_6x) those and a0 b2 + a1 b1 + a2 b0; every pass into the
// same f32 accumulator. The epilogue row_d - x_d row_D rounds each op
// (__fsub_rn / __fmul_rn, no FMA contraction), one thread a row or column,
// into per-tile partials (T, T, TS, D), T = N / TS, summed in a fixed order
// and scaled once by gm[0] by reduce_partials: no atomics, so two runs give
// the same bits. The tensor cores' own accumulation order is not IEEE's, so
// the kernel matches its plain version to rounding (the summed |terms|
// rule), not bit for bit.
//
// What bounds it on this card: the w chain on the FP32 cores (9 ops a pair
// at D = 2: 2 subtracts, 2 multiplies, 2 adds, rsqrt, 2 multiplies), plus
// the bf16 splits (1, 4 or 7 conversions and subtracts a pair) and their
// shared-memory stores; not the MMAs, whose 4 (D + 1) x passes flops a pair
// take ~10% (default) to ~55% (highest) of the FP32 term's time at the
// tensor cores' peak. Like the TPU's (:18-31), every product's N is the
// coordinate dimension: D + 1 = 3 or 4 of each MMA's 16 columns do work.
//
// Takes D in {2, 3}, N a multiple of TS (no padding) and eps^2 > 0 (at zero
// softening the self-pair makes inf * 0); the wrapper raises otherwise.

#include "nbody_common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int TS = BT;               // tile side
constexpr int NC = 16;               // columns of [x | 1]: wmma's N, padded
constexpr int WARPS = TS / 16;       // one 16-row slab of each product a warp
constexpr int THREADS = 32 * WARPS;  // = 2 TS: one particle of (I, J) each
constexpr int LDW = TS + 8;          // w's row stride, bf16 elements

// Pass q of precision P multiplies w plane pass_w(q) by x plane pass_x(q):
// (0,0) (0,1) (1,0) (0,2) (1,1) (2,0).
__host__ __device__ constexpr int n_passes(int p) {
  return p == 0 ? 1 : (p == 1 ? 3 : 6);
}
__host__ __device__ constexpr int pass_w(int q) {
  return q == 2 || q == 4 ? 1 : (q == 5 ? 2 : 0);
}
__host__ __device__ constexpr int pass_x(int q) {
  return q == 1 || q == 4 ? 1 : (q == 3 ? 2 : 0);
}

// a's first PL bf16 planes to dst[0], dst[stride], dst[2 stride].
template <int PL>
__device__ __forceinline__ void split_store(float a, __nv_bfloat16* dst,
                                            int stride) {
  float rest = a;
#pragma unroll
  for (int p = 0; p < PL; ++p) {
    const __nv_bfloat16 h = __float2bfloat16_rn(rest);
    dst[p * stride] = h;
    if (p + 1 < PL) rest = __fsub_rn(rest, __bfloat162float(h));
  }
}

template <int D, int P>
__global__ void __launch_bounds__(THREADS)
sym_force_mxu(const float* __restrict__ pos, float soft,
              float* __restrict__ part) {
  constexpr int PL = P + 1;  // planes of each operand
  constexpr int NP = n_passes(P);
  constexpr int W_BYTES = PL * TS * LDW * 2;
  constexpr int X_BYTES = PL * TS * NC * 2;
  static_assert(W_BYTES >= 2 * TS * NC * 4, "the results reuse w's bytes");
  static_assert(THREADS == 2 * TS, "one particle of the tile pair a thread");
  const int I = blockIdx.y;
  const int J = blockIdx.x;
  if (I > J) return;
  const int T = gridDim.x;
  const bool diag = (I == J);  // block-uniform
  const int t = threadIdx.x;

  // w's planes [PL][TS][LDW], after the products the two f32 results
  // [2][TS][NC]; the planes of [x | 1] of the receivers (tile I) and of the
  // sources (tile J), [PL][TS][NC] each. wmma wants 32-byte aligned tiles.
  __shared__ __align__(128) unsigned char smem[W_BYTES + 2 * X_BYTES];
  __shared__ float xi_s[D][TS], xj_s[D][TS];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xi_p = reinterpret_cast<__nv_bfloat16*>(smem + W_BYTES);
  __nv_bfloat16* xj_p =
      reinterpret_cast<__nv_bfloat16*>(smem + W_BYTES + X_BYTES);
  float* res_s = reinterpret_cast<float*>(smem);

  {  // thread t loads particle t % TS of tile I (t < TS) or of tile J
    const bool recv = t < TS;
    const int k = t % TS;
    const size_t row = (size_t)(recv ? I : J) * TS + k;
    float x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = pos[row * D + d];
      (recv ? xi_s : xj_s)[d][k] = x[d];
    }
    __nv_bfloat16* xp = (recv ? xi_p : xj_p) + k * NC;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      split_store<PL>(c < D ? x[c] : (c == D ? 1.f : 0.f), xp + c, TS * NC);
  }
  __syncthreads();

  {  // w of pair (i, j): thread t takes column j = t % TS, every other row
    const int j = t % TS;
    float xj[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xj[d] = xj_s[d][j];
    const IntGrid g{};
    for (int i = t / TS; i < TS; i += THREADS / TS) {
      float dx[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj[d], xi_s[d][i]);
      const float w = pair_w<MODE_F32>(__fadd_rn(raw_d2<D>(dx), soft), g);
      split_store<PL>(w, w_s + i * LDW + j, TS * LDW);
    }
  }
  __syncthreads();

  // Warp m takes rows m0 .. m0 + 15 of both products, over K = TS in 16s.
  const int m0 = 16 * (t / 32);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> row_acc, col_acc;
  wmma::fill_fragment(row_acc, 0.f);
  wmma::fill_fragment(col_acc, 0.f);
#pragma unroll
  for (int k0 = 0; k0 < TS; k0 += 16) {
    {  // rows: W[m0.., k0..] (row-major) x [x_j | 1][k0.., :]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[PL];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[PL];
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        wmma::load_matrix_sync(a[p], w_s + p * TS * LDW + m0 * LDW + k0,
                               LDW);
        wmma::load_matrix_sync(b[p], xj_p + p * TS * NC + k0 * NC, NC);
      }
#pragma unroll
      for (int q = 0; q < NP; ++q)
        wmma::mma_sync(row_acc, a[pass_w(q)], b[pass_x(q)], row_acc);
    }
    if (!diag) {  // columns: W^T[m0.., k0..] = W[k0.., m0..] column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[PL];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[PL];
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        wmma::load_matrix_sync(a[p], w_s + p * TS * LDW + k0 * LDW + m0,
                               LDW);
        wmma::load_matrix_sync(b[p], xi_p + p * TS * NC + k0 * NC, NC);
      }
#pragma unroll
      for (int q = 0; q < NP; ++q)
        wmma::mma_sync(col_acc, a[pass_w(q)], b[pass_x(q)], col_acc);
    }
  }
  __syncthreads();  // every warp is done with w: the results take its bytes
  wmma::store_matrix_sync(res_s + m0 * NC, row_acc, NC, wmma::mem_row_major);
  if (!diag)
    wmma::store_matrix_sync(res_s + (TS + m0) * NC, col_acc, NC,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: thread t < TS receiver t's rows, t >= TS source t - TS's
  // columns (off the diagonal).
  if (t < TS) {
    const float* r = res_s + t * NC;
    float* out = part + (((size_t)I * T + J) * TS + t) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[d] = __fsub_rn(r[d], __fmul_rn(xi_s[d][t], r[D]));
  } else if (!diag) {
    const int j = t - TS;
    const float* c = res_s + (TS + j) * NC;
    float* out = part + (((size_t)J * T + I) * TS + j) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[d] = __fsub_rn(c[d], __fmul_rn(xj_s[d][j], c[D]));
  }
}

template <int D, int P>
void launch_mxu(const float* pos, const float* gm, int n, float soft,
                float* part, float* out, cudaStream_t s) {
  const int T = n / TS;
  sym_force_mxu<D, P><<<dim3(T, T), THREADS, 0, s>>>(pos, soft, part);
  launch_reduce<D, TS>(part, n, T, out, s, gm);
}

template <int D>
void launch_mxu_p(int precision, const float* pos, const float* gm, int n,
                  float soft, float* part, float* out, cudaStream_t s) {
  if (precision == 0)
    launch_mxu<D, 0>(pos, gm, n, soft, part, out, s);
  else if (precision == 1)
    launch_mxu<D, 1>(pos, gm, n, soft, part, out, s);
  else
    launch_mxu<D, 2>(pos, gm, n, soft, part, out, s);
}

}  // namespace

// The accumulation-offload sym kernel, equal masses: pos (n, dim) f32 with
// dim in {2, 3} and n a multiple of 64, gm (1,) f32 on the device (G m, only
// gm[0] is read), softening_sq > 0, precision 0 default, 1 high, 2 highest;
// part (T, T, 64, dim) f32 scratch, T = n / 64; out (n, dim) f32. Returns a
// CUDA error code (cudaGetLastError() after the launches).
extern "C" int nbody_sym_force_mxu(const float* pos, const float* gm, int n,
                                   int dim, float softening_sq, int precision,
                                   float* part, float* out, void* stream) {
  if (n <= 0 || n % TS != 0 || n / TS > 65535 || !(softening_sq > 0.f) ||
      (dim != 2 && dim != 3) || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2)
    launch_mxu_p<2>(precision, pos, gm, n, softening_sq, part, out, s);
  else
    launch_mxu_p<3>(precision, pos, gm, n, softening_sq, part, out, s);
  return (int)cudaGetLastError();
}
