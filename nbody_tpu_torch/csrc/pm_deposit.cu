// Deterministic segment sum on Hopper (sm_90a): the particle-mesh deposit.
//
// Replaces: no Pallas kernel. nbody_tpu/ops/pm.py deposits mass with
// jax.ops.segment_sum (ngp_deposit :41, cic_deposit :65), which XLA runs
// as a sequential scatter: grid[c] is the f32 sum of the weights whose key
// is c, added in particle order. A CUDA index_add_ / scatter_add_ adds
// with float atomics, in an order that changes from run to run, and the
// project binds every sum to a fixed order (the PM trajectories feed the
// chaos and multiverse studies), so the deposit is this kernel.
//
// Contract: given the cell keys sorted stably (torch.sort(stable=True), a
// deterministic radix sort, in the wrapper) and the permutation that sorts
// them, out[c] = prev[c] + s_c (or s_c when prev is null), where
// s_c = ((0 + w[p_0]) + w[p_1]) + ... over the particles p_0 < p_1 < ...
// whose key is c: the sequential scatter's sum, bit for bit, because a
// stable sort keeps particle order within a cell. CIC runs it once a
// corner with prev = the grid so far, JAX's grid = grid + segment_sum(..)
// in corner order. Every cell is written, an empty one as prev[c] (or 0),
// so the output needs no zeroing pass, and nothing is added atomically.
// Keys outside [0, cells) are never summed: no write leaves the grid.
//
// Design (the first, simple one): a block owns DB consecutive cells; two
// threads binary-search the block's range of sorted keys, then each
// thread binary-searches its cell's first key inside that range and walks
// its run, summing in order (__fadd_rn: no contraction, no reassociation).
// What bounds it on the H100: bytes, the sorted keys, the permutation and
// the weights read once and the grid written (plus prev read, CIC), over
// 3.35 TB/s; the searches cost ~log2(N) cached loads a block plus
// ~log2(run) a cell. Its weakness: a dense cell is summed by one thread
// alone, so a clustered late-time state serialises on its densest cells.

#include <cuda_runtime.h>

namespace {

constexpr int DB = 256;  // cells (threads) a block

// First index in [lo, hi) whose key is >= target (hi if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int lo, int hi, long long target) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((long long)keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(DB)
    pm_deposit_cells(const int* __restrict__ keys,
                     const long long* __restrict__ perm,
                     const float* __restrict__ w,
                     const float* __restrict__ prev, float* __restrict__ out,
                     int n, int cells) {
  __shared__ int range[2];
  const long long c0 = (long long)blockIdx.x * DB;
  if (threadIdx.x < 2)
    range[threadIdx.x] = lower_bound(keys, 0, n, c0 + threadIdx.x * DB);
  __syncthreads();
  const long long c = c0 + threadIdx.x;
  if (c >= cells) return;
  const int hi = range[1];
  float s = 0.0f;
  for (int k = lower_bound(keys, range[0], hi, c); k < hi && keys[k] == c;
       ++k)
    s = __fadd_rn(s, w[perm[k]]);
  out[c] = prev != nullptr ? __fadd_rn(prev[c], s) : s;
}

}  // namespace

// keys: n int32 cell keys sorted stably; perm: the n int64 indices that
// sort them (torch.sort's); w: n f32 weights in particle order; prev:
// `cells` f32 or null; out: `cells` f32 (may not alias prev). Launches on
// `stream`; returns the CUDA error of the launch.
extern "C" int nbody_pm_deposit(const int* keys, const long long* perm,
                                const float* w, const float* prev, float* out,
                                int n, int cells, void* stream) {
  if (n < 0 || cells <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)cells + DB - 1) / DB);
  pm_deposit_cells<<<blocks, DB, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, perm, w, prev, out, n, cells);
  return (int)cudaGetLastError();
}
