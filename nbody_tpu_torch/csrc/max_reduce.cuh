// The fixed reduction of per-block maxima of raw d^2, shared by
// max_dist_sq.cu (max_d2, pair_max) and sym_force.cu's fused max.
//
// A kernel keeps each block's running max and stores it with
// store_block_max; max_stage folds any number of such values into at most
// `capacity` per-block maxima (a capped grid-stride loop); max_d2_reduce
// takes the max of those in one block. The one-launch kernels (max_d2's
// single launch, pair_max's register-tiled one and the one-pass sym_force's
// fused max) fold theirs in the block that takes the last ticket instead
// (fold_by_ticket). Max is exact, so the result does not depend on the
// order: the fused max of sym_force is bitwise max_d2's.

#pragma once

#include <cuda_runtime.h>

namespace {

// Threads of max_stage and max_d2_reduce (and of max_dist_sq.cu's tiles).
constexpr int MAX_RT = 256;

// *slot = the max of `best` over the block's NT threads (thread 0 writes).
// Every thread of the block must call it.
template <int NT>
__device__ __forceinline__ void store_block_max(float best,
                                                float* __restrict__ slot) {
  __shared__ float red[NT];
  const int t = threadIdx.x;
  red[t] = best;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = fmaxf(red[t], red[t + s]);
    __syncthreads();
  }
  if (t == 0) *slot = red[0];
}

// The fold by ticket of a kernel's per-block maxima, in the kernel itself:
// the block stores its max in block_max[slot] and takes an integer ticket;
// the block that takes the last of `blocks` tickets folds block_max[0 ..
// blocks) into *out, counts the run (`count` nullable) and leaves the
// ticket 0 for the next launch. Max is exact, so the bits do not depend on
// which block folds. Every thread of the block calls it; `ticket` must not
// be shared with a launch running at the same time.
template <int NT>
__device__ __forceinline__ void fold_by_ticket(float best,
                                               float* __restrict__ block_max,
                                               int slot, int blocks,
                                               int* __restrict__ ticket,
                                               int* __restrict__ count,
                                               float* __restrict__ out) {
  const int t = threadIdx.x;
  store_block_max<NT>(best, block_max + slot);
  __shared__ int last;
  if (t == 0) {
    __threadfence();  // this block's max, before its ticket
    last = atomicAdd(ticket, 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;  // block-uniform
  __threadfence();
  float b = 0.f;
#pragma unroll 8
  for (int k = t; k < blocks; k += NT) b = fmaxf(b, __ldcg(block_max + k));
  store_block_max<NT>(b, out);
  if (t == 0) {
    if (count != nullptr) *count += 1;
    *ticket = 0;
  }
}

// block_max[blockIdx.x] = the max of in[k] over this block's grid-stride
// share of k in [0, n); returns at once when *skip != 0.
__global__ void __launch_bounds__(MAX_RT)
max_stage(const float* __restrict__ in, long long n,
          const int* __restrict__ skip, float* __restrict__ block_max) {
  if (skip != nullptr && *skip != 0) return;
  float best = 0.f;
  for (long long k = (long long)blockIdx.x * MAX_RT + threadIdx.x; k < n;
       k += (long long)gridDim.x * MAX_RT)
    best = fmaxf(best, in[k]);
  store_block_max<MAX_RT>(best, block_max + blockIdx.x);
}

// out[0] = the max of block_max[0..nb-1] (0 when *skip != 0); `count`
// (nullable) gains 1 when the launch was not skipped.
__global__ void __launch_bounds__(MAX_RT)
max_d2_reduce(const float* __restrict__ block_max, int nb,
              const int* __restrict__ skip, int* __restrict__ count,
              float* __restrict__ out) {
  const int t = threadIdx.x;
  if (skip != nullptr && *skip != 0) {
    if (t == 0) out[0] = 0.f;
    return;
  }
  if (t == 0 && count != nullptr) *count += 1;
  __shared__ float red[MAX_RT];
  float best = 0.f;
  for (int k = t; k < nb; k += MAX_RT) best = fmaxf(best, block_max[k]);
  red[t] = best;
  __syncthreads();
  for (int s = MAX_RT / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = fmaxf(red[t], red[t + s]);
    __syncthreads();
  }
  if (t == 0) out[0] = red[0];
}

}  // namespace
