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
// stable sort keeps particle order within a cell. Every add is __fadd_rn
// (no contraction, no reassociation), and nothing is added atomically.
// Keys outside [0, cells) are never summed: no write leaves the grid.
//
// Design (run-centric, nbody_pm_deposit_runs): three launches.
//  1. pm_deposit_fill writes the grid's base, vectorised: 0, or
//     prev[c] + 0 (bitwise prev + s_c below: (prev + 0) + s == prev + s
//     in round-to-nearest, a -0.0 in prev included), and zeroes the
//     long-run counter. An accumulating deposit fills nothing.
//  2. pm_deposit_runs: a thread a sorted particle; the thread at a run's
//     first index owns the run. keys[k + R] tells in one load whether the
//     run is longer than R (long_run): if so the owner appends k to the
//     work list (an int atomicAdd on the counter: the list's order varies
//     from run to run, no sum depends on it); otherwise it sums the run in
//     batches of 8, the batch's keys and permutation loaded together (the
//     first batch with the thread's own keys), then its weights, then the
//     adds in order: two latencies a batch, not two an add. Only occupied
//     cells are written.
//  3. pm_deposit_long: a block a listed run (persistent blocks, a grid of
//     at most the resident count, sized on the host without a read): the
//     block finds the run's end by a 256-way search (three rounds at
//     N = 262144); warps 1-7 stage the run's weights, read through the
//     permutation, into shared memory in pieces of 896, double-buffered,
//     while lane 0 of warp 0 adds the previous piece in particle order.
//
// In place (accumulate): cic_deposit's later corners add s_c into the
// running grid and touch only occupied cells, where the out-of-place chain
// wrote prev + 0 into every untouched cell. The two differ only where prev
// holds -0.0, and no deposit grid does: every sum starts at +0.0 and
// x + (-x) rounds to +0.0. The public segment_sum(prev=...) keeps the
// out-of-place contract for any prev (step 1), -0.0 included.
//
// What bounds it on the H100: bytes (the sorted keys, the int64
// permutation and the weights read once, the grid written) over 3.35 TB/s,
// or the longest run's chain of dependent FADDs (~4 cycles each at the SM
// clock), whichever is larger: an order-preserving sum of one cell cannot
// be split.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int FB = 256;   // fill: threads a block
constexpr int FILL_PER_SM = 16;
constexpr int RB = 256;   // run pass: sorted particles (threads) a block
constexpr int BATCH = 8;  // a short run's loads issued together
constexpr int LB = 256;   // long pass: threads a block, warp 0 adds
constexpr int STAGERS = LB - 32;
constexpr int PER = 4;                    // weights a stager a piece
constexpr int PIECE = STAGERS * PER;      // 896, a multiple of 8
constexpr int PAD = 8;                    // the adder's look-ahead reads
constexpr int LONG_PER_SM = 8;            // 2048 threads a SM / LB

// out = 0 or prev + 0 over `cells` cells (none when accumulating), float4
// at a time where both pointers are 16-byte aligned; zeroes the counter.
__global__ void __launch_bounds__(FB)
    pm_deposit_fill(const float* __restrict__ prev, float* __restrict__ out,
                    long long cells, int vec, int* __restrict__ long_count) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *long_count = 0;
  const long long stride = (long long)gridDim.x * FB;
  const long long first = (long long)blockIdx.x * FB + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long quads = cells >> 2;
    float4* o4 = reinterpret_cast<float4*>(out);
    const float4* p4 = reinterpret_cast<const float4*>(prev);
    for (long long i = first; i < quads; i += stride) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (prev != nullptr) {
        v = p4[i];
        v.x = __fadd_rn(v.x, 0.0f);
        v.y = __fadd_rn(v.y, 0.0f);
        v.z = __fadd_rn(v.z, 0.0f);
        v.w = __fadd_rn(v.w, 0.0f);
      }
      o4[i] = v;
    }
    done = quads << 2;
  }
  for (long long i = done + first; i < cells; i += stride)
    out[i] = prev != nullptr ? __fadd_rn(prev[i], 0.0f) : 0.0f;
}

__device__ __forceinline__ void write_cell(float* __restrict__ out, int c,
                                           float s, int add) {
  out[c] = add ? __fadd_rn(out[c], s) : s;
}

// The keys and permutation of sorted indices b .. b + BATCH - 1 below
// stop (-1 and 0 beyond it: -1 is no cell).
__device__ __forceinline__ void load_batch(const int* __restrict__ keys,
                                           const long long* __restrict__ perm,
                                           int b, int stop, int (&kk)[BATCH],
                                           long long (&pp)[BATCH]) {
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    kk[j] = b + j < stop ? keys[b + j] : -1;
    pp[j] = b + j < stop ? perm[b + j] : 0;
  }
}

__global__ void __launch_bounds__(RB)
    pm_deposit_runs(const int* __restrict__ keys,
                    const long long* __restrict__ perm,
                    const float* __restrict__ w, float* __restrict__ out,
                    int n, int cells, int long_run, int add,
                    int* __restrict__ long_starts,
                    int* __restrict__ long_count) {
  const int k = blockIdx.x * RB + threadIdx.x;
  if (k >= n) return;
  // Every load that depends on k alone is issued at once: the key, its
  // predecessor, the key R on, and the first batch.
  const long long last = (long long)k + long_run;
  const int stop = (int)(last < n ? last : (long long)n);
  const int key = keys[k];
  const int before = k > 0 ? keys[k - 1] : -1;
  const int at_last = last < n ? keys[last] : -1;
  int kk[BATCH];
  long long pp[BATCH];
  load_batch(keys, perm, k, stop, kk, pp);
  if (key < 0 || key >= cells) return;   // never summed
  if (before == key) return;             // not the run's first index
  if (at_last == key) {                  // longer than long_run
    long_starts[atomicAdd(long_count, 1)] = k;
    return;
  }
  // A short run: it ends before `stop`; its particles are a prefix of
  // each batch until one holds another key.
  float s = 0.0f;
  for (int b = k;;) {
    float ww[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) ww[j] = kk[j] == key ? w[pp[j]] : 0.0f;
    bool more = true;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (kk[j] == key)
        s = __fadd_rn(s, ww[j]);
      else
        more = false;
    }
    b += BATCH;
    if (!more || b >= stop) break;
    load_batch(keys, perm, b, stop, kk, pp);
  }
  write_cell(out, key, s, add);
}

// Stager t's share of a piece: the weights of sorted indices base + e,
// e = j * STAGERS + t < cnt, through the permutation, into buf[e].
__device__ __forceinline__ void stage_piece(float* buf,
                                            const long long* __restrict__ perm,
                                            const float* __restrict__ w,
                                            int base, int cnt, int t) {
  long long p[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = j * STAGERS + t;
    p[j] = e < cnt ? perm[base + e] : 0;
  }
  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = j * STAGERS + t < cnt ? w[p[j]] : 0.0f;
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (j * STAGERS + t < cnt) buf[j * STAGERS + t] = v[j];
}

// s + buf[0] + buf[1] + ... + buf[cnt - 1], in that order; the next eight
// values are read from shared memory while the current eight are added.
__device__ __forceinline__ float add_in_order(float s, const float* buf,
                                              int cnt) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  const int groups = cnt >> 3;
  float4 a = b4[0], b = b4[1];
  for (int g = 0; g < groups; ++g) {
    const float4 c = b4[2 * g + 2], d = b4[2 * g + 3];
    s = __fadd_rn(s, a.x);
    s = __fadd_rn(s, a.y);
    s = __fadd_rn(s, a.z);
    s = __fadd_rn(s, a.w);
    s = __fadd_rn(s, b.x);
    s = __fadd_rn(s, b.y);
    s = __fadd_rn(s, b.z);
    s = __fadd_rn(s, b.w);
    a = c;
    b = d;
  }
  for (int i = groups << 3; i < cnt; ++i) s = __fadd_rn(s, buf[i]);
  return s;
}

__global__ void __launch_bounds__(LB)
    pm_deposit_long(const int* __restrict__ keys,
                    const long long* __restrict__ perm,
                    const float* __restrict__ w, float* __restrict__ out,
                    int n, int long_run, int add,
                    const int* __restrict__ long_starts,
                    const int* __restrict__ long_count) {
  __shared__ __align__(16) float stage[2][PIECE + PAD];
  const int count = *long_count;
  const int t = threadIdx.x - 32;   // stager index (warps 1-7)
  for (int r = blockIdx.x; r < count; r += gridDim.x) {
    const int start = long_starts[r];
    const int key = keys[start];
    // The run's end: keys[lo] == key, and every index from hi on holds
    // another key (or hi == n). Each round narrows [lo, hi) 256-fold.
    long long lo = (long long)start + long_run, hi = n;
    while (hi - lo > 1) {
      const long long step = (hi - lo + LB - 1) / LB;
      const long long i = lo + threadIdx.x * step;
      const int c = __syncthreads_count(i < hi && keys[i] == key);
      hi = min(hi, lo + c * step);
      lo += (c - 1) * step;
    }
    const int len = (int)(hi - start);
    const int pieces = (len + PIECE - 1) / PIECE;
    if (t >= 0) stage_piece(stage[0], perm, w, start, min(len, PIECE), t);
    __syncthreads();
    float s = 0.0f;
    for (int p = 0; p < pieces; ++p) {
      if (t >= 0) {
        const int next = (p + 1) * PIECE;
        if (next < len)
          stage_piece(stage[(p + 1) & 1], perm, w, start + next,
                      min(len - next, PIECE), t);
      } else if (threadIdx.x == 0) {
        s = add_in_order(s, stage[p & 1], min(len - p * PIECE, PIECE));
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) write_cell(out, key, s, add);
  }
}

// The current device's SM count in *sms; returns the CUDA error.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(
                                  sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// keys: n int32 cell keys sorted stably; perm: the n int64 indices that
// sort them (torch.sort's); w: n f32 weights in particle order; prev:
// `cells` f32 or null; out: `cells` f32 (may not alias prev); long_run
// (R >= 1), the longest run a thread sums; accumulate: add into out in
// place (prev null), touching only occupied cells; scratch: int32 of
// 1 + ceil(n / (R + 1)), the long-run count then the work list. Launches
// pm_deposit_fill always, pm_deposit_runs when n > 0, pm_deposit_long
// when n > R, in that order on `stream`; returns the CUDA error.
extern "C" int nbody_pm_deposit_runs(const int* keys, const long long* perm,
                                     const float* w, const float* prev,
                                     float* out, int n, int cells,
                                     int long_run, int accumulate,
                                     int* scratch, void* stream) {
  if (n < 0 || cells <= 0 || long_run < 1 ||
      (accumulate && prev != nullptr))
    return (int)cudaErrorInvalidValue;
  int sm = 0;
  const cudaError_t err = sm_count(&sm);
  if (err != cudaSuccess) return (int)err;
  const long long sms = sm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long fill = accumulate ? 0 : cells;
  const int vec =
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(prev)) &
       15) == 0;
  long long fill_blocks = ((fill + 3) / 4 + FB - 1) / FB;
  fill_blocks = fill_blocks < 1 ? 1
                : fill_blocks > sms * FILL_PER_SM ? sms * FILL_PER_SM
                                                  : fill_blocks;
  pm_deposit_fill<<<(int)fill_blocks, FB, 0, st>>>(prev, out, fill, vec,
                                                   scratch);
  const int add = accumulate || prev != nullptr;
  if (n > 0)
    pm_deposit_runs<<<(n + RB - 1) / RB, RB, 0, st>>>(
        keys, perm, w, out, n, cells, long_run, add, scratch + 1, scratch);
  if (n > long_run) {
    long long blocks = ((long long)n + long_run) / ((long long)long_run + 1);
    blocks = blocks < sms * LONG_PER_SM ? blocks : sms * LONG_PER_SM;
    pm_deposit_long<<<(int)blocks, LB, 0, st>>>(keys, perm, w, out, n,
                                                long_run, add, scratch + 1,
                                                scratch);
  }
  return (int)cudaGetLastError();
}
