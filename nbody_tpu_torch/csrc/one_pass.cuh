// The one-pass design of the equal-mass sym kernels (sym_force.cu's
// sym_force_uniform and pair_sym_force.cu's pair_sym_force_uniform) on
// Hopper (sm_90a): each pair's w is computed once, t = w diff is formed once
// and added into the receiver's row sums and the source's reaction sums in
// the same iteration, as the TPU's equal-mass body does
// (nbody_tpu/ops/pallas_nbody.py:287-292, :1022-1031).
//
// Geometry. A block of OP_THREADS = 64 threads (two warps) owns a receiver
// tile of OP_RW = 256 receivers: lane l of warp w holds the OP_R = 4
// receivers w 128 + 32 r + l (r = 0..3) in registers, with their row sums.
// The block walks a segment of `seg` source tiles of BT = 64 sources, each
// staged in shared memory (double-buffered, one barrier a tile). A warp
// takes a source tile in batches of C sources (C = 8 at D = 2, 4 at D = 3):
// every lane evaluates its R x C pairs, adding each t to its row sums and to
// a register array v[C][D] of reaction partials (summed over its R
// receivers). The batch's reaction partials then fold across the 32 lanes
// in a fixed order: a reduce-scatter by halving (log2 C rounds of
// __shfl_xor_sync, lane offsets 16, 8, ...) and an all-reduce over the lane
// bits left (5 - log2 C rounds). No select is needed: lane l visits the
// batch's sources in the order c ^ f(l), f(l) = (l >> (5 - log2 C)) & (C - 1),
// so that its slot c and its partner's slot c + H hold the same source at
// every halving. A batch costs each lane D (C + 4 - log2 C) shuffles and as
// many adds for its R C pairs: 1.1 slots a pair at D = 2, C = 8, R = 4. The two
// warps' sums of a source tile meet in shared memory, warp 0 + warp 1, and
// go out as one reaction partial per (source tile, receiver tile).
//
// Partials (f32, no atomics): rpart (TI, nsegmax, OP_RW, D) row sums per
// receiver tile and segment, cpart (T, TI, BT, D) reaction sums per source
// tile and receiver tile, TI = ceil(T_receivers / OP_SUB), OP_SUB = 4 base
// tiles a receiver tile. A fixed-order reduction follows, so every launch
// gives the same bits.
//
// The full-tile rule holds by counts: set sizes are multiples of BT, and a
// receiver tile whose last 32-receiver rows fall past the end (T not a
// multiple of 4, as at 209728 = 3277 BT) skips them, warp-uniformly. Sources
// are always whole tiles.
//
// Numerics: csrc/nbody_common.cuh; t = __fmul_rn(w, dx) and both sums by
// __fadd_rn, so nothing is contracted into an FMA.
//
// Masses carried per particle (GM: the general pair_sym_force,
// pallas_nbody.py:1032-1039, and the general sym_force past 256 tiles,
// pallas_nbody.py:294-303's unflagged body). The same body with G m beside
// each position: a source's G m_j rides in the staged float4 (its .w at
// D = 3, its .z at D = 2, where the staged Vec widens from a float2 to a
// float4 {x, y, G m, 0}: still one shared load a source), and each lane
// holds its 4 receivers' G m_i in registers. A pair takes fr = G m_j w and
// fc = G m_i w, then row += fr dx and v += fc dx by fmaf, as the two-pass
// tile sums them: 2 multiplies and 2 D FMAs, as many issue slots as the
// t-form's D multiplies and 2 D adds. The reactions fold and are stored
// negated as in the equal-mass body; the reduction scales nothing. Four
// more live registers than the equal-mass body: its instances take 96
// registers at most (OP_MIN_BLOCKS_GM, 20 resident warps a SM) so that none
// spills.
//
// The fused max (EMIT, sym_one_pass only, int modes: emit_max,
// pallas_nbody.py:294-303): each lane also keeps the max of the raw d^2 of
// the pairs it evaluates, one fmaxf a pair, and the launch folds the
// blocks' maxima by ticket (max_reduce.cuh), so a fused launch is the
// force launch and its reduction, where the two-pass tile took four.
//
// The int chain by table (the kernels' TABLE instances, MODE_INT launches
// up to hopper_nbody.INT_TABLE_MAX_LEVELS levels): each block builds the
// launch's bin edges and weights from the accurate chain in its prologue
// (op_build_table, further down) and takes a pair's w by one shared load
// and a compare where the block proves that all its pairs fall in the
// table (op_reach), the same bits as the chain at ~21 SASS instructions a
// pair against ~54 (int4, D = 2). The chain instances, the float modes'
// included, are the body as it was.

#pragma once

#include "max_reduce.cuh"
#include "nbody_common.cuh"

namespace {

constexpr int OP_WARPS = 2;
constexpr int OP_THREADS = 32 * OP_WARPS;
constexpr int OP_R = 4;                       // receivers a lane
constexpr int OP_RW = OP_THREADS * OP_R;      // receivers a block: 256
constexpr int OP_SUB = OP_RW / BT;            // base tiles a receiver tile
constexpr int OP_MIN_BLOCKS = 12;             // 24 resident warps a SM
constexpr int OP_MIN_BLOCKS_GM = 10;          // masses per particle: 20
static_assert(OP_THREADS == BT, "one thread a source stages and combines");

// Sources a batch, and the source layout in shared memory: D = 3 padded to
// a float4, one 16-byte load a source, G m in its .w when GM; D = 2 a
// float2, or a float4 {x, y, G m, 0} when GM.
template <int D, bool GM = false>
struct OpTraits;
template <>
struct OpTraits<2, false> {
  static constexpr int C = 8;
  using Vec = float2;
};
template <>
struct OpTraits<2, true> {
  static constexpr int C = 8;
  using Vec = float4;
};
template <bool GM>
struct OpTraits<3, GM> {
  static constexpr int C = 4;
  using Vec = float4;
};

__device__ __forceinline__ void vec_get(const float2& s, float (&x)[2],
                                        float& gm) {
  x[0] = s.x;
  x[1] = s.y;
  gm = 0.f;
}
__device__ __forceinline__ void vec_get(const float4& s, float (&x)[2],
                                        float& gm) {
  x[0] = s.x;
  x[1] = s.y;
  gm = s.z;
}
__device__ __forceinline__ void vec_get(const float4& s, float (&x)[3],
                                        float& gm) {
  x[0] = s.x;
  x[1] = s.y;
  x[2] = s.z;
  gm = s.w;
}
template <typename Vec>
__device__ __forceinline__ Vec vec_make(const float (&x)[2], float gm) {
  if constexpr (std::is_same<Vec, float2>::value)
    return make_float2(x[0], x[1]);
  else
    return make_float4(x[0], x[1], gm, 0.f);
}
template <typename Vec>
__device__ __forceinline__ Vec vec_make(const float (&x)[3], float gm) {
  return make_float4(x[0], x[1], x[2], gm);
}

// Lane l's source order within a batch: slot c holds source c ^ op_perm(l),
// the lane bits that the halving rounds pair (bits 4, 3, ... of l).
template <int C>
__device__ __forceinline__ int op_perm(int lane) {
  static_assert(C == 2 || C == 4 || C == 8 || C == 16, "C a power of 2");
  constexpr int LOG2C = C == 16 ? 4 : (C == 8 ? 3 : (C == 4 ? 2 : 1));
  return (lane >> (5 - LOG2C)) & (C - 1);
}

// The batch's reaction partials across the warp, in a fixed order: after
// it v[0] holds the warp's sum for source op_perm(lane) of the batch, the
// same bits in the 32 / C lanes that share it.
// Halving rounds (H live slots kept, lane offset OFF), then all-reduce
// rounds on slot 0; template-recursive so that every slot index is a
// constant and v stays in registers.
template <int H, int OFF, int C, int D>
__device__ __forceinline__ void op_halve(float (&v)[C][D]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int m = 0; m < H; ++m)
#pragma unroll
      for (int d = 0; d < D; ++d)
        v[m][d] = __fadd_rn(v[m][d],
                            __shfl_xor_sync(0xffffffffu, v[m + H][d], OFF));
    op_halve<H / 2, OFF / 2, C, D>(v);
  } else if constexpr (OFF >= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      v[0][d] = __fadd_rn(v[0][d], __shfl_xor_sync(0xffffffffu, v[0][d], OFF));
    op_halve<0, OFF / 2, C, D>(v);
  }
}

template <int C, int D>
__device__ __forceinline__ void op_fold(float (&v)[C][D]) {
  op_halve<C / 2, 16, C, D>(v);
}

// What a 32-receiver row r of a lane does against the current source tile:
// both sums, the row sums alone (a diagonal tile: every source of the tile,
// the self pair skipped when self-masked), or nothing.
enum OpKind { OP_BOTH = 0, OP_ROWS = 1, OP_NONE = 2 };

// The int chain by table (the kernels' TABLE instances, which an int
// launch with int_table set runs: hopper_nbody.int_chain_design). In one
// launch the grid scalars are
// fixed, and every operation of the chain's index k = rint(log(x) norm_a +
// norm_b) is monotone in x = max(d^2 + eps^2, min_d2) (fmul by norm_a >= 0,
// fadd, rint, and the accurate logf, which the card's exhaustive test
// confirms float by float over the grids it runs). So k is a step
// function of x, and the weight expf(min(k arg_k + arg_0, arg_cap)) a
// function of k alone. The block builds, in its prologue and in shared
// memory, from the chain's own operations (int_chain_k / int_chain_w):
//
//   * the edges e_j, j = 1..E: the least float x >= lo = max(eps^2,
//     min_d2) at which k reaches k0 + j, k0 = k(lo), by bisection over the
//     bit patterns of the positive floats, one thread an edge (+inf where
//     no float reaches it); E = levels + OP_TABLE_SLACK bins;
//   * the weights w_i of bins k0 + i, i < E;
//   * buckets of the bit pattern, bucket(x) = bits(x) >> shift, at the
//     largest shift at which the first m edges fall in m distinct buckets
//     (m as large as op_table_buckets(levels) buckets allow): each bucket
//     holds at most one edge, as {edge (or +inf), w below it, w from it
//     on}. The table covers [lo, e_m).
//
// A pair then costs a max, a shift, an address, one 16-byte shared load, a
// compare and a select, and gets exactly the chain's w, on one condition:
// lo <= x < e_m. The block proves it once (op_reach): every coordinate
// of its receivers and of its segment's sources finite, and the d^2 of
// their bounding boxes' far corners, formed by the same monotone float
// operations as a pair's, below e_m. A block that cannot (bounds stale
// by more than the table's slack, coordinates not finite, an invalid grid:
// lo not a positive finite float, or k0 not an integer below 2^22) runs
// every pair on the accurate chain and counts itself in `fallbacks`
// (op_run_table): the weights are the chain's, bit for bit, whatever the
// bounds. The slack and
// the bucket count are the host's too (hopper_nbody.int_table_bytes sizes
// the dynamic shared memory).
constexpr int OP_TABLE_SLACK = 8;

__host__ __device__ constexpr int op_table_edges(int levels) {
  return levels + OP_TABLE_SLACK;
}

// Four buckets an edge and a few: the largest shift puts a bucket at more
// than half the least edge spacing, in units of the bit pattern, whose
// spacings differ by at most a factor of 2 over an octave.
__host__ __device__ constexpr int op_table_buckets(int levels) {
  return 4 * op_table_edges(levels) + 8;
}

__host__ __device__ constexpr size_t op_table_bytes(int levels) {
  return (size_t)op_table_buckets(levels) * sizeof(float4) +
         (size_t)(2 * op_table_edges(levels) + 1) * sizeof(float);
}

// Whether a table of `levels` fits the dynamic shared memory a launch takes
// without an opt-in (48 KiB).
__host__ __device__ constexpr bool op_table_fits(int levels) {
  return levels >= 1 && op_table_bytes(levels) <= 48 * 1024;
}

struct OpTable {
  const float4* bucket;  // indexed by bits(x) >> shift: the buckets - base
  int shift;
  float end;             // e_m: the table covers [lo, end); -inf if empty
  const volatile IntGrid* grid;  // the chain's grid in shared memory
};

// Where a body takes its weights: the mode's pair_w on the grid in
// registers (OP_W_CHAIN), the block's table (OP_W_TABLE), or pair_w on the
// grid read from shared memory at each use (OP_W_SHARED_CHAIN: the table
// kernels' chain, four registers lighter, the same bits).
enum OpWeights { OP_W_CHAIN = 0, OP_W_TABLE = 1, OP_W_SHARED_CHAIN = 2 };

__device__ __forceinline__ IntGrid op_grid(const volatile IntGrid& v) {
  IntGrid g;
  g.norm_a = v.norm_a;
  g.norm_b = v.norm_b;
  g.arg_k = v.arg_k;
  g.arg_0 = v.arg_0;
  g.arg_cap = v.arg_cap;
  g.min_d2 = v.min_d2;
  return g;
}

// The table's w of a softened d^2 whose x = max(d^2, min_d2) lies in
// [lo, end): the chain's, bit for bit.
__device__ __forceinline__ float op_table_w(float d2, const IntGrid& g,
                                            const OpTable& tb) {
  const float x = fmaxf(d2, g.min_d2);
  const float4 e = tb.bucket[__float_as_uint(x) >> tb.shift];
  return x >= e.x ? e.z : e.y;
}

// The least float x at or above bit pattern lo_u (where the chain's k is
// below `target`) at which k reaches target; +inf if none does.
__device__ __forceinline__ float op_table_edge(unsigned lo_u, float target,
                                               const IntGrid& g) {
  unsigned lo = lo_u, hi = 0x7f800000u;  // +inf
  if (!(int_chain_k<MODE_INT>(__uint_as_float(hi), g) >= target))
    return __uint_as_float(hi);
  while (hi - lo > 1) {
    const unsigned mid = lo + (hi - lo) / 2;
    if (int_chain_k<MODE_INT>(__uint_as_float(mid), g) >= target)
      hi = mid;
    else
      lo = mid;
  }
  return __uint_as_float(hi);
}

// Builds the block's table in `smem` (op_table_bytes(levels), 16-byte
// aligned) from the grid g and eps^2 = soft; every thread of the block
// calls it (three barriers). meta, if not null, receives {m, shift, base,
// buckets used} (the card's test export).
__device__ __forceinline__ OpTable op_build_table(const IntGrid& g,
                                                  float soft, int levels,
                                                  float4* smem, int* meta) {
  __shared__ int ctl[3];  // shift, base, m
  const int t = threadIdx.x;
  const int E = op_table_edges(levels);
  float* edge = reinterpret_cast<float*>(smem + op_table_buckets(levels));
  float* w = edge + E + 1;  // edge[1..E], w[0..E-1]
  const float lo = fmaxf(soft, g.min_d2);
  const unsigned lo_u = __float_as_uint(lo);
  const float k0 = int_chain_k<MODE_INT>(lo, g);
  const bool valid = lo > 0.f && lo_u < 0x7f800000u && fabsf(k0) < 4194304.f;
  if (valid) {
    for (int j = t + 1; j <= E; j += blockDim.x)
      edge[j] = op_table_edge(lo_u, k0 + (float)j, g);
    for (int i = t; i < E; i += blockDim.x)
      w[i] = int_chain_w<MODE_INT>(i == 0 ? k0 : k0 + (float)i, g);
  }
  __syncthreads();
  if (t < 32) {
    // Lane s: how many edges the buckets of shift s keep apart.
    const unsigned base = lo_u >> t;
    int m = 0;
    if (valid) {
      int prev = -1;
      for (int j = 1; j <= E; ++j) {
        const int r = (int)((__float_as_uint(edge[j]) >> t) - base);
        if (r <= prev || r >= op_table_buckets(levels)) break;
        prev = r;
        m = j;
      }
    }
    int key = m * 32 + t;  // the most edges; then the largest shift
    for (int off = 16; off > 0; off >>= 1)
      key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
    if (t == 0) {
      ctl[0] = key & 31;
      ctl[1] = (int)(lo_u >> (key & 31));
      ctl[2] = key >> 5;
    }
  }
  __syncthreads();
  const int shift = ctl[0];
  const unsigned base = (unsigned)ctl[1];
  const int m = ctl[2];
  auto rel = [&](float x) {
    return (int)((__float_as_uint(x) >> shift) - base);
  };
  // Bin i's buckets: those after the one that holds e_i, up to the one
  // that holds e_{i+1}; x never reaches e_m (op_reach), so the last
  // bucket's upper weight is NaN.
  for (int i = t; i < m; i += blockDim.x) {
    const int last = rel(edge[i + 1]);
    const float up = i + 1 < m ? w[i + 1] : __int_as_float(0x7fffffff);
    for (int b = i == 0 ? 0 : rel(edge[i]) + 1; b < last; ++b)
      smem[b] = make_float4(__int_as_float(0x7f800000), w[i], w[i], 0.f);
    smem[last] = make_float4(edge[i + 1], w[i], up, 0.f);
  }
  if (t == 0 && meta != nullptr) {
    meta[0] = m;
    meta[1] = shift;
    meta[2] = (int)base;
    meta[3] = m > 0 ? rel(edge[m]) + 1 : 0;
  }
  __syncthreads();
  return OpTable{smem - base, shift,
                 m > 0 ? edge[m] : __int_as_float(0xff800000), nullptr};
}

// The block's bound on x = max(d^2 + eps^2, min_d2) over every pair of
// its receivers (receiver tile I of recv, the lane's OP_R of op_block's;
// zero past n_recv, as op_block holds them: inside the bound) and the
// sources of tiles [Jb, Je) of src: from the bounding boxes, per dimension
// the larger of hi_s - lo_r and hi_r - lo_s, then raw_d2's operations,
// + soft, max with min_d2. Each operation is monotone, so a pair's
// computed x is at most it; +inf if a coordinate is not finite (its pairs
// could form NaN). One barrier.
template <int D>
__device__ __forceinline__ float op_reach(const float* __restrict__ recv,
                                          int n_recv, int I,
                                          const float* __restrict__ src,
                                          int Jb, int Je, float soft,
                                          float min_d2) {
  __shared__ float part[OP_WARPS][4 * D + 1];
  const int t = threadIdx.x;
  const int i_first = I * OP_RW + (t >> 5) * 32 * OP_R + (t & 31);
  float lr[D], hr[D], ls[D], hs[D];
  bool bad = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    lr[d] = ls[d] = __int_as_float(0x7f800000);
    hr[d] = hs[d] = -lr[d];
  }
#pragma unroll
  for (int r = 0; r < OP_R; ++r) {
    const int i = i_first + 32 * r;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float v = i < n_recv ? recv[(size_t)i * D + d] : 0.f;
      lr[d] = fminf(lr[d], v);
      hr[d] = fmaxf(hr[d], v);
      bad |= !(fabsf(v) <= 3.402823466e38f);
    }
  }
  for (size_t j = (size_t)Jb * BT + t; j < (size_t)Je * BT; j += OP_THREADS)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float v = src[j * D + d];
      ls[d] = fminf(ls[d], v);
      hs[d] = fmaxf(hs[d], v);
      bad |= !(fabsf(v) <= 3.402823466e38f);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      lr[d] = fminf(lr[d], __shfl_xor_sync(0xffffffffu, lr[d], off));
      hr[d] = fmaxf(hr[d], __shfl_xor_sync(0xffffffffu, hr[d], off));
      ls[d] = fminf(ls[d], __shfl_xor_sync(0xffffffffu, ls[d], off));
      hs[d] = fmaxf(hs[d], __shfl_xor_sync(0xffffffffu, hs[d], off));
    }
  bad = __any_sync(0xffffffffu, bad);
  if ((t & 31) == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      part[t >> 5][d] = lr[d];
      part[t >> 5][D + d] = hr[d];
      part[t >> 5][2 * D + d] = ls[d];
      part[t >> 5][3 * D + d] = hs[d];
    }
    part[t >> 5][4 * D] = bad ? 1.f : 0.f;
  }
  __syncthreads();
  float far[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float a = fminf(part[0][d], part[1][d]);
    const float b = fmaxf(part[0][D + d], part[1][D + d]);
    const float c = fminf(part[0][2 * D + d], part[1][2 * D + d]);
    const float e = fmaxf(part[0][3 * D + d], part[1][3 * D + d]);
    far[d] = fmaxf(__fsub_rn(e, a), __fsub_rn(b, c));
  }
  if (part[0][4 * D] != 0.f || part[1][4 * D] != 0.f)
    return __int_as_float(0x7f800000);
  return fmaxf(__fadd_rn(raw_d2<D>(far), soft), min_d2);
}

// One source tile against the lane's R receivers; the warp's reaction sums
// of the tile's BT sources go to colw[BT][D]. GENERIC honours kind[r] (the
// diagonal band and a ragged receiver tile); otherwise every row is OP_BOTH.
// GM: masses per particle, the source's G m staged with it and the
// receivers' in gmi. EMIT: best takes the max of the raw d^2 of every pair
// evaluated (an OP_NONE row evaluates none). W: where w comes from
// (OpWeights).
template <int MODE, int D, bool GENERIC, bool GM, bool EMIT, int W>
__device__ __forceinline__ void op_tile(
    const typename OpTraits<D, GM>::Vec* __restrict__ xs,
    const float (&xi)[OP_R][D], const float (&gmi)[OP_R],
    float (&row)[OP_R][D], float soft, const IntGrid& g, const OpTable& tb,
    int lane, const int (&kind)[OP_R], int self_masked,
    float* __restrict__ colw, float& best) {
  constexpr int C = OpTraits<D, GM>::C;
  const int f = op_perm<C>(lane);
#pragma unroll 1
  for (int cb = 0; cb < BT; cb += C) {
    float v[C][D];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int src = cb + (c ^ f);
      float xj[D], gmj;
      vec_get(xs[src], xj, gmj);
#pragma unroll
      for (int d = 0; d < D; ++d) v[c][d] = 0.f;
#pragma unroll
      for (int r = 0; r < OP_R; ++r) {
        if (GENERIC && kind[r] == OP_NONE) continue;
        float dx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dx[d] = __fsub_rn(xj[d], xi[r][d]);
        const float r2 = raw_d2<D>(dx);
        if (EMIT) best = fmaxf(best, r2);
        const float w =
            W == OP_W_TABLE ? op_table_w(__fadd_rn(r2, soft), g, tb)
            : W == OP_W_SHARED_CHAIN
                ? pair_w<MODE>(__fadd_rn(r2, soft), op_grid(*tb.grid))
                : pair_w<MODE>(__fadd_rn(r2, soft), g);
        if (GENERIC && kind[r] == OP_ROWS) {
          // The receiver's index in the tile is 32 (r & 1) + lane.
          if (self_masked && src == 32 * (r & 1) + lane) continue;
          const float fr = GM ? __fmul_rn(gmj, w) : w;
#pragma unroll
          for (int d = 0; d < D; ++d)
            row[r][d] = GM ? fmaf(fr, dx[d], row[r][d])
                           : __fadd_rn(row[r][d], __fmul_rn(w, dx[d]));
          continue;
        }
        if constexpr (GM) {
          const float fr = __fmul_rn(gmj, w);
          const float fc = __fmul_rn(gmi[r], w);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            row[r][d] = fmaf(fr, dx[d], row[r][d]);
            v[c][d] = (GENERIC || r > 0) ? fmaf(fc, dx[d], v[c][d])
                                         : __fmul_rn(fc, dx[d]);
          }
        } else {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float t = __fmul_rn(w, dx[d]);
            row[r][d] = __fadd_rn(row[r][d], t);
            v[c][d] = (GENERIC || r > 0) ? __fadd_rn(v[c][d], t) : t;
          }
        }
      }
    }
    op_fold<C, D>(v);
    if ((lane & (32 / C - 1)) == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) colw[(cb + f) * D + d] = v[0][d];
    }
  }
}

// Source tile J's positions (and G m when GM), one per thread (t < BT).
template <int D, bool GM>
__device__ __forceinline__ typename OpTraits<D, GM>::Vec op_load_src(
    const float* __restrict__ src, const float* __restrict__ gm, int J,
    int t) {
  const size_t j = (size_t)J * BT + t;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = src[j * D + d];
  return vec_make<typename OpTraits<D, GM>::Vec>(x, GM ? gm[j] : 0.f);
}

// The block body shared by both kernels: receiver tile I (OP_RW receivers
// from `recv`, n_recv of them, a multiple of BT) against source tiles
// [Jb, Je) of `src`. Row sums go to rpart[I][S], the reaction sums of
// source tile J to cpart[J][I] (negated when NEG). kind_of(r_tile, J) gives
// a row's OpKind from its base tile index and J; `generic_until` is the
// first J past the diagonal band (-1 for none), `ragged` whether some row of
// this receiver tile falls past n_recv. GM: gm_recv and gm_src hold the
// sets' G m (unread otherwise). W: where the weights come from (OpWeights;
// tb holds the table and the shared grid, op_run_table); but for
// OP_W_CHAIN the row sums go to `rows`, for the caller to store
// (op_store_rows). Returns the lane's max of the raw d^2 of the pairs it
// evaluated under EMIT, else 0.
template <int MODE, int D, bool NEG, bool GM, bool EMIT, int W,
          typename KindOf>
__device__ __forceinline__ float op_block(
    const float* __restrict__ recv, const float* __restrict__ gm_recv,
    int n_recv, const float* __restrict__ src,
    const float* __restrict__ gm_src, const float* __restrict__ bounds,
    int levels, float arg_cap, float min_d2, int self_masked, int I, int S,
    int TI, int nsegmax, int Jb, int Je, int generic_until, bool ragged,
    KindOf kind_of, float* __restrict__ rpart, float* __restrict__ cpart,
    const OpTable& tb, float (&rows)[OP_R][D]) {
  using Vec = typename OpTraits<D, GM>::Vec;
  __shared__ Vec xs[2][BT];
  __shared__ float colbuf[2][OP_WARPS][BT * D];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i_first = I * OP_RW + warp * 32 * OP_R;
  const int T0 = I * OP_SUB;  // base tile of the receiver tile's first row

  float xi[OP_R][D], row[OP_R][D], gmi[OP_R];
#pragma unroll
  for (int r = 0; r < OP_R; ++r) {
    const int i = i_first + 32 * r + lane;
    gmi[r] = GM && i < n_recv ? gm_recv[i] : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xi[r][d] = i < n_recv ? recv[(size_t)i * D + d] : 0.f;
      row[r][d] = 0.f;
    }
  }
  const float soft = bounds[2];
  const IntGrid g = mode_grid<MODE>(bounds, levels, arg_cap, min_d2);
  float best = 0.f;

  xs[0][t] = op_load_src<D, GM>(src, gm_src, Jb, t);
  __syncthreads();
  for (int J = Jb, k = 0; J < Je; ++J, ++k) {
    const int buf = k & 1;
    // The next tile into the other buffer (every thread has read it, at
    // the last barrier): in the table kernels straight to shared memory,
    // so that no register holds it over the tile; else held and stored
    // after.
    Vec nxt{};
    if (J + 1 < Je) {
      if constexpr (W != OP_W_CHAIN)
        xs[buf ^ 1][t] = op_load_src<D, GM>(src, gm_src, J + 1, t);
      else
        nxt = op_load_src<D, GM>(src, gm_src, J + 1, t);
    }
    float* colw = colbuf[buf][warp];
    if (J < generic_until || ragged) {
      int kind[OP_R];
#pragma unroll
      for (int r = 0; r < OP_R; ++r)
        kind[r] = kind_of(T0 + (warp * 32 * OP_R + 32 * r) / BT, J);
      op_tile<MODE, D, true, GM, EMIT, W>(xs[buf], xi, gmi, row, soft, g, tb,
                                          lane, kind, self_masked, colw,
                                          best);
    } else {
      const int none[OP_R] = {};
      op_tile<MODE, D, false, GM, EMIT, W>(xs[buf], xi, gmi, row, soft, g,
                                           tb, lane, none, 0, colw, best);
    }
    if constexpr (W == OP_W_CHAIN) xs[buf ^ 1][t] = nxt;
    __syncthreads();
    // Tile J's reactions: warp 0 + warp 1, one thread a source.
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float s = colbuf[buf][0][t * D + d];
#pragma unroll
      for (int w = 1; w < OP_WARPS; ++w)
        s = __fadd_rn(s, colbuf[buf][w][t * D + d]);
      cpart[(((size_t)J * TI + I) * BT + t) * D + d] = NEG ? -s : s;
    }
  }
  if constexpr (W != OP_W_CHAIN) {
#pragma unroll
    for (int r = 0; r < OP_R; ++r)
#pragma unroll
      for (int d = 0; d < D; ++d) rows[r][d] = row[r][d];
    return best;
  }
  float* out = rpart + (((size_t)I * nsegmax + S) * OP_RW + warp * 32 * OP_R +
                        lane) * D;
#pragma unroll
  for (int r = 0; r < OP_R; ++r)
#pragma unroll
    for (int d = 0; d < D; ++d) out[32 * r * D + d] = row[r][d];
  return best;
}

// The lane's row sums of receiver tile I, segment S, to rpart, as
// op_block stores them.
template <int D>
__device__ __forceinline__ void op_store_rows(const float (&row)[OP_R][D],
                                              float* __restrict__ rpart,
                                              int I, int S, int nsegmax) {
  const int t = threadIdx.x;
  float* out = rpart + (((size_t)I * nsegmax + S) * OP_RW +
                        (t >> 5) * 32 * OP_R + (t & 31)) * D;
#pragma unroll
  for (int r = 0; r < OP_R; ++r)
#pragma unroll
    for (int d = 0; d < D; ++d) out[32 * r * D + d] = row[r][d];
}

// The table kernels' block (MODE_INT): op_block's arguments, the block's
// table built (op_build_table, in the launch's dynamic shared memory) and
// the chain's grid put in shared memory; then op_block on the table where
// op_reach proves that every pair falls in it, else on the chain (the grid
// from shared memory), counted in *fallbacks. A ragged receiver tile
// (pair_one_pass's last, rows past the set) takes the chain uncounted: the
// table's body has no ragged rows, and so holds no row kinds over its walk.
template <int D, bool NEG, bool GM, bool EMIT, typename KindOf>
__device__ __forceinline__ float op_run_table(
    const float* __restrict__ recv, const float* __restrict__ gm_recv,
    int n_recv, const float* __restrict__ src,
    const float* __restrict__ gm_src, const float* __restrict__ bounds,
    int levels, float arg_cap, float min_d2, int self_masked, int I, int S,
    int TI, int nsegmax, int Jb, int Je, int generic_until, bool ragged,
    KindOf kind_of, float* __restrict__ rpart, float* __restrict__ cpart,
    int* __restrict__ fallbacks) {
  extern __shared__ float4 op_table_smem[];
  __shared__ IntGrid grid;
  const float soft = bounds[2];
  const IntGrid g = int_grid(bounds, levels, arg_cap, min_d2);
  if (threadIdx.x == 0) grid = g;
  const float reach = op_reach<D>(recv, n_recv, I, src, Jb, Je, soft, min_d2);
  OpTable tb = op_build_table(g, soft, levels, op_table_smem, nullptr);
  tb.grid = &grid;
  // A warp vote of a block-wide value: the branch is uniform, so the body
  // keeps the block's bookkeeping in uniform registers. The rows are
  // stored once, after either body.
  const bool covered = __all_sync(0xffffffffu, reach < tb.end);
  float row[OP_R][D];
  float best;
  if (covered && !ragged) {
    best = op_block<MODE_INT, D, NEG, GM, EMIT, OP_W_TABLE>(
        recv, gm_recv, n_recv, src, gm_src, bounds, levels, arg_cap, min_d2,
        self_masked, I, S, TI, nsegmax, Jb, Je, generic_until, false, kind_of,
        rpart, cpart, tb, row);
  } else {
    if (!covered && threadIdx.x == 0 && fallbacks != nullptr)
      atomicAdd(fallbacks, 1);
    best = op_block<MODE_INT, D, NEG, GM, EMIT, OP_W_SHARED_CHAIN>(
        recv, gm_recv, n_recv, src, gm_src, bounds, levels, arg_cap, min_d2,
        self_masked, I, S, TI, nsegmax, Jb, Je, generic_until, ragged,
        kind_of, rpart, cpart, tb, row);
  }
  op_store_rows<D>(row, rpart, I, S, nsegmax);
  return best;
}

// One set (sym_force_uniform, or with GM the general sym_force):
// receiver tile I = blockIdx.y walks source tiles J from T0 = OP_SUB I (its
// diagonal band first) to T - 1, in segments of `seg` tiles,
// S = blockIdx.x; blocks past the last segment evaluate nothing. Band
// rows: a row of base tile a against J takes both sums for a < J, the full
// row sums at a == J, nothing for a > J (that pair is the row's reaction
// from tile J's rows) or a >= T. Only the last receiver tile can hold rows
// past T (a >= T, when T is not a multiple of OP_SUB), and it visits only
// J < T < T0 + OP_SUB, the band, so the non-generic tile never meets them.
//
// EMIT (the fused max, int modes): every unordered pair is evaluated once
// by the walk above (a row against its own tile's sources includes the
// self pair, whose d^2 is 0); each lane keeps the max of the raw d^2 it
// formed, op for op as max_dist_sq.cu forms it (x_j - x_i: the subtraction
// is antisymmetric in IEEE arithmetic, so either order gives the same
// square), and the block's max goes to fold_by_ticket over all gridDim.x
// gridDim.y blocks, those past the last segment with 0: *max_out is
// bitwise max_d2's, and the forces are the same bits as without it.
//
// TABLE (MODE_INT): the table kernel, op_run_table's weights, its blocks
// that fall back to the chain counted in *fallbacks (may be null).
template <int MODE, int D, bool GM, bool EMIT, bool TABLE = false>
__global__ void __launch_bounds__(OP_THREADS,
                                  GM ? OP_MIN_BLOCKS_GM : OP_MIN_BLOCKS)
sym_one_pass(const float* __restrict__ pos, const float* __restrict__ gm,
             const float* __restrict__ bounds, int n, int levels,
             float arg_cap, float min_d2, int self_masked, int seg,
             float* __restrict__ rpart, float* __restrict__ cpart,
             float* __restrict__ block_max, int* __restrict__ ticket,
             float* __restrict__ max_out, int* __restrict__ fallbacks) {
  const int S = blockIdx.x;
  const int I = blockIdx.y;
  const int T = n / BT;
  const int T0 = I * OP_SUB;
  const int Jb = T0 + S * seg;
  float best = 0.f;
  if (Jb < T) {  // block-uniform
    const int Je = min(T, Jb + seg);
    auto kind_of = [T](int a, int J) {
      return a >= T || a > J ? OP_NONE : (a == J ? OP_ROWS : OP_BOTH);
    };
    if constexpr (TABLE)
      best = op_run_table<D, false, GM, EMIT>(
          pos, gm, n, pos, gm, bounds, levels, arg_cap, min_d2, self_masked,
          I, S, gridDim.y, gridDim.x, Jb, Je, T0 + OP_SUB, false, kind_of,
          rpart, cpart, fallbacks);
    else {
      float unused[OP_R][D];
      best = op_block<MODE, D, false, GM, EMIT, OP_W_CHAIN>(
          pos, gm, n, pos, gm, bounds, levels, arg_cap, min_d2, self_masked,
          I, S, gridDim.y, gridDim.x, Jb, Je, T0 + OP_SUB, false, kind_of,
          rpart, cpart, OpTable{}, unused);
    }
  }
  if constexpr (EMIT)
    fold_by_ticket<OP_THREADS>(best, block_max,
                               blockIdx.y * gridDim.x + blockIdx.x,
                               gridDim.x * gridDim.y, ticket, nullptr,
                               max_out);
}

// Two disjoint sets (pair_sym_force_uniform, or with GM the general
// pair_sym_force): receiver tile I = blockIdx.y of A against segment
// S = blockIdx.x of B's tiles; a ragged last receiver tile skips its rows
// past na. Reaction partials are stored negated, so reduce_partials sums
// them as the two-pass tile's. TABLE: as sym_one_pass's.
template <int MODE, int D, bool GM, bool TABLE = false>
__global__ void __launch_bounds__(OP_THREADS,
                                  GM ? OP_MIN_BLOCKS_GM : OP_MIN_BLOCKS)
pair_one_pass(const float* __restrict__ pa, const float* __restrict__ gma,
              int na, const float* __restrict__ pb,
              const float* __restrict__ gmb, int nb,
              const float* __restrict__ bounds, int levels, float arg_cap,
              float min_d2, int seg, float* __restrict__ rpart,
              float* __restrict__ cpart, int* __restrict__ fallbacks) {
  const int S = blockIdx.x;
  const int I = blockIdx.y;
  const int Ta = na / BT;
  const int Jb = S * seg;
  const int Je = min(nb / BT, Jb + seg);
  auto kind_of = [Ta](int a, int) { return a < Ta ? OP_BOTH : OP_NONE; };
  if constexpr (TABLE)
    op_run_table<D, true, GM, false>(pa, gma, na, pb, gmb, bounds, levels,
                                     arg_cap, min_d2, 0, I, S, gridDim.y,
                                     gridDim.x, Jb, Je, -1,
                                     (I + 1) * OP_SUB > Ta, kind_of, rpart,
                                     cpart, fallbacks);
  else {
    float unused[OP_R][D];
    op_block<MODE, D, true, GM, false, OP_W_CHAIN>(
        pa, gma, na, pb, gmb, bounds, levels, arg_cap, min_d2, 0, I, S,
        gridDim.y, gridDim.x, Jb, Je, -1, (I + 1) * OP_SUB > Ta, kind_of,
        rpart, cpart, OpTable{}, unused);
  }
}

// sym_one_pass's fixed-order reduction: particle p sums its receiver
// tile's row partials over the segments, in order, then subtracts the
// reaction partials of its source tile J from receiver tiles 0..J / OP_SUB,
// in order; the equal-mass sum is scaled once by G m_0 (scale[0], on the
// device), the general one (scale null: G m rode in the pairs) not at all.
template <int D>
__global__ void sym_one_pass_reduce(const float* __restrict__ rpart,
                                    const float* __restrict__ cpart, int n,
                                    int TI, int nsegmax, int seg,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int T = n / BT;
  const int I = p / OP_RW;
  const int J = p / BT;
  const int nseg = (T - I * OP_SUB + seg - 1) / seg;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  for (int S = 0; S < nseg; ++S) {
    const float* q = rpart + (((size_t)I * nsegmax + S) * OP_RW + p % OP_RW) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = __fadd_rn(s[d], q[d]);
  }
  for (int i = 0; i <= J / OP_SUB; ++i) {
    const float* q = cpart + (((size_t)J * TI + i) * BT + p % BT) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = __fsub_rn(s[d], q[d]);
  }
  if (scale != nullptr) {
    const float gm0 = scale[0];
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = __fmul_rn(s[d], gm0);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) out[(size_t)p * D + d] = s[d];
}

// The card's exhaustive test of the table (a test export: no path of the
// program launches it). Each block builds the table of (bounds, levels)
// as op_block does; its threads then take the floats x of bit patterns
// u_lo + i, i < count, in turn, as softened d^2: where lo <= x < e_m the
// table's weight, elsewhere the chain's (a block that falls back), each
// against pair_w<MODE_INT>(x). tally[0] counts the x that differ bitwise,
// tally[1] the x outside the table, tally[2] takes the least bit pattern
// that differs (atomicMin; start it at ~0). Block 0 writes meta {m, shift,
// base, buckets used} and edges e_1..e_E (E = op_table_edges(levels)).
__global__ void __launch_bounds__(OP_THREADS) int_table_sweep(
    const float* __restrict__ bounds, int levels, float arg_cap,
    float min_d2, unsigned u_lo, unsigned long long count,
    unsigned long long* __restrict__ tally, int* __restrict__ meta,
    float* __restrict__ edges) {
  extern __shared__ float4 op_table_smem[];
  const IntGrid g = int_grid(bounds, levels, arg_cap, min_d2);
  const float lo = fmaxf(bounds[2], min_d2);
  const OpTable tb = op_build_table(g, bounds[2], levels, op_table_smem,
                                    blockIdx.x == 0 ? meta : nullptr);
  if (blockIdx.x == 0) {
    const float* edge = reinterpret_cast<const float*>(
        op_table_smem + op_table_buckets(levels));
    for (int j = threadIdx.x; j < op_table_edges(levels); j += blockDim.x)
      edges[j] = edge[j + 1];
  }
  unsigned long long bad = 0, past = 0, first = ~0ull;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < count; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned u = u_lo + (unsigned)i;
    const float x = __uint_as_float(u);
    const float chain = pair_w<MODE_INT>(x, g);
    const bool in = x >= lo && x < tb.end;
    past += !in;
    float w = op_table_w(in ? x : lo, g, tb);
    if (!in) w = pair_w<MODE_INT>(x, g);
    if (__float_as_uint(w) != __float_as_uint(chain)) {
      ++bad;
      first = min(first, (unsigned long long)u);
    }
  }
  atomicAdd(&tally[0], bad);
  atomicAdd(&tally[1], past);
  atomicMin(&tally[2], first);
}

// Blocks of an instance a SM holds at once with `smem` bytes of dynamic
// shared memory (-1 if the query fails).
template <typename K>
int op_resident(K kernel, size_t smem = 0) {
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    OP_THREADS, smem) !=
      cudaSuccess)
    blocks = -1;
  return blocks;
}

// The dynamic shared memory at which the int table kernels' residency is
// reported: int4's table.
constexpr int OP_RESIDENT_LEVELS = 16;

}  // namespace
