// What the four packed searches share (closest_hit.cu, K1, occlusion.cu,
// K2, closest_hit_streamed.cu, K3, and occlusion_streamed.cu, K4): the
// live-slot contract of a triangle column, the sparse decision dot products,
// and a ring of shared-memory stages that asynchronous copies fill, walked
// along a cluster's computed blocks (K3, K4) or along a tile's block schedule
// (K1, K2).
//
// The slot contract. A packed triangle column (w is (nb, 16, 5*tb), see
// decision.cuh) has 5 x 16 (scalar, feature row) slots, but pack_scene fills
// only 25 of them: s0, s1 and s2 read rows 0-5 ([d, o x d]), D reads rows
// 0-2 (d) and num reads rows 6-9 ([o, 1]). Every other slot is exactly 0,
// and pack_rays leaves feature rows 10-15 at 0 (ops/plucker.py LIVE_SLOTS;
// tests/test_torch_slots.py holds the packs, the rays and the table below to
// it). So a staged chunk holds 25 row segments, not 80, and a (ray, column)
// pair takes 25 FMAs, not 80. The kernels rely on w coming from pack_scene
// (the wrappers take only a pack marked live_slots_only).
//
// The sums are bit-identical to the 16-term chains of the dense product:
// each scalar's accumulator starts at 0 and takes fmaf(f[k], w[s][k], acc)
// over that scalar's live rows in ascending k. A dropped term adds f * 0 =
// +-0 (the features are finite: padded lanes carry o = 0, dead lanes
// DEAD_ORIGIN), which leaves a nonzero accumulator unchanged and can only
// flip the sign of a zero one, and a signed zero decides nothing: edge <= 0
// holds for both, dd <= -EPS and num < EPS * dd fail for both.
//
// The precision modes (ops/packed_intersect.py PRECISIONS, the JAX
// package's `_decision_dot`). HIGHEST is the f32 code above in every
// kernel; every kernel runs its bf16 modes (HIGH, MIXED, DEFAULT) on the
// tensor cores (the tensor-core route, at the end of this file).
//
// The ring. STAGES stages of NLIVE x CHUNK floats ([slot][column], 12.8 KB
// each) in dynamic shared memory, filled with cp.async.cg: 16 bytes a
// thread, one warp per 512-byte row segment, every warp of the CTA copying,
// completion by commit/wait groups and then one CTA barrier per chunk. This
// rather than the bulk copy (cp.async.bulk with an mbarrier): every thread
// meets at one barrier per chunk anyway (K2 and K4 exchange their occlusion
// flags there, and K1 and K2 fold each block across the CTA), so a producer
// warp with full/empty barrier pairs would add bookkeeping and no overlap; a
// chunk is 25 row segments 5 x tb floats apart, which one bulk copy cannot
// take without a tensor map built on the host; and 16-byte copies need
// nothing beyond the tb % 4 == 0 and 16-byte base alignment the wrappers
// check. The copies run STAGES - 1 chunks ahead of the arithmetic, across
// block boundaries.
// - Along a cluster (walk_cluster, K3 and K4): the cluster's computed
//   blocks are fixed at its start, because every skip tests against the
//   cluster-start worst or bound. The ring does not fetch into the next
//   scheduled cluster: which of its blocks are computed depends on the bound
//   this cluster leaves.
// - Along a block schedule (walk_schedule, K1 and K2): there is no skip
//   inside the schedule, so the next block is always order[j + 1], and the
//   exit test decides only whether it is used. The ring fetches it
//   speculatively, while its entry bound is below the newest worst or bound
//   the walk knows. Those only fall and the entries ascend, so every chunk
//   the walk computes was fetched, and a fetch past the exit costs only its
//   reads from L2; the walk waits for every copy before it returns.
#pragma once

#include "decision.cuh"

#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>
#include <utility>

namespace stream {

using decision::BIG;
using decision::CHUNK;
using decision::EPS;
using decision::K;
using decision::NS;

constexpr int NLIVE = 25;          // live slots of a triangle column
constexpr int NF = 10;             // live feature rows, 0..9
constexpr int STAGES = 3;          // depth of the ring
constexpr int CHUNK4 = CHUNK / 4;  // float4 columns of a full chunk (one per warp lane)
constexpr int STAGE_FLOAT4 = NLIVE * CHUNK4;
constexpr int RING_BYTES = STAGES * STAGE_FLOAT4 * 16;  // 38,400

static_assert(RING_BYTES == STAGES * NLIVE * CHUNK * (int)sizeof(float), "the f32 ring holds the live rows only");

// The decision product's precision, in the order of PRECISIONS.
enum Precision : int { HIGHEST = 0, HIGH = 1, MIXED = 2, DEFAULT = 3 };
constexpr int NEDGE = 18;  // live slots of s0, s1 and s2: the first 18 of the table

struct Slot {
  int s;  // decision scalar: 0, 1, 2 = s0, s1, s2; 3 = D; 4 = num
  int k;  // feature row
};

// The live slots in the order the kernels sum them.
__host__ __device__ constexpr Slot live_slot(int i) {
  constexpr Slot LIVE_SLOTS[NLIVE] = {
      {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5},
      {1, 0}, {1, 1}, {1, 2}, {1, 3}, {1, 4}, {1, 5},
      {2, 0}, {2, 1}, {2, 2}, {2, 3}, {2, 4}, {2, 5},
      {3, 0}, {3, 1}, {3, 2},
      {4, 6}, {4, 7}, {4, 8}, {4, 9},
  };
  return LIVE_SLOTS[i];
}

// Row k * NS + s of a block's (16, 5) slot grid for live slot i, in closed
// form for the copies (checked against the table below).
__host__ __device__ constexpr int slot_row(int i) {
  return i < 18 ? (i % 6) * NS + i / 6 : i < 21 ? (i - 18) * NS + 3 : (i - 15) * NS + 4;
}

constexpr bool slots_consistent() {
  for (int i = 0; i < NLIVE; ++i) {
    const Slot a = live_slot(i);
    if (a.s < 0 || a.s >= NS || a.k < 0 || a.k >= NF || slot_row(i) != a.k * NS + a.s) return false;
    if (i > 0) {
      const Slot p = live_slot(i - 1);
      if (a.s < p.s || (a.s == p.s && a.k <= p.k)) return false;  // scalar by scalar, rows ascending
    }
  }
  return true;
}
static_assert(slots_consistent(), "the live-slot table, its closed form and its order disagree");

// The live features of a ray.
__device__ __forceinline__ void load_live_features(const float* __restrict__ feats, int ray, float f[NF]) {
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = feats[(size_t)ray * K + k];
}

__device__ __forceinline__ float bf16_rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// A ray's live features, as HIGHEST multiplies them.
struct RayFeatures {
  float f[NF];

  __device__ __forceinline__ void load(const float* __restrict__ feats, int ray) { load_live_features(feats, ray, f); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of columns [c0, c0 + cw) of the live rows of the block
// at `wb` into `stage`: warp v copies rows v, v + nwarps, ..., lane q the
// float4 column q.
__device__ __forceinline__ void fetch_chunk(float4* __restrict__ stage, const float* __restrict__ wb, int tb, int c0) {
  const int cw4 = min(CHUNK, tb - c0) / 4;
  const int lane = threadIdx.x & 31;
  if (lane >= cw4) return;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < NLIVE; i += nwarps) {
    cp_async16(stage + i * CHUNK4 + lane, wb + (size_t)slot_row(i) * tb + c0 + 4 * lane);
  }
}

// acc[r][s][c] += f[r][k] * stage[slot I][4q + c] for live slot I = (s, k).
template <int RPT, int I>
__device__ __forceinline__ void fma_slot(const RayFeatures (&x)[RPT], const float4* __restrict__ stage, int q,
                                         float (&acc)[RPT][NS][4]) {
  constexpr Slot sl = live_slot(I);
  const float4 v = stage[I * CHUNK4 + q];  // a broadcast: one address for the whole warp
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float xk = x[r].f[sl.k];
    acc[r][sl.s][0] = fmaf(xk, v.x, acc[r][sl.s][0]);
    acc[r][sl.s][1] = fmaf(xk, v.y, acc[r][sl.s][1]);
    acc[r][sl.s][2] = fmaf(xk, v.z, acc[r][sl.s][2]);
    acc[r][sl.s][3] = fmaf(xk, v.w, acc[r][sl.s][3]);
  }
}

template <int RPT, int... I>
__device__ __forceinline__ void fma_slots(const RayFeatures (&x)[RPT], const float4* __restrict__ stage, int q,
                                          float (&acc)[RPT][NS][4], std::integer_sequence<int, I...>) {
  (fma_slot<RPT, I>(x, stage, q, acc), ...);  // in table order
}

// acc[r][s][c] = scalar s of ray r and staged columns 4q + c at HIGHEST:
// the sparse decision dot products, the slots unrolled at compile time.
template <int RPT>
__device__ __forceinline__ void live_dots(const RayFeatures (&x)[RPT], const float4* __restrict__ stage, int q,
                                          float (&acc)[RPT][NS][4]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[r][s][0] = acc[r][s][1] = acc[r][s][2] = acc[r][s][3] = 0.0f;
  }
  fma_slots<RPT>(x, stage, q, acc, std::make_integer_sequence<int, NLIVE>{});
}

// The closest-hit test of one pair: accept iff max(s0, s1, s2) <= 0 and
// D <= -EPS and num < EPS * D, then t = num / D (IEEE division), else BIG.
__device__ __forceinline__ float hit_t(float s0, float s1, float s2, float dd, float num) {
  const float edge = fmaxf(fmaxf(s0, s1), s2);
  float t = BIG;
  if (edge <= 0.0f && dd <= -EPS && num < __fmul_rn(EPS, dd)) t = __fdiv_rn(num, dd);
  return t;
}

// The any-hit test of one pair: an accepted hit with t in
// (EPS, mt), division-free.
__device__ __forceinline__ bool blocks_ray(float s0, float s1, float s2, float dd, float num, float mt) {
  const float edge = fmaxf(fmaxf(s0, s1), s2);
  return edge <= 0.0f && dd <= -EPS && num < __fmul_rn(EPS, dd) && num > __fmul_rn(mt, dd);
}

// The next computed block of a cluster at or after b: eb[b] < lim (eb is
// the cluster's row of enter_blk); bpc when there is none.
__device__ __forceinline__ int next_block(const float* __restrict__ eb, int b, int bpc, float lim) {
  while (b < bpc && !(eb[b] < lim)) ++b;
  return b;
}

// Walks the chunks of one cluster's computed blocks (ascending, chunks
// ascending) through the ring and calls compute(stage, b, c0, cw4) for each,
// with b the block within the cluster and cw4 the chunk's float4 columns.
// fetch_chunk_of(stage, b, c0) starts the copies of block b's chunk at
// column c0 into a stage of SF4 float4s. Every thread of the CTA calls it
// with the same arguments; it holds one CTA barrier per chunk, and the
// caller must hold one between two calls (the stages are refilled at once).
template <int SF4, typename Fetch, typename Compute>
__device__ __forceinline__ void walk_cluster(float4* __restrict__ ring, Fetch&& fetch_chunk_of,
                                             const float* __restrict__ eb, int bpc, int tb, float lim,
                                             Compute&& compute) {
  int pb = next_block(eb, 0, bpc, lim), pc = 0;  // the next chunk to fetch
  int cb = pb, cc = 0;                           // the next chunk to compute
  auto advance = [&](int& b, int& c0) {
    c0 += CHUNK;
    if (c0 >= tb) {
      c0 = 0;
      b = next_block(eb, b + 1, bpc, lim);
    }
  };
  auto fetch = [&](int stage) {
    if (pb < bpc) {
      fetch_chunk_of(ring + stage * SF4, pb, pc);
      advance(pb, pc);
    }
    cp_async_commit();  // one group per chunk slot, empty past the end
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  int slot = 0;
  while (cb < bpc) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk `slot` have landed
    __syncthreads();              // everyone's have; the stage refilled next was read by all
    fetch(slot == 0 ? STAGES - 1 : slot - 1);
    compute(ring + slot * SF4, cb, cc, min(CHUNK, tb - cc) / 4);
    advance(cb, cc);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
}

// walk_cluster over the live rows of w (HIGHEST): `wc` is the cluster's
// first block.
template <typename Compute>
__device__ __forceinline__ void stream_cluster(float4* __restrict__ ring, const float* __restrict__ wc,
                                               const float* __restrict__ eb, int bpc, int tb, float lim,
                                               Compute&& compute) {
  const size_t block_floats = (size_t)K * NS * tb;
  walk_cluster<STAGE_FLOAT4>(
      ring, [&](float4* stage, int b, int c0) { fetch_chunk(stage, wc + b * block_floats, tb, c0); }, eb, bpc, tb,
      lim, compute);
}

// Max of v over the CTA, returned to every thread, with one barrier: each
// warp reduces and posts its max to `warp_max` (32 floats of shared
// memory), then every warp reads all posts. Every thread of the CTA must
// call it, and must pass another CTA barrier before the next call (which
// overwrites the posts).
__device__ __forceinline__ float cta_max_posted(float v, float* warp_max) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The closest-hit searches' test counter (K1, K3; a null `tests` counts
// nothing): adds tb x the sum over the CTA's threads of `lane_blocks`, the
// blocks each thread's walk computed for the live rays it owns (each ray
// owned by one thread of the CTA, 0 from the others), so the CTA adds the
// (live lane, triangle column) tests it computed, as the plain versions'
// count_work counts them (lane_blocks x tb). Called at the CTA's exit by
// every thread (it holds two barriers): one atomic a CTA in global memory.
__device__ __forceinline__ void add_tests(unsigned long long* tests, unsigned long long lane_blocks, int tb) {
  __shared__ unsigned long long cta_lane_blocks;
  if (threadIdx.x == 0) cta_lane_blocks = 0;
  __syncthreads();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) lane_blocks += __shfl_xor_sync(0xffffffffu, lane_blocks, off);
  if ((threadIdx.x & 31) == 0 && lane_blocks) atomicAdd(&cta_lane_blocks, lane_blocks);
  __syncthreads();
  if (threadIdx.x == 0 && cta_lane_blocks) atomicAdd(tests, cta_lane_blocks * (unsigned long long)tb);
}

// Whether a walk along a block schedule takes position j: j < nb and
// enter[j] < lim, and order[j] names a block (the culled tail holds the
// sentinel nb with enter = +inf, so the entry test stops there first).
__device__ __forceinline__ bool takes(const int* __restrict__ order, const float* __restrict__ enter, int j, int nb,
                                      float lim) {
  if (!(j < nb && enter[j] < lim)) return false;
  const int blk = order[j];
  return blk >= 0 && blk < nb;
}

// Walks the chunks of one tile's block schedule (position j = 0, 1, ... is
// block order[j], its chunks ascending) through the ring, taking positions
// while takes(j, lim). fetch_chunk_of(stage, blk, c0) starts the copies of
// block blk's chunk at column c0 into a stage of SF4 float4s. Calls
// compute(stage, blk, c0, cw4) for each chunk, with cw4 the chunk's float4
// columns, and after a block's last chunk sets lim = block_end(blk): the
// exact worst (K1) or bound (K2) after that block, so the walk stops where
// the plain version stops. The copies of the chunks that follow are fetched
// STAGES - 1 chunks ahead, across block boundaries, each while its position
// is taken at the newest lim (see the header). On return every copy has
// landed, and it returns the number of blocks it computed. Every thread of
// the CTA calls it with the same arguments, and every thread calls
// block_end, which may hold barriers; the walk holds one CTA barrier per
// chunk besides.
template <int SF4, typename Fetch, typename Compute, typename BlockEnd>
__device__ __forceinline__ int walk_schedule(float4* __restrict__ ring, Fetch&& fetch_chunk_of,
                                             const int* __restrict__ order, const float* __restrict__ enter, int nb,
                                             int tb, float lim, Compute&& compute, BlockEnd&& block_end) {
  int pj = 0, pc = 0;  // the next chunk to fetch
  auto fetch = [&](int stage) {
    if (takes(order, enter, pj, nb, lim)) {
      fetch_chunk_of(ring + stage * SF4, order[pj], pc);
      pc += CHUNK;
      if (pc >= tb) {
        pc = 0;
        ++pj;
      }
    }
    cp_async_commit();  // one group per chunk slot, empty past the stop
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  int cj = 0, cc = 0;  // the next chunk to compute
  bool go = takes(order, enter, 0, nb, lim);
  int slot = 0;
  while (go) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk `slot` have landed
    __syncthreads();              // everyone's have; the stage refilled next was read by all
    fetch(slot == 0 ? STAGES - 1 : slot - 1);
    const int blk = order[cj];
    compute(ring + slot * SF4, blk, cc, min(CHUNK, tb - cc) / 4);
    cc += CHUNK;
    if (cc >= tb) {
      cc = 0;
      lim = block_end(blk);
      go = takes(order, enter, ++cj, nb, lim);
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // the speculative copies past the stop
  return cj;
}

// walk_schedule over the live rows of w (HIGHEST).
template <typename Compute, typename BlockEnd>
__device__ __forceinline__ int stream_schedule(float4* __restrict__ ring, const float* __restrict__ w,
                                               const int* __restrict__ order, const float* __restrict__ enter, int nb,
                                               int tb, float lim, Compute&& compute, BlockEnd&& block_end) {
  const size_t block_floats = (size_t)K * NS * tb;
  return walk_schedule<STAGE_FLOAT4>(
      ring, [&](float4* stage, int blk, int c0) { fetch_chunk(stage, w + blk * block_floats, tb, c0); }, order,
      enter, nb, tb, lim, compute, block_end);
}

// ---------------------------------------------------------------------------
// The tensor-core route: the bf16 modes of all four kernels (K1-K4 at
// HIGH, MIXED and DEFAULT). Every HIGHEST instantiation keeps the f32 FMA
// code above.
//
// Operands. The wrapper (`_kernel_operands(w, precision)`) gives
// w_hi = bf16(w) and w_lo = bf16(w - bf16(w)) as (nb, NS, tb, WIN) bf16:
// for each block, scalar s and column c, the WIN = 8 feature rows of s's
// window, contiguous in k. s0, s1, s2 and D take rows 0-7, num rows 6-13
// (window_start), so every live slot lies in its scalar's window and every
// other row of a window is 0 in w. A column window is 16 bytes, and the B
// fragment of mma.m16n8k8.row.col (k = 2 (lane % 4) + {0, 1}, n = lane / 4)
// is one 32-bit shared-memory load a thread: eight columns of 16 bytes, 32
// distinct banks. Why k8 and not k16: a scalar reads at most 6 of the 10
// live feature rows, all inside one 8-row window, so one k8 step gives the
// same sums at half the tensor-core work of a k16 step.
//
// Rays (the A operand). A warp holds MT m-tiles of 16 rays; the thread
// holds rays lane / 4 and lane / 4 + 8 of each, at k = 2 (lane % 4) +
// {0, 1}. Its fragments are bf16(f) and bf16(f - bf16(f)) of window 0
// (feature rows 0-5, with rows 6 and 7 set to 0 as they are in w) and of
// num's window (rows 6-9; rows 10-13 are 0), loaded once per tile: a ray's
// features do not change along its schedule.
//
// Products, for 8 staged columns and each scalar: DEFAULT one mma (but
// num, below); HIGH three, fh wl, then fl wh, then fh wh, chained through
// the accumulator (C), so the small products are summed first; MIXED those
// three for s0-s2, and D and num as f32 FMA chains on the CUDA cores from
// w's f32 live rows (staged after the bf16 windows), in exactly the order
// HIGHEST sums them, so t is bit-equal to HIGHEST's wherever the winning
// triangle agrees. A tensor core sums a k-step's products (each exact in
// f32) in an order, and with an internal alignment, that PTX leaves
// unspecified: the edge scalars, and at HIGH t, are not bit-equal to the
// plain version's f32 matmuls, and the hit bar (closest hits) or the flag
// bar (any hits) holds them. The JAX
// package's grouping, hh + (hl + lh) from three separate accumulators
// (`_dot_high`), costs 40 f32 adds a thread per 8 columns and some 30 more
// registers, and was slower with the same bars met (tools/mma_variant_ab.py,
// PERF.md section 6). DEFAULT sums
// num on the CUDA cores too, fh times the bf16 num rows that lead its
// staged window, in the plain version's order: at a bounce ray's own
// surface num cancels to a residual of the bf16 roundings whose sign alone
// decides a self-hit (t of order 1e-3, past the 1e-6 epsilon), so another
// summation order flips about 0.1% of those rays' triangles (measured on
// the H100 at the config 3 stand-in's bounce-1 rays).
//
// Epilogue. An m16n8 f32 accumulator leaves the thread rays lane / 4 and
// lane / 4 + 8 at columns 2 (lane % 4) + {0, 1}, so the five scalars' tiles
// over the same 8 columns put all five scalars of those 4 pairs in one
// thread, and hit_t runs as it is. Each thread keeps its least (t, row) per
// ray over ascending columns with strict <; at a fold the 4 threads of a
// quad fold by (t, packed row), the lower row winning ties (quad_min): given
// the same scalars, the plain version's argmin, ties included. The any
// hits (mma_chunk_any) test blocks_ray on the same accumulators, division-
// free, OR a ray's columns over the chunk, then its quad (one warp vote
// after the chunk), so the four threads that hold a ray agree on its flag;
// a warp takes a chunk only while one of its rays is open (maxt > 0, not
// yet occluded). Votes after every n-tile, which stop a warp sooner, took
// K4 7-16% longer (tools/mma_variant_ab.py anyhit, PERF.md section 6).
//
// Why mma.sync and not wgmma: at HIGH a 16 x 8 tile of pairs costs 15
// m16n8k8, some 10-11 SM clocks at mma.sync's rate, and the epilogue's ~10
// decision instructions a pair cost about as many clocks on the CUDA cores
// for the same 128 pairs, so the epilogue keeps pace with the tensor cores.
// wgmma's 64-row tiles, shared-memory A and asynchronous execution buy little
// until a profile shows the tensor cores busy.

constexpr int WIN = 8;  // feature rows of a scalar's window

// First feature row of scalar s's window: 0 for s0, s1, s2 and D, 6 for num.
__host__ __device__ constexpr int window_start(int s) { return s == 4 ? 6 : 0; }

constexpr bool windows_hold_live_slots() {
  for (int i = 0; i < NLIVE; ++i) {
    const Slot a = live_slot(i);
    if (a.k < window_start(a.s) || a.k >= window_start(a.s) + WIN) return false;
  }
  return true;
}
static_assert(windows_hold_live_slots(), "a live slot lies outside its scalar's window");

constexpr int NDN = NLIVE - NEDGE;  // MIXED's f32 live rows of D and num

// The first live slot whose products the CUDA cores sum (in table order, to
// the last): MIXED's D and num, DEFAULT's num; none at HIGH.
template <int P>
__host__ __device__ constexpr int fma_slot0() {
  return P == MIXED ? NEDGE : P == DEFAULT ? NEDGE + 3 : NLIVE;
}

// The scalars whose products run on the tensor cores (MIXED: s0, s1, s2;
// DEFAULT: s0, s1, s2, D).
template <int P>
__host__ __device__ constexpr int mma_scalars() {
  return P == MIXED ? 3 : P == DEFAULT ? 4 : NS;
}

// The bf16 windows staged: hi and lo of the tensor-core scalars, and for
// DEFAULT hi of all five (num's rows feed its FMA chains).
template <int P>
__host__ __device__ constexpr int mma_segments() {
  return P == DEFAULT ? NS : 2 * mma_scalars<P>();
}

// A stage: for each bf16 operand (w_hi, then w_lo) and each of its scalars,
// CHUNK column windows of 16 bytes; for MIXED then the NDN f32 live rows of
// D and num, CHUNK floats each.
template <int P>
__host__ __device__ constexpr int mma_stage_float4() {
  return mma_segments<P>() * CHUNK + (P == MIXED ? NDN * CHUNK4 : 0);
}

template <int P>
__host__ __device__ constexpr int mma_ring_bytes() {
  return STAGES * mma_stage_float4<P>() * 16;
}

// Starts the copies of columns [c0, c0 + cw) of block blk into `stage`:
// 16-byte column windows of w_hi and w_lo and, for MIXED, float4s of w's
// D|num live rows, spread over every thread of the CTA.
template <int P>
__device__ __forceinline__ void fetch_chunk_mma(float4* __restrict__ stage, const float* __restrict__ w,
                                                const __nv_bfloat16* __restrict__ w_hi,
                                                const __nv_bfloat16* __restrict__ w_lo, int blk, int tb, int c0) {
  constexpr int NM = P == DEFAULT ? NS : mma_scalars<P>();  // windows of each operand
  const int cw = min(CHUNK, tb - c0);
  for (int i = threadIdx.x; i < mma_segments<P>() * CHUNK; i += blockDim.x) {
    const int seg = i / CHUNK, col = i % CHUNK;
    if (col < cw) {
      const __nv_bfloat16* src = seg < NM ? w_hi : w_lo;
      cp_async16(stage + i, src + (((size_t)blk * NS + seg % NM) * tb + c0 + col) * WIN);
    }
  }
  if constexpr (P == MIXED) {
    const int cw4 = cw / 4;
    const float* wb = w + (size_t)blk * K * NS * tb;
    float4* rows = stage + mma_segments<P>() * CHUNK;
    for (int i = threadIdx.x; i < NDN * CHUNK4; i += blockDim.x) {
      const int r = i / CHUNK4, q = i % CHUNK4;
      if (q < cw4) cp_async16(rows + i, wb + (size_t)slot_row(NEDGE + r) * tb + c0 + 4 * q);
    }
  }
}

// Two floats as bf16x2, each rounded to nearest even; x0 (the lower k) in
// the low half, as the mma fragments hold them.
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's rays as the tensor-core route multiplies them: MT m-tiles of 16
// rays from `ray0`; ray lane / 4 + 8 h (h = 0, 1) of m-tile m is this
// thread's ray (m, h).
template <int P, int MT>
struct RayFragments {
  uint32_t hi[MT][2][2];  // [m][window 0, num's][h]: bf16(f) at k = 2 (lane % 4) + {0, 1}
  uint32_t lo[MT][2][2];  // bf16(f - bf16(f)) (HIGH, MIXED)
  float fx[MT][2][NDN];   // the CUDA cores' factors at live slots fma_slot0.. in table order:
                          // f (MIXED's D and num), bf16(f) (DEFAULT's num)

  __device__ __forceinline__ void load(const float* __restrict__ feats, int ray0, int lane) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* f = feats + (size_t)(ray0 + 16 * m + 8 * h + (lane >> 2)) * K;
#pragma unroll
        for (int win = 0; win < 2; ++win) {
          const int k0 = window_start(win ? 4 : 0) + 2 * (lane & 3);
          const int end = win ? NF : 6;  // the window's live feature rows end here
          const float x0 = k0 < end ? f[k0] : 0.0f, x1 = k0 + 1 < end ? f[k0 + 1] : 0.0f;
          const float h0 = bf16_rn(x0), h1 = bf16_rn(x1);
          hi[m][win][h] = bf16x2(h0, h1);
          if constexpr (P != DEFAULT) lo[m][win][h] = bf16x2(x0 - h0, x1 - h1);  // x - bf16(x) is exact
        }
#pragma unroll
        for (int i = 0; i < NLIVE - fma_slot0<P>(); ++i) {
          const float x = f[live_slot(fma_slot0<P>() + i).k];
          fx[m][h][i] = P == DEFAULT ? bf16_rn(x) : x;
        }
      }
    }
  }
};

// d = a b on the tensor cores: m16n8k8, bf16 operands, f32 sums, C = 0.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// d += a b on the tensor cores (C = d).
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// s[m][sc][2 h + x] = scalar sc of ray (m, h) and staged column
// 8 nt + 2 (lane % 4) + x at precision P: the decision products of the
// tensor-core route. Every lane of the warp calls it (mma.sync is warp-wide).
template <int P, int MT>
__device__ __forceinline__ void mma_dots(const RayFragments<P, MT>& a, const float4* __restrict__ stage, int nt,
                                         int lane, float (&s)[MT][NS][4]) {
  constexpr int NM = mma_scalars<P>();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
  const int off = (8 * nt + (lane >> 2)) * (WIN / 2) + (lane & 3);  // column 8 nt + lane / 4, k pair lane % 4
#pragma unroll
  for (int sc = 0; sc < NM; ++sc) {
    const int win = sc == 4;
    const uint32_t bh = words[sc * CHUNK * (WIN / 2) + off];
    if constexpr (P == DEFAULT) {
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(s[m][sc], a.hi[m][win][0], a.hi[m][win][1], bh);
    } else {
      const uint32_t bl = words[(NM + sc) * CHUNK * (WIN / 2) + off];
#pragma unroll
      for (int m = 0; m < MT; ++m) {  // the small products first: fh wl, fl wh, then fh wh
        mma_bf16(s[m][sc], a.hi[m][win][0], a.hi[m][win][1], bl);
        mma_bf16_acc(s[m][sc], a.lo[m][win][0], a.lo[m][win][1], bh);
        mma_bf16_acc(s[m][sc], a.hi[m][win][0], a.hi[m][win][1], bh);
      }
    }
  }
  // The CUDA cores' slots, ascending k per scalar, as live_dots sums them:
  // MIXED's D and num from w's f32 rows (staged after the windows), DEFAULT's
  // num from the bf16 rows 6-9 that lead its staged window.
  constexpr int F0 = fma_slot0<P>();
  if constexpr (F0 < NLIVE) {
    const int col = 8 * nt + 2 * (lane & 3);
    float wx[NLIVE - F0][2];  // [slot][x]: w at column col + x
    if constexpr (P == MIXED) {
      const float* rows = reinterpret_cast<const float*>(stage + mma_segments<P>() * CHUNK);
#pragma unroll
      for (int i = 0; i < NLIVE - F0; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(rows + i * CHUNK + col);
        wx[i][0] = v.x;
        wx[i][1] = v.y;
      }
    } else {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint2 q = *reinterpret_cast<const uint2*>(words + (4 * CHUNK + col + x) * (WIN / 2));
        wx[0][x] = __uint_as_float(q.x << 16);  // bf16 to f32: the high half of the bits
        wx[1][x] = __uint_as_float(q.x & 0xffff0000u);
        wx[2][x] = __uint_as_float(q.y << 16);
        wx[3][x] = __uint_as_float(q.y & 0xffff0000u);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int sc = live_slot(F0).s; sc < NS; ++sc) s[m][sc][e] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < NLIVE - F0; ++i) {
      const int sc = live_slot(F0 + i).s;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 0; x < 2; ++x) s[m][sc][2 * h + x] = fmaf(a.fx[m][h][i], wx[i][x], s[m][sc][2 * h + x]);
        }
      }
    }
  }
}

// One chunk of the closest-hit search on the tensor-core route: n-tiles
// nt = g, g + groups, ... of its cw staged columns (cw a multiple of 4;
// row0 the packed row of column 0). For each ray (m, h) of the thread with
// take(m, h), its least (t, row) over ascending columns, strict <, into
// (gt, gi). Every lane of the warp calls it with the same g, groups and cw.
template <int P, int MT, typename Take>
__device__ __forceinline__ void mma_chunk_min(const RayFragments<P, MT>& a, const float4* __restrict__ stage, int g,
                                              int groups, int cw, int row0, int lane, float (&gt)[MT][2],
                                              int (&gi)[MT][2], Take&& take) {
  for (int nt = g; 8 * nt < cw; nt += groups) {
    float s[MT][NS][4];
    mma_dots<P, MT>(a, stage, nt, lane, s);
    const int col = 8 * nt + 2 * (lane & 3);
    if (col < cw) {  // else a ragged last n-tile: both of this thread's columns lie past the chunk
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {  // ascending columns
            const int e = 2 * h + x;
            const float t = hit_t(s[m][0][e], s[m][1][e], s[m][2][e], s[m][3][e], s[m][4][e]);
            if (take(m, h) && t < gt[m][h]) {  // strict <: the lower column wins ties
              gt[m][h] = t;
              gi[m][h] = row0 + col + x;
            }
          }
        }
      }
    }
  }
}

// One chunk of the any-hit search on the tensor-core route: n-tiles nt = g,
// g + groups, ... of its cw staged columns (cw a multiple of 4). If no ray
// of the warp is open (mt > 0 and not occ), the warp skips the chunk; else
// each open ray (m, h) of the thread is set in occ when blocks_ray holds
// for one of its columns in the chunk, in every thread of the ray's quad
// (one warp vote per ray after the chunk's last n-tile).
// Every lane of the warp calls it with the same g, groups and cw (mma.sync
// and the votes are warp-wide).
template <int P, int MT>
__device__ __forceinline__ void mma_chunk_any(const RayFragments<P, MT>& a, const float4* __restrict__ stage, int g,
                                              int groups, int cw, int lane, const float (&mt)[MT][2],
                                              bool (&occ)[MT][2]) {
  bool open = false;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) open |= !occ[m][h] && mt[m][h] > 0.0f;
  }
  if (!__any_sync(0xffffffffu, open)) return;
  bool hit[MT][2] = {};
  for (int nt = g; 8 * nt < cw; nt += groups) {
    float s[MT][NS][4];
    mma_dots<P, MT>(a, stage, nt, lane, s);
    const bool in = 8 * nt + 2 * (lane & 3) < cw;  // else a ragged last n-tile: both columns lie past the chunk
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * h + x;
          hit[m][h] |= in && blocks_ray(s[m][0][e], s[m][1][e], s[m][2][e], s[m][3][e], s[m][4][e], mt[m][h]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The quad's OR: lanes 4 (lane / 4) .. + 3 hold this ray.
      const unsigned quad = __ballot_sync(0xffffffffu, hit[m][h]) >> (lane & ~3);
      occ[m][h] |= (quad & 0xfu) && mt[m][h] > 0.0f;
    }
  }
}

// The least (t, i) of the 4 threads of a quad, the lower i winning ties,
// returned to all 4.
__device__ __forceinline__ void quad_min(float& t, int& i) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, t, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ot < t || (ot == t && oi < i)) {
      t = ot;
      i = oi;
    }
  }
}

// The tensor-core route's launch shape: `groups` column groups of
// ray_tile / (16 MT) warps, at most max_threads (the kernel's launch
// bound). Returns the threads, or 0 if the shape is not one the kernel
// takes.
template <int MT>
inline int mma_threads(int ray_tile, int groups, int max_threads) {
  if (ray_tile <= 0 || ray_tile % (16 * MT) || groups < 1) return 0;
  const int threads = ray_tile / (16 * MT) * 32 * groups;
  return threads <= max_threads ? threads : 0;
}

// Returns f(std::integral_constant<int, P>{}) for the precision P named by
// the runtime `precision`, or `invalid` if it names none.
template <typename F>
inline int with_precision(int precision, int invalid, F&& f) {
  switch (precision) {
    case HIGHEST: return f(std::integral_constant<int, HIGHEST>{});
    case HIGH: return f(std::integral_constant<int, HIGH>{});
    case MIXED: return f(std::integral_constant<int, MIXED>{});
    case DEFAULT: return f(std::integral_constant<int, DEFAULT>{});
  }
  return invalid;
}

// The launch shape: one CTA per ray tile of `groups` column groups, each
// of ray_tile / RPT threads (a whole number of warps) with RPT rays each.
// Returns the threads, or 0 if the shape is not one the kernel takes.
template <int RPT>
inline int ring_threads(int ray_tile, int groups, int max_threads) {
  if (ray_tile <= 0 || ray_tile % (32 * RPT) || groups < 1) return 0;
  const int threads = ray_tile / RPT * groups;
  return threads <= max_threads ? threads : 0;
}

// Launches `kernel` with `bytes` of dynamic shared memory and returns
// cudaGetLastError(). The kernel's dynamic limit is set to `bytes` first:
// by default it is 48 KB less the static shared memory.
template <typename Kernel, typename... Args>
inline int launch_ring(Kernel kernel, int blocks, int threads, size_t bytes, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of `kernel` resident per SM at this shape, or -1.
template <typename Kernel>
inline int ring_occupancy(Kernel kernel, int threads, size_t bytes) {
  if (threads <= 0 ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) != cudaSuccess) {
    return -1;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes) != cudaSuccess) return -1;
  return n;
}

}  // namespace stream
