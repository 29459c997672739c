// Closest-hit search of ray tiles along a cluster schedule (the streamed
// route, packs over 16 MiB), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_streamed` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by `_launch_streamed`,
// wrapped by `intersect_pallas`), with all of its modes: its precisions,
// and its seeded `init_t`/`init_i` inputs, cluster `budget`, per-lane
// `done` output, sub-tile gating (`subtiles`) and fresh-worst gating
// (`fresh`), which the two-phase straggler regroup of `intersect_packed`
// uses. One kernel template at HIGHEST, closest_hit_streamed_kernel<RPT,
// MODES>, and one at the bf16 modes (below): MODES = false is the default
// single-phase mode that the renders run, MODES = true the other modes
// (below). It computes what the TPU kernel computes; it is not carried over
// block by block.
//
// Inputs (row-major, contiguous, device pointers):
//   order     int32 (rt, nc)        tile i's front-to-back cluster schedule
//   enter     float (rt, nc)        ascending cluster entry bounds (+inf = culled tail,
//                                   where order holds the sentinel nc)
//   enter_blk float (rt, nc*bpc)    each block's own entry bound (+inf = culled)
//   feats     float (rt*TR, 16)     ray features [d, o x d, o, 1, 0...]
//   alive     int32 (rt*TR)         0 = dead lane (best_t starts at -inf)
//   w         float (nc*bpc, 16, 5*tb) triangle columns [s0 | s1 | s2 | D | num]
//                                   from pack_scene (only the live slots are read);
//                                   cluster c is blocks c*bpc .. c*bpc+bpc-1
//   w_hi, w_lo bf16 (nc*bpc, 5, tb, 8) the bf16 modes' operands: bf16(w) and
//             bf16(w - bf16(w)) in the tensor-core route's column windows
//             (stream_stage.cuh; the wrapper's `_kernel_operands`);
//             HIGHEST reads w only, MIXED also w's D|num rows
// Outputs: best_t float (rt*TR), best_i int32 (rt*TR) packed row, -1 on miss;
//   tests     int64 (1) or null: the (live lane, triangle column) tests
//             computed are added to it, once a CTA at its exit: tb x, over
//             each block computed, the tile's live lanes (add_tests in
//             stream_stage.cuh); in the modes, the live lanes the block was
//             computed for, as the plain version counts them (the gates
//             count into shared memory as they open). Null, which every
//             untraced frame passes, adds nothing and changes no output.
//
// Semantics of the single-phase mode, as the TPU kernel, at each of its
// precisions: lanes start at BIG (live) or -inf (dead)
// with best_i -1, and `worst` starts as the tile's max of those (so an
// all-dead tile visits nothing). The loop takes schedule positions j while
// j < nc and enter[j] < worst. For cluster c = order[j], blocks b = 0..bpc-1
// in order are computed iff enter_blk[c*bpc + b] < worst, where worst is the
// value at the cluster's start (not refreshed inside the cluster: the
// plain version's work count, and so the bound, describe exactly that).
// Accept iff max(s0, s1, s2) <= 0 and D <= -1e-6 and num < 1e-6 * D, then
// t = num / D (IEEE division), else BIG; the least t wins, ties to the
// earlier block and then the lower column; the running best is replaced only
// on strict <, and best_i only when t < BIG. After the cluster, worst = the
// tile's max best_t.
//
// Design (stream_stage.cuh). Only the 25 live slots of each column are
// staged and multiplied, bit-identical to the 80-slot sums. The CTA holds
// one ray tile as `groups` column groups of warps; a thread keeps RPT rays'
// 10 live features in registers, and group g takes float4 columns g,
// g + groups, ... of every staged chunk (one shared-memory broadcast feeds
// 4 x RPT columns' FMAs). A ring of STAGES chunk stages, filled by cp.async
// copies, keeps the next chunks of the cluster's computed blocks in flight
// while the current one is multiplied. Within a cluster each (ray, group)
// keeps its least (t, packed row) with strict < over ascending rows; at the
// cluster's end the groups are folded by (t, row), the lower row winning
// ties. Blocks ascend within a cluster (blk = c*bpc + b), so "earlier block,
// then lower column" is "lower packed row", and this equals the chain of
// strict-< updates block by block; the fold then replaces the running best
// only on strict <, so earlier clusters win ties.
//
// What bounds it on the H100 (measured by chip_smoke.py and
// tools/stream_sweep.py; times, shares of the bound and the sweep in
// PERF.md section 6): instruction issue in the SMs. A pair costs 25 FMAs,
// about 10 decision instructions and, at 2 rays a thread, 3 shared-memory
// broadcasts, and the registers of 2 rays a thread leave 2 CTAs of 256
// threads (16 warps) per SM. Memory does not bound it: a pack's live rows
// are under a third of its bytes (those of the config 6 stand-in fit in the
// 50 MB L2), and even read from HBM they take well under the arithmetic's
// time. One ray a thread (twice the warps, but twice the shared loads per
// FMA) and other group counts were slower.
//
// The modes (MODES = true). Inputs as above, and init_t float, init_i int32
// (rt*TR), both null for BIG and -1; output done int32 (rt*TR). Semantics,
// as the TPU kernel: live lanes start at init_t, dead lanes at -inf, best_i
// at init_i; the first worst is the tile's max of that (not +inf). The loop
// takes positions j < min(budget, nc) (budget 0: nc) while enter[j] <
// worst. In cluster c = order[j], block b = 0..bpc-1 is computed for a lane
// iff enter_blk[c*bpc + b] is below the lane's gate: the cluster-start
// worst; with fresh, the tile's running max; with subtiles > 1, the running
// max of the lane's group of ray_tile / subtiles lanes. Each computed block
// folds into the running best with strict < (per block, not per cluster:
// the next gate reads it). After the cluster, worst = the tile's max.
// done = (j_end >= nc) | (best_t <= enter[min(j_end, nc - 1)]), j_end the
// position the loop stopped at. Design: the ring stages what the
// single-phase mode stages (every block below the cluster-start worst) and
// the gates select from it only the arithmetic: a gate is a running max,
// never above the cluster-start worst, so the computed blocks are a subset
// of the staged ones. Each thread gates its rays on their own sub-tile, so
// a thread holding rays of two sub-tiles may compute one and skip the
// other. After each block group 0 posts the running best of every lane to
// shared memory, and each thread reads its rays' sub-tile (or the tile)
// from there for the next gate: one more barrier a block. Entry bounds are
// lower bounds and updates strict <, so a skipped block could not have
// changed a lane, and every mode gives the single-phase hits.
//
// The bf16 modes (closest_hit_streamed_mma_kernel<P, MT, MODES>, both
// MODES) take the tensor-core route of stream_stage.cuh, as closest_hit.cu's
// do: `groups` column groups of ray_tile / (16 MT) warps, each warp MT
// m-tiles of 16 rays with their bf16 A fragments in registers, group g
// taking n-tiles g, g + groups, ... of every chunk; each thread keeps its
// least (t, row) per ray, and a fold first takes the quad's least (t, row),
// then the groups' through shared memory. The modes' gates are per ray, as
// above; a warp skips a chunk's products only when none of its rays is
// gated on (mma.sync is warp-wide), and the gates select which results
// count. mma.sync rather than wgmma, for the reason closest_hit.cu gives.

#include "stream_stage.cuh"

#include <stdint.h>

namespace {

using namespace stream;

// One kernel for every mode at HIGHEST (the bf16 modes take the
// tensor-core kernel below): MODES = false is the single-phase mode (it
// reads no seed, no budget and no gate, and writes no done), MODES = true
// the others. `if constexpr` leaves the single-phase instantiation none of
// the modes' code, so it keeps its registers and occupancy. COUNT = true
// (a non-null test counter, traced frames only) adds the count; the
// instantiations without it are those of an untraced frame, with neither
// the count's code nor its registers.
template <int RPT, bool MODES, bool COUNT>
__global__ void __launch_bounds__(RPT == 1 ? 1024 : 512)
    closest_hit_streamed_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                                const float* __restrict__ enter_blk, const float* __restrict__ feats,
                                const int* __restrict__ alive, const float* __restrict__ init_t,
                                const int* __restrict__ init_i, const float* __restrict__ w,
                                float* __restrict__ best_t_out, int* __restrict__ best_i_out,
                                int* __restrict__ done_out, unsigned long long* __restrict__ tests, int nc, int bpc,
                                int tb, int ray_tile, int groups, int budget, int subtiles, int fresh) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float* fold_t = reinterpret_cast<float*>(smem + STAGES * STAGE_FLOAT4);  // (groups, ray_tile)
  int* fold_i = reinterpret_cast<int*>(fold_t + groups * ray_tile);             // (groups, ray_tile)
  float* lane_t = reinterpret_cast<float*>(fold_i + groups * ray_tile);         // MODES: (ray_tile,) running best
  __shared__ float warp_max[32];
  __shared__ float tile_worst;
  __shared__ unsigned int lane_blocks;  // MODES with a test counter: live lanes x blocks computed for them

  const int tpg = ray_tile / RPT;  // threads per group
  const int g = threadIdx.x / tpg;
  const int tile = blockIdx.x;
  const int nb = nc * bpc;

  // Every group holds the running best of its rays; the groups agree.
  int lane[RPT];  // ray within the tile
  RayFeatures f[RPT];
  float best_t[RPT];
  int best_i[RPT];
  float tile_max = -INFINITY;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    lane[r] = threadIdx.x - g * tpg + r * tpg;
    const int ray = tile * ray_tile + lane[r];
    f[r].load(feats, ray);
    if constexpr (MODES) {
      best_t[r] = alive[ray] > 0 ? (init_t ? init_t[ray] : BIG) : -INFINITY;
      best_i[r] = init_i ? init_i[ray] : -1;
      if (g == 0) lane_t[lane[r]] = best_t[r];
    } else {
      best_t[r] = alive[ray] > 0 ? BIG : -INFINITY;
      best_i[r] = -1;
    }
    tile_max = fmaxf(tile_max, best_t[r]);
  }
  if (MODES && COUNT && threadIdx.x == 0) lane_blocks = 0;
  // Its barriers also publish lane_t (and lane_blocks' start).
  float worst = decision::cta_max(tile_max, warp_max, &tile_worst);

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;
  const int cap = MODES && budget > 0 ? min(budget, nc) : nc;

  bool on[RPT];   // MODES: the current block is computed for ray r
  float gt[RPT];  // this group's least (t, row) in the cluster (MODES: in the block)
  int gi[RPT];
  int blocks = 0;  // COUNT, single-phase: blocks computed for every ray of the tile
  // Fold the groups by (t, row), then into the running best (MODES: of the
  // rays that computed the block, and post it to lane_t for the next gates).
  auto fold = [&]() {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      fold_t[g * ray_tile + lane[r]] = gt[r];
      fold_i[g * ray_tile + lane[r]] = gi[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float ct = BIG;
      int ci = 0;
      for (int h = 0; h < groups; ++h) {
        const float t = fold_t[h * ray_tile + lane[r]];
        const int i = fold_i[h * ray_tile + lane[r]];
        if (t < ct || (t == ct && i < ci)) {
          ct = t;
          ci = i;
        }
      }
      if ((!MODES || on[r]) && ct < best_t[r]) {  // strict <: earlier clusters and blocks win ties
        best_t[r] = ct;
        if (ct < BIG) best_i[r] = ci;
      }
      if constexpr (MODES) {
        if (g == 0) lane_t[lane[r]] = best_t[r];
      }
    }
  };

  int j = 0;
  for (; j < cap; ++j) {
    // Uniform across the CTA: every thread reads the same entries and worst.
    if (!(tile_enter[j] < worst)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there
    const float* eb = tile_enter_blk + (size_t)c * bpc;

    if constexpr (!MODES) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        gt[r] = BIG;
        gi[r] = 0;
      }
    }
    const size_t cluster = (size_t)c * bpc * K * NS * tb;
    stream_cluster(ring, w + cluster, eb, bpc, tb, worst,
                   [&](const float4* stage, int b, int c0, int cw4) {
                     bool any = true;
                     if constexpr (MODES) {
                       if (c0 == 0) {  // the block's gates, from lane_t as the last block left it
#pragma unroll
                         for (int r = 0; r < RPT; ++r) {
                           float gate = worst;
                           if (subtiles > 1 || fresh) {
                             const int gs = ray_tile / subtiles;  // lanes of a sub-tile
                             const int lo = subtiles > 1 ? lane[r] / gs * gs : 0;
                             const int n = subtiles > 1 ? gs : ray_tile;
                             gate = -INFINITY;
                             for (int i = 0; i < n; ++i) gate = fmaxf(gate, lane_t[lo + i]);
                           }
                           on[r] = eb[b] < gate;
                           if constexpr (COUNT) {
                             if (on[r] && g == 0 && alive[tile * ray_tile + lane[r]] > 0) atomicAdd(&lane_blocks, 1u);
                           }
                           gt[r] = BIG;
                           gi[r] = 0;
                         }
                       }
                       any = false;
#pragma unroll
                       for (int r = 0; r < RPT; ++r) any |= on[r];
                     }
                     const int row0 = (c * bpc + b) * tb + c0;
                     for (int q = g; any && q < cw4; q += groups) {
                       float acc[RPT][NS][4];
                       live_dots<RPT>(f, stage, q, acc);
#pragma unroll
                       for (int r = 0; r < RPT; ++r) {
#pragma unroll
                         for (int x = 0; x < 4; ++x) {  // ascending columns
                           const float t =
                               hit_t(acc[r][0][x], acc[r][1][x], acc[r][2][x], acc[r][3][x], acc[r][4][x]);
                           if ((!MODES || on[r]) && t < gt[r]) {  // strict <: the lower row wins ties
                             gt[r] = t;
                             gi[r] = row0 + 4 * q + x;
                           }
                         }
                       }
                     }
                     if constexpr (MODES) {
                       // The block's last chunk: fold it and post it. The fold's reads
                       // sit between its barrier and this one, the next block's writes
                       // after the ring's next barrier.
                       if (c0 + CHUNK < tb) return;
                       fold();
                       __syncthreads();
                     } else if constexpr (COUNT) {
                       blocks += c0 + CHUNK >= tb;  // the block's last chunk
                     }
                   });
    if constexpr (!MODES) fold();

    tile_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < RPT; ++r) tile_max = fmaxf(tile_max, best_t[r]);
    // Its barriers also keep the next cluster's fold writes and copies
    // behind every read of this one.
    worst = decision::cta_max(tile_max, warp_max, &tile_worst);
  }
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int ray = tile * ray_tile + lane[r];
      best_t_out[ray] = best_t[r];
      best_i_out[ray] = best_i[r];
      if constexpr (MODES) {
        if (done_out) done_out[ray] = (j >= nc || best_t[r] <= tile_enter[min(j, nc - 1)]) ? 1 : 0;
      }
    }
  }
  if constexpr (COUNT && MODES) {  // the gates counted as they opened
    __syncthreads();
    if (threadIdx.x == 0 && lane_blocks) atomicAdd(tests, (unsigned long long)lane_blocks * tb);
  } else if constexpr (COUNT) {  // group 0 owns the tile's rays
    unsigned long long mine = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) mine += g == 0 && alive[tile * ray_tile + lane[r]] > 0 ? blocks : 0;
    add_tests(tests, mine, tb);
  }
}

// The tensor-core kernel's launch bound: 512 threads at one m-tile a warp
// (4 column groups of the 64-ray tile, 0.93-0.95x the time of 2 groups on
// the bounce-1 rays, tools/stream_sweep.py mma), 1024 at two (ray tiles
// past 256 a group).
template <int MT>
constexpr int mma_max_threads() {
  return MT == 1 ? 512 : 1024;
}

// The bf16 modes on the tensor cores (see the header), in every mode, with
// and without the count (COUNT, as the kernel above).
template <int P, int MT, bool MODES, bool COUNT>
__global__ void __launch_bounds__(mma_max_threads<MT>())
    closest_hit_streamed_mma_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                                    const float* __restrict__ enter_blk, const float* __restrict__ feats,
                                    const int* __restrict__ alive, const float* __restrict__ init_t,
                                    const int* __restrict__ init_i, const float* __restrict__ w,
                                    const __nv_bfloat16* __restrict__ w_hi, const __nv_bfloat16* __restrict__ w_lo,
                                    float* __restrict__ best_t_out, int* __restrict__ best_i_out,
                                    int* __restrict__ done_out, unsigned long long* __restrict__ tests, int nc,
                                    int bpc, int tb, int ray_tile, int groups, int budget, int subtiles, int fresh) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float* fold_t = reinterpret_cast<float*>(smem + STAGES * mma_stage_float4<P>());  // (groups, ray_tile)
  int* fold_i = reinterpret_cast<int*>(fold_t + groups * ray_tile);                 // (groups, ray_tile)
  float* lane_t = reinterpret_cast<float*>(fold_i + groups * ray_tile);             // MODES: (ray_tile,) running best
  __shared__ float warp_max[32];
  __shared__ float tile_worst;
  __shared__ unsigned int lane_blocks;  // MODES with a test counter: live lanes x blocks computed for them

  const int lane = threadIdx.x & 31;
  const int wpg = ray_tile / (16 * MT);  // warps per group
  const int g = (threadIdx.x >> 5) / wpg;
  const int first = ((threadIdx.x >> 5) - g * wpg) * 16 * MT;  // the warp's first ray in the tile
  const int tile = blockIdx.x;
  const int nb = nc * bpc;

  RayFragments<P, MT> a;
  a.load(feats, tile * ray_tile + first, lane);
  // Every thread holds the running best of its rays (the groups and a
  // quad's 4 threads agree).
  int lane_of[MT][2];  // ray within the tile
  float best_t[MT][2];
  int best_i[MT][2];
  float tile_max = -INFINITY;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lane_of[m][h] = first + 16 * m + 8 * h + (lane >> 2);
      const int ray = tile * ray_tile + lane_of[m][h];
      if constexpr (MODES) {
        best_t[m][h] = alive[ray] > 0 ? (init_t ? init_t[ray] : BIG) : -INFINITY;
        best_i[m][h] = init_i ? init_i[ray] : -1;
        if (g == 0 && (lane & 3) == 0) lane_t[lane_of[m][h]] = best_t[m][h];
      } else {
        best_t[m][h] = alive[ray] > 0 ? BIG : -INFINITY;
        best_i[m][h] = -1;
      }
      tile_max = fmaxf(tile_max, best_t[m][h]);
    }
  }
  if (MODES && COUNT && threadIdx.x == 0) lane_blocks = 0;
  // Its barriers also publish lane_t (and lane_blocks' start).
  float worst = decision::cta_max(tile_max, warp_max, &tile_worst);

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;
  const int cap = MODES && budget > 0 ? min(budget, nc) : nc;

  bool on[MT][2];   // MODES: the current block is computed for ray (m, h)
  float gt[MT][2];  // this thread's least (t, row) in the cluster (MODES: in the block)
  int gi[MT][2];
  int blocks = 0;  // COUNT, single-phase: blocks computed for every ray of the tile
  // Fold the quad, then the groups by (t, row), then into the running best
  // (MODES: of the rays that computed the block, and post it to lane_t for
  // the next gates). The barrier also keeps lane_t's writes behind every
  // gate's reads.
  auto fold = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        quad_min(gt[m][h], gi[m][h]);
        if (groups > 1 && (lane & 3) == 0) {
          fold_t[g * ray_tile + lane_of[m][h]] = gt[m][h];
          fold_i[g * ray_tile + lane_of[m][h]] = gi[m][h];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ct = gt[m][h];
        int ci = gi[m][h];
        for (int q = 0; groups > 1 && q < groups; ++q) {
          const float t = fold_t[q * ray_tile + lane_of[m][h]];
          const int i = fold_i[q * ray_tile + lane_of[m][h]];
          if (t < ct || (t == ct && i < ci)) {
            ct = t;
            ci = i;
          }
        }
        if ((!MODES || on[m][h]) && ct < best_t[m][h]) {  // strict <: earlier clusters and blocks win ties
          best_t[m][h] = ct;
          if (ct < BIG) best_i[m][h] = ci;
        }
        if constexpr (MODES) {
          if (g == 0 && (lane & 3) == 0) lane_t[lane_of[m][h]] = best_t[m][h];
        }
      }
    }
  };

  int j = 0;
  for (; j < cap; ++j) {
    // Uniform across the CTA: every thread reads the same entries and worst.
    if (!(tile_enter[j] < worst)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there
    const float* eb = tile_enter_blk + (size_t)c * bpc;

    if constexpr (!MODES) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          gt[m][h] = BIG;
          gi[m][h] = 0;
        }
      }
    }
    walk_cluster<mma_stage_float4<P>()>(
        ring, [&](float4* stage, int b, int c0) { fetch_chunk_mma<P>(stage, w, w_hi, w_lo, c * bpc + b, tb, c0); },
        eb, bpc, tb, worst, [&](const float4* stage, int b, int c0, int cw4) {
          bool any = true;
          if constexpr (MODES) {
            if (c0 == 0) {  // the block's gates, from lane_t as the last block left it
#pragma unroll
              for (int m = 0; m < MT; ++m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float gate = worst;
                  if (subtiles > 1 || fresh) {
                    const int gs = ray_tile / subtiles;  // lanes of a sub-tile
                    const int lo = subtiles > 1 ? lane_of[m][h] / gs * gs : 0;
                    const int n = subtiles > 1 ? gs : ray_tile;
                    gate = -INFINITY;
                    for (int i = 0; i < n; ++i) gate = fmaxf(gate, lane_t[lo + i]);
                  }
                  on[m][h] = eb[b] < gate;
                  if constexpr (COUNT) {
                    if (on[m][h] && g == 0 && (lane & 3) == 0 && alive[tile * ray_tile + lane_of[m][h]] > 0) {
                      atomicAdd(&lane_blocks, 1u);
                    }
                  }
                  gt[m][h] = BIG;
                  gi[m][h] = 0;
                }
              }
            }
            any = false;
#pragma unroll
            for (int m = 0; m < MT; ++m) any |= on[m][0] | on[m][1];
            any = __any_sync(0xffffffffu, any);  // warp-wide: mma.sync takes the whole warp
          }
          if (any) {
            mma_chunk_min<P, MT>(a, stage, g, groups, 4 * cw4, (c * bpc + b) * tb + c0, lane, gt, gi,
                                 [&](int m, int h) { return !MODES || on[m][h]; });
          }
          if constexpr (MODES) {
            // The block's last chunk: fold it and post it. The fold's reads
            // sit between its barrier and this one, the next block's writes
            // after the ring's next barrier.
            if (c0 + CHUNK < tb) return;
            fold();
            __syncthreads();
          } else if constexpr (COUNT) {
            blocks += c0 + CHUNK >= tb;  // the block's last chunk
          }
        });
    if constexpr (!MODES) fold();

    tile_max = -INFINITY;
#pragma unroll
    for (int m = 0; m < MT; ++m) tile_max = fmaxf(tile_max, fmaxf(best_t[m][0], best_t[m][1]));
    // Its barriers also keep the next cluster's fold writes and copies
    // behind every read of this one.
    worst = decision::cta_max(tile_max, warp_max, &tile_worst);
  }
  if (g == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ray = tile * ray_tile + lane_of[m][h];
        best_t_out[ray] = best_t[m][h];
        best_i_out[ray] = best_i[m][h];
        if constexpr (MODES) {
          if (done_out) done_out[ray] = (j >= nc || best_t[m][h] <= tile_enter[min(j, nc - 1)]) ? 1 : 0;
        }
      }
    }
  }
  if constexpr (COUNT && MODES) {  // the gates counted as they opened
    __syncthreads();
    if (threadIdx.x == 0 && lane_blocks) atomicAdd(tests, (unsigned long long)lane_blocks * tb);
  } else if constexpr (COUNT) {  // the first thread of each quad of group 0 owns its rays
    unsigned long long mine = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine += g == 0 && (lane & 3) == 0 && alive[tile * ray_tile + lane_of[m][h]] > 0 ? blocks : 0;
      }
    }
    add_tests(tests, mine, tb);
  }
}

template <int P>
size_t smem_bytes(int ray_tile, int groups, bool modes) {
  return (P == HIGHEST ? RING_BYTES : mma_ring_bytes<P>()) +
         (size_t)groups * ray_tile * (sizeof(float) + sizeof(int)) + (modes ? (size_t)ray_tile * sizeof(float) : 0);
}

template <int RPT>
int threads_of(int ray_tile, int groups) {
  return ring_threads<RPT>(ray_tile, groups, RPT == 1 ? 1024 : 512);
}

// f(kernel, threads) for the kernel at precision P, in the modes or the
// single-phase one, with or without the count: at HIGHEST the FMA kernel of
// per = rays_per_thread (1 or 2), at the bf16 modes the tensor-core kernel
// of per m-tiles a warp (1 or 2); `invalid` for a shape it does not take.
template <int P, bool MODES, bool COUNT, typename F>
int with_kernel(int ray_tile, int groups, int per, int invalid, F&& f) {
  if constexpr (P == HIGHEST) {
    if (per == 1 && threads_of<1>(ray_tile, groups))
      return f(closest_hit_streamed_kernel<1, MODES, COUNT>, threads_of<1>(ray_tile, groups));
    if (per == 2 && threads_of<2>(ray_tile, groups))
      return f(closest_hit_streamed_kernel<2, MODES, COUNT>, threads_of<2>(ray_tile, groups));
  } else {
    if (per == 1 && mma_threads<1>(ray_tile, groups, mma_max_threads<1>()))
      return f(closest_hit_streamed_mma_kernel<P, 1, MODES, COUNT>,
               mma_threads<1>(ray_tile, groups, mma_max_threads<1>()));
    if (per == 2 && mma_threads<2>(ray_tile, groups, mma_max_threads<2>()))
      return f(closest_hit_streamed_mma_kernel<P, 2, MODES, COUNT>,
               mma_threads<2>(ray_tile, groups, mma_max_threads<2>()));
  }
  return invalid;
}

}  // namespace

extern "C" {

// Launches a kernel on `stream`, one CTA per ray tile of `ray_tile` rays,
// at `precision` (0 highest, 1 high, 2 mixed, 3 default): with modes = 0
// the single-phase mode (init_t, init_i and done are not read), else the
// other modes with budget (0 = none), subtiles (dividing ray_tile) and
// fresh (0 or 1); init_t and init_i may be null (BIG and -1), done too;
// `tests` (null: no count) takes the tests computed (see the header).
// Returns cudaGetLastError() (0 = launched). At HIGHEST the CTA is
// `groups` column groups of ray_tile / per threads, per = rays a thread (1
// or 2), with at most 1024 (1 ray a thread) or 512 (2) threads in all; at
// the bf16 modes `groups` column groups of ray_tile / (16 per) warps, per =
// m-tiles of 16 rays a warp (1 or 2), with at most 512 (1) or 1024 (2)
// threads. Anything else returns cudaErrorInvalidValue. w_hi and w_lo are
// read only at the bf16 modes. The caller checks shapes, types, alignment
// (tb % 4 == 0; w, w_hi and w_lo on a 16-byte boundary) and ray_tile.
int closest_hit_streamed_launch(const void* order, const void* enter, const void* enter_blk,
                                const void* feats, const void* alive, const void* init_t, const void* init_i,
                                const void* w, const void* w_hi, const void* w_lo, void* best_t, void* best_i,
                                void* done, void* tests, int rt, int nc, int bpc, int tb, int ray_tile, int groups,
                                int per, int precision, int modes, int budget, int subtiles, int fresh, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (modes && (subtiles < 1 || ray_tile % subtiles || budget < 0)) return invalid;
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    const size_t bytes = smem_bytes<P>(ray_tile, groups, modes != 0);
    auto launch = [&](auto kernel, int threads) {
      // The triangle operands: w of the FMA kernel (HIGHEST), w, w_hi and
      // w_lo of the tensor-core one.
      auto with_operands = [&](auto... operands) {
        return launch_ring(kernel, rt, threads, bytes, s, static_cast<const int*>(order),
                           static_cast<const float*>(enter), static_cast<const float*>(enter_blk),
                           static_cast<const float*>(feats), static_cast<const int*>(alive),
                           static_cast<const float*>(init_t), static_cast<const int*>(init_i), operands...,
                           static_cast<float*>(best_t), static_cast<int*>(best_i), static_cast<int*>(done),
                           static_cast<unsigned long long*>(tests), nc, bpc, tb, ray_tile, groups, budget, subtiles,
                           fresh);
      };
      const auto wf = static_cast<const float*>(w);
      if constexpr (P == HIGHEST) {
        return with_operands(wf);
      } else {
        return with_operands(wf, static_cast<const __nv_bfloat16*>(w_hi), static_cast<const __nv_bfloat16*>(w_lo));
      }
    };
    if (tests) {
      return modes ? with_kernel<P, true, true>(ray_tile, groups, per, invalid, launch)
                   : with_kernel<P, false, true>(ray_tile, groups, per, invalid, launch);
    }
    return modes ? with_kernel<P, true, false>(ray_tile, groups, per, invalid, launch)
                 : with_kernel<P, false, false>(ray_tile, groups, per, invalid, launch);
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// closest_hit_streamed_launch takes them; modes 0 or 1; without the count),
// or -1 if it is not one.
int closest_hit_streamed_occupancy(int ray_tile, int groups, int per, int precision, int modes) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    auto occupancy = [&](auto kernel, int threads) {
      return ring_occupancy(kernel, threads, smem_bytes<P>(ray_tile, groups, modes != 0));
    };
    return modes ? with_kernel<P, true, false>(ray_tile, groups, per, -1, occupancy)
                 : with_kernel<P, false, false>(ray_tile, groups, per, -1, occupancy);
  });
}

const char* closest_hit_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
