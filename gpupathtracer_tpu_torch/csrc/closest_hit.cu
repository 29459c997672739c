// Closest-hit search of ray tiles against the packed scene (the resident
// route, packs up to 16 MiB), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_resident` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by `_launch_resident`,
// wrapped by `intersect_pallas`). It computes what that kernel computes; it
// is not carried over block by block.
//
// Inputs (row-major, contiguous, device pointers):
//   order  int32 (rt, nb)       tile i's front-to-back block schedule
//   enter  float (rt, nb)       ascending entry bounds (+inf = culled tail)
//   feats  float (rt*TR, 16)    ray features [d, o x d, o, 1, 0...]
//   alive  int32 (rt*TR)        0 = dead lane (best_t starts at -inf)
//   w      float (nb, 16, 5*tb) triangle columns [s0 | s1 | s2 | D | num]
//                               from pack_scene (only the live slots are read)
// Outputs: best_t float (rt*TR), best_i int32 (rt*TR) packed row, -1 on miss;
//   tests     int64 (1) or null: the (live lane, triangle column) tests
//             computed are added to it (add_tests in stream_stage.cuh: the
//             blocks the walk computed x the tile's live lanes x tb), once
//             a CTA at its exit; null, which every untraced frame passes,
//             adds nothing and changes no output.
//   w_hi, w_lo bf16 (nb, 5, tb, 8) the bf16 modes' operands: bf16(w) and
//                               bf16(w - bf16(w)) in the tensor-core route's
//                               column windows (stream_stage.cuh; the
//                               wrapper's `_kernel_operands`);
//                               HIGHEST reads w only, MIXED also w's D|num rows
//
// Semantics, as the TPU kernel, at each of its precisions (the decision
// products of stream_stage.cuh: live_dots at HIGHEST, mma_dots at the bf16
// modes): lanes start at BIG (live) or -inf (dead)
// with best_i -1, and the tile's worst at +inf. The loop takes schedule
// positions j while j < nb and enter[j] < worst. Accept iff max(s0, s1, s2)
// <= 0 and D <= -1e-6 and num < 1e-6 * D, then t = num / D (IEEE division),
// else BIG; per block the least t over ascending columns (ties to the lower
// column); the running best is replaced only on strict <, so earlier-visited
// blocks win ties, and best_i only when the block's least t is below BIG.
// After each block, worst = the tile's max best_t. Dead lanes sit at -inf,
// so they never update and never hold the loop open.
//
// Design (stream_stage.cuh). Only the 25 live slots of each column are
// staged and multiplied, bit-identical to the 80-slot sums. The CTA holds
// one ray tile as `groups` column groups of warps; a thread keeps RPT rays'
// 10 live features in registers, and group g takes float4 columns g,
// g + groups, ... of every staged chunk (one shared-memory broadcast feeds
// 4 x RPT columns' FMAs). A ring of STAGES chunk stages, filled by cp.async
// copies, walks the tile's block schedule and keeps the next chunks in
// flight across block boundaries while the current one is multiplied. Within
// a block each (ray, group) keeps its least (t, column) with strict < over
// ascending columns; at the block's end group 0 folds the groups by (t,
// packed row), the lower row winning ties, which is the block's argmin, and
// folds that into the running best with strict <. The fold is per block,
// not per schedule: blocks are visited front to back, not in row order. The
// same pass posts the tile's max for the exact worst, so a block costs the
// ring's barrier per chunk and two more.
//
// What bounds it on the H100 (measured by chip_smoke.py and
// tools/stream_sweep.py; times, shares of the bound and the sweep in
// PERF.md section 6): instruction issue in the SMs, as for
// closest_hit_streamed.cu. A pair costs 25 FMAs and about 10 decision
// instructions; the per-block fold and its barriers weigh most at tb 128,
// where a block is one chunk. Memory does not bound it: a resident pack's
// live rows (under 16 MiB x 25 / 80) stay in the 50 MB L2.
//
// The bf16 modes (closest_hit_mma_kernel<P, MT>) take the tensor-core route
// of stream_stage.cuh: the CTA holds the ray tile as `groups` column groups
// of ray_tile / (16 MT) warps, each warp MT m-tiles of 16 rays whose bf16 A
// fragments it keeps in registers for the whole walk; group g takes n-tiles
// (8 columns) g, g + groups, ... of every staged chunk, one mma.sync
// m16n8k8 per scalar and operand pair (15 at HIGH; 9 and D's and num's f32
// FMA chains at MIXED; 4 and num's chain at DEFAULT), then hit_t on the
// accumulators as they lie. At
// a block's end each quad folds by (t, packed row), then the groups fold
// through shared memory (none with one group), and the running best is
// replaced on strict <, as above. mma.sync rather than wgmma: at HIGH a
// 16 x 8 tile of pairs costs 15 m16n8k8 (some 10-11 SM clocks) and its
// epilogue about as many, so the decision instructions, not the tensor
// cores, set the pace; wgmma's 64-row tiles and asynchronous execution wait
// for a profile that shows the tensor cores busy.

#include "stream_stage.cuh"

#include <stdint.h>

namespace {

using namespace stream;

// HIGHEST (the bf16 modes take the tensor-core kernel below).
template <int RPT>
__global__ void __launch_bounds__(RPT == 1 ? 1024 : 512)
    closest_hit_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                       const float* __restrict__ feats, const int* __restrict__ alive,
                       const float* __restrict__ w, float* __restrict__ best_t_out, int* __restrict__ best_i_out,
                       unsigned long long* __restrict__ tests, int nb, int tb, int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float* fold_t = reinterpret_cast<float*>(smem + STAGES * STAGE_FLOAT4);  // (groups, ray_tile)
  int* fold_i = reinterpret_cast<int*>(fold_t + groups * ray_tile);  // (groups, ray_tile)
  __shared__ float warp_max[32];

  const int tpg = ray_tile / RPT;  // threads per group
  const int g = threadIdx.x / tpg;
  const int tile = blockIdx.x;

  // Group 0 holds the running best of its rays; every group its least
  // (t, row) in the current block.
  int lane[RPT];  // ray within the tile
  RayFeatures f[RPT];
  float best_t[RPT], gt[RPT];
  int best_i[RPT], gi[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    lane[r] = threadIdx.x - g * tpg + r * tpg;
    const int ray = tile * ray_tile + lane[r];
    f[r].load(feats, ray);
    best_t[r] = alive[ray] > 0 ? BIG : -INFINITY;
    best_i[r] = -1;
    gt[r] = BIG;
    gi[r] = 0;
  }

  const int blocks = stream_schedule(
      ring, w, order + (size_t)tile * nb, enter + (size_t)tile * nb, nb, tb, INFINITY,
      [&](const float4* stage, int blk, int c0, int cw4) {
        const int row0 = blk * tb + c0;
        for (int q = g; q < cw4; q += groups) {
          float acc[RPT][NS][4];
          live_dots<RPT>(f, stage, q, acc);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {  // ascending columns
              const float t = hit_t(acc[r][0][x], acc[r][1][x], acc[r][2][x], acc[r][3][x], acc[r][4][x]);
              if (t < gt[r]) {  // strict <: the lower column wins ties
                gt[r] = t;
                gi[r] = row0 + 4 * q + x;
              }
            }
          }
        }
      },
      [&](int) {
        // Fold the groups by (t, row) into the running best, then the
        // tile's worst lane. The fold's reads sit between this barrier and
        // cta_max_posted's, the next block's writes after both.
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          fold_t[g * ray_tile + lane[r]] = gt[r];
          fold_i[g * ray_tile + lane[r]] = gi[r];
          gt[r] = BIG;
          gi[r] = 0;
        }
        __syncthreads();
        float tile_max = -INFINITY;
        if (g == 0) {
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
            if (ct < best_t[r]) {  // strict <: earlier-visited blocks win ties
              best_t[r] = ct;
              if (ct < BIG) best_i[r] = ci;
            }
            tile_max = fmaxf(tile_max, best_t[r]);
          }
        }
        return cta_max_posted(tile_max, warp_max);
      });
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int ray = tile * ray_tile + lane[r];
      best_t_out[ray] = best_t[r];
      best_i_out[ray] = best_i[r];
    }
  }
  if (tests) {  // group 0 owns the tile's rays
    unsigned long long mine = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) mine += g == 0 && alive[tile * ray_tile + lane[r]] > 0 ? blocks : 0;
    add_tests(tests, mine, tb);
  }
}

// The tensor-core kernel's launch bounds: at one m-tile a warp 256 threads
// and 3 CTAs an SM (at most 80 registers a thread; without the minimum
// "mixed" takes 81 and so 2 CTAs, and was slower, PERF.md section 6); at
// two (ray tiles past 128 a group), 1024 threads.
template <int MT>
constexpr int mma_max_threads() {
  return MT == 1 ? 256 : 1024;
}

// The bf16 modes on the tensor cores (see the header).
template <int P, int MT>
__global__ void __launch_bounds__(mma_max_threads<MT>(), MT == 1 ? 3 : 1)
    closest_hit_mma_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                           const float* __restrict__ feats, const int* __restrict__ alive,
                           const float* __restrict__ w, const __nv_bfloat16* __restrict__ w_hi,
                           const __nv_bfloat16* __restrict__ w_lo, float* __restrict__ best_t_out,
                           int* __restrict__ best_i_out, unsigned long long* __restrict__ tests, int nb, int tb,
                           int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float* fold_t = reinterpret_cast<float*>(smem + STAGES * mma_stage_float4<P>());  // (groups, ray_tile)
  int* fold_i = reinterpret_cast<int*>(fold_t + groups * ray_tile);            // (groups, ray_tile)
  __shared__ float warp_max[32];

  const int lane = threadIdx.x & 31;
  const int wpg = ray_tile / (16 * MT);  // warps per group
  const int g = (threadIdx.x >> 5) / wpg;
  const int first = ((threadIdx.x >> 5) - g * wpg) * 16 * MT;  // the warp's first ray in the tile
  const int tile = blockIdx.x;

  RayFragments<P, MT> a;
  a.load(feats, tile * ray_tile + first, lane);
  // Every thread holds the running best of its rays (the groups and a
  // quad's 4 threads agree), and its least (t, row) in the current block.
  int lane_of[MT][2];  // ray within the tile
  float best_t[MT][2], gt[MT][2];
  int best_i[MT][2], gi[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lane_of[m][h] = first + 16 * m + 8 * h + (lane >> 2);
      best_t[m][h] = alive[tile * ray_tile + lane_of[m][h]] > 0 ? BIG : -INFINITY;
      best_i[m][h] = -1;
      gt[m][h] = BIG;
      gi[m][h] = 0;
    }
  }

  const int blocks = walk_schedule<mma_stage_float4<P>()>(
      ring, [&](float4* stage, int blk, int c0) { fetch_chunk_mma<P>(stage, w, w_hi, w_lo, blk, tb, c0); },
      order + (size_t)tile * nb, enter + (size_t)tile * nb, nb, tb, INFINITY,
      [&](const float4* stage, int blk, int c0, int cw4) {
        mma_chunk_min<P, MT>(a, stage, g, groups, 4 * cw4, blk * tb + c0, lane, gt, gi, [](int, int) { return true; });
      },
      [&](int) {
        // Fold the quad, then the groups by (t, row), into the running
        // best, then the tile's worst lane. The fold's reads sit between
        // its barrier and cta_max_posted's, the next block's writes after
        // both.
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) quad_min(gt[m][h], gi[m][h]);
        }
        if (groups > 1) {
          if ((lane & 3) == 0) {
#pragma unroll
            for (int m = 0; m < MT; ++m) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
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
              gt[m][h] = BIG;
              gi[m][h] = 0;
              for (int q = 0; q < groups; ++q) {
                const float t = fold_t[q * ray_tile + lane_of[m][h]];
                const int i = fold_i[q * ray_tile + lane_of[m][h]];
                if (t < gt[m][h] || (t == gt[m][h] && i < gi[m][h])) {
                  gt[m][h] = t;
                  gi[m][h] = i;
                }
              }
            }
          }
        }
        float tile_max = -INFINITY;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (gt[m][h] < best_t[m][h]) {  // strict <: earlier-visited blocks win ties
              best_t[m][h] = gt[m][h];
              if (gt[m][h] < BIG) best_i[m][h] = gi[m][h];
            }
            tile_max = fmaxf(tile_max, best_t[m][h]);
            gt[m][h] = BIG;
            gi[m][h] = 0;
          }
        }
        return cta_max_posted(tile_max, warp_max);
      });
  if (g == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        best_t_out[tile * ray_tile + lane_of[m][h]] = best_t[m][h];
        best_i_out[tile * ray_tile + lane_of[m][h]] = best_i[m][h];
      }
    }
  }
  if (tests) {  // the first thread of each quad of group 0 owns its rays
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
size_t smem_bytes(int ray_tile, int groups) {
  return (P == HIGHEST ? RING_BYTES : mma_ring_bytes<P>()) +
         (size_t)groups * ray_tile * (sizeof(float) + sizeof(int));
}

template <int RPT>
int threads_of(int ray_tile, int groups) {
  return ring_threads<RPT>(ray_tile, groups, RPT == 1 ? 1024 : 512);
}

template <int MT>
int mma_threads_of(int ray_tile, int groups) {
  return mma_threads<MT>(ray_tile, groups, mma_max_threads<MT>());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one CTA per ray tile of `ray_tile` rays
// at `precision` (0 highest, 1 high, 2 mixed, 3 default), and returns
// cudaGetLastError() (0 = launched). At HIGHEST the CTA is `groups` column
// groups of ray_tile / per threads, per = rays a thread (1 or 2), with at
// most 1024 (1 ray a thread) or 512 (2) threads in all; at the bf16 modes
// it is `groups` column groups of ray_tile / (16 per) warps, per = m-tiles
// of 16 rays a warp (1 or 2), with at most 256 (1 m-tile) or 1024 (2)
// threads in all. Anything else
// returns cudaErrorInvalidValue. w_hi and w_lo are read only at the bf16
// modes. `tests` (null: no count) takes the tests computed (see the
// header). The caller checks shapes, types, alignment (tb % 4 == 0; w, w_hi
// and w_lo on a 16-byte boundary) and ray_tile.
int closest_hit_launch(const void* order, const void* enter, const void* feats, const void* alive, const void* w,
                       const void* w_hi, const void* w_lo, void* best_t, void* best_i, void* tests, int rt, int nb,
                       int tb, int ray_tile, int groups, int per, int precision, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    const size_t bytes = smem_bytes<P>(ray_tile, groups);
    const auto o = static_cast<const int*>(order);
    const auto e = static_cast<const float*>(enter);
    const auto f = static_cast<const float*>(feats);
    const auto al = static_cast<const int*>(alive);
    const auto wf = static_cast<const float*>(w);
    const auto bt = static_cast<float*>(best_t);
    const auto bi = static_cast<int*>(best_i);
    const auto n = static_cast<unsigned long long*>(tests);
    if constexpr (P == HIGHEST) {
      if (per == 1 && threads_of<1>(ray_tile, groups)) {
        return launch_ring(closest_hit_kernel<1>, rt, threads_of<1>(ray_tile, groups), bytes, s, o, e, f, al, wf, bt,
                           bi, n, nb, tb, ray_tile, groups);
      }
      if (per == 2 && threads_of<2>(ray_tile, groups)) {
        return launch_ring(closest_hit_kernel<2>, rt, threads_of<2>(ray_tile, groups), bytes, s, o, e, f, al, wf, bt,
                           bi, n, nb, tb, ray_tile, groups);
      }
    } else {
      const auto hi = static_cast<const __nv_bfloat16*>(w_hi);
      const auto lo = static_cast<const __nv_bfloat16*>(w_lo);
      if (per == 1 && mma_threads_of<1>(ray_tile, groups)) {
        return launch_ring(closest_hit_mma_kernel<P, 1>, rt, mma_threads_of<1>(ray_tile, groups), bytes, s, o, e, f,
                           al, wf, hi, lo, bt, bi, n, nb, tb, ray_tile, groups);
      }
      if (per == 2 && mma_threads_of<2>(ray_tile, groups)) {
        return launch_ring(closest_hit_mma_kernel<P, 2>, rt, mma_threads_of<2>(ray_tile, groups), bytes, s, o, e, f,
                           al, wf, hi, lo, bt, bi, n, nb, tb, ray_tile, groups);
      }
    }
    return invalid;
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// closest_hit_launch takes them), or -1 if it is not one.
int closest_hit_occupancy(int ray_tile, int groups, int per, int precision) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    const size_t bytes = smem_bytes<P>(ray_tile, groups);
    if constexpr (P == HIGHEST) {
      if (per == 1) return ring_occupancy(closest_hit_kernel<1>, threads_of<1>(ray_tile, groups), bytes);
      if (per == 2) return ring_occupancy(closest_hit_kernel<2>, threads_of<2>(ray_tile, groups), bytes);
    } else {
      if (per == 1) return ring_occupancy(closest_hit_mma_kernel<P, 1>, mma_threads_of<1>(ray_tile, groups), bytes);
      if (per == 2) return ring_occupancy(closest_hit_mma_kernel<P, 2>, mma_threads_of<2>(ray_tile, groups), bytes);
    }
    return -1;
  });
}

const char* closest_hit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
