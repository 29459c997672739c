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
// Outputs: best_t float (rt*TR), best_i int32 (rt*TR) packed row, -1 on miss.
// For the bf16 precision modes, w is operand a and w_lo operand b of
// stream_stage.cuh (the wrapper's `_kernel_operands`); HIGHEST reads w only.
//
// Semantics, as the TPU kernel, at each of its precisions (the decision
// products of stream_stage.cuh's live_dots): lanes start at BIG (live) or -inf (dead)
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

#include "stream_stage.cuh"

#include <stdint.h>

namespace {

using namespace stream;

template <int RPT, int P>
__global__ void __launch_bounds__(RPT == 1 ? 1024 : 512)
    closest_hit_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                       const float* __restrict__ feats, const int* __restrict__ alive,
                       const float* __restrict__ w, const float* __restrict__ w_lo, float* __restrict__ best_t_out,
                       int* __restrict__ best_i_out, int nb, int tb, int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float* fold_t = reinterpret_cast<float*>(smem + STAGES * stage_float4<P>());  // (groups, ray_tile)
  int* fold_i = reinterpret_cast<int*>(fold_t + groups * ray_tile);        // (groups, ray_tile)
  __shared__ float warp_max[32];

  const int tpg = ray_tile / RPT;  // threads per group
  const int g = threadIdx.x / tpg;
  const int tile = blockIdx.x;

  // Group 0 holds the running best of its rays; every group its least
  // (t, row) in the current block.
  int lane[RPT];  // ray within the tile
  RayFeatures<P> f[RPT];
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

  stream_schedule<P>(
      ring, w, w_lo, order + (size_t)tile * nb, enter + (size_t)tile * nb, nb, tb, INFINITY,
      [&](const float4* stage, int blk, int c0, int cw4) {
        const int row0 = blk * tb + c0;
        for (int q = g; q < cw4; q += groups) {
          float acc[RPT][NS][4];
          live_dots<RPT, P>(f, stage, q, acc);
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
}

template <int P>
size_t smem_bytes(int ray_tile, int groups) {
  return ring_bytes<P>() + (size_t)groups * ray_tile * (sizeof(float) + sizeof(int));
}

template <int RPT>
int threads_of(int ray_tile, int groups) {
  return ring_threads<RPT>(ray_tile, groups, RPT == 1 ? 1024 : 512);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one CTA per ray tile of `ray_tile` rays
// as `groups` column groups of ray_tile / rays_per_thread threads, at
// `precision` (0 highest, 1 high, 2 mixed, 3 default), and returns
// cudaGetLastError() (0 = launched). rays_per_thread is 1 or 2 and must
// leave each group a whole number of warps, with at most 1024 (1 ray a
// thread) or 512 (2) threads in all; anything else returns
// cudaErrorInvalidValue. The caller checks shapes, types, alignment
// (tb % 4 == 0, w and w_lo on a 16-byte boundary) and ray_tile.
int closest_hit_launch(const void* order, const void* enter, const void* feats, const void* alive, const void* w,
                       const void* w_lo, void* best_t, void* best_i, int rt, int nb, int tb, int ray_tile, int groups,
                       int rays_per_thread, int precision, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    auto args = [&](auto kernel, int threads) {
      return launch_ring(kernel, rt, threads, smem_bytes<P>(ray_tile, groups), s, static_cast<const int*>(order),
                         static_cast<const float*>(enter), static_cast<const float*>(feats),
                         static_cast<const int*>(alive), static_cast<const float*>(w),
                         static_cast<const float*>(w_lo), static_cast<float*>(best_t), static_cast<int*>(best_i), nb,
                         tb, ray_tile, groups);
    };
    if (rays_per_thread == 1 && threads_of<1>(ray_tile, groups)) {
      return args(closest_hit_kernel<1, P>, threads_of<1>(ray_tile, groups));
    }
    if (rays_per_thread == 2 && threads_of<2>(ray_tile, groups)) {
      return args(closest_hit_kernel<2, P>, threads_of<2>(ray_tile, groups));
    }
    return invalid;
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// closest_hit_launch takes them), or -1 if it is not one.
int closest_hit_occupancy(int ray_tile, int groups, int rays_per_thread, int precision) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (rays_per_thread == 1) {
      return ring_occupancy(closest_hit_kernel<1, P>, threads_of<1>(ray_tile, groups), smem_bytes<P>(ray_tile, groups));
    }
    if (rays_per_thread == 2) {
      return ring_occupancy(closest_hit_kernel<2, P>, threads_of<2>(ray_tile, groups), smem_bytes<P>(ray_tile, groups));
    }
    return -1;
  });
}

const char* closest_hit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
