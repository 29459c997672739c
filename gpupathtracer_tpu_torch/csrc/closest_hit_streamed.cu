// Closest-hit search of ray tiles along a cluster schedule (the streamed
// route, packs over 16 MiB), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_streamed` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by `_launch_streamed`,
// wrapped by `intersect_pallas`), in its default single-phase mode: no
// cluster budget, one lane group, the cluster-start worst. The TPU kernel's
// seeded `init_t`/`init_i` inputs and its `done` output exist only for its
// default-off two-phase regroup; this kernel seeds BIG / -inf itself and
// has no `done`. It computes what the TPU kernel computes; it is not carried
// over block by block.
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
// Outputs: best_t float (rt*TR), best_i int32 (rt*TR) packed row, -1 on miss.
//
// Semantics, as the TPU kernel: lanes start at BIG (live) or -inf (dead)
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

#include "stream_stage.cuh"

#include <stdint.h>

namespace {

using namespace stream;

template <int RPT>
__global__ void __launch_bounds__(RPT == 1 ? 1024 : 512)
    closest_hit_streamed_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                                const float* __restrict__ enter_blk, const float* __restrict__ feats,
                                const int* __restrict__ alive, const float* __restrict__ w,
                                float* __restrict__ best_t_out, int* __restrict__ best_i_out, int nc, int bpc,
                                int tb, int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float* fold_t = reinterpret_cast<float*>(smem + STAGES * STAGE_FLOAT4);  // (groups, ray_tile)
  int* fold_i = reinterpret_cast<int*>(fold_t + groups * ray_tile);        // (groups, ray_tile)
  __shared__ float warp_max[32];
  __shared__ float tile_worst;

  const int tpg = ray_tile / RPT;  // threads per group
  const int g = threadIdx.x / tpg;
  const int tile = blockIdx.x;
  const int nb = nc * bpc;

  // Every group holds the running best of its rays; the groups agree.
  int lane[RPT];  // ray within the tile
  float f[RPT][NF];
  float best_t[RPT];
  int best_i[RPT];
  float tile_max = -INFINITY;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    lane[r] = threadIdx.x - g * tpg + r * tpg;
    const int ray = tile * ray_tile + lane[r];
    load_live_features(feats, ray, f[r]);
    best_t[r] = alive[ray] > 0 ? BIG : -INFINITY;
    best_i[r] = -1;
    tile_max = fmaxf(tile_max, best_t[r]);
  }
  float worst = decision::cta_max(tile_max, warp_max, &tile_worst);

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;

  for (int j = 0; j < nc; ++j) {
    // Uniform across the CTA: every thread reads the same entries and worst.
    if (!(tile_enter[j] < worst)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there

    float gt[RPT];  // this group's least (t, row) in the cluster
    int gi[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      gt[r] = BIG;
      gi[r] = 0;
    }
    stream_cluster(ring, w + (size_t)c * bpc * K * NS * tb, tile_enter_blk + (size_t)c * bpc, bpc, tb, worst,
                   [&](const float4* stage, int b, int c0, int cw4) {
                     const int row0 = (c * bpc + b) * tb + c0;
                     for (int q = g; q < cw4; q += groups) {
                       float acc[RPT][NS][4];
                       live_dots<RPT>(f, stage, q, acc);
#pragma unroll
                       for (int r = 0; r < RPT; ++r) {
#pragma unroll
                         for (int x = 0; x < 4; ++x) {  // ascending columns
                           const float t = hit_t(acc[r][0][x], acc[r][1][x], acc[r][2][x], acc[r][3][x], acc[r][4][x]);
                           if (t < gt[r]) {  // strict <: the lower row wins ties
                             gt[r] = t;
                             gi[r] = row0 + 4 * q + x;
                           }
                         }
                       }
                     }
                   });

    // Fold the groups by (t, row), then into the running best.
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      fold_t[g * ray_tile + lane[r]] = gt[r];
      fold_i[g * ray_tile + lane[r]] = gi[r];
    }
    __syncthreads();
    tile_max = -INFINITY;
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
      if (ct < best_t[r]) {  // strict <: earlier clusters win ties
        best_t[r] = ct;
        if (ct < BIG) best_i[r] = ci;
      }
      tile_max = fmaxf(tile_max, best_t[r]);
    }
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
    }
  }
}

size_t smem_bytes(int ray_tile, int groups) {
  return RING_BYTES + (size_t)groups * ray_tile * (sizeof(float) + sizeof(int));
}

template <int RPT>
int threads_of(int ray_tile, int groups) {
  return ring_threads<RPT>(ray_tile, groups, RPT == 1 ? 1024 : 512);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one CTA per ray tile of `ray_tile` rays
// as `groups` column groups of ray_tile / rays_per_thread threads, and
// returns cudaGetLastError() (0 = launched). rays_per_thread is 1 or 2 and
// must leave each group a whole number of warps, with at most 1024 (1 ray a
// thread) or 512 (2) threads in all; anything else returns
// cudaErrorInvalidValue. The caller checks shapes, types, alignment
// (tb % 4 == 0, w on a 16-byte boundary) and ray_tile.
int closest_hit_streamed_launch(const void* order, const void* enter, const void* enter_blk,
                                const void* feats, const void* alive, const void* w,
                                void* best_t, void* best_i,
                                int rt, int nc, int bpc, int tb, int ray_tile, int groups,
                                int rays_per_thread, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel, int threads, size_t bytes) {
    return launch_ring(kernel, rt, threads, bytes, s, static_cast<const int*>(order),
                       static_cast<const float*>(enter), static_cast<const float*>(enter_blk),
                       static_cast<const float*>(feats), static_cast<const int*>(alive),
                       static_cast<const float*>(w), static_cast<float*>(best_t), static_cast<int*>(best_i),
                       nc, bpc, tb, ray_tile, groups);
  };
  if (rays_per_thread == 1 && threads_of<1>(ray_tile, groups)) {
    return args(closest_hit_streamed_kernel<1>, threads_of<1>(ray_tile, groups), smem_bytes(ray_tile, groups));
  }
  if (rays_per_thread == 2 && threads_of<2>(ray_tile, groups)) {
    return args(closest_hit_streamed_kernel<2>, threads_of<2>(ray_tile, groups), smem_bytes(ray_tile, groups));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs resident per SM at the launch shape of these arguments (as
// closest_hit_streamed_launch takes them), or -1 if it is not one.
int closest_hit_streamed_occupancy(int ray_tile, int groups, int rays_per_thread) {
  if (rays_per_thread == 1) {
    return ring_occupancy(closest_hit_streamed_kernel<1>, threads_of<1>(ray_tile, groups),
                          smem_bytes(ray_tile, groups));
  }
  if (rays_per_thread == 2) {
    return ring_occupancy(closest_hit_streamed_kernel<2>, threads_of<2>(ray_tile, groups),
                          smem_bytes(ray_tile, groups));
  }
  return -1;
}

const char* closest_hit_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
