// Any-hit (shadow-ray) search of ray tiles along a cluster schedule (the
// streamed route, packs over 16 MiB), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_occlusion_streamed` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by
// `_launch_occlusion_streamed`, wrapped by `intersect_pallas_occluded`). It
// computes what that kernel computes; it is not carried over block by block.
//
// Inputs (row-major, contiguous, device pointers): order, enter, enter_blk,
// feats and w as in closest_hit_streamed.cu (w from pack_scene; only its
// live slots are read), and
//   maxt  float (rt*TR)   per-ray cutoff; 0 = the lane needs no test
// Output: occ int32 (rt*TR), 1 where some accepted hit has t < maxt.
// For the bf16 precision modes, w is operand a and w_lo operand b of
// stream_stage.cuh; HIGHEST reads w only.
//
// Semantics, as the TPU kernel, at each of its precisions: flags start at 0 and the tile's bound at
// +inf, so unlike occlusion.cu the first scheduled cluster is visited even
// when every cutoff is tiny (the flags do not change; the work does, and the
// plain version follows it). The loop takes schedule positions j while
// j < nc and enter[j] < bound. For cluster c = order[j], blocks b = 0..bpc-1
// in order are tested iff enter_blk[c*bpc + b] < bound, where bound is the
// value at the cluster's start. A pair blocks the ray iff max(s0, s1, s2)
// <= 0 and D <= -1e-6 and num < 1e-6 * D and num > maxt * D (t in
// (1e-6, maxt), no division; the products rounded on their own so that no
// FMA contraction moves a comparison). After the cluster a CTA
// max-reduction of (occ ? -inf : maxt) gives the bound: -inf once every
// lane is occluded, 0 when the rest have maxt = 0.
//
// Design: closest_hit_streamed.cu's (stream_stage.cuh: the 25 live slots
// only, the cp.async ring along the cluster's tested blocks, `groups`
// column groups of warps over one ray tile), at one ray a thread. A ray's
// flag is or'ed across the groups through a per-ray word in shared memory:
// a group that finds a hit sets it at once, and every group reads it at the
// start of each chunk, so a lane occluded in one group stops testing in the
// others by the next chunk. Groups set and read the word between barriers,
// so it is accessed through block-scope relaxed atomics; the race that
// remains is only one of timing (a group may test a lane that another group
// has just occluded), which costs time and never a flag: the word only goes
// from 0 to 1, and the barrier at the cluster's end gives every group the
// final OR. So the flags equal the block-by-block chain's. A thread whose ray
// is occluded or has maxt = 0 skips the arithmetic but joins every copy and
// barrier.
//
// What bounds it on the H100 (measured by chip_smoke.py and
// tools/stream_sweep.py; times in PERF.md section 6): too little parallel
// work, unevenly spread. NEE shadow rays are few, so only a small share of
// the tiles holds live lanes, and a live tile walks most of the pack's
// blocks chunk after chunk, so the longest tiles set the time. Small CTAs
// (2 groups of 64 threads), more of them per SM, beat wide ones.

#include "stream_stage.cuh"

#include <cuda/atomic>
#include <stdint.h>

namespace {

using namespace stream;

template <int P>
__global__ void __launch_bounds__(1024)
    occlusion_streamed_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                              const float* __restrict__ enter_blk, const float* __restrict__ feats,
                              const float* __restrict__ maxt, const float* __restrict__ w,
                              const float* __restrict__ w_lo, int* __restrict__ occ_out, int nc, int bpc, int tb,
                              int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* occ_shared = reinterpret_cast<int*>(smem + STAGES * stage_float4<P>());  // (ray_tile,)
  __shared__ float warp_max[32];
  __shared__ float tile_bound;

  const int g = threadIdx.x / ray_tile;
  const int lane = threadIdx.x - g * ray_tile;  // ray within the tile
  const int tile = blockIdx.x;
  const int ray = tile * ray_tile + lane;
  const int nb = nc * bpc;

  RayFeatures<P> f[1];
  f[0].load(feats, ray);
  const float mt = maxt[ray];
  cuda::atomic_ref<int, cuda::thread_scope_block> flag(occ_shared[lane]);
  if (g == 0) flag.store(0, cuda::std::memory_order_relaxed);
  __syncthreads();
  int occ = 0;
  float bound = INFINITY;

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;

  for (int j = 0; j < nc; ++j) {
    // Uniform across the CTA: every thread reads the same entries and bound.
    if (!(tile_enter[j] < bound)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there
    const size_t cluster = (size_t)c * bpc * K * NS * tb;
    stream_cluster<P>(ring, w + cluster, w_lo + cluster, tile_enter_blk + (size_t)c * bpc, bpc, tb, bound,
                   [&](const float4* stage, int, int, int cw4) {
                     occ |= flag.load(cuda::std::memory_order_relaxed);  // the other groups' finds so far
                     if (occ || !(mt > 0.0f)) return;
                     for (int q = g; q < cw4; q += groups) {
                       float acc[1][NS][4];
                       live_dots<1, P>(f, stage, q, acc);
#pragma unroll
                       for (int x = 0; x < 4; ++x) {
                         if (blocks_ray(acc[0][0][x], acc[0][1][x], acc[0][2][x], acc[0][3][x], acc[0][4][x], mt)) {
                           occ = 1;
                         }
                       }
                       if (occ) {
                         flag.store(1, cuda::std::memory_order_relaxed);
                         return;
                       }
                     }
                   });
    __syncthreads();  // every group's flags of this cluster are in occ_shared
    occ |= flag.load(cuda::std::memory_order_relaxed);
    // Its barriers also keep the next cluster's copies behind every read of
    // this one.
    bound = decision::cta_max(occ ? -INFINITY : mt, warp_max, &tile_bound);
  }
  if (g == 0) occ_out[ray] = occ;
}

template <int P>
size_t smem_bytes(int ray_tile) { return ring_bytes<P>() + (size_t)ray_tile * sizeof(int); }

int threads_of(int ray_tile, int groups) { return ring_threads<1>(ray_tile, groups, 1024); }

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one CTA per ray tile of `ray_tile` rays
// as `groups` column groups of ray_tile threads (one ray a thread), at
// `precision` (0 highest, 1 high, 2 mixed, 3 default), and returns
// cudaGetLastError() (0 = launched; cudaErrorInvalidValue for a shape the
// kernel does not take: more than 1024 threads, or a ray_tile that is not
// a multiple of 32, or another precision). The caller checks shapes,
// types, alignment (tb % 4 == 0, w and w_lo on a 16-byte boundary) and
// ray_tile.
int occlusion_streamed_launch(const void* order, const void* enter, const void* enter_blk,
                              const void* feats, const void* maxt, const void* w, const void* w_lo, void* occ,
                              int rt, int nc, int bpc, int tb, int ray_tile, int groups, int precision, void* stream) {
  const int threads = threads_of(ray_tile, groups);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (threads == 0) return invalid;
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return launch_ring(occlusion_streamed_kernel<P>, rt, threads, smem_bytes<P>(ray_tile),
                       static_cast<cudaStream_t>(stream), static_cast<const int*>(order),
                       static_cast<const float*>(enter), static_cast<const float*>(enter_blk),
                       static_cast<const float*>(feats), static_cast<const float*>(maxt),
                       static_cast<const float*>(w), static_cast<const float*>(w_lo), static_cast<int*>(occ), nc, bpc,
                       tb, ray_tile, groups);
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// occlusion_streamed_launch takes them), or -1 if it is not one.
int occlusion_streamed_occupancy(int ray_tile, int groups, int precision) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return ring_occupancy(occlusion_streamed_kernel<P>, threads_of(ray_tile, groups), smem_bytes<P>(ray_tile));
  });
}

const char* occlusion_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
