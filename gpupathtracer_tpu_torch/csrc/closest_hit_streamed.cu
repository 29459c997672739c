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
//   w         float (nc*bpc, 16, 5*tb) triangle columns [s0 | s1 | s2 | D | num];
//                                   cluster c is blocks c*bpc .. c*bpc+bpc-1
// Outputs: best_t float (rt*TR), best_i int32 (rt*TR) packed row, -1 on miss.
//
// Semantics, as the TPU kernel: lanes start at BIG (live) or -inf (dead)
// with best_i -1, and `worst` starts as the tile's max of those (so an
// all-dead tile visits nothing). The loop takes schedule positions j while
// j < nc and enter[j] < worst. For cluster c = order[j], blocks b = 0..bpc-1
// in order are computed iff enter_blk[c*bpc + b] < worst, where worst is the
// value at the cluster's start (not refreshed inside the cluster: the
// plain version's work count, and so the bound, describe exactly that). The
// block test is closest_hit.cu's (decision.cuh: ascending columns, strict <
// everywhere, IEEE division). After the cluster, worst = the tile's max
// best_t.
//
// Design: closest_hit.cu's layout. One CTA per ray tile (64 rays on the
// main path), one thread per ray with its 16 features in registers; each
// computed block is staged into shared memory in 128-column chunks (40 KB)
// and each thread takes five f32 FMA dot products per column. The TPU's
// double-buffered cluster DMA has no counterpart here: a ~1 MB cluster does
// not fit in an SM's 228 KB of shared memory, so blocks are staged chunk by
// chunk from global memory as in closest_hit.cu.
//
// What bounds it on this card: the per-pair FMAs and shared-memory
// broadcasts, as in closest_hit.cu, but the streamed packs (~105 MB) exceed
// the 50 MB L2, so visited blocks come from HBM, with no overlap of a
// block's loads and the previous block's arithmetic. 64-thread CTAs at 40 KB
// allow at most 5 CTAs (10 warps) per SM. Later work: cp.async or TMA
// double-buffering of the chunks, and more rays per CTA.

#include "decision.cuh"

#include <stdint.h>

namespace {

using namespace decision;

__global__ void closest_hit_streamed_kernel(const int* __restrict__ order,
                                            const float* __restrict__ enter,
                                            const float* __restrict__ enter_blk,
                                            const float* __restrict__ feats,
                                            const int* __restrict__ alive,
                                            const float* __restrict__ w,
                                            float* __restrict__ best_t_out,
                                            int* __restrict__ best_i_out,
                                            int nc, int bpc, int tb) {
  __shared__ float4 stage[STAGE_FLOAT4];
  __shared__ float warp_max[32];
  __shared__ float tile_worst;

  const int tile = blockIdx.x;
  const int ray = tile * blockDim.x + threadIdx.x;
  const int nb = nc * bpc;

  float f[K];
  load_features(feats, ray, f);
  float best_t = alive[ray] > 0 ? BIG : -INFINITY;
  int best_i = -1;
  float worst = cta_max(best_t, warp_max, &tile_worst);

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;

  for (int j = 0; j < nc; ++j) {
    // Uniform across the CTA: every thread reads the same entries and worst.
    if (!(tile_enter[j] < worst)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there
    for (int b = 0; b < bpc; ++b) {
      const int blk = c * bpc + b;
      if (!(tile_enter_blk[blk] < worst)) continue;  // against the cluster-start worst
      closest_in_block(f, stage, w + (size_t)blk * K * NS * tb, tb, blk, best_t, best_i);
    }
    worst = cta_max(best_t, warp_max, &tile_worst);  // the tile's worst lane
  }
  best_t_out[ray] = best_t;
  best_i_out[ray] = best_i;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with one CTA of `ray_tile` threads per ray
// tile and returns cudaGetLastError() (0 = launched). The caller checks
// shapes, types, alignment (tb % 4 == 0) and ray_tile (a multiple of 32, at
// most 1024).
int closest_hit_streamed_launch(const void* order, const void* enter, const void* enter_blk,
                                const void* feats, const void* alive, const void* w,
                                void* best_t, void* best_i,
                                int rt, int nc, int bpc, int tb, int ray_tile, void* stream) {
  closest_hit_streamed_kernel<<<rt, ray_tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(enter),
      static_cast<const float*>(enter_blk), static_cast<const float*>(feats),
      static_cast<const int*>(alive), static_cast<const float*>(w),
      static_cast<float*>(best_t), static_cast<int*>(best_i), nc, bpc, tb);
  return static_cast<int>(cudaGetLastError());
}

const char* closest_hit_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
