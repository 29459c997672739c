// Any-hit (shadow-ray) search of ray tiles along a cluster schedule (the
// streamed route, packs over 16 MiB), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_occlusion_streamed` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by
// `_launch_occlusion_streamed`, wrapped by `intersect_pallas_occluded`). It
// computes what that kernel computes; it is not carried over block by block.
//
// Inputs (row-major, contiguous, device pointers): order, enter, enter_blk,
// feats and w as in closest_hit_streamed.cu, and
//   maxt  float (rt*TR)   per-ray cutoff; 0 = the lane needs no test
// Output: occ int32 (rt*TR), 1 where some accepted hit has t < maxt.
//
// Semantics, as the TPU kernel: flags start at 0 and the tile's bound at
// +inf, so unlike occlusion.cu the first scheduled cluster is visited even
// when every cutoff is tiny (the flags do not change; the work does, and the
// plain version follows it). The loop takes schedule positions j while
// j < nc and enter[j] < bound. For cluster c = order[j], blocks b = 0..bpc-1
// in order are tested iff enter_blk[c*bpc + b] < bound, where bound is the
// value at the cluster's start. The block test is occlusion.cu's
// (decision.cuh: division-free, __fmul_rn products). After the cluster a
// CTA max-reduction of (occ ? -inf : maxt) gives the bound: -inf once every
// lane is occluded, 0 when the rest have maxt = 0.
//
// Design and what bounds it: as closest_hit_streamed.cu (one CTA per
// 64-ray tile, one thread per ray, blocks staged from global memory in
// 128-column chunks of 40 KB, the ~105 MB pack read from HBM). A thread
// keeps one `occ` flag and no distance; an occluded lane, or one with
// maxt = 0, skips the arithmetic but joins every barrier.

#include "decision.cuh"

#include <stdint.h>

namespace {

using namespace decision;

__global__ void occlusion_streamed_kernel(const int* __restrict__ order,
                                          const float* __restrict__ enter,
                                          const float* __restrict__ enter_blk,
                                          const float* __restrict__ feats,
                                          const float* __restrict__ maxt,
                                          const float* __restrict__ w,
                                          int* __restrict__ occ_out,
                                          int nc, int bpc, int tb) {
  __shared__ float4 stage[STAGE_FLOAT4];
  __shared__ float warp_max[32];
  __shared__ float tile_bound;

  const int tile = blockIdx.x;
  const int ray = tile * blockDim.x + threadIdx.x;
  const int nb = nc * bpc;

  float f[K];
  load_features(feats, ray, f);
  const float mt = maxt[ray];
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
    for (int b = 0; b < bpc; ++b) {
      const int blk = c * bpc + b;
      if (!(tile_enter_blk[blk] < bound)) continue;  // against the cluster-start bound
      occluded_in_block(f, stage, w + (size_t)blk * K * NS * tb, tb, mt, occ);
    }
    bound = cta_max(occ ? -INFINITY : mt, warp_max, &tile_bound);
  }
  occ_out[ray] = occ;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with one CTA of `ray_tile` threads per ray
// tile and returns cudaGetLastError() (0 = launched). The caller checks
// shapes, types, alignment (tb % 4 == 0) and ray_tile (a multiple of 32, at
// most 1024).
int occlusion_streamed_launch(const void* order, const void* enter, const void* enter_blk,
                              const void* feats, const void* maxt, const void* w, void* occ,
                              int rt, int nc, int bpc, int tb, int ray_tile, void* stream) {
  occlusion_streamed_kernel<<<rt, ray_tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(enter),
      static_cast<const float*>(enter_blk), static_cast<const float*>(feats),
      static_cast<const float*>(maxt), static_cast<const float*>(w), static_cast<int*>(occ),
      nc, bpc, tb);
  return static_cast<int>(cudaGetLastError());
}

const char* occlusion_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
