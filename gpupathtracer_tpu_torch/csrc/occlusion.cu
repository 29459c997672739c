// Any-hit (shadow-ray) search of ray tiles against the packed scene, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_occlusion` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by `_launch_occlusion`,
// wrapped by `intersect_pallas_occluded`). It computes what that kernel
// computes; it is not carried over block by block.
//
// Inputs (row-major, contiguous, device pointers):
//   order  int32 (rt, nb)       tile i's front-to-back block schedule
//   enter  float (rt, nb)       ascending entry bounds (+inf = culled tail)
//   feats  float (rt*TR, 16)    ray features [d, o x d, o, 1, 0...]
//   maxt   float (rt*TR)        per-ray cutoff; 0 = the lane needs no test
//   w      float (nb, 16, 5*tb) triangle columns [s0 | s1 | s2 | D | num]
// Output: occ int32 (rt*TR), 1 where some accepted hit has t < maxt.
//
// Design: the layout of closest_hit.cu (decision.cuh, which holds the
// block test shared with occlusion_streamed.cu). One CTA per ray
// tile, one thread per ray with its features in registers; each scheduled
// block is staged into shared memory in 128-column chunks (40 KB) and each
// thread takes five f32 FMA dot products per column. A thread keeps one
// `occ` flag and no distance.
//
// Semantics, as the TPU kernel:
//   a pair blocks the ray iff max(s0, s1, s2) <= 0 and D <= -1e-6 and
//   num < 1e-6 * D and num > maxt * D: with D < 0 that is t = num / D in
//   (1e-6, maxt), both strict, with no division. The products are rounded
//   on their own (__fmul_rn) so that no FMA contraction moves a comparison.
//   Before every block, a CTA max-reduction of (occ ? -inf : maxt) gives the
//   tile's bound, in the order of the TPU kernel's loop condition; the loop
//   stops when the schedule ends or the next entry bound is not below it. A
//   tile whose lanes all have maxt = 0 (bound 0 <= every entry) or are all
//   occluded (bound -inf) stops before its next block. A thread whose lane
//   is occluded or has maxt = 0 skips the arithmetic but joins every
//   barrier.
//
// What bounds it on this card: as for closest_hit.cu, the per-pair FMAs and
// the shared-memory broadcasts that feed them, with a CTA barrier per staged
// chunk and two per block for the bound. Later PRs may try: leaving a
// block's chunks as soon as every lane is occluded (__syncthreads_or), the
// product on the tensor cores in 3xTF32, and double-buffered block loads
// with cp.async or TMA.

#include "decision.cuh"

#include <stdint.h>

namespace {

using namespace decision;

__global__ void occlusion_kernel(const int* __restrict__ order,
                                 const float* __restrict__ enter,
                                 const float* __restrict__ feats,
                                 const float* __restrict__ maxt,
                                 const float* __restrict__ w,
                                 int* __restrict__ occ_out,
                                 int nb, int tb) {
  __shared__ float4 stage[STAGE_FLOAT4];
  __shared__ float warp_max[32];
  __shared__ float tile_bound;

  const int tile = blockIdx.x;
  const int ray = tile * blockDim.x + threadIdx.x;

  float f[K];
  load_features(feats, ray, f);
  const float mt = maxt[ray];
  int occ = 0;

  const int* tile_order = order + (size_t)tile * nb;
  const float* tile_enter = enter + (size_t)tile * nb;

  for (int j = 0; j < nb; ++j) {
    // Uniform across the CTA: every thread gets the same bound and entry.
    const float bound = cta_max(occ ? -INFINITY : mt, warp_max, &tile_bound);
    if (!(tile_enter[j] < bound)) break;
    const int blk = tile_order[j];
    if (blk < 0 || blk >= nb) break;  // culled sentinel; unreachable while enter is +inf there
    occluded_in_block(f, stage, w + (size_t)blk * K * NS * tb, tb, mt, occ);
  }
  occ_out[ray] = occ;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with one CTA of `ray_tile` threads per ray
// tile and returns cudaGetLastError() (0 = launched). The caller checks
// shapes, types, alignment (tb % 4 == 0) and ray_tile (a multiple of 32, at
// most 1024).
int occlusion_launch(const void* order, const void* enter, const void* feats,
                     const void* maxt, const void* w, void* occ,
                     int rt, int nb, int tb, int ray_tile, void* stream) {
  occlusion_kernel<<<rt, ray_tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(enter),
      static_cast<const float*>(feats), static_cast<const float*>(maxt),
      static_cast<const float*>(w), static_cast<int*>(occ), nb, tb);
  return static_cast<int>(cudaGetLastError());
}

const char* occlusion_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
