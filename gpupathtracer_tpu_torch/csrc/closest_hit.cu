// Closest-hit search of ray tiles against the packed scene, for Hopper (sm_90a).
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
// Outputs: best_t float (rt*TR), best_i int32 (rt*TR) packed row, -1 on miss.
//
// Design. One CTA per ray tile, one thread per ray (TR = blockDim.x). Each
// thread keeps its ray's 16 feature values in registers (rows 10..15 are the
// zero padding of pack_rays). The CTA walks its tile's schedule; for each
// visited block it stages the block's columns into shared memory in chunks
// of 128 triangles (5 scalars x 16 rows x 128 columns x 4 B = 40 KB, for any
// tb) and takes the five dot products per column with f32 FMAs (staging,
// dot products, the block test and the CTA max live in decision.cuh, shared
// with the other three searches). No TF32: the parity bar needs f32 t.
//
// Semantics, as the TPU kernel:
//   accept iff max(s0, s1, s2) <= 0 and D <= -1e-6 and num < 1e-6 * D, then
//   t = num / D (IEEE division), else BIG; per block the minimum over
//   ascending columns with strict < (ties go to the lower column); the
//   running best is replaced only on strict <, and best_i only when the
//   block minimum is below BIG. After each block a CTA max-reduction of
//   best_t gives the tile's worst lane; the loop stops when the next entry
//   bound is >= worst (worst starts at +inf) or the schedule ends. Dead lanes
//   sit at -inf, so they never update and never hold the loop open.
//
// Memory: the pack (1.7 MB at 5,248 rows) stays in the 50 MB L2, so blocks
// are re-read from L2 per visiting tile. The kernel itself takes a pack of
// any size; the host sends packs over 16 MiB to closest_hit_streamed.cu, by
// the JAX package's resident/streamed rule.
//
// What bounds it on this card: the per-pair arithmetic, 5 x 16 FMAs plus the
// epilogue, and the shared-memory broadcasts that feed them (one 16-byte load
// per 4 FMAs), with a CTA barrier per staged chunk and per block. Later work
// may skip the zero K rows (6 padding rows, and the structural zeros of each
// scalar's column), run the product on the tensor cores with mma.sync or
// wgmma in 3xTF32, and double-buffer the block loads with cp.async or TMA.

#include "decision.cuh"

#include <stdint.h>

namespace {

using namespace decision;

__global__ void closest_hit_kernel(const int* __restrict__ order,
                                   const float* __restrict__ enter,
                                   const float* __restrict__ feats,
                                   const int* __restrict__ alive,
                                   const float* __restrict__ w,
                                   float* __restrict__ best_t_out,
                                   int* __restrict__ best_i_out,
                                   int nb, int tb) {
  __shared__ float4 stage[STAGE_FLOAT4];
  __shared__ float warp_max[32];
  __shared__ float tile_worst;

  const int tile = blockIdx.x;
  const int ray = tile * blockDim.x + threadIdx.x;

  float f[K];
  load_features(feats, ray, f);
  float best_t = alive[ray] > 0 ? BIG : -INFINITY;
  int best_i = -1;
  float worst = INFINITY;

  const int* tile_order = order + (size_t)tile * nb;
  const float* tile_enter = enter + (size_t)tile * nb;

  for (int j = 0; j < nb; ++j) {
    // Uniform across the CTA: every thread reads the same entry and worst.
    if (!(tile_enter[j] < worst)) break;
    const int blk = tile_order[j];
    if (blk < 0 || blk >= nb) break;  // culled sentinel; unreachable while enter is +inf there
    closest_in_block(f, stage, w + (size_t)blk * K * NS * tb, tb, blk, best_t, best_i);
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
int closest_hit_launch(const void* order, const void* enter, const void* feats,
                       const void* alive, const void* w, void* best_t, void* best_i,
                       int rt, int nb, int tb, int ray_tile, void* stream) {
  closest_hit_kernel<<<rt, ray_tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(enter),
      static_cast<const float*>(feats), static_cast<const int*>(alive),
      static_cast<const float*>(w), static_cast<float*>(best_t), static_cast<int*>(best_i),
      nb, tb);
  return static_cast<int>(cudaGetLastError());
}

const char* closest_hit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
