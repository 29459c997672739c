// The constants of the packed decision test, shared by the four searches
// (closest_hit.cu, occlusion.cu, closest_hit_streamed.cu and
// occlusion_streamed.cu, all through stream_stage.cuh, which stages and
// multiplies the 25 live slots of a column), and the CTA-wide max with
// which the streamed kernels bound each tile's early exit.
//
// Layouts (row-major, contiguous):
//   feats  float (rt*TR, 16)    ray features [d, o x d, o, 1, 0...]
//   w      float (nb, 16, 5*tb) triangle columns [s0 | s1 | s2 | D | num]

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace decision {

constexpr int K = 16;           // feature depth
constexpr int NS = 5;           // decision scalars per triangle
constexpr int CHUNK = 128;      // triangle columns staged per pass
constexpr float EPS = 1e-6f;    // the reference's EPSILON
constexpr float BIG = 3.0e38f;  // the miss distance

// Max of v over the CTA, returned to every thread. `warp_max` holds one
// float per warp and `result` one float, both in shared memory; two
// barriers, so every thread of the CTA must call it.
__device__ __forceinline__ float cta_max(float v, float* warp_max, float* result) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_max[0];
    for (int i = 1; i < nwarps; ++i) t = fmaxf(t, warp_max[i]);
    *result = t;
  }
  __syncthreads();
  return *result;
}

}  // namespace decision
