// The parts the packed-search kernels share (closest_hit.cu, occlusion.cu):
// loading a ray's features, staging a block's triangle columns into shared
// memory, the five decision dot products, and the CTA-wide max that bounds
// each tile's early exit.
//
// Layouts (row-major, contiguous):
//   feats  float (rt*TR, 16)    ray features [d, o x d, o, 1, 0...]
//   w      float (nb, 16, 5*tb) triangle columns [s0 | s1 | s2 | D | num]
// A staged chunk keeps w's [scalar][row][column] order for CHUNK columns, so
// staging is a coalesced float4 copy, and every thread of the CTA then reads
// the same float4 (a broadcast: four columns of one row) while it
// accumulates the five dot products of four columns at once with f32 FMAs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace decision {

constexpr int K = 16;         // feature depth
constexpr int NS = 5;         // decision scalars per triangle
constexpr int CHUNK = 128;    // triangle columns staged per pass
constexpr float EPS = 1e-6f;  // the reference's EPSILON
constexpr int STAGE_FLOAT4 = NS * K * (CHUNK / 4);  // 40 KB of shared memory

// The ray's 16 features into registers.
__device__ __forceinline__ void load_features(const float* __restrict__ feats, int ray, float f[K]) {
  const float4* f4 = reinterpret_cast<const float4*>(feats + (size_t)ray * K);
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 v = f4[q];
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// Stages columns [c0, c0 + 4*cw4) of block `wb` (one (16, 5*tb) slice of w)
// into `stage`. The caller brackets it with barriers.
__device__ __forceinline__ void stage_chunk(float4* __restrict__ stage, const float* __restrict__ wb,
                                            int tb, int c0, int cw4) {
  const int five_tb = NS * tb;
  for (int idx = threadIdx.x; idx < NS * K * cw4; idx += blockDim.x) {
    const int r = idx / cw4;  // r = s * K + k
    const int q = idx - r * cw4;
    const int s = r / K;
    const int k = r - s * K;
    stage[r * (CHUNK / 4) + q] =
        *reinterpret_cast<const float4*>(wb + (size_t)k * five_tb + s * tb + c0 + 4 * q);
  }
}

// acc[s][c] = scalar s of staged columns 4q + c, summed over k in order.
__device__ __forceinline__ void decision_dot4(const float f[K], const float4* __restrict__ stage, int q,
                                              float acc[NS][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 v = stage[(s * K + k) * (CHUNK / 4) + q];
      acc[s][0] = fmaf(f[k], v.x, acc[s][0]);
      acc[s][1] = fmaf(f[k], v.y, acc[s][1]);
      acc[s][2] = fmaf(f[k], v.z, acc[s][2]);
      acc[s][3] = fmaf(f[k], v.w, acc[s][3]);
    }
  }
}

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
