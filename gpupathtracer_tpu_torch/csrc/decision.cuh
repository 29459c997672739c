// The parts the resident packed-search kernels share (closest_hit.cu,
// occlusion.cu): loading a ray's features, staging a block's triangle
// columns into shared memory, the five decision dot products, the
// closest-hit and any-hit tests of one block, and the CTA-wide max that
// bounds each tile's early exit. The streamed kernels take the constants and
// the CTA max from here and stage and multiply through stream_stage.cuh.
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
constexpr float BIG = 3.0e38f;  // the miss distance
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

// Closest hit of this thread's ray in block `blk` (its columns at `wb`),
// folded into the running (best_t, best_i). Accept iff max(s0, s1, s2) <= 0
// and D <= -1e-6 and num < 1e-6 * D, then t = num / D (IEEE division), else
// BIG; the block minimum is taken over ascending columns with strict < (the
// lower column wins ties); the running best is replaced only on strict <
// (earlier blocks win ties), and best_i only when the minimum is below BIG.
// Every thread of the CTA must call it (it stages with barriers).
__device__ __forceinline__ void closest_in_block(const float f[K], float4* __restrict__ stage,
                                                 const float* __restrict__ wb, int tb, int blk,
                                                 float& best_t, int& best_i) {
  float blk_min = INFINITY;
  int blk_arg = 0;
  for (int c0 = 0; c0 < tb; c0 += CHUNK) {
    const int cw4 = min(CHUNK, tb - c0) / 4;  // float4 columns in this chunk
    __syncthreads();  // the previous chunk has been read
    stage_chunk(stage, wb, tb, c0, cw4);
    __syncthreads();

    for (int q = 0; q < cw4; ++q) {
      float acc[NS][4];
      decision_dot4(f, stage, q, acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // ascending columns
        const float edge = fmaxf(fmaxf(acc[0][c], acc[1][c]), acc[2][c]);
        const float dd = acc[3][c];
        const float num = acc[4][c];
        float t = BIG;
        if (edge <= 0.0f && dd <= -EPS && num < __fmul_rn(EPS, dd)) t = __fdiv_rn(num, dd);
        if (t < blk_min) {  // strict <: the lower column wins ties
          blk_min = t;
          blk_arg = c0 + 4 * q + c;
        }
      }
    }
  }
  if (blk_min < best_t) {  // strict <: earlier blocks win ties
    best_t = blk_min;
    if (blk_min < BIG) best_i = blk * tb + blk_arg;
  }
}

// Any hit of this thread's ray in the block at `wb` with t in (1e-6, mt),
// or'ed into `occ`: max(s0, s1, s2) <= 0 and D <= -1e-6 and num < 1e-6 * D
// and num > mt * D (with D < 0 that is t = num / D in (1e-6, mt), both
// strict, with no division). The products are rounded on their own
// (__fmul_rn) so that no FMA contraction moves a comparison. A lane already
// occluded, or with mt = 0, skips the arithmetic but joins every barrier.
__device__ __forceinline__ void occluded_in_block(const float f[K], float4* __restrict__ stage,
                                                  const float* __restrict__ wb, int tb, float mt, int& occ) {
  for (int c0 = 0; c0 < tb; c0 += CHUNK) {
    const int cw4 = min(CHUNK, tb - c0) / 4;  // float4 columns in this chunk
    __syncthreads();  // the previous chunk has been read
    stage_chunk(stage, wb, tb, c0, cw4);
    __syncthreads();
    if (occ || !(mt > 0.0f)) continue;  // nothing left to test on this lane

    for (int q = 0; q < cw4 && !occ; ++q) {
      float acc[NS][4];
      decision_dot4(f, stage, q, acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float edge = fmaxf(fmaxf(acc[0][c], acc[1][c]), acc[2][c]);
        const float dd = acc[3][c];
        const float num = acc[4][c];
        if (edge <= 0.0f && dd <= -EPS && num < __fmul_rn(EPS, dd) && num > __fmul_rn(mt, dd)) occ = 1;
      }
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
