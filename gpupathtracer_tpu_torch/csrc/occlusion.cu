// Any-hit (shadow-ray) search of ray tiles against the packed scene (the
// resident route, packs up to 16 MiB), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_occlusion` in
// gpupathtracer_tpu/ops/pallas_intersect.py (launched by `_launch_occlusion`,
// wrapped by `intersect_pallas_occluded`). It computes what that kernel
// computes; it is not carried over block by block.
//
// Inputs (row-major, contiguous, device pointers): order, enter, feats and w
// as in closest_hit.cu (w from pack_scene; only its live slots are read), and
//   maxt   float (rt*TR)        per-ray cutoff; 0 = the lane needs no test
// Output: occ int32 (rt*TR), 1 where some accepted hit has t < maxt.
// For the bf16 precision modes, w is operand a and w_lo operand b of
// stream_stage.cuh; HIGHEST reads w only.
//
// Semantics, as the TPU kernel, at each of its precisions: a pair blocks the ray iff max(s0, s1, s2)
// <= 0 and D <= -1e-6 and num < 1e-6 * D and num > maxt * D: with D < 0
// that is t = num / D in (1e-6, maxt), both strict, with no division. The
// products are rounded on their own (__fmul_rn) so that no FMA contraction
// moves a comparison. Before every block, a CTA max-reduction of
// (occ ? -inf : maxt) gives the tile's bound, in the order of the TPU
// kernel's loop condition; the loop stops when the schedule ends or the next
// entry bound is not below it. A tile whose lanes all have maxt = 0 (bound
// 0 <= every entry) or are all occluded (bound -inf) stops before its next
// block.
//
// Design: closest_hit.cu's (stream_stage.cuh: the 25 live slots only, the
// cp.async ring along the tile's block schedule, `groups` column groups of
// warps over one ray tile), at one ray a thread. A ray's flag is or'ed
// across the groups through a per-ray word in shared memory, read and set
// through block-scope relaxed atomics as in occlusion_streamed.cu: a group
// that finds a hit sets it at once, and every group reads it at the start of
// each chunk, so a lane occluded in one group stops testing in the others by
// the next chunk. The word only goes from 0 to 1, so a late read costs time
// and never a flag. After each block's last chunk a barrier completes the
// block's flags, every thread takes the OR, and the bound of the next block
// is the max over those flags, exactly the plain version's bound. A thread
// whose ray is occluded or has maxt = 0 skips the arithmetic but joins every
// copy and barrier.
//
// What bounds it on the H100 (measured by chip_smoke.py and
// tools/stream_sweep.py; times in PERF.md section 6): too little parallel
// work. NEE shadow rays are few, so only a small share of the tiles holds
// live lanes, and each live tile walks its blocks chunk after chunk; more
// warps per tile is the cure this design takes.

#include "stream_stage.cuh"

#include <cuda/atomic>
#include <stdint.h>

namespace {

using namespace stream;

template <int P>
__global__ void __launch_bounds__(1024)
    occlusion_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                     const float* __restrict__ feats, const float* __restrict__ maxt,
                     const float* __restrict__ w, const float* __restrict__ w_lo, int* __restrict__ occ_out, int nb,
                     int tb, int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* occ_shared = reinterpret_cast<int*>(smem + STAGES * stage_float4<P>());  // (ray_tile,)
  __shared__ float warp_max[32];

  const int g = threadIdx.x / ray_tile;
  const int lane = threadIdx.x - g * ray_tile;  // ray within the tile
  const int tile = blockIdx.x;
  const int ray = tile * ray_tile + lane;

  RayFeatures<P> f[1];
  f[0].load(feats, ray);
  const float mt = maxt[ray];
  cuda::atomic_ref<int, cuda::thread_scope_block> flag(occ_shared[lane]);
  if (g == 0) flag.store(0, cuda::std::memory_order_relaxed);
  int occ = 0;
  // The bound before the first block; its barrier also publishes the zeroed
  // flags.
  const float bound = cta_max_posted(mt, warp_max);

  stream_schedule<P>(
      ring, w, w_lo, order + (size_t)tile * nb, enter + (size_t)tile * nb, nb, tb, bound,
      [&](const float4* stage, int, int, int cw4) {
        occ |= flag.load(cuda::std::memory_order_relaxed);  // the other groups' finds so far
        if (occ || !(mt > 0.0f)) return;
        for (int q = g; q < cw4; q += groups) {
          float acc[1][NS][4];
          live_dots<1, P>(f, stage, q, acc);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (blocks_ray(acc[0][0][x], acc[0][1][x], acc[0][2][x], acc[0][3][x], acc[0][4][x], mt)) occ = 1;
          }
          if (occ) {
            flag.store(1, cuda::std::memory_order_relaxed);
            return;
          }
        }
      },
      [&](int) {
        __syncthreads();  // every group's flags of this block are in occ_shared
        occ |= flag.load(cuda::std::memory_order_relaxed);
        return cta_max_posted(occ ? -INFINITY : mt, warp_max);
      });
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
int occlusion_launch(const void* order, const void* enter, const void* feats, const void* maxt, const void* w,
                     const void* w_lo, void* occ, int rt, int nb, int tb, int ray_tile, int groups, int precision,
                     void* stream) {
  const int threads = threads_of(ray_tile, groups);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (threads == 0) return invalid;
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return launch_ring(occlusion_kernel<P>, rt, threads, smem_bytes<P>(ray_tile), static_cast<cudaStream_t>(stream),
                       static_cast<const int*>(order), static_cast<const float*>(enter),
                       static_cast<const float*>(feats), static_cast<const float*>(maxt),
                       static_cast<const float*>(w), static_cast<const float*>(w_lo), static_cast<int*>(occ), nb, tb,
                       ray_tile, groups);
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// occlusion_launch takes them), or -1 if it is not one.
int occlusion_occupancy(int ray_tile, int groups, int precision) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return ring_occupancy(occlusion_kernel<P>, threads_of(ray_tile, groups), smem_bytes<P>(ray_tile));
  });
}

const char* occlusion_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
