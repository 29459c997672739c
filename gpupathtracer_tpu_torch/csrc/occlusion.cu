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
//   w_hi, w_lo bf16 (nb, 5, tb, 8) the bf16 modes' operands, as in
//               closest_hit.cu; HIGHEST reads w only, MIXED also w's D|num
//               rows
// Output: occ int32 (rt*TR), 1 where some accepted hit has t < maxt.
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
//
// The bf16 modes (occlusion_mma_kernel<P, MT>) take the tensor-core route
// of stream_stage.cuh, as closest_hit.cu's do: `groups` column groups of
// ray_tile / (16 MT) warps, each warp MT m-tiles of 16 rays with their bf16
// A fragments in registers, group g taking n-tiles g, g + groups, ... of
// every chunk (mma_chunk_any, as occlusion_streamed.cu's). A ray's flag is
// the OR of its quad's 4 threads, crossing the groups through the per-ray
// shared word above (the quad's first thread sets it); after
// each block come a barrier, the OR, and the next bound with one barrier
// (cta_max_posted), in the order of the TPU kernel's loop condition. A warp
// whose rays are all occluded or have maxt = 0 skips the chunk. The sums take the tensor
// cores' order, so the flags meet the flag bar against the plain version,
// not bit-equality.

#include "stream_stage.cuh"

#include <cuda/atomic>
#include <stdint.h>

namespace {

using namespace stream;

// HIGHEST (the bf16 modes take the tensor-core kernel below).
__global__ void __launch_bounds__(1024)
    occlusion_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                     const float* __restrict__ feats, const float* __restrict__ maxt,
                     const float* __restrict__ w, int* __restrict__ occ_out, int nb, int tb, int ray_tile,
                     int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* occ_shared = reinterpret_cast<int*>(smem + STAGES * STAGE_FLOAT4);  // (ray_tile,)
  __shared__ float warp_max[32];

  const int g = threadIdx.x / ray_tile;
  const int lane = threadIdx.x - g * ray_tile;  // ray within the tile
  const int tile = blockIdx.x;
  const int ray = tile * ray_tile + lane;

  RayFeatures f[1];
  f[0].load(feats, ray);
  const float mt = maxt[ray];
  cuda::atomic_ref<int, cuda::thread_scope_block> flag(occ_shared[lane]);
  if (g == 0) flag.store(0, cuda::std::memory_order_relaxed);
  int occ = 0;
  // The bound before the first block; its barrier also publishes the zeroed
  // flags.
  const float bound = cta_max_posted(mt, warp_max);

  stream_schedule(
      ring, w, order + (size_t)tile * nb, enter + (size_t)tile * nb, nb, tb, bound,
      [&](const float4* stage, int, int, int cw4) {
        occ |= flag.load(cuda::std::memory_order_relaxed);  // the other groups' finds so far
        if (occ || !(mt > 0.0f)) return;
        for (int q = g; q < cw4; q += groups) {
          float acc[1][NS][4];
          live_dots<1>(f, stage, q, acc);
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

// The tensor-core kernel's launch bound, at one or two m-tiles a warp: as
// the FMA kernel's 8 groups of 128 threads, which beat fewer (the live
// tiles are few, so each takes as many warps as a CTA holds).
constexpr int MMA_MAX_THREADS = 1024;

// The bf16 modes on the tensor cores (see the header).
template <int P, int MT>
__global__ void __launch_bounds__(MMA_MAX_THREADS)
    occlusion_mma_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                         const float* __restrict__ feats, const float* __restrict__ maxt,
                         const float* __restrict__ w, const __nv_bfloat16* __restrict__ w_hi,
                         const __nv_bfloat16* __restrict__ w_lo, int* __restrict__ occ_out, int nb, int tb,
                         int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* occ_shared = reinterpret_cast<int*>(smem + STAGES * mma_stage_float4<P>());  // (ray_tile,)
  __shared__ float warp_max[32];

  const int lane = threadIdx.x & 31;
  const int wpg = ray_tile / (16 * MT);  // warps per group
  const int g = (threadIdx.x >> 5) / wpg;
  const int first = ((threadIdx.x >> 5) - g * wpg) * 16 * MT;  // the warp's first ray in the tile
  const int tile = blockIdx.x;

  RayFragments<P, MT> a;
  a.load(feats, tile * ray_tile + first, lane);
  // Every thread holds the flags of its rays (a quad's 4 threads agree
  // after each chunk, the groups after each block). Held in the kernel's
  // own arrays: the same state in a struct shared with occlusion_streamed.cu
  // made K4 5-6% slower (tools/bench_ab.py, PERF.md section 6).
  int lane_of[MT][2];  // ray within the tile
  float mt[MT][2];
  bool occ[MT][2];
  float open_max = -INFINITY;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lane_of[m][h] = first + 16 * m + 8 * h + (lane >> 2);
      mt[m][h] = maxt[tile * ray_tile + lane_of[m][h]];
      occ[m][h] = false;
      open_max = fmaxf(open_max, mt[m][h]);
    }
  }
  auto flag = [&](int i) { return cuda::atomic_ref<int, cuda::thread_scope_block>(occ_shared[i]); };
  for (int i = threadIdx.x; i < ray_tile; i += blockDim.x) flag(i).store(0, cuda::std::memory_order_relaxed);
  // The bound before the first block; its barrier also publishes the zeroed
  // flags.
  const float bound = cta_max_posted(open_max, warp_max);

  walk_schedule<mma_stage_float4<P>()>(
      ring, [&](float4* stage, int blk, int c0) { fetch_chunk_mma<P>(stage, w, w_hi, w_lo, blk, tb, c0); },
      order + (size_t)tile * nb, enter + (size_t)tile * nb, nb, tb, bound,
      [&](const float4* stage, int, int, int cw4) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // the other groups' finds so far
            occ[m][h] |= flag(lane_of[m][h]).load(cuda::std::memory_order_relaxed) != 0;
          }
        }
        mma_chunk_any<P, MT>(a, stage, g, groups, 4 * cw4, lane, mt, occ);
        if ((lane & 3) == 0) {  // the quad's first thread posts its rays' flags
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (occ[m][h]) flag(lane_of[m][h]).store(1, cuda::std::memory_order_relaxed);
            }
          }
        }
      },
      [&](int) {
        __syncthreads();  // every group's flags of this block are in occ_shared
        float v = -INFINITY;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            occ[m][h] |= flag(lane_of[m][h]).load(cuda::std::memory_order_relaxed) != 0;
            v = fmaxf(v, occ[m][h] ? -INFINITY : mt[m][h]);
          }
        }
        return cta_max_posted(v, warp_max);
      });
  if (g == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) occ_out[tile * ray_tile + lane_of[m][h]] = occ[m][h];
    }
  }
}

template <int P>
size_t smem_bytes(int ray_tile) {
  return (P == HIGHEST ? RING_BYTES : mma_ring_bytes<P>()) + (size_t)ray_tile * sizeof(int);
}

// f(kernel, threads) for the kernel at precision P: at HIGHEST the FMA
// kernel (per = 1 ray a thread), at the bf16 modes the tensor-core kernel of
// per m-tiles a warp (1 or 2); `invalid` for a shape it does not take.
template <int P, typename F>
int with_kernel(int ray_tile, int groups, int per, int invalid, F&& f) {
  if constexpr (P == HIGHEST) {
    if (per == 1 && ring_threads<1>(ray_tile, groups, 1024))
      return f(occlusion_kernel, ring_threads<1>(ray_tile, groups, 1024));
  } else {
    if (per == 1 && mma_threads<1>(ray_tile, groups, MMA_MAX_THREADS))
      return f(occlusion_mma_kernel<P, 1>, mma_threads<1>(ray_tile, groups, MMA_MAX_THREADS));
    if (per == 2 && mma_threads<2>(ray_tile, groups, MMA_MAX_THREADS))
      return f(occlusion_mma_kernel<P, 2>, mma_threads<2>(ray_tile, groups, MMA_MAX_THREADS));
  }
  return invalid;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one CTA per ray tile of `ray_tile` rays,
// at `precision` (0 highest, 1 high, 2 mixed, 3 default), and returns
// cudaGetLastError() (0 = launched). At HIGHEST the CTA is `groups` column
// groups of ray_tile threads (per = 1 ray a thread), at most 1024 in all;
// at the bf16 modes `groups` column groups of ray_tile / (16 per) warps,
// per = m-tiles of 16 rays a warp (1 or 2), at most 1024 threads in all.
// Anything else returns cudaErrorInvalidValue. w_hi and w_lo are read only
// at the bf16 modes. The caller checks shapes, types, alignment (tb % 4 ==
// 0; w, w_hi and w_lo on a 16-byte boundary) and ray_tile.
int occlusion_launch(const void* order, const void* enter, const void* feats, const void* maxt, const void* w,
                     const void* w_hi, const void* w_lo, void* occ, int rt, int nb, int tb, int ray_tile, int groups,
                     int per, int precision, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return with_kernel<P>(ray_tile, groups, per, invalid, [&](auto kernel, int threads) {
      // The triangle operands: w of the FMA kernel (HIGHEST), w, w_hi and
      // w_lo of the tensor-core one.
      auto with_operands = [&](auto... operands) {
        return launch_ring(kernel, rt, threads, smem_bytes<P>(ray_tile), s, static_cast<const int*>(order),
                           static_cast<const float*>(enter), static_cast<const float*>(feats),
                           static_cast<const float*>(maxt), operands..., static_cast<int*>(occ), nb, tb, ray_tile,
                           groups);
      };
      const auto wf = static_cast<const float*>(w);
      if constexpr (P == HIGHEST) {
        return with_operands(wf);
      } else {
        return with_operands(wf, static_cast<const __nv_bfloat16*>(w_hi), static_cast<const __nv_bfloat16*>(w_lo));
      }
    });
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// occlusion_launch takes them), or -1 if it is not one.
int occlusion_occupancy(int ray_tile, int groups, int per, int precision) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return with_kernel<P>(ray_tile, groups, per, -1, [&](auto kernel, int threads) {
      return ring_occupancy(kernel, threads, smem_bytes<P>(ray_tile));
    });
  });
}

const char* occlusion_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
