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
//   w_hi, w_lo bf16 (nc*bpc, 5, tb, 8) the bf16 modes' operands, as in
//             closest_hit_streamed.cu; HIGHEST reads w only, MIXED also
//             w's D|num rows
//   tests     int64 (1) or null: the (open lane, triangle column) tests of
//             the blocks tested, added once a CTA (add_tests in
//             stream_stage.cuh): for each tested block, the tile's lanes
//             still open at its start (unoccluded, maxt > 0) x tb, as the
//             plain version's count_work counts them (lane_blocks x tb); a
//             lane occluded inside a block counts the block's tb columns
// Output: occ int32 (rt*TR), 1 where some accepted hit has t < maxt.
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
//
// A lane's flag at a block's first chunk is the OR of every find before the
// block (the ring's barrier sits between two chunks), which is the plain
// version's flag before that block: so the count equals its count_work
// wherever the flags agree. COUNT = true (a non-null counter, traced frames
// only) adds the count; the instantiations without it, an untraced frame's,
// have neither its code nor its registers.
//
// The bf16 modes (occlusion_streamed_mma_kernel<P, MT, COUNT>) take the
// tensor-core route of stream_stage.cuh, as closest_hit_streamed.cu's do: `groups`
// column groups of ray_tile / (16 MT) warps, each warp MT m-tiles of 16 rays
// with their bf16 A fragments in registers, group g taking n-tiles g,
// g + groups, ... of every chunk (mma_chunk_any: 15 mma.sync m16n8k8 per
// 16 x 8 pairs at HIGH, 9 and D's and num's f32 FMA chains at MIXED, 4 and
// num's chain at DEFAULT, then blocks_ray on the accumulators). A ray's flag
// is the OR of its quad's 4 threads, voted once per chunk; a warp skips a
// chunk when none of its rays is open. The flags cross the groups through
// the same per-ray shared word (the quad's first thread sets it), and after each cluster come a barrier, the OR, and the bound with
// one barrier (cta_max_posted). The tensor cores take the arithmetic that
// tripled at HIGH on the CUDA cores, so the longest tiles shorten with it;
// the sums take the tensor cores' order, so the flags meet the flag bar
// against the plain version, not bit-equality.

#include "stream_stage.cuh"

#include <cuda/atomic>
#include <stdint.h>

namespace {

using namespace stream;

// HIGHEST (the bf16 modes take the tensor-core kernel below).
template <bool COUNT>
__global__ void __launch_bounds__(1024)
    occlusion_streamed_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                              const float* __restrict__ enter_blk, const float* __restrict__ feats,
                              const float* __restrict__ maxt, const float* __restrict__ w, int* __restrict__ occ_out,
                              unsigned long long* __restrict__ tests, int nc, int bpc, int tb, int ray_tile,
                              int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* occ_shared = reinterpret_cast<int*>(smem + STAGES * STAGE_FLOAT4);  // (ray_tile,)
  __shared__ float warp_max[32];
  __shared__ float tile_bound;

  const int g = threadIdx.x / ray_tile;
  const int lane = threadIdx.x - g * ray_tile;  // ray within the tile
  const int tile = blockIdx.x;
  const int ray = tile * ray_tile + lane;
  const int nb = nc * bpc;

  RayFeatures f[1];
  f[0].load(feats, ray);
  const float mt = maxt[ray];
  cuda::atomic_ref<int, cuda::thread_scope_block> flag(occ_shared[lane]);
  if (g == 0) flag.store(0, cuda::std::memory_order_relaxed);
  __syncthreads();
  int occ = 0;
  int blocks = 0;  // COUNT: blocks tested while the lane was open (group 0 owns the tile's rays)
  float bound = INFINITY;

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;

  for (int j = 0; j < nc; ++j) {
    // Uniform across the CTA: every thread reads the same entries and bound.
    if (!(tile_enter[j] < bound)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there
    stream_cluster(ring, w + (size_t)c * bpc * K * NS * tb, tile_enter_blk + (size_t)c * bpc, bpc, tb, bound,
                   [&](const float4* stage, int, int c0, int cw4) {
                     occ |= flag.load(cuda::std::memory_order_relaxed);  // the other groups' finds so far
                     if constexpr (COUNT) blocks += g == 0 && c0 == 0 && !occ && mt > 0.0f;
                     if (occ || !(mt > 0.0f)) return;
                     for (int q = g; q < cw4; q += groups) {
                       float acc[1][NS][4];
                       live_dots<1>(f, stage, q, acc);
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
  if constexpr (COUNT) add_tests(tests, blocks, tb);
}

// The tensor-core kernel's launch bound: 512 threads at one m-tile a warp
// (4 column groups of the 64-ray tile, 0.93-0.94x the time of 2 groups at
// "high" and "mixed" on the NEE shadow rays, tools/stream_sweep.py mma),
// 1024 at two (ray tiles past 256 a group), as closest_hit_streamed.cu's.
template <int MT>
constexpr int mma_max_threads() {
  return MT == 1 ? 512 : 1024;
}

// The bf16 modes on the tensor cores (see the header), with and without
// the count (COUNT, as the kernel above).
template <int P, int MT, bool COUNT>
__global__ void __launch_bounds__(mma_max_threads<MT>())
    occlusion_streamed_mma_kernel(const int* __restrict__ order, const float* __restrict__ enter,
                                  const float* __restrict__ enter_blk, const float* __restrict__ feats,
                                  const float* __restrict__ maxt, const float* __restrict__ w,
                                  const __nv_bfloat16* __restrict__ w_hi, const __nv_bfloat16* __restrict__ w_lo,
                                  int* __restrict__ occ_out, unsigned long long* __restrict__ tests, int nc, int bpc,
                                  int tb, int ray_tile, int groups) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* occ_shared = reinterpret_cast<int*>(smem + STAGES * mma_stage_float4<P>());  // (ray_tile,)
  __shared__ float warp_max[32];

  const int lane = threadIdx.x & 31;
  const int wpg = ray_tile / (16 * MT);  // warps per group
  const int g = (threadIdx.x >> 5) / wpg;
  const int first = ((threadIdx.x >> 5) - g * wpg) * 16 * MT;  // the warp's first ray in the tile
  const int tile = blockIdx.x;
  const int nb = nc * bpc;

  RayFragments<P, MT> a;
  a.load(feats, tile * ray_tile + first, lane);
  // Every thread holds the flags of its rays (a quad's 4 threads agree
  // after each chunk, the groups after each cluster), in the kernel's own
  // arrays (see occlusion.cu).
  int lane_of[MT][2];  // ray within the tile
  float mt[MT][2];
  bool occ[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lane_of[m][h] = first + 16 * m + 8 * h + (lane >> 2);
      mt[m][h] = maxt[tile * ray_tile + lane_of[m][h]];
      occ[m][h] = false;
    }
  }
  auto flag = [&](int i) { return cuda::atomic_ref<int, cuda::thread_scope_block>(occ_shared[i]); };
  for (int i = threadIdx.x; i < ray_tile; i += blockDim.x) flag(i).store(0, cuda::std::memory_order_relaxed);
  __syncthreads();
  float bound = INFINITY;
  // COUNT: blocks tested while each of the thread's rays was open (group 0,
  // a quad's first thread, owns the rays).
  int blocks = 0;
  const bool owner = g == 0 && (lane & 3) == 0;

  const int* tile_order = order + (size_t)tile * nc;
  const float* tile_enter = enter + (size_t)tile * nc;
  const float* tile_enter_blk = enter_blk + (size_t)tile * nb;

  for (int j = 0; j < nc; ++j) {
    // Uniform across the CTA: every thread reads the same entries and bound.
    if (!(tile_enter[j] < bound)) break;
    const int c = tile_order[j];
    if (c < 0 || c >= nc) break;  // culled sentinel; unreachable while enter is +inf there
    walk_cluster<mma_stage_float4<P>()>(
        ring, [&](float4* stage, int b, int c0) { fetch_chunk_mma<P>(stage, w, w_hi, w_lo, c * bpc + b, tb, c0); },
        tile_enter_blk + (size_t)c * bpc, bpc, tb, bound, [&](const float4* stage, int, int c0, int cw4) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // the other groups' finds so far
              occ[m][h] |= flag(lane_of[m][h]).load(cuda::std::memory_order_relaxed) != 0;
              if constexpr (COUNT) blocks += owner && c0 == 0 && !occ[m][h] && mt[m][h] > 0.0f;
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
        });
    __syncthreads();  // every group's flags of this cluster are in occ_shared
    float open_max = -INFINITY;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        occ[m][h] |= flag(lane_of[m][h]).load(cuda::std::memory_order_relaxed) != 0;
        open_max = fmaxf(open_max, occ[m][h] ? -INFINITY : mt[m][h]);
      }
    }
    // Its barrier, with the one above, keeps the next cluster's copies and
    // flag posts behind every read of this one.
    bound = cta_max_posted(open_max, warp_max);
  }
  if (g == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) occ_out[tile * ray_tile + lane_of[m][h]] = occ[m][h];
    }
  }
  if constexpr (COUNT) add_tests(tests, blocks, tb);
}

template <int P>
size_t smem_bytes(int ray_tile) {
  return (P == HIGHEST ? RING_BYTES : mma_ring_bytes<P>()) + (size_t)ray_tile * sizeof(int);
}

// f(kernel, threads) for the kernel at precision P, with or without the
// count: at HIGHEST the FMA kernel (per = 1 ray a thread), at the bf16 modes
// the tensor-core kernel of per m-tiles a warp (1 or 2); `invalid` for a
// shape it does not take.
template <int P, bool COUNT, typename F>
int with_kernel(int ray_tile, int groups, int per, int invalid, F&& f) {
  if constexpr (P == HIGHEST) {
    if (per == 1 && ring_threads<1>(ray_tile, groups, 1024))
      return f(occlusion_streamed_kernel<COUNT>, ring_threads<1>(ray_tile, groups, 1024));
  } else {
    if (per == 1 && mma_threads<1>(ray_tile, groups, mma_max_threads<1>()))
      return f(occlusion_streamed_mma_kernel<P, 1, COUNT>, mma_threads<1>(ray_tile, groups, mma_max_threads<1>()));
    if (per == 2 && mma_threads<2>(ray_tile, groups, mma_max_threads<2>()))
      return f(occlusion_streamed_mma_kernel<P, 2, COUNT>, mma_threads<2>(ray_tile, groups, mma_max_threads<2>()));
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
// per = m-tiles of 16 rays a warp (1 or 2), with at most 512 (1) or 1024 (2)
// threads. Anything else returns cudaErrorInvalidValue. w_hi and w_lo are
// read only at the bf16 modes. `tests` (null: no count) takes the tests of
// the blocks tested (see the header). The caller checks shapes, types,
// alignment (tb % 4 == 0; w, w_hi and w_lo on a 16-byte boundary) and
// ray_tile.
int occlusion_streamed_launch(const void* order, const void* enter, const void* enter_blk, const void* feats,
                              const void* maxt, const void* w, const void* w_hi, const void* w_lo, void* occ,
                              void* tests, int rt, int nc, int bpc, int tb, int ray_tile, int groups, int per,
                              int precision, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  return with_precision(precision, invalid, [&](auto p) {
    constexpr int P = decltype(p)::value;
    auto launch = [&](auto kernel, int threads) {
      // The triangle operands: w of the FMA kernel (HIGHEST), w, w_hi and
      // w_lo of the tensor-core one.
      auto with_operands = [&](auto... operands) {
        return launch_ring(kernel, rt, threads, smem_bytes<P>(ray_tile), s, static_cast<const int*>(order),
                           static_cast<const float*>(enter), static_cast<const float*>(enter_blk),
                           static_cast<const float*>(feats), static_cast<const float*>(maxt), operands...,
                           static_cast<int*>(occ), static_cast<unsigned long long*>(tests), nc, bpc, tb, ray_tile,
                           groups);
      };
      const auto wf = static_cast<const float*>(w);
      if constexpr (P == HIGHEST) {
        return with_operands(wf);
      } else {
        return with_operands(wf, static_cast<const __nv_bfloat16*>(w_hi), static_cast<const __nv_bfloat16*>(w_lo));
      }
    };
    return tests ? with_kernel<P, true>(ray_tile, groups, per, invalid, launch)
                 : with_kernel<P, false>(ray_tile, groups, per, invalid, launch);
  });
}

// CTAs resident per SM at the launch shape of these arguments (as
// occlusion_streamed_launch takes them; without the count), or -1 if it is
// not one.
int occlusion_streamed_occupancy(int ray_tile, int groups, int per, int precision) {
  return with_precision(precision, -1, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return with_kernel<P, false>(ray_tile, groups, per, -1, [&](auto kernel, int threads) {
      return ring_occupancy(kernel, threads, smem_bytes<P>(ray_tile));
    });
  });
}

const char* occlusion_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
